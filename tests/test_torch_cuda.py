"""Tests of the port that need an NVIDIA GPU: each is marked ``cuda``
and skips with a reason where ``torch.cuda.is_available()`` is false.
This file imports no JAX, so that it runs on a machine with the card:

    PYTHONPATH=src python -m pytest -m cuda tests/test_torch_cuda.py
"""
import pytest

torch = pytest.importorskip("torch")

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 2e-2)])
def test_wkv6_backward_on_the_card(card, dtype, tol):
    """The WKV6 Function (one forward launch, one ``wkv6_bwd``) in the
    model's BSHN layout against ``wkv6_bwd_ref`` on the card: each
    gradient in its input's dtype, within tol x its max |g|
    (``chip_smoke.GRAD_TOL``), at chunk edges (S = 77)."""
    from repro_torch.kernels.rwkv6 import ops as wk
    from repro_torch.kernels.rwkv6 import ref
    g = torch.Generator(device="cuda").manual_seed(0)
    b, h, s, n = 2, 4, 77, 64

    def randn(*shape):
        return torch.randn(shape, generator=g, device="cuda")
    r, k, v = (randn(b, h, s, n).to(dtype) for _ in range(3))
    w = torch.exp(-torch.exp(randn(b, h, s, n) * 0.5 - 2.0))
    u, do = randn(h, n) * 0.5, randn(b, h, s, n)
    want = ref.wkv6_bwd_ref(r, k, v, w, u, do)
    leaves = [t.clone().requires_grad_(True) for t in (r, k, v, w, u)]
    fwd, bwd = wk.LAUNCHES, wk.BWD_LAUNCHES
    wk.wkv6_bshn(*(t.transpose(1, 2) for t in leaves[:4]),
                 leaves[4]).backward(do.transpose(1, 2))
    assert wk.LAUNCHES == fwd + 1 and wk.BWD_LAUNCHES == bwd + 1
    for t, want_g in zip(leaves, want):
        assert t.grad.dtype == t.dtype
        err = float((t.grad.float() - want_g.float()).abs().max())
        assert err <= tol * float(want_g.float().abs().max())


def test_wkv6_backward_is_bitwise_repeatable(card):
    """Two ``wkv6_bwd`` calls on the same inputs give bitwise-equal
    gradients: the kernels use no float atomics and add every sum (the
    chunks' carry, the partials of a CTA, dv across a cluster's row
    groups, du over the chunks) in a fixed order. (2, 40, 300, 64) bf16:
    80 heads, ten chunks with a ragged last one, 4 row groups a chunk."""
    from repro_torch.kernels.rwkv6 import ops as wk
    g = torch.Generator(device="cuda").manual_seed(1)
    b, h, s, n = 2, 40, 300, 64

    def randn(*shape):
        return torch.randn(shape, generator=g, device="cuda")
    r, k, v = (randn(b, h, s, n).bfloat16() for _ in range(3))
    w = torch.exp(-torch.exp(randn(b, h, s, n) * 0.5 - 2.0))
    u, do = randn(h, n) * 0.5, randn(b, h, s, n)
    bwd = wk.BWD_LAUNCHES
    first = wk._launch_bwd(r, k, v, w, u, do, heads=1)
    second = wk._launch_bwd(r, k, v, w, u, do, heads=1)
    torch.cuda.synchronize()
    assert wk.BWD_LAUNCHES == bwd + 2
    for x, y in zip(first, second):
        assert torch.isfinite(x.float()).all()
        assert torch.equal(x, y)


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 2e-2)])
def test_flash_gradient_on_the_card(card, dtype, tol):
    """The Function (one launch, torch-op backward) against autograd
    through the plain version on the card: each gradient within tol x
    its max |g| (``chip_smoke.GRAD_TOL``)."""
    from repro_torch.kernels.flash_attention import ops as fa
    from repro_torch.kernels.flash_attention import ref
    g = torch.Generator(device="cuda").manual_seed(0)
    q, k, v = (torch.randn(shape, generator=g, device="cuda").to(dtype)
               .requires_grad_(True)
               for shape in ((2, 9, 200, 64), (2, 3, 200, 64),
                             (2, 3, 200, 64)))
    do = torch.randn((2, 9, 200, 64), generator=g, device="cuda").to(dtype)
    launches = fa.LAUNCHES
    fa.flash_attention(q, k, v).backward(do)
    assert fa.LAUNCHES == launches + 1
    got = [t.grad for t in (q, k, v)]
    for t in (q, k, v):
        t.grad = None
    ref.attention_ref(q, k, v).backward(do)
    for a, t in zip(got, (q, k, v)):
        assert a.dtype == dtype
        want = t.grad.float()
        assert float((a.float() - want).abs().max()) <= tol * float(
            want.abs().max())


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5),
                                       (torch.bfloat16, 3e-2)])
def test_flash_small_head_on_the_card(card, dtype, tol):
    """Head size 8 (the reduced configs') runs on the D = 32 instance,
    padded: one launch a call, within ``chip_smoke``'s flash tolerance
    of the plain version, in both layouts."""
    from repro_torch.kernels.flash_attention import ops as fa
    from repro_torch.kernels.flash_attention import ref
    g = torch.Generator(device="cuda").manual_seed(1)
    q, k, v = (torch.randn(shape, generator=g, device="cuda").to(dtype)
               for shape in ((8, 4, 64, 8), (8, 2, 64, 8), (8, 2, 64, 8)))
    want = ref.attention_ref(q, k, v).float()
    launches = fa.LAUNCHES
    got = fa.flash_attention(q, k, v).float()
    bshd = fa.flash_attention_bshd(*(t.transpose(1, 2) for t in (q, k, v)))
    assert fa.LAUNCHES == launches + 2
    for out in (got, bshd.transpose(1, 2).float()):
        assert out.shape == want.shape
        assert bool(((out - want).abs() <= tol + tol * want.abs()).all())


def test_arena_checkpoint_moves_cuda_leaves_with_cellcopy(card):
    from repro_torch.core import Arena, LocalPool
    from repro_torch.kernels.cellcopy import ops as cc
    from repro_torch.train.checkpoint import ArenaCheckpoint
    tree = {"w": torch.randn(64, 33, device="cuda"),
            "b": (torch.randn(7, device="cuda").bfloat16(),),
            "n": torch.zeros((), dtype=torch.int32, device="cuda")}
    ck = ArenaCheckpoint(Arena(LocalPool(8 << 20, device="cuda"), 0,
                               initialize=True))
    launches = cc.LAUNCHES
    ck.save(5, tree)
    step, got = ck.restore({k: (torch.empty_like(v[0]),) if k == "b"
                            else torch.empty_like(v)
                            for k, v in tree.items()})
    assert step == 5 and cc.LAUNCHES == launches + 6
    assert torch.equal(got["w"], tree["w"]) and torch.equal(
        got["b"][0], tree["b"][0]) and torch.equal(got["n"], tree["n"])


def test_meta_and_card_counts_equal(card):
    """``analysis.hlo.count`` of a small flash and wkv6 call, forward and
    backward, on the card and on the meta device: the same FLOPs, bytes
    and charged kernels, and the card's launches equal the charged
    ones."""
    from repro_torch.analysis import hlo
    from repro_torch.kernels.flash_attention import ops as fa
    from repro_torch.kernels.rwkv6 import ops as wk

    def step(dev):
        g = torch.Generator().manual_seed(0)

        def leaf(*shape, dtype=torch.bfloat16):
            return torch.randn(shape, generator=g).to(dev, dtype) \
                .requires_grad_(True)
        q, k, v = leaf(2, 4, 128, 64), leaf(2, 2, 128, 64), \
            leaf(2, 2, 128, 64)
        r, kk, vv = (leaf(1, 2, 64, 64) for _ in range(3))
        w = leaf(1, 2, 64, 64, dtype=torch.float32)
        u = leaf(2, 64, dtype=torch.float32)

        def run():
            (fa.flash_attention(q, k, v).float().sum()
             + wk.wkv6(r, kk, vv, w, u).sum()).backward()
        return run

    before = (fa.LAUNCHES, wk.LAUNCHES, wk.BWD_LAUNCHES)
    card_st = hlo.count(step("cuda"))
    torch.cuda.synchronize()
    launched = tuple(a - b for a, b in zip(
        (fa.LAUNCHES, wk.LAUNCHES, wk.BWD_LAUNCHES), before))
    meta_st = hlo.count(step("meta"))
    assert (card_st.flops, card_st.bytes_) == (meta_st.flops, meta_st.bytes_)
    assert card_st.kernels == meta_st.kernels
    assert launched == tuple(card_st.kernels[n]["launches"] for n in (
        "flash_attention", "wkv6", "wkv6_bwd")) == (1, 1, 1)


def _scan_inputs(b, s, d_in, n, seed=0, with_h=False):
    """u, dt, B, C, A (and h) on the card in the model's regime: dt a
    softplus near its bias's 0.01, A = -(1..n) times e^(0.1 x), f32."""
    g = torch.Generator(device="cuda").manual_seed(seed)

    def randn(*shape):
        return torch.randn(shape, generator=g, device="cuda")
    u = randn(b, s, d_in)
    dt = torch.nn.functional.softplus(randn(b, s, d_in) * 0.5 - 4.6)
    B, C = randn(b, s, n), randn(b, s, n)
    A = -torch.arange(1, n + 1, dtype=torch.float32, device="cuda") \
        .repeat(d_in, 1) * torch.exp(randn(d_in, n) * 0.1)
    return u, dt, B, C, A, randn(b, d_in, n) if with_h else None


@pytest.mark.parametrize("b,s,d_in,n,with_h", [
    (1, 1, 64, 16, False), (2, 63, 100, 16, True), (2, 64, 100, 16, False),
    (2, 300, 100, 16, True), (1, 300, 72, 4, True),
    (1, 8192, 8192, 16, False), (1, 8192, 8192, 16, True)])
def test_selective_scan_kernel_on_the_card(card, b, s, d_in, n, with_h):
    """The kernel against the plain version on the card: one token, a
    tile's edge, ragged tiles, d_in = 100 (not a multiple of a CTA's 32
    channels), b = 2, the reduced configs' N = 4 and a Jamba2-Mini
    layer's prefill; y and the last state each within 1e-5 of the plain
    version's largest |value| (``chip_smoke.SCAN_TOL``: the order of
    rounding and exp2 for exp); one launch a call."""
    from repro_torch.kernels.selective_scan import ops as ss
    args = _scan_inputs(b, s, d_in, n, seed=s + d_in, with_h=with_h)
    want_y, want_h = ss.selective_scan_ref(*args)
    before = ss.LAUNCHES
    got_y, got_h = ss.selective_scan(*args)
    torch.cuda.synchronize()
    assert ss.LAUNCHES == before + 1
    for got, want in ((got_y, want_y), (got_h, want_h)):
        assert got.shape == want.shape and got.dtype == torch.float32
        err = float((got - want).abs().max())
        assert err <= 1e-5 * float(want.abs().max())


def test_selective_scan_gradient_on_the_card(card):
    """The Function's backward is the plain version's autograd on the
    saved inputs: with the same output gradients the input gradients,
    h's included, equal autograd through the plain version bit for
    bit."""
    from repro_torch.kernels.selective_scan import ops as ss
    args = _scan_inputs(2, 130, 40, 16, seed=5, with_h=True)
    g = torch.Generator(device="cuda").manual_seed(6)
    dy = torch.randn(2, 130, 40, generator=g, device="cuda")
    dh = torch.randn(2, 40, 16, generator=g, device="cuda")
    grads = []
    for fn in (ss.selective_scan, ss.selective_scan_ref):
        leaves = [t.clone().requires_grad_(True) for t in args]
        y, h_last = fn(*leaves)
        ((y * dy).sum() + (h_last * dh).sum()).backward()
        grads.append([t.grad for t in leaves])
    for got, want in zip(*grads):
        assert torch.equal(got, want)


def test_mamba_layers_count_their_kernel_scans(card):
    """While the tracer records, each Mamba prefill layer on the card
    counts one ``mamba_scan_kernel`` and its ``mamba_scan_chunks``; a
    decode step launches no scan and counts neither; nothing is counted
    while the tracer is off."""
    from types import SimpleNamespace

    from repro_torch.configs import get_config
    from repro_torch.core.trace import Tracer
    from repro_torch.kernels.selective_scan import ops as ss
    from repro_torch.models import blocks
    cfg = get_config("jamba2-mini").reduced()
    params = blocks.mamba_init(torch.Generator(device="cuda").manual_seed(0),
                               cfg, device="cuda")
    state = blocks.mamba_state_init(cfg, 2, device="cuda")
    tr = Tracer(enabled=False)
    dist = SimpleNamespace(tracer=tr)
    x = torch.randn(2, 70, cfg.d_model, device="cuda").to(
        getattr(torch, cfg.compute_dtype))
    before = ss.LAUNCHES
    blocks.mamba_apply(params, cfg, x, state=state, dist=dist)
    assert not tr.metrics.counters
    tr.start()
    for _ in range(3):
        blocks.mamba_apply(params, cfg, x, state=state, dist=dist)
    blocks.mamba_apply(params, cfg, x[:, :1], state=state, dist=dist)
    tr.stop()
    torch.cuda.synchronize()
    assert ss.LAUNCHES == before + 4
    assert tr.metrics.counters["mamba_scan_kernel"] == 3
    assert tr.metrics.counters["mamba_scan_chunks"] == 3 * 2


def _two_rank_sums(env):
    """A Jamba-shaped pair of pieces (f32) and the embedding's bf16 sum,
    through ``auto`` and the ring: their bits, and the pieces counted."""
    c, out = env.comm, []
    c.tracer.start()
    g = torch.Generator(device="cuda").manual_seed(30 + env.rank)
    for dtype, n in ((torch.float32, 3 * (c.lease_cap // 4) + 5),
                     (torch.bfloat16, 1 << 20)):
        x = torch.randn(n, generator=g, device="cuda").to(dtype)
        auto, ring = c.allreduce(x), c.allreduce(x, algo="ring")
        out.append(torch.equal(auto.view(torch.uint8),
                               ring.view(torch.uint8)))
    return out, c.tracer.allreduce_direct


def test_two_rank_sum_on_the_card(card):
    """The direct sum of two ranks on the card (threads of one process
    over a mapped pool), the peer's operand read from the pool's mapped
    window: bitwise the ring's, f32 in 4 pieces (the last ragged) and
    bf16 whole."""
    from repro_torch.core import run_threads
    res = run_threads(2, _two_rank_sums, pool_bytes=64 << 20,
                      device="cuda", timeout=120)
    for ok, pieces in res:
        assert all(ok) and pieces == 4 + 1
