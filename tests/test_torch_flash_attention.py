"""The port's flash attention (plain PyTorch version on the CPU) against
the JAX package's Pallas kernel in interpret mode and its jnp oracle:
the same numpy inputs through both, on the cases of
tests/test_kernels.py::TestFlashAttention. The f32 CUDA kernel's
arithmetic (three TF32 products over its tiles) is replayed in plain
torch by ``emulate_split_tf32`` and held to the JAX kernel too."""
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels.flash_attention.kernel import \
    flash_attention as jax_flash  # noqa: E402
from repro.kernels.flash_attention.ops import \
    flash_attention_bshd as jax_flash_bshd  # noqa: E402
from repro.models.blocks import _plain_attention as jax_plain  # noqa: E402
from repro_torch.kernels.flash_attention import ops, ref  # noqa: E402
from repro_torch.models import blocks  # noqa: E402

# (b, h, kv, s, d, causal, bf16) of test_kernels.py::test_sweep
SWEEP = [(2, 4, 4, 256, 64, True, False), (1, 8, 2, 256, 128, True, True),
         (2, 4, 1, 128, 64, False, False), (1, 2, 2, 512, 32, True, False)]


def _pair(a: np.ndarray, bf16: bool):
    """The same values in both frameworks (bf16 rounds alike in both)."""
    if bf16:
        return jnp.asarray(a, jnp.bfloat16), torch.from_numpy(a).bfloat16()
    return jnp.asarray(a), torch.from_numpy(a)


def _qkv(rng, b, h, kv, s, d, bf16=False):
    shapes = [(b, h, s, d), (b, kv, s, d), (b, kv, s, d)]
    pairs = [_pair(rng.standard_normal(sh, dtype=np.float32), bf16)
             for sh in shapes]
    return [p[0] for p in pairs], [p[1] for p in pairs]


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


@pytest.mark.parametrize("b,h,kv,s,d,causal,bf16", SWEEP)
def test_flash_matches_jax_kernel(b, h, kv, s, d, causal, bf16, rng):
    (jq, jk, jv), (tq, tk, tv) = _qkv(rng, b, h, kv, s, d, bf16)
    want = jax_flash(jq, jk, jv, causal=causal, block_q=64, block_k=64)
    tol = 3e-2 if bf16 else 1e-5
    launches = ops.LAUNCHES
    got = ops.flash_attention(tq, tk, tv, causal=causal)
    assert got.dtype == tq.dtype and got.shape == tq.shape
    np.testing.assert_allclose(_f32(got), _f32(want), rtol=tol, atol=tol)
    plain = ref.attention_ref(tq, tk, tv, causal=causal)
    np.testing.assert_allclose(_f32(plain), _f32(want), rtol=tol, atol=tol)
    assert ops.LAUNCHES == launches      # the plain version is no launch


def test_block_shapes_of_the_jax_kernel_agree_with_the_port(rng):
    """The port has no block-size knob: both JAX block shapes of
    test_block_shape_invariance match it."""
    (jq, jk, jv), (tq, tk, tv) = _qkv(rng, 1, 2, 2, 256, 64)
    got = _f32(ops.flash_attention(tq, tk, tv))
    for bq, bk in [(64, 64), (128, 32)]:
        want = jax_flash(jq, jk, jv, block_q=bq, block_k=bk)
        np.testing.assert_allclose(got, _f32(want), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("kv", [4, 2])
def test_bshd_wrapper_matches_blocks_layout(kv, rng):
    """flash_attention_bshd in the models/blocks layout against the JAX
    package's wrapper and _plain_attention (over repeated kv heads)."""
    b, s, h, d = 2, 128, 4, 64
    shapes = [(b, s, h, d), (b, s, kv, d), (b, s, kv, d)]
    arrs = [rng.standard_normal(sh, dtype=np.float32) for sh in shapes]
    jq, jk, jv = map(jnp.asarray, arrs)
    tq, tk, tv = map(torch.from_numpy, arrs)
    got = _f32(ops.flash_attention_bshd(tq, tk, tv, causal=True))
    want = jax_flash_bshd(jq, jk, jv, causal=True, block_q=64, block_k=64,
                          interpret=True)
    np.testing.assert_allclose(got, _f32(want), rtol=1e-5, atol=1e-5)
    rep = h // kv
    plain = jax_plain(jq, jnp.repeat(jk, rep, axis=2),
                      jnp.repeat(jv, rep, axis=2), causal=True)
    np.testing.assert_allclose(got, _f32(plain), rtol=1e-4, atol=1e-4)
    port_plain = blocks._plain_attention(
        tq, blocks._repeat_kv(tk, rep), blocks._repeat_kv(tv, rep), True)
    np.testing.assert_allclose(got, _f32(port_plain), rtol=1e-5, atol=1e-5)


def test_wrapper_rejects_what_the_kernel_does_not_take():
    z = torch.zeros
    with pytest.raises(ValueError):              # head size 48
        ops.flash_attention(z(1, 2, 8, 48), z(1, 2, 8, 48), z(1, 2, 8, 48))
    with pytest.raises(ValueError):              # 3 heads over 2
        ops.flash_attention(z(1, 3, 8, 32), z(1, 2, 8, 32), z(1, 2, 8, 32))
    with pytest.raises(ValueError):              # mixed dtypes
        ops.flash_attention(z(1, 2, 8, 32), z(1, 2, 8, 32).bfloat16(),
                            z(1, 2, 8, 32))
    with pytest.raises(ValueError):              # float16
        h = z(1, 2, 8, 32).half()
        ops.flash_attention(h, h, h)

@pytest.mark.parametrize("d,padded", [(8, 32), (16, 64), (4, 64), (2, 32),
                                      (32, 32), (64, 64), (128, 128),
                                      (48, None), (12, None), (256, None)])
def test_small_heads_run_on_a_padded_instance(d, padded):
    """A head size below the kernel's instances (the reduced configs'
    8) runs on the instance ``padded_head`` names: zero columns and q
    scaled by a power of 2, so the first d columns of the padded
    attention are the attention at d, to f32 rounding (the plain
    version stands in for the kernel); sizes with no such instance are
    refused."""
    assert ops.padded_head(d) == padded
    if padded is None:
        with pytest.raises(ValueError):
            ops.flash_attention(*(torch.zeros(1, 2, 8, d) for _ in "qkv"))
        return
    g = torch.Generator().manual_seed(d)
    q, k, v = (torch.randn(2, 4, 37, d, generator=g) * 3 for _ in "qkv")
    k, v = k[:, :2], v[:, :2]                    # GQA: 4 heads over 2
    pq, pk, pv = ops.pad_head(q, k, v)
    assert pq.shape[3] == pk.shape[3] == pv.shape[3] == padded
    for causal in (True, False):
        want = ref.attention_ref(q, k, v, causal=causal)
        got = ref.attention_ref(pq, pk, pv, causal=causal)
        np.testing.assert_allclose(got[..., :d], want, rtol=1e-6, atol=1e-6)
        assert not got[..., d:].any()
        np.testing.assert_array_equal(
            ops.flash_attention(q, k, v, causal=causal), want)



class _FakeLibrary:
    """Stands in for the CUDA library: records what the wrapper would
    hand the kernel and launches nothing."""

    def __init__(self):
        self.calls = []

    def flash_attention_fwd(self, *args):
        self.calls.append([a.value if hasattr(a, "value") else a
                           for a in args])
        return 0


STREAM = 0x5EED0                         # a stand-in stream handle


def _card_route(monkeypatch):
    import types

    from repro_torch.kernels import build
    lib = _FakeLibrary()
    monkeypatch.setattr(build, "load", lambda: lib)
    monkeypatch.setattr(ops, "route", lambda name, *ts: "cuda")
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda: types.SimpleNamespace(cuda_stream=STREAM))
    return lib


def _misaligned(shape, dtype):
    """A contiguous view whose storage offset puts it 2 or 4 bytes past a
    16-byte boundary."""
    n = int(np.prod(shape))
    base = torch.zeros(n + 8, dtype=dtype)
    t = base[1:n + 1].view(shape)
    assert t.is_contiguous() and t.data_ptr() % 16
    return t


# (layout, dtype, misaligned view): BHSD, BSHD, a BSHD view of BHSD
# tensors (no copy), and misaligned views (copied); f32 in every layout,
# since its kernel's 16-byte loads take the same strides as bf16's TMA
LAUNCH_CASES = [("bhsd", torch.bfloat16, False),
                ("bshd", torch.bfloat16, False),
                ("bshd-view", torch.bfloat16, False),
                ("bhsd", torch.bfloat16, True),
                ("bshd", torch.float32, True),
                ("bhsd", torch.float32, False),
                ("bshd", torch.float32, False),
                ("bshd-view", torch.float32, False)]


@pytest.mark.parametrize(
    "layout,dtype,misaligned", LAUNCH_CASES,
    ids=[f"{la}-{str(dt)[6:]}{'-misaligned' if mis else ''}"
         for la, dt, mis in LAUNCH_CASES])
def test_launch_arguments(layout, dtype, misaligned, monkeypatch):
    """What the wrapper passes the kernel library on the card route: the
    dtype code, B/H/KV/S/D, the causal flag, the (batch, head, seq)
    strides of q, k, v and out in elements, 16-byte aligned pointers,
    and one launch per call. Tensors the kernel can address go in as
    they lie; the others are copied into fresh contiguous ones."""
    lib = _card_route(monkeypatch)
    b, h, kv, s, d = 2, 8, 2, 200, 64
    heads = 1 if layout == "bhsd" else 2
    shapes = {"bhsd": [(b, h, s, d), (b, kv, s, d), (b, kv, s, d)],
              "bshd": [(b, s, h, d), (b, s, kv, d), (b, s, kv, d)]}
    if layout == "bshd-view":
        q, k, v = (torch.zeros(sh, dtype=dtype).transpose(1, 2)
                   for sh in shapes["bhsd"])
    elif misaligned:
        q, k, v = (_misaligned(sh, dtype) for sh in shapes[layout])
    else:
        q, k, v = (torch.zeros(sh, dtype=dtype) for sh in shapes[layout])
    call = ops.flash_attention if heads == 1 else ops.flash_attention_bshd
    launches = ops.LAUNCHES
    out = call(q, k, v, causal=False)
    assert ops.LAUNCHES == launches + 1
    out = call(q, k, v, causal=True)
    assert ops.LAUNCHES == launches + 2
    assert len(lib.calls) == 2 and out.shape == q.shape
    args = lib.calls[1]
    ptrs, ints, strides, stream = args[:4], args[4:11], args[11:23], args[23]
    assert ints == [ops.DTYPES[dtype], b, h, kv, s, d, 1]
    assert lib.calls[0][10] == 0                      # causal=False
    assert stream == STREAM
    assert all(p % 16 == 0 for p in ptrs)
    seq = 3 - heads

    def bhs(t):
        return [t.stride(0), t.stride(heads), t.stride(seq)]

    if misaligned:                       # fresh contiguous copies
        assert all(p != t.data_ptr() for p, t in zip(ptrs, (q, k, v)))
        want = []
        for sh in shapes[layout]:
            c = torch.empty(sh)
            want += [c.stride(0), c.stride(heads), c.stride(seq)]
        assert strides[:9] == want
    else:                                # as they lie, no transpose
        assert ptrs[:3] == [t.data_ptr() for t in (q, k, v)]
        assert strides[:9] == bhs(q) + bhs(k) + bhs(v)
    assert ptrs[3] == out.data_ptr() and strides[9:] == bhs(out)
    assert all(st * q.element_size() % 16 == 0 for st in strides)


def _chip_smoke():
    import importlib.util
    from pathlib import Path
    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_smoke_l2_bound_admits_tiled_rounding_and_catches_a_scale_error(
        rng):
    """chip_smoke.py's bf16 flash check: the Pallas kernel (128-key tiles,
    p rounded unnormalised as the CUDA kernel rounds it) stays inside
    FLASH_L2 of the plain version, and an output whose softmax scale is
    2 % off, which assert_allclose at 3e-2 lets through, does not."""
    smoke = _chip_smoke()
    (jq, jk, jv), (tq, tk, tv) = _qkv(rng, 1, 4, 1, 1024, 128, bf16=True)
    want = ref.attention_ref(tq, tk, tv, causal=True)
    check = smoke.FloatCheck("flash_attention")
    tiled = torch.from_numpy(_f32(jax_flash(
        jq, jk, jv, causal=True, block_q=128, block_k=128))).bfloat16()
    check.close("pallas", tiled, want, 3e-2, smoke.FLASH_L2)
    assert 0 < check.max_l2_err < smoke.FLASH_L2
    off = ref.attention_ref(tq.float() * 1.02, tk, tv).bfloat16()
    np.testing.assert_allclose(_f32(off), _f32(want), rtol=3e-2, atol=3e-2)
    with pytest.raises(SystemExit):
        check.close("scale 1.02", off, want, 3e-2, smoke.FLASH_L2)
    assert check.mismatches == 1 and check.max_l2_err > smoke.FLASH_L2


# ---------------------------------------------------------------------------
# the f32 kernel's split-TF32 arithmetic, replayed on the CPU
# ---------------------------------------------------------------------------

def tf32(x: torch.Tensor) -> torch.Tensor:
    """``cvt.rna.tf32.f32``: round to the nearest tf32 (10 explicit
    mantissa bits), ties away from zero -- on the int32 view, add half of
    the low 13 bits' range and clear them (the sign bit rides along)."""
    i = x.float().contiguous().view(torch.int32)
    return ((i + 0x1000) & -0x2000).view(torch.float32)


def split_tf32(x: torch.Tensor):
    """(hi, lo), both tf32, with x = hi + lo to within 2^-22 |x|."""
    hi = tf32(x)
    return hi, tf32(x - hi)


def _tf32_mm(a, b, products: int = 3):
    """a @ b^T as the kernel forms it: hi.hi, plus hi.lo + lo.hi summed
    apart (three products), f32 sums."""
    ah, al = split_tf32(a)
    bh, bl = split_tf32(b)
    main = ah @ bh.transpose(-1, -2)
    if products == 1:
        return main
    return main + (ah @ bl.transpose(-1, -2) + al @ bh.transpose(-1, -2))


def emulate_split_tf32(q, k, v, causal: bool = True,
                       products: int = 3) -> torch.Tensor:
    """The f32 CUDA kernel's arithmetic in plain torch: per query block
    of ``block_q`` rows, the K/V tiles of ``block_k`` keys that
    ``ops.launch_plan`` gives it (the causal skip included), scores as
    three TF32 products, the diagonal and ragged tiles masked to -1e30,
    the online softmax in exp2 with the scale folded with log2 e, p split
    again for P V, each tile's P V added to the running output. q: (B, H,
    S, D) f32; k, v: (B, KV, S, D)."""
    b, h, s, d = q.shape
    plan = ops.launch_plan(b, h, k.shape[1], s, d, torch.float32, causal)
    bq, bk = plan["block_q"], plan["block_k"]
    group = h // k.shape[1]
    k = k.repeat_interleave(group, dim=1)
    v = v.repeat_interleave(group, dim=1)
    c = torch.tensor(1.4426950408889634 / math.sqrt(d), dtype=torch.float32)
    out = torch.empty_like(q)
    for qb, n_tiles in enumerate(plan["kv_tiles"]):
        rows = torch.arange(qb * bq, min(qb * bq + bq, s))
        qt = q[:, :, rows]
        m = torch.full((b, h, len(rows)), -1e30)
        l = torch.zeros(b, h, len(rows))
        acc = torch.zeros(b, h, len(rows), d)
        for t in range(n_tiles):
            keys = torch.arange(t * bk, min(t * bk + bk, s))
            sc = _tf32_mm(qt, k[:, :, keys], products)
            if causal:
                sc = sc.masked_fill(keys[None, :] > rows[:, None], -1e30)
            x = torch.maximum(m, sc.amax(-1))
            alpha = torch.exp2((m - x) * c)
            p = torch.exp2(sc * c - (x * c)[..., None])
            l = l * alpha + p.sum(-1)
            vt = v[:, :, keys]
            if products == 1:
                pv = tf32(p) @ tf32(vt)
            else:
                ph, pl = split_tf32(p)
                vh, vl = split_tf32(vt)
                pv = ph @ vh + (ph @ vl + pl @ vh)
            acc = acc * alpha[..., None] + pv
            m = x
        out[:, :, rows] = acc / l.clamp_min(1e-30)[..., None]
    return out


# (b, h, kv, s, d, causal): the f32 sweep (GQA groups 1, 2 and 4, causal
# and not) against the Pallas kernel; S not a multiple of the kernel's
# 64-row blocks and 32-key stages, and S = 1, against the plain version
SPLIT_CASES = [(2, 4, 4, 256, 64, True), (2, 4, 1, 128, 64, False),
               (1, 2, 2, 512, 32, True), (1, 8, 4, 256, 128, True),
               (1, 4, 2, 100, 64, True), (1, 8, 2, 77, 128, False),
               (2, 4, 1, 1, 32, True)]


@pytest.mark.parametrize("b,h,kv,s,d,causal", SPLIT_CASES)
def test_split_tf32_emulation_matches_jax_kernel(b, h, kv, s, d, causal,
                                                 rng):
    """Three TF32 products over the kernel's tiles give the function to
    f32 accuracy: within 1e-5 of the JAX Pallas kernel in interpret mode
    (64-row blocks, so S % 64 == 0), else of the port's plain version."""
    (jq, jk, jv), (tq, tk, tv) = _qkv(rng, b, h, kv, s, d)
    got = emulate_split_tf32(tq, tk, tv, causal)
    if s % 64 == 0:
        want = _f32(jax_flash(jq, jk, jv, causal=causal, block_q=64,
                              block_k=64))
    else:
        want = _f32(ref.attention_ref(tq, tk, tv, causal=causal))
    np.testing.assert_allclose(_f32(got), want, rtol=1e-5, atol=1e-5)


def test_one_tf32_product_does_not_hold_f32_accuracy(rng):
    """Why three products: with one (hi.hi, 11 significant bits) the
    same tiles miss the 1e-5 bound by far."""
    (jq, jk, jv), (tq, tk, tv) = _qkv(rng, 1, 8, 4, 256, 128)
    want = _f32(jax_flash(jq, jk, jv, causal=True, block_q=64, block_k=64))
    one = _f32(emulate_split_tf32(tq, tk, tv, True, products=1))
    err = np.abs(one - want) / (1e-5 + 1e-5 * np.abs(want))
    assert err.max() > 10


EDGES = [0.0, -0.0, 1.0, -1.5, 3.0e-39, -1.0e-40, 1.4e-45, 1.17549435e-38,
         1e30, -1e30, 6.5e4, 1e-30, 0.1, 1.0 / 3.0]


def test_split_tf32_reconstructs_within_2_to_the_minus_22(rng):
    """hi + lo = x to within 2^-22 |x|, both parts tf32, on random values
    over 60 binades and on edges: 0, subnormals, the smallest normal,
    +-1e30 and the -1e30 mask. Below 2^-115 the low part is subnormal
    and rounds to a multiple of 2^-136 (tf32 drops the low 13 bits of a
    subnormal too), so there the bound is 2^-137 absolute."""
    mags = 10.0 ** rng.uniform(-30, 30, 4096)
    x = torch.from_numpy(np.concatenate([
        rng.standard_normal(4096) * mags, EDGES]).astype(np.float32))
    hi, lo = split_tf32(x)
    for part in (hi, lo):
        assert not bool((part.view(torch.int32) & 0x1FFF).any())
    err = (x.double() - hi.double() - lo.double()).abs()
    bound = torch.maximum(x.double().abs() * 2.0 ** -22,
                          torch.tensor(2.0 ** -137, dtype=torch.float64))
    assert bool((err <= bound).all())
    assert bool((lo.abs() <= hi.abs() * 2.0 ** -11).all())
    normal = x.abs() >= 2.0 ** -115
    assert bool((err[normal] <= x.double().abs()[normal] * 2.0 ** -22).all())
    for v in (0.0, 1.0, -1.5, 1e30, -1e30):
        h_, l_ = split_tf32(torch.tensor([v]))
        assert float(h_.double() + l_.double()) == pytest.approx(
            v, rel=2.0 ** -22, abs=0.0)


@pytest.mark.parametrize("d", ops.HEAD_DIMS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_launch_plan_fits_and_hands_out_longest_blocks_first(d, dtype):
    """Each kernel's CTA fits the 232,448 bytes of shared memory a block
    may take, and its grid covers every (batch, head, query block) once:
    causal, the longest blocks first (their K/V tile counts never rise
    along the launch order); else in order. ``chip_smoke.py`` holds this
    order and these tile counts to the library's ``flash_attention_order``,
    which computes them with the kernels' own function."""
    for b, h, kv, s in [(1, 32, 8, 4096), (4, 32, 8, 128), (2, 4, 2, 200),
                        (1, 2, 1, 1)]:
        for causal in (True, False):
            plan = ops.launch_plan(b, h, kv, s, d, dtype, causal)
            assert plan["smem_bytes"] <= 232_448
            wgs = plan["warpgroups"]
            assert plan["threads"] == 128 * (wgs["load"] + wgs["math"])
            nq = -(-s // plan["block_q"])
            assert plan["grid"] == len(plan["order"]) == nq * b * h
            assert sorted(plan["order"]) == [
                (bi, hi, qi) for bi in range(b) for hi in range(h)
                for qi in range(nq)]
            n_kv, bq, bk = (-(-s // plan["block_k"]), plan["block_q"],
                            plan["block_k"])
            for qi, n in enumerate(plan["kv_tiles"]):
                # every key the block's last row attends, and no tile
                # wholly past it
                end = min(s, (qi + 1) * bq) if causal else s
                assert n * bk >= end > (n - 1) * bk
            tiles = [plan["kv_tiles"][qi] for _, _, qi in plan["order"]]
            if causal:
                assert plan["order"][0][2] == nq - 1
                assert tiles == sorted(tiles, reverse=True)
                assert tiles[0] == n_kv and 1 <= tiles[-1] <= n_kv
            else:
                assert [qi for _, _, qi in plan["order"]] == sorted(
                    qi for _, _, qi in plan["order"])
                assert set(tiles) == {n_kv}
    if dtype == torch.float32:       # Q hi/lo + 2 stages of 4 tiles
        assert ops.smem_bytes(d, dtype) == 1536 * d + 32 + 1024


# --------------------------------------------------------------------------
# the gradient: bwd.attention_bwd (the card's backward, torch ops) and
# the autograd Function around the kernel
# --------------------------------------------------------------------------

# (b, h, kv, s, d, causal, block_q): causal and full, GQA groups 1 to 4,
# D 64 and 128, S not a multiple of the query block (100 = 2 x 48 + 4,
# 77 = 2 x 32 + 13) and S below one block
BWD_CASES = [(2, 4, 2, 100, 64, True, 48), (1, 4, 1, 77, 128, False, 32),
             (2, 2, 2, 64, 64, False, 48), (1, 8, 2, 77, 128, True, 32),
             (1, 3, 1, 40, 64, True, 1024)]
# f32 gradients within BWD_TOL of the largest |g| of each input (both
# sides f32 with summation order only apart)
BWD_TOL = 1e-5


def _bwd_inputs(rng, b, h, kv, s, d):
    (jq, jk, jv), (tq, tk, tv) = _qkv(rng, b, h, kv, s, d)
    do = rng.standard_normal((b, h, s, d), dtype=np.float32)
    return (jq, jk, jv), (tq, tk, tv), do


def _close_grads(got, want):
    for g, w in zip(got, want):
        g, w = _f32(g), _f32(w)
        assert g.shape == w.shape
        assert np.abs(g - w).max() <= BWD_TOL * np.abs(w).max()


@pytest.mark.parametrize("b,h,kv,s,d,causal,block_q", BWD_CASES)
def test_torch_op_backward_matches_autograd_and_jax_vjp(
        b, h, kv, s, d, causal, block_q, rng):
    """``bwd.attention_bwd`` in blocks of ``block_q`` query rows against
    autograd through the plain version and against ``jax.vjp`` of the
    JAX package's oracle, on the same numpy inputs."""
    import jax

    from repro.kernels.flash_attention.ref import \
        attention_ref as jax_oracle
    from repro_torch.kernels.flash_attention import bwd

    (jq, jk, jv), (tq, tk, tv), do = _bwd_inputs(rng, b, h, kv, s, d)
    out = ref.attention_ref(tq, tk, tv, causal=causal)
    got = bwd.attention_bwd(tq, tk, tv, out, torch.from_numpy(do),
                            causal=causal, block_q=block_q)
    assert [g.dtype for g in got] == [torch.float32] * 3
    leaves = [t.clone().requires_grad_(True) for t in (tq, tk, tv)]
    ref.attention_ref(*leaves, causal=causal).backward(torch.from_numpy(do))
    _close_grads(got, [t.grad for t in leaves])
    _, vjp = jax.vjp(lambda q, k, v: jax_oracle(q, k, v, causal=causal),
                     jq, jk, jv)
    _close_grads(got, vjp(jnp.asarray(do)))


def test_torch_op_backward_returns_the_input_dtypes(rng):
    """bf16 inputs: the gradients in bf16, near the f32 gradients of the
    same values (bf16 rounding of q, k, v, o and the results only)."""
    from repro_torch.kernels.flash_attention import bwd

    _, (tq, tk, tv), do = _bwd_inputs(rng, 1, 4, 2, 96, 64)
    bf = [t.bfloat16() for t in (tq, tk, tv)]
    f32 = [t.float() for t in bf]
    dob = torch.from_numpy(do).bfloat16()
    got = bwd.attention_bwd(*bf, ref.attention_ref(*bf), dob, block_q=32)
    want = bwd.attention_bwd(*f32, ref.attention_ref(*f32), dob.float())
    assert [g.dtype for g in got] == [torch.bfloat16] * 3
    for g, w in zip(got, want):
        assert float((g.float() - w).abs().max()) <= 2e-2 * float(
            w.abs().max())


def _launch_plainly(monkeypatch):
    """The card route with ``_launch`` replaced by the plain version in
    its layout (and counted, as the launch is): the Function's plumbing
    on the CPU."""
    calls = []

    def launch(q, k, v, causal, heads):
        calls.append(heads)
        ops.LAUNCHES += 1
        if heads == 1:
            return ref.attention_ref(q, k, v, causal=causal)
        return ref.attention_ref(*(t.transpose(1, 2) for t in (q, k, v)),
                                 causal=causal).transpose(1, 2)

    monkeypatch.setattr(ops, "route", lambda name, *ts: "cuda")
    monkeypatch.setattr(ops, "_launch", launch)
    return calls


@pytest.mark.parametrize("layout", ["bhsd", "bshd"])
@pytest.mark.parametrize("causal", [True, False])
def test_function_on_the_card_route(layout, causal, monkeypatch, rng):
    """With an input that requires grad, the card route runs the
    Function: one launch per forward and none in the backward, the
    output and gradients those of autograd through the plain version;
    without (``torch.no_grad``, or no input requiring grad), the
    Function's forward alone: one launch and no graph."""
    calls = _launch_plainly(monkeypatch)
    heads = 1 if layout == "bhsd" else 2
    call = ops.flash_attention if heads == 1 else ops.flash_attention_bshd
    _, (tq, tk, tv), do = _bwd_inputs(rng, 2, 4, 2, 70, 64)
    if heads == 2:
        tq, tk, tv = (t.transpose(1, 2).contiguous() for t in (tq, tk, tv))
        do = np.ascontiguousarray(do.transpose(0, 2, 1, 3))
    leaves = [t.clone().requires_grad_(True) for t in (tq, tk, tv)]
    launches = ops.LAUNCHES
    out = call(*leaves, causal=causal)
    assert type(out.grad_fn).__name__ == "FlashAttentionBackward"
    assert ops.LAUNCHES == launches + 1 and calls == [heads]
    out.backward(torch.from_numpy(do))
    assert ops.LAUNCHES == launches + 1           # no launch backward
    plain = [t.clone().requires_grad_(True) for t in (tq, tk, tv)]
    monkeypatch.setattr(ops, "route", lambda name, *ts: "cpu")
    want = call(*plain, causal=causal)
    want.backward(torch.from_numpy(do))
    np.testing.assert_allclose(_f32(out.detach()), _f32(want.detach()),
                               rtol=1e-6, atol=1e-6)
    _close_grads([t.grad for t in leaves], [t.grad for t in plain])
    monkeypatch.setattr(ops, "route", lambda name, *ts: "cuda")
    with torch.no_grad():
        assert call(*leaves, causal=causal).grad_fn is None
    assert call(tq, tk, tv, causal=causal).grad_fn is None
    assert ops.LAUNCHES == launches + 3 and calls == [heads] * 3
