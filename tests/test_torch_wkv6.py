"""The port's WKV6 (plain PyTorch version on the CPU) against the JAX
package's Pallas kernel in interpret mode and its sequential oracle
(``blocks._wkv6_scan``): the same numpy inputs through both, on the
cases of tests/test_kernels.py::TestWKV6, held to rel < 1e-4. The
backward (``ref.wkv6_bwd_ref``, and ``wkv6_bwd``'s schedule emulated in
plain torch) against ``jax.vjp`` of the JAX oracle, and the ``WKV6``
Function's plumbing on the card route with a stand-in library."""
import ctypes

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.kernels.rwkv6.kernel import wkv6 as jax_wkv6  # noqa: E402
from repro.kernels.rwkv6.ref import wkv6_ref as jax_ref  # noqa: E402
from repro.kernels.rwkv6.ops import wkv6_bshn as jax_wkv6_bshn  # noqa: E402
from repro.models.blocks import _wkv6_scan as jax_scan  # noqa: E402
from repro_torch.kernels.rwkv6 import ops, ref  # noqa: E402
from repro_torch.models import blocks  # noqa: E402

SWEEP = [(2, 2, 64, 16, 16), (1, 4, 128, 32, 32), (2, 1, 96, 64, 32),
         (1, 1, 32, 8, 8)]


def _inputs(rng, shape, heads_axis, w_scale=0.5, bf16=False):
    """r, k, v, w in ``shape`` and u (H, n), as numpy f32; r, k, v rounded
    to bf16 first when asked (the kernel's bf16 input)."""
    r, k, v = (rng.standard_normal(shape, dtype=np.float32)
               for _ in range(3))
    if bf16:
        r, k, v = (torch.from_numpy(a).bfloat16().float().numpy()
                   for a in (r, k, v))
    w = np.exp(-np.exp(rng.standard_normal(shape, dtype=np.float32)
                       * w_scale - 2.0)).astype(np.float32)
    u = (rng.standard_normal((shape[heads_axis], shape[3]),
                             dtype=np.float32) * 0.5)
    return r, k, v, w, u


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    return float(np.abs(got - want).max() / (np.abs(want).max() + 1e-9))


@pytest.mark.parametrize("b,h,s,n,chunk", SWEEP)
def test_wkv6_matches_jax_kernel(b, h, s, n, chunk, rng):
    args = _inputs(rng, (b, h, s, n), 1)
    want = jax_wkv6(*map(jnp.asarray, args), chunk=chunk)
    launches = ops.LAUNCHES
    got = ops.wkv6(*map(torch.from_numpy, args))
    assert got.dtype == torch.float32 and got.shape == (b, h, s, n)
    assert _rel(got, want) < 1e-4
    assert _rel(ref.wkv6_ref(*map(torch.from_numpy, args)), want) < 1e-4
    assert ops.LAUNCHES == launches      # the plain version is no launch


def test_bf16_inputs_match_f32_of_the_same_values(rng):
    """r, k, v in bf16 (the model's prefill): the same function as f32
    inputs holding the same values."""
    args = _inputs(rng, (1, 2, 64, 16), 1, bf16=True)
    t = [torch.from_numpy(a) for a in args]
    got = ops.wkv6(*(a.bfloat16() for a in t[:3]), *t[3:])
    assert _rel(got, ops.wkv6(*t)) < 1e-6
    assert _rel(got, jax_wkv6(*map(jnp.asarray, args), chunk=16)) < 1e-4


def test_bshn_wrapper_matches_blocks_oracle(rng):
    args = _inputs(rng, (2, 64, 2, 16), 2, w_scale=1.0)
    ja = list(map(jnp.asarray, args))
    got = ops.wkv6_bshn(*map(torch.from_numpy, args))
    assert _rel(got, jax_scan(*ja)) < 1e-4
    assert _rel(got, jax_wkv6_bshn(*ja, chunk=16, interpret=True)) < 1e-4
    assert _rel(blocks._wkv6_scan(*map(torch.from_numpy, args)),
                jax_scan(*ja)) < 1e-4


def test_wrapper_rejects_what_the_kernel_does_not_take():
    z = torch.zeros
    with pytest.raises(ValueError):              # head size 12
        ops.wkv6(*(z(1, 2, 4, 12) for _ in range(4)), z(2, 12))
    with pytest.raises(ValueError):              # u of the wrong shape
        ops.wkv6(*(z(1, 2, 4, 8) for _ in range(4)), z(3, 8))
    with pytest.raises(ValueError):              # w in bf16
        ops.wkv6(*(z(1, 2, 4, 8) for _ in range(3)),
                 z(1, 2, 4, 8).bfloat16(), z(2, 8))


# --- the kernel's schedule: column groups, row groups, staged chunks

def _fma(a, b, c):
    """fmaf in float32: the product is exact in float64, and the sum is
    rounded once to float64 and once to float32 (a double rounding that
    can differ from a fused one in the last bit, far inside 1e-4)."""
    return (a.double() * b.double() + c.double()).float()


def emulate_kernel(r, k, v, w, u):
    """The arithmetic of ``csrc/wkv6.cu`` in plain torch, in its schedule
    (``ops.launch_plan``): each of the G column groups carries its own
    columns of the state; each row group's thread holds its rows in
    order, sums r (S + u k v) into four partials (row q into partial
    q % 4) and adds them as (p0 + p1) + (p2 + p3); the row groups'
    sums are added in the order of a xor butterfly (xor 4, 2, 1); the
    tokens come a staged chunk at a time, the last chunk ragged."""
    b, h, s, n = r.shape
    plan = ops.launch_plan(b, h, s, n, r.dtype)
    groups, cols, nrg = plan["grid"][0], plan["cols"], plan["row_groups"]
    rows = torch.tensor([list(g) for g in plan["rows"]])      # (R, P)
    r, k, v, w, u = (a.float() for a in (r, k, v, w, u))
    uu = u[:, rows][None, :, :, :, None]                       # 1,H,R,P,1
    lanes = torch.arange(nrg)
    out = torch.full((b, h, s, n), float("nan"))
    for g in range(groups):
        cs = slice(g * cols, (g + 1) * cols)
        st = torch.zeros(b, h, nrg, rows.shape[1], cols)       # B,H,R,P,C
        for t0, t1 in plan["chunks"]:
            rc, kc, wc = (a[:, :, t0:t1][..., rows] for a in (r, k, w))
            vc = v[:, :, t0:t1, cs]
            for tt in range(t1 - t0):
                vj = vc[:, :, tt, None, :]                     # B,H,1,C
                acc = torch.zeros(b, h, nrg, 4, cols)
                for q in range(rows.shape[1]):
                    kv = kc[:, :, tt, :, q, None] * vj         # B,H,R,C
                    acc[:, :, :, q % 4] = _fma(
                        rc[:, :, tt, :, q, None],
                        _fma(uu[:, :, :, q], kv, st[:, :, :, q]),
                        acc[:, :, :, q % 4])
                    st[:, :, :, q] = _fma(st[:, :, :, q],
                                          wc[:, :, tt, :, q, None], kv)
                y = (acc[:, :, :, 0] + acc[:, :, :, 1]) + (
                    acc[:, :, :, 2] + acc[:, :, :, 3])
                off = nrg // 2
                while off:
                    y = y + y[:, :, lanes ^ off]
                    off //= 2
                out[:, :, t0 + tt, cs] = y[:, :, 0]
    return out


# (b, h, s, n, chunk of the JAX kernel, bf16 r, k, v): a ragged last chunk
# (40 = 32 + 8, 70 = 2 x 32 + 6), S shorter than a chunk (12, 1), exactly
# one chunk, every head size
SCHEDULE_CASES = [(1, 2, 40, 16, 8, False), (2, 1, 12, 8, 4, False),
                  (1, 1, 70, 64, 10, False), (1, 2, 32, 32, 32, True),
                  (2, 2, 1, 16, 1, False), (1, 1, 70, 64, 14, True)]


@pytest.mark.parametrize("b,h,s,n,chunk,bf16", SCHEDULE_CASES)
def test_schedule_emulation_matches_jax_kernel(b, h, s, n, chunk, bf16,
                                               rng):
    args = _inputs(rng, (b, h, s, n), 1, bf16=bf16)
    t = [torch.from_numpy(a) for a in args]
    if bf16:                                   # exact: values are bf16
        t[:3] = [a.bfloat16() for a in t[:3]]
    plan = ops.launch_plan(b, h, s, n, t[0].dtype)
    spans = plan["chunks"]
    assert spans[0][0] == 0 and spans[-1][1] == s
    assert all(x[1] == y[0] for x, y in zip(spans, spans[1:]))
    assert all(t1 - t0 == ops.CHUNK for t0, t1 in spans[:-1])
    got = emulate_kernel(*t)
    assert not torch.isnan(got).any()          # every output written
    want = jax_wkv6(*map(jnp.asarray, args), chunk=chunk)
    assert _rel(got, want) < 1e-4
    assert _rel(got, ref.wkv6_ref(*t)) < 1e-4


class _FakeLibrary:
    """Stands in for the CUDA library: records what the wrapper would
    hand the kernel and launches nothing."""

    def __init__(self):
        self.calls = []

    def wkv6_fwd(self, *args):
        self.calls.append([a.value if hasattr(a, "value") else a
                           for a in args])
        return 0


def _misaligned(shape, dtype):
    """A contiguous view 2 or 4 bytes past a 16-byte boundary."""
    n = int(np.prod(shape))
    t = torch.zeros(n + 8, dtype=dtype)[1:n + 1].view(shape)
    assert t.is_contiguous() and t.data_ptr() % 16
    return t


@pytest.mark.parametrize("layout,dtype,misaligned", [
    ("bhsn", torch.bfloat16, False), ("bshn", torch.bfloat16, False),
    ("bhsn", torch.float32, False), ("bshn", torch.float32, True),
    ("bhsn", torch.bfloat16, True)])
def test_launch_arguments(layout, dtype, misaligned, monkeypatch):
    """What the wrapper passes the kernel library on the card route: the
    dtype code, B/H/S/n, the (batch, head, seq) strides of the inputs and
    of the f32 output in elements, 16-byte aligned pointers (a view that
    is not is copied), one launch per call; and the launch the kernel
    makes of it: grid (n / 8 column groups, H, B), 32 threads (4 pairs
    of columns x 8 row groups), two chunk buffers of dynamic shared
    memory (over 48 KB at n = 64)."""
    import types

    from repro_torch.kernels import build
    lib = _FakeLibrary()
    stream = 0x5EED0
    monkeypatch.setattr(build, "load", lambda: lib)
    monkeypatch.setattr(ops, "route", lambda name, *ts: "cuda")
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda: types.SimpleNamespace(cuda_stream=stream))
    b, h, s, n = 2, 40, 77, 64
    heads = 1 if layout == "bhsn" else 2
    shape = (b, h, s, n) if heads == 1 else (b, s, h, n)
    def make(sh, dt):
        return _misaligned(sh, dt) if misaligned else torch.zeros(
            sh, dtype=dt)

    r, k, v = (make(shape, dtype) for _ in range(3))
    w = make(shape, torch.float32)
    u = torch.zeros(h, n)
    call = ops.wkv6 if heads == 1 else ops.wkv6_bshn
    launches = ops.LAUNCHES
    out = call(r, k, v, w, u)
    assert ops.LAUNCHES == launches + 1 and len(lib.calls) == 1
    assert out.shape == shape and out.dtype == torch.float32
    args = lib.calls[0]
    ptrs, ints, strides = args[:6], args[6:11], args[11:17]
    assert ints == [ops.DTYPES[dtype], b, h, s, n] and args[17] == stream
    assert all(p % 16 == 0 for p in ptrs)
    assert (ptrs[:4] == [a.data_ptr() for a in (r, k, v, w)]) \
        != misaligned                        # as they lie, or copied
    assert ptrs[4] == u.data_ptr() and ptrs[5] == out.data_ptr()
    seq = 3 - heads
    c = torch.empty(shape)
    want = [c.stride(0), c.stride(heads), c.stride(seq)]
    assert strides == want + want            # inputs, then the output
    plan = ops.launch_plan(b, h, s, n, dtype)
    es = r.element_size()
    assert plan["grid"] == (8, h, b) and plan["threads"] == 32
    assert plan["smem_bytes"] == 2 * 32 * (n * (2 * es + 4) + 8 * es
                                           + 64 * 4)
    assert plan["smem_bytes"] > 48 * 1024
    assert all(st * es % 16 == 0 for st in want)
    assert [len(x) for x in plan["rows"]] == [n // 8] * 8
    assert plan["chunks"][-1] == (64, 77)


class _FakeBwdLibrary(_FakeLibrary):
    """Also stands in for ``wkv6_bwd``: records its arguments and writes
    each gradient's index + 1 into it (through the pointer), so that a
    test sees which buffer came back as which gradient."""

    def wkv6_bwd(self, *args):
        vals = [a.value if hasattr(a, "value") else a for a in args]
        self.calls.append(vals)
        ptrs, (dt, b, h, s, n) = vals[:12], vals[12:17]
        es = 4 if dt == 0 else 2
        sizes = [b * h * s * n * es] * 3 + [b * h * s * n * 4, h * n * 4]
        for i, (ptr, nbytes) in enumerate(zip(ptrs[6:11], sizes)):
            ctypes.memset(ptr, i + 1, nbytes)
        return 0


@pytest.mark.parametrize("layout", ["bhsn", "bshn"])
def test_card_route_refuses_grad(layout, monkeypatch):
    """On the card route a gradient comes from the ``wkv6_bwd`` kernel or
    not at all: a backward launch that fails raises and leaves every
    input without a gradient, and a kernel library that does not build
    raises at the forward; neither falls back to autograd through the
    plain version."""
    import types

    from repro_torch.kernels import build

    class FailingBwd(_FakeBwdLibrary):
        def wkv6_bwd(self, *args):
            super().wkv6_bwd(*args)
            return 700                 # cudaErrorIllegalAddress

    monkeypatch.setattr(build, "load", lambda: FailingBwd())
    monkeypatch.setattr(ops, "route", lambda name, *ts: "cuda")
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda: types.SimpleNamespace(cuda_stream=0))
    call = ops.wkv6 if layout == "bhsn" else ops.wkv6_bshn
    shape = (2, 3, 40, 16) if layout == "bhsn" else (2, 40, 3, 16)
    h = 3
    r, k, v = (torch.randn(shape).requires_grad_(True) for _ in range(3))
    w = torch.rand(shape, requires_grad=True)
    u = torch.randn(h, 16, requires_grad=True)
    bwd = ops.BWD_LAUNCHES
    out = call(r, k, v, w, u)
    with pytest.raises(RuntimeError, match="wkv6_bwd launch failed"):
        out.sum().backward()
    assert ops.BWD_LAUNCHES == bwd + 1
    assert all(t.grad is None for t in (r, k, v, w, u))

    def no_library():
        raise RuntimeError("nvcc failed")
    monkeypatch.setattr(build, "load", no_library)
    fwd = ops.LAUNCHES
    with pytest.raises(RuntimeError, match="nvcc failed"):
        call(r, k, v, w, u)
    assert ops.LAUNCHES == fwd
    assert all(t.grad is None for t in (r, k, v, w, u))


@pytest.mark.parametrize("layout", ["bhsn", "bshn"])
def test_card_route_takes_grad_through_the_function(layout, monkeypatch):
    """On the card route every call goes through the ``WKV6`` Function:
    one forward launch, and a
    backward that launches ``wkv6_bwd`` once, before nothing else, with
    the inputs and the output gradient made contiguous and 16-byte
    aligned, one set of strides, the dtype code, B/H/S/n, the stream and
    a workspace of ``bwd_launch_plan``'s bytes; its buffers come back as
    dr, dk, dv (the inputs' dtype), dw and du (f32) in the inputs' shapes.
    Under ``torch.no_grad`` the call is the launch alone. On the CPU,
    autograd runs through the plain version and launches nothing."""
    import types

    from repro_torch.kernels import build
    lib = _FakeBwdLibrary()
    stream = 0x5EED0
    monkeypatch.setattr(build, "load", lambda: lib)
    monkeypatch.setattr(ops, "route", lambda name, *ts: "cuda")
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda: types.SimpleNamespace(cuda_stream=stream))
    call = ops.wkv6 if layout == "bhsn" else ops.wkv6_bshn
    heads = 1 if layout == "bhsn" else 2
    b, h, s, n = 2, 3, 40, 16
    shape = (b, h, s, n) if heads == 1 else (b, s, h, n)
    r, k, v = (torch.randn(shape).bfloat16().requires_grad_(True)
               for _ in range(3))
    w = torch.rand(shape, requires_grad=True)
    u = torch.randn(h, n, requires_grad=True)
    fwd, bwd = ops.LAUNCHES, ops.BWD_LAUNCHES
    out = call(r, k, v, w, u)
    assert type(out.grad_fn).__name__ == "WKV6Backward"
    assert ops.LAUNCHES == fwd + 1 and ops.BWD_LAUNCHES == bwd
    do = torch.randn(shape).transpose(0, 1).contiguous().transpose(0, 1)
    assert not do.is_contiguous()
    out.backward(do)
    assert ops.LAUNCHES == fwd + 1 and ops.BWD_LAUNCHES == bwd + 1
    args = lib.calls[-1]
    ptrs, ints, strides = args[:12], args[12:17], args[17:20]
    assert ints == [ops.DTYPES[torch.bfloat16], b, h, s, n]
    assert args[20] == stream and all(p % 16 == 0 for p in ptrs)
    c = torch.empty(shape)
    assert strides == [c.stride(0), c.stride(heads), c.stride(3 - heads)]
    assert ptrs[:5] == [a.data_ptr() for a in (r, k, v, w, u)]
    plan = ops.bwd_launch_plan(b, h, s, n, torch.bfloat16)
    assert plan["workspace_bytes"] == 4 * b * h * 2 * (  # 2 chunks of 32
        2 * n * n + 2 * n + 32)
    for i, (t, dt) in enumerate(zip((r, k, v, w, u), [torch.bfloat16] * 3
                                    + [torch.float32] * 2)):
        assert t.grad.dtype == dt and t.grad.shape == t.shape
        want = torch.full(t.shape, 1, dtype=torch.uint8).fill_(i + 1)
        assert torch.equal(t.grad.contiguous().view(torch.uint8),
                           want.repeat_interleave(t.element_size(), -1)
                           .view(t.shape[:-1] + (-1,)))
    for t in (r, k, v, w, u):
        t.grad = None
    with torch.no_grad():
        call(r, k, v, w, u)
    assert ops.LAUNCHES == fwd + 2 and ops.BWD_LAUNCHES == bwd + 1
    monkeypatch.setattr(ops, "route", lambda name, *ts: "cpu")
    call(r, k, v, w, u).sum().backward()
    assert r.grad is not None and r.grad.abs().sum() > 0
    assert ops.LAUNCHES == fwd + 2 and ops.BWD_LAUNCHES == bwd + 1


def test_bwd_launch_plan():
    """The backward's launches: the state split by rows, 16 a CTA (n
    below 16: all n), each row group's CTA at all n columns, a thread a
    2 x 4 tile, the n / rows row groups of a chunk a cluster; the local
    and chunk kernels on a grid (row groups x chunks, H, B) of at least a
    warp; the local kernel's shared memory: the stage (r, k, w at the
    CTA's rows, v, do at all columns, 32 tokens), a_t, and k and r times
    their decay products; the chunk kernel's: the stage, a_t, u at the
    CTA's rows, and 8 tokens' partials (dr, dk, dw as float2, dv as
    float4, a plane of one entry a thread, padded after every 16); the
    carry, a thread per 4 columns of a row, S and G; one du CTA a head.
    At rwkv6-3b's launch (1, 40, 4096, 64): 20480 CTAs of 128 threads in
    clusters of 4, 3 CTAs an SM by shared memory (3 warps a scheduler),
    and a workspace of the chunks' start states and end Gs (84 MB each),
    0.17 GB in all (1.09 GB before the state was split by rows and the
    chunks carried)."""
    for dt, es in ((torch.float32, 4), (torch.bfloat16, 2)):
        for n in ops.HEAD_SIZES:
            p = ops.bwd_launch_plan(3, 5, 77, n, dt)
            rows = min(16, n)
            tile = rows // 2 * (n // 4)
            assert p["rows"] == rows and p["cluster"] == n // rows
            assert p["grid"] == (n // rows * 3, 5, 3)
            assert p["tile_threads"] == tile
            assert p["threads"] == max(32, tile) and p["threads"] % 32 == 0
            stage = 32 * (rows * (2 * es + 4) + n * (es + 4)) + 32 * 4
            assert p["local_smem_bytes"] == stage + 2 * 32 * rows * 4
            assert p["smem_bytes"] == stage + rows * 4 + 8 * (
                tile + tile // 16) * (3 * 8 + 16)
            assert p["smem_bytes"] <= 227 * 1024
            assert p["carry_grid"] == (-(-(15 * n * n // 4) // 128), 2)
            assert p["carry_threads"] == 128 and p["du_grid"] == (5,)
            assert p["workspace_bytes"] == 4 * 45 * (2 * n * n + 2 * n
                                                     + 32)
    p = ops.bwd_launch_plan(1, 40, 4096, 64, torch.bfloat16)
    assert p["grid"] == (4 * 128, 40, 1) and p["cluster"] == 4
    assert p["threads"] == 128 and p["smem_bytes"] == 60096
    assert p["ctas_per_sm_by_smem"] == 3
    assert p["warps_per_scheduler_by_smem"] == 3
    assert p["workspace_floats"]["starts"] == 40 * 128 * 64 * 64
    assert p["workspace_bytes"] == 171048960 <= 0.55e9


def _vjp_case(rng, shape, bf16=False, decay="mixed"):
    """Inputs, an output gradient, and jax.vjp of the JAX package's
    oracle (``repro.kernels.rwkv6.ref.wkv6_ref``) at them. ``decay``:
    "mixed" (w = exp(-exp(x)), the model's spread), "near_one" (w = 1 -
    1e-3: long memory, where the carry over chunks dominates) or
    "near_zero" (w ~ 0.01: a chunk's decay product underflows to 0)."""
    args = _inputs(rng, shape, 1, bf16=bf16)
    if decay == "near_one":
        args = (*args[:3], np.full(shape, 1 - 1e-3, np.float32), args[4])
    elif decay == "near_zero":
        args = (*args[:3], rng.uniform(0.005, 0.02, shape).astype(
            np.float32), args[4])
    do = rng.standard_normal(shape, dtype=np.float32)
    _, vjp = jax.vjp(jax_ref, *map(jnp.asarray, args))
    return args, do, [np.asarray(g) for g in vjp(jnp.asarray(do))]


def _close_grads(got, want, tol):
    for name, a, w in zip(("dr", "dk", "dv", "dw", "du"), got, want):
        a = np.asarray(a.float() if isinstance(a, torch.Tensor) else a,
                       np.float32)
        assert a.shape == w.shape, name
        assert float(np.abs(a - w).max()) <= tol * float(np.abs(w).max()), \
            name


@pytest.mark.parametrize("shape", [(2, 3, 40, 16), (1, 2, 64, 64)])
def test_wkv6_bwd_ref_matches_jax_vjp(shape, rng):
    """The reverse recurrence (``ref.wkv6_bwd_ref``, not autograd)
    against ``jax.vjp`` of the JAX oracle, within 1e-5 x max|g| of each
    gradient; in bf16 it returns dr, dk, dv in bf16, dw and du in f32."""
    args, do, want = _vjp_case(rng, shape)
    got = ref.wkv6_bwd_ref(*map(torch.from_numpy, args),
                           torch.from_numpy(do))
    assert all(g.dtype == torch.float32 for g in got)
    _close_grads(got, want, 1e-5)
    t = [torch.from_numpy(a) for a in args]
    got = ref.wkv6_bwd_ref(*(a.bfloat16() for a in t[:3]), *t[3:],
                           torch.from_numpy(do))
    assert [g.dtype for g in got] == [torch.bfloat16] * 3 + \
        [torch.float32] * 2


def emulate_bwd_kernel(r, k, v, w, u, do):
    """``wkv6_bwd``'s schedule in plain torch (BHSN, f32), kernel by
    kernel as ``ops.bwd_launch_plan`` gives them:

    1. each 32-token chunk's decay product and its walks from zero as
       sums of products: S_c^0 = sum_t (k_t o decay after t) v_t^T and
       G_c^0 = sum_t (r_t o decay before t) do_t^T; a_t (a thread's sum
       over the columns) and du's chunk partials per row;
    2. the carry, serial in the chunk: run <- D_c o run + x turns them
       into the chunks' start states (forward) and end Gs (backward);
    3. per chunk, the states before each 8-token sub-chunk walked from
       the start state; then per sub-chunk, last first, its states
       recomputed and the reverse walk from the G reached. A thread's
       2 x 4 tile gives partials of dr, dk, dw over its 4 columns and of
       dv over its 2 rows (after its own rows' r u k do term); the CTA
       adds dr, dk, dw over its column quads and dv over its row pairs,
       the cluster's row groups add dv in rank order, and dr, dk take the
       u a_t terms;
    4. du over (b, chunk).

    The sums inside a thread, and a_t's and du's, are torch's here: the
    emulation holds the decomposition, not the last bit of each order."""
    b, h, s, n = r.shape
    plan = ops.bwd_launch_plan(b, h, s, n, torch.float32)
    qr, qc = ops.TILE_ROWS, ops.TILE_COLS
    groups, sub = plan["cluster"], ops.SUB
    chunks = [(t, min(t + ops.CHUNK, s)) for t in range(0, s, ops.CHUNK)]
    r, k, v, w, u, do = (a.float() for a in (r, k, v, w, u, do))

    def step(st, t):
        return st * w[:, :, t, :, None] + \
            k[:, :, t, :, None] * v[:, :, t, None, :]

    def back(g, t):
        return w[:, :, t, :, None] * g + \
            r[:, :, t, :, None] * do[:, :, t, None, :]

    def tiles(x):        # (B, H, row pair, row, column quad, column)
        return x.reshape(b, h, n // qr, qr, n // qc, qc)

    zero = torch.zeros(b, h, n, n)
    local = []                                             # 1.
    for t0, t1 in chunks:
        after, kt = torch.ones(b, h, n), {}
        for t in range(t1 - 1, t0 - 1, -1):
            kt[t] = k[:, :, t] * after
            after = after * w[:, :, t]
        before, st, g = torch.ones(b, h, n), zero, zero
        for t in range(t0, t1):
            st = st + kt[t][..., None] * v[:, :, t, None, :]
            g = g + (r[:, :, t] * before)[..., None] * do[:, :, t, None, :]
            before = before * w[:, :, t]
        local.append((after[..., None], st, g))
    starts, ends, run = [], [None] * len(chunks), zero      # 2.
    for dec, st, _ in local:
        starts.append(run)
        run = dec * run + st
    run = zero
    for c in range(len(chunks) - 1, -1, -1):
        ends[c] = run
        run = local[c][0] * run + local[c][2]
    a = (v * do).sum(-1)                                   # 3.
    dr, dk, dv, dw = (torch.full((b, h, s, n), float("nan"))
                      for _ in range(4))
    du = torch.zeros(h, n)
    for (t0, t1), st0, g in zip(chunks, starts, ends):
        cps = [st0]
        for lo in range(t0 + sub, t1, sub):
            st = cps[-1]
            for t in range(lo - sub, lo):
                st = step(st, t)
            cps.append(st)
        for j in range(len(cps) - 1, -1, -1):
            lo, st, prev = t0 + j * sub, cps[j], []
            hi = min(lo + sub, t1)
            for t in range(lo, hi):
                prev.append(st)
                st = step(st, t)
            for t in range(hi - 1, lo - 1, -1):
                sp, gq = tiles(prev[t - lo]), tiles(g)
                dd = do[:, :, t].reshape(b, h, 1, 1, n // qc, qc)
                vv = v[:, :, t].reshape(b, h, 1, 1, n // qc, qc)
                kk = k[:, :, t].reshape(b, h, n // qr, qr, 1, 1)
                ruk = (r[:, :, t] * u * k[:, :, t]).reshape(
                    b, h, n // qr, qr).sum(-1)[..., None, None]
                # a thread's partials, then the CTA's sums over its quads
                pr, pk, pw = ((x * y).sum(-1).sum(-1).reshape(b, h, n)
                              for x, y in ((sp, dd), (gq, vv), (gq, sp)))
                pv = ruk * dd[:, :, :, 0] + (kk * gq).sum(3)   # B,H,RP,CQ,4
                pv = pv.reshape(b, h, groups, -1, n // qc, qc).sum(3)
                dv[:, :, t] = pv.sum(2).reshape(b, h, n)       # rank order
                dr[:, :, t] = pr + u * k[:, :, t] * a[:, :, t, None]
                dk[:, :, t] = pk + r[:, :, t] * u * a[:, :, t, None]
                dw[:, :, t] = pw
                g = back(g, t)
        du += (r[:, :, t0:t1] * k[:, :, t0:t1]
               * a[:, :, t0:t1, None]).sum(2).sum(0)           # 4.
    return dr, dk, dv, dw, du


# (b, h, s, n), decay: ragged last chunks (40, 77, 70), S = chunk + 1
# (33), S = 1, every head size (n = 32 and 64: clusters of 2 and 4 row
# groups), w near 1 over 7 chunks and near 0
BWD_CASES = [((2, 3, 40, 16), "mixed"), ((1, 2, 77, 8), "mixed"),
             ((1, 1, 33, 64), "mixed"), ((1, 2, 200, 16), "near_one"),
             ((1, 1, 70, 64), "near_one"), ((2, 2, 77, 32), "near_zero"),
             ((1, 1, 45, 64), "near_zero"), ((2, 2, 1, 16), "mixed"),
             ((1, 2, 33, 32), "near_one")]


@pytest.mark.parametrize("shape,decay", BWD_CASES,
                         ids=[f"shape{i}" for i in range(len(BWD_CASES))])
def test_bwd_schedule_emulation_matches_jax_vjp(shape, decay, rng):
    """The kernel's schedule (chunk-local walks from zero, the carry,
    the sub-chunks' reverse walks, the CTA's and the cluster's sums in
    their order) gives jax.vjp's gradients within 1e-5 x max|g|, also
    where the carry dominates (w near 1) and where the chunks' decay
    products underflow (w near 0)."""
    args, do, want = _vjp_case(rng, shape, decay=decay)
    got = emulate_bwd_kernel(*map(torch.from_numpy, args),
                             torch.from_numpy(do))
    assert not any(torch.isnan(x).any() for x in got)  # every token written
    _close_grads(got, want, 1e-5)
