"""The port's WKV6 (plain PyTorch version on the CPU) against the JAX
package's Pallas kernel in interpret mode and its sequential oracle
(``blocks._wkv6_scan``): the same numpy inputs through both, on the
cases of tests/test_kernels.py::TestWKV6, held to rel < 1e-4."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels.rwkv6.kernel import wkv6 as jax_wkv6  # noqa: E402
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


@pytest.mark.parametrize("layout", ["bhsn", "bshn"])
def test_card_route_refuses_grad(layout, monkeypatch):
    """The kernel has no backward: on the card route an input that
    requires grad raises, naming the ROADMAP item, before any launch (no
    detached output, no plain version); under ``torch.no_grad`` the same
    call launches. On the CPU, autograd runs through the plain version."""
    import types

    from repro_torch.kernels import build
    lib = _FakeLibrary()
    monkeypatch.setattr(build, "load", lambda: lib)
    monkeypatch.setattr(ops, "route", lambda name, *ts: "cuda")
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda: types.SimpleNamespace(cuda_stream=0x5EED0))
    call = ops.wkv6 if layout == "bhsn" else ops.wkv6_bshn
    r, k, v = (torch.randn(1, 2, 2, 16) for _ in range(3))    # H = S = 2
    w, u = torch.rand(1, 2, 2, 16), torch.randn(2, 16)
    launches = ops.LAUNCHES
    for needs in (w, u, r):
        needs.requires_grad_(True)
        with pytest.raises(NotImplementedError,
                           match="wkv6 backward kernel and rwkv6 training"):
            call(r, k, v, w, u)
        needs.requires_grad_(False)
    assert ops.LAUNCHES == launches and lib.calls == []
    r.requires_grad_(True)
    with torch.no_grad():
        call(r, k, v, w, u)
    assert ops.LAUNCHES == launches + 1 and len(lib.calls) == 1
    monkeypatch.setattr(ops, "route", lambda name, *ts: "cpu")
    call(r, k, v, w, u).sum().backward()
    assert r.grad is not None and r.grad.abs().sum() > 0
