"""The Mamba selective scan's routes on the CPU (``kernels/selective_scan``):
the kernel's arithmetic, one token at a time as ``csrc/selective_scan.cu``
computes it, against the plain version's doubling scan; the CPU route
through ``blocks._selective_scan`` bit for bit the plain version; the
work charged on the CPU and on the dry run's meta route, which launches
nothing; mixed devices raising. The kernel itself runs in
``tests/test_torch_cuda.py`` on the card."""
import math

import pytest

torch = pytest.importorskip("torch")

from repro_torch.analysis import hlo as H  # noqa: E402
from repro_torch.core.trace import Tracer  # noqa: E402
from repro_torch.kernels.selective_scan import ops  # noqa: E402
from repro_torch.models import blocks  # noqa: E402

LOG2E = 1.4426950408889634


def _inputs(b, s, d_in=12, n=16, seed=0, device="cpu"):
    """u, dt, B, Cm, A as the model hands them over: dt a softplus near
    its bias's 0.01, A = -exp(A_log) over -1..-n, f32."""
    g = torch.Generator().manual_seed(seed)
    u = torch.randn(b, s, d_in, generator=g)
    dt = torch.nn.functional.softplus(
        torch.randn(b, s, d_in, generator=g) * 0.5 - 4.6)
    B, Cm = (torch.randn(b, s, n, generator=g) for _ in range(2))
    A = -torch.arange(1, n + 1, dtype=torch.float32).repeat(d_in, 1) \
        * torch.exp(torch.randn(d_in, n, generator=g) * 0.1)
    return [t.to(device) for t in (u, dt, B, Cm, A)]


def sequential_scan(u, dt, B, Cm, A, h=None):
    """The kernel's order of operations: a token at a time, dA =
    exp2(dt (A log2 e)), h = dA h + (dt u) B, y = sum_n C h."""
    b, s, d_in = u.shape
    a2 = A * LOG2E
    h = torch.zeros(b, d_in, A.shape[1]) if h is None else h.clone()
    ys = []
    for t in range(s):
        dA = torch.exp2(dt[:, t, :, None] * a2)
        h = dA * h + (dt[:, t] * u[:, t])[..., None] * B[:, t, None, :]
        ys.append((h * Cm[:, t, None, :]).sum(-1))
    return torch.stack(ys, 1), h


def _close(got, want, rel=1e-5):
    """Within ``rel`` of each element and of the largest |want|."""
    torch.testing.assert_close(got, want, rtol=rel,
                               atol=rel * float(want.abs().max()))


@pytest.mark.parametrize("with_h", [False, True])
@pytest.mark.parametrize("b", [1, 2])
@pytest.mark.parametrize("s", [1, 63, 64, 130, 257])
def test_sequential_scan_matches_the_doubling_scan(s, b, with_h):
    """One token, inside a chunk, at its edge, and over three and five
    chunks with a ragged last one, from zeros and from a given state: y
    and the last state to 1e-5 (the two differ in the order of rounding
    and exp2 for exp, ~1e-7 a step)."""
    u, dt, B, Cm, A = _inputs(b, s, seed=s + b)
    h0 = torch.randn(b, 12, 16, generator=torch.Generator().manual_seed(9)) \
        if with_h else None
    y, h_last = sequential_scan(u, dt, B, Cm, A, h0)
    want_y, want_h = ops.selective_scan_ref(u, dt, B, Cm, A, h0)
    assert y.shape == want_y.shape == (b, s, 12)
    _close(y, want_y)
    _close(h_last, want_h)


@pytest.mark.parametrize("with_h", [False, True])
@pytest.mark.parametrize("s", [63, 130])
def test_the_cpu_route_is_the_plain_version_bit_for_bit(s, with_h):
    """``blocks._selective_scan`` on the CPU returns the plain version's
    y exactly and writes its last state into ``h``; the tracer counts the
    chunks and no kernel layer."""
    u, dt, B, Cm, A = _inputs(2, s, seed=s)
    h0 = torch.randn(2, 12, 16, generator=torch.Generator().manual_seed(3))
    h = h0.clone() if with_h else None
    tr = Tracer(enabled=True)
    launches = ops.LAUNCHES
    y = blocks._selective_scan(u, dt, B, Cm, A, h=h, tr=tr)
    want_y, want_h = ops.selective_scan_ref(u, dt, B, Cm, A,
                                            h0 if with_h else None)
    assert torch.equal(y, want_y)
    if with_h:
        assert torch.equal(h, want_h)
    assert tr.metrics.counters.get("mamba_scan_chunks") == -(-s // 64)
    assert "mamba_scan_kernel" not in tr.metrics.counters
    assert ops.LAUNCHES == launches


def test_work_at_the_cells_shape():
    """(1, 8192, 8192, 16), a Jamba2-Mini layer's prefill: 113 flops a
    token and channel; u, dt and y, B and C, A and the last state once:
    0.81 GB, 0.241 ms at HBM's rate; 256 CTAs of 32 channels."""
    b, s, d, n = 1, 8192, 8192, 16
    flops, nbytes = ops.work(b, s, d, n)
    assert flops == s * d * 113
    assert nbytes == 4 * (3 * s * d + 2 * s * n + 2 * d * n) == 807403520
    ms, by = H.bound_ms(flops, nbytes, "float32")
    assert by == "bytes" and ms == pytest.approx(0.2410, abs=5e-5)
    # the exponentials on the SFUs: 16 a clock an SM, 132 SMs, 1.98 GHz
    assert s * d * n / (16 * 132 * 1.98e9) * 1e3 == pytest.approx(
        0.2568, abs=5e-5)
    plan = ops.launch_plan(b, d, n)
    assert plan["grid"] == (256, 1) and plan["channels"] == 32
    assert plan["smem_bytes"] == 2 * 64 * (2 * 32 + 2 * 16) * 4 == 49152
    assert ops.launch_plan(2, 100, 16)["grid"] == (math.ceil(100 / 32), 2)


@pytest.mark.parametrize("dev", ["cpu", "meta"])
def test_the_scan_charges_its_work(dev):
    """On the CPU and on the dry run's meta route the counter sees one
    ``selective_scan`` launch with ``work`` and none of the plain
    version's ops; the meta route launches nothing."""
    args = _inputs(1, 70, d_in=8, n=4, device=dev)
    want = ops.work(1, 70, 8, 4)
    launches = ops.LAUNCHES
    st = H.count(ops.selective_scan, *args)
    assert st.kernels == {"selective_scan": {
        "launches": 1, "flops": want[0], "bytes": want[1]}}
    assert (st.flops, st.bytes_) == want
    assert ops.LAUNCHES == launches


def test_the_meta_route_runs_under_autograd():
    """The backward is the plain version's ops, counted as they run; the
    forward is charged as the kernel."""
    u, dt, B, Cm, A = (t.requires_grad_() for t in
                       _inputs(1, 70, d_in=8, n=4, device="meta"))
    st = H.count(lambda: ops.selective_scan(u, dt, B, Cm, A)[0]
                 .sum().backward())
    assert st.kernels["selective_scan"]["launches"] == 1
    assert st.flops > ops.work(1, 70, 8, 4)[0]
    assert u.grad is not None and u.grad.shape == u.shape


@pytest.mark.parametrize("where", ["mixed", "meta_uncounted"])
def test_other_devices_raise(where):
    """Tensors on the CPU and the meta device together, or meta tensors
    with no counter active, take no route."""
    args = _inputs(1, 8, d_in=8, n=4)
    if where == "mixed":
        args[1] = args[1].to("meta")
    else:
        args = [t.to("meta") for t in args]
    with pytest.raises(ValueError, match="selective_scan"):
        ops.selective_scan(*args)
