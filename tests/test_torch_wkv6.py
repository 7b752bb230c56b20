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
