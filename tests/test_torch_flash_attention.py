"""The port's flash attention (plain PyTorch version on the CPU) against
the JAX package's Pallas kernel in interpret mode and its jnp oracle:
the same numpy inputs through both, on the cases of
tests/test_kernels.py::TestFlashAttention."""
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
