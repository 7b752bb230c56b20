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
# tensors (no copy), and misaligned views (copied)
LAUNCH_CASES = [("bhsd", torch.bfloat16, False),
                ("bshd", torch.bfloat16, False),
                ("bshd-view", torch.bfloat16, False),
                ("bhsd", torch.bfloat16, True),
                ("bshd", torch.float32, True),
                ("bhsd", torch.float32, False)]


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
