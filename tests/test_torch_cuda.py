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


def test_wkv6_on_the_card_raises_under_grad(card):
    from repro_torch.kernels.rwkv6 import ops as wk
    b, h, s, n = 1, 2, 8, 16
    r, k, v = (torch.randn(b, h, s, n, device="cuda") for _ in range(3))
    w = torch.rand(b, h, s, n, device="cuda")
    u = torch.randn(h, n, device="cuda")
    r.requires_grad_(True)
    launches = wk.LAUNCHES
    with pytest.raises(NotImplementedError, match="wkv6 backward kernel"):
        wk.wkv6(r, k, v, w, u)
    assert wk.LAUNCHES == launches
    with torch.no_grad():
        assert wk.wkv6(r, k, v, w, u).shape == (b, h, s, n)
    assert wk.LAUNCHES == launches + 1


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
