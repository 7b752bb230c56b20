"""The port's MoE, Mamba and cross-attention blocks
(``repro_torch.models.blocks``) against the JAX package's on the same
weights and inputs, on the CPU, in f32 within ``TOL``: the MoE dispatch
where capacity overflows (the reference's slot clobber included) and
where it is ample (also against ``tests/test_models.py``'s dense oracle),
each with and without a tie in the router's logits; the chunked selective
scan across chunk edges and padding; Mamba's decode step; cross-attention
over a context and at decode over a filled cache."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.models import blocks as JB  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models import blocks as B  # noqa: E402

TOL = 1e-4
N_TOK = 16          # the probe's tokens: C = ceil(16 * 2 * 1.25 / 4) = 10


def _cfgs(arch, **over):
    over.setdefault("compute_dtype", "float32")
    return (dataclasses.replace(jax_get_config(arch).reduced(), **over),
            dataclasses.replace(get_config(arch).reduced(), **over))


def _t(tree):
    """A JAX tree of arrays as torch tensors (CPU)."""
    return jax.tree.map(lambda a: torch.from_numpy(np.array(a)), tree)


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32),
                               rtol=tol, atol=tol)


def _moe_case(capacity_factor, tie):
    """granite-moe reduced (4 experts, top-2), f32, one row of 16 tokens
    with a router biased to expert 0, so every token ranks it first.
    With ``tie``, x and the router take small integers times 1/64, so
    every logit is exact, and experts 1 and 2 have the same router
    column: each token's second choice is a tie, which lax.top_k breaks
    to expert 1, at a weight of 0.1-0.3 (expert 0's logit is 2, expert
    3's -16, those of experts 1 and 2 within +-1.1)."""
    jcfg, cfg = _cfgs("granite-moe-1b-a400m")
    moe = dataclasses.replace(jcfg.moe, capacity_factor=capacity_factor)
    jcfg = dataclasses.replace(jcfg, moe=moe)
    cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, capacity_factor=capacity_factor))
    params = jax.tree.map(np.array, JB.moe_init(jax.random.key(0), jcfg))
    rng = np.random.default_rng(5)
    d = jcfg.d_model
    router = params["router"]
    if tie:
        x = rng.integers(-2, 3, size=(1, N_TOK, d)).astype(np.float32)
        router[:] = rng.integers(-1, 2, size=router.shape) / 64.0
        router[:, 2] = router[:, 1]
        router[:, 0] = router[:, 3] = 0.0
        router[0, 0], router[0, 3] = 0.5, -4.0
    else:
        x = rng.normal(size=(1, N_TOK, d)).astype(np.float32)
        router[0, :] = 0.0
        router[0, 0] = 10.0
    x[..., 0] = 4.0
    return jcfg, cfg, params, x


def _dense_oracle(params, cfg, x):
    """tests/test_models.py's dense oracle: every expert on every token,
    mixed by the top-k weights."""
    params = jax.tree.map(jnp.asarray, params)
    logits = x @ params["router"]
    probs = jax.nn.softmax(logits, axis=-1)
    top_p, top_e = jax.lax.top_k(probs, cfg.moe.top_k)
    top_p = top_p / top_p.sum(-1, keepdims=True)
    h = jax.nn.silu(jnp.einsum("bsd,edf->ebsf", x, params["w_gate"])) \
        * jnp.einsum("bsd,edf->ebsf", x, params["w_up"])
    eo = jnp.einsum("ebsf,efd->ebsd", h, params["w_down"])
    oh = jax.nn.one_hot(top_e, cfg.moe.n_experts, dtype=jnp.float32)
    w = jnp.einsum("bske,bsk->ebs", oh, top_p)
    return jnp.einsum("ebs,ebsd->bsd", w, eo)


@pytest.mark.parametrize("tie", [False, True])
def test_moe_overflow_matches_jax_clobber_included(tie):
    """The reference's probe: C = 10 slots for 16 tokens that all rank
    expert 0 first. Tokens 10-15 are dropped from expert 0; token 9, kept
    in expert 0's last slot, loses that slot to a later dropped entry's
    sentinel, so its output differs from the ample-capacity one, in both
    packages alike; tokens 0-8 match it."""
    jcfg, cfg, params, x = _moe_case(1.25, tie)
    assert B.moe_capacity(cfg, N_TOK) == JB.moe_capacity(jcfg, N_TOK) == 10
    jy, jaux = JB.moe_apply(jax.tree.map(jnp.asarray, params), jcfg,
                            jnp.asarray(x))
    ty, taux = B.moe_apply(_t(params), cfg, torch.from_numpy(x))
    _close(ty, jy)
    _close(taux, jaux)
    ample, _ = B.moe_apply(_t(params), dataclasses.replace(
        cfg, moe=dataclasses.replace(cfg.moe, capacity_factor=8.0)),
        torch.from_numpy(x))
    diff = (ty - ample).abs().amax(dim=-1)[0]
    assert float(diff[:9].max()) <= TOL
    assert float(diff[9]) > 1e-2          # the clobbered slot
    assert float(diff[10:].min()) > 1e-2  # dropped from expert 0


@pytest.mark.parametrize("tie", [False, True])
def test_moe_ample_capacity_matches_jax_and_the_dense_oracle(tie):
    jcfg, cfg, params, x = _moe_case(8.0, tie)
    jy, jaux = JB.moe_apply(jax.tree.map(jnp.asarray, params), jcfg,
                            jnp.asarray(x))
    ty, taux = B.moe_apply(_t(params), cfg, torch.from_numpy(x))
    _close(ty, jy)
    _close(taux, jaux)
    _close(ty, _dense_oracle(params, jcfg, jnp.asarray(x)))
    assert float(taux) > 0


def test_moe_top_k_breaks_ties_to_the_lower_expert():
    probs = torch.tensor([[0.1, 0.3, 0.3, 0.3], [0.25, 0.25, 0.25, 0.25]])
    jp, je = jax.lax.top_k(jnp.asarray(probs.numpy()), 2)
    tp, te = B._top_k(probs, 2)
    assert te.tolist() == np.asarray(je).tolist() == [[1, 2], [0, 1]]
    _close(tp, jp)


@pytest.mark.parametrize("s", [63, 64, 130])
def test_selective_scan_matches_jax(s):
    """Inside one chunk, at its edge, and over three chunks with the last
    one padded."""
    rng = np.random.default_rng(s)
    b, d_in, n = 2, 8, 4
    u = rng.normal(size=(b, s, d_in)).astype(np.float32)
    dt = rng.uniform(0.001, 0.1, size=(b, s, d_in)).astype(np.float32)
    bm, cm = (rng.normal(size=(b, s, n)).astype(np.float32)
              for _ in range(2))
    a = -rng.uniform(0.5, 4.0, size=(d_in, n)).astype(np.float32)
    want = JB._selective_scan(*(jnp.asarray(t) for t in (u, dt, bm, cm, a)))
    got = B._selective_scan(*(torch.from_numpy(t) for t in (u, dt, bm, cm,
                                                             a)))
    assert got.shape == want.shape == (b, s, d_in)
    _close(got, want)


def test_mamba_prefill_and_decode_match_jax():
    """mamba_apply over 12 tokens, then 4 decode steps from a zero
    state, and the state after them."""
    jcfg, cfg = _cfgs("jamba-1.5-large-398b")
    params = JB.mamba_init(jax.random.key(2), jcfg)
    tparams = _t(params)
    rng = np.random.default_rng(4)
    x = rng.normal(size=(2, 12, jcfg.d_model)).astype(np.float32)
    jy, _ = JB.mamba_apply(params, jcfg, jnp.asarray(x))
    ty, st = B.mamba_apply(tparams, cfg, torch.from_numpy(x))
    assert st is None
    _close(ty, jy)
    jst = JB.mamba_state_init(jcfg, 2)
    tst = B.mamba_state_init(cfg, 2)
    for i in range(4):
        xi = x[:, i:i + 1]
        jy, jst = JB.mamba_apply(params, jcfg, jnp.asarray(xi), state=jst)
        ty, tst = B.mamba_apply(tparams, cfg, torch.from_numpy(xi),
                                state=tst)
        _close(ty, jy)
    for name in ("conv", "h"):
        _close(tst[name], jst[name])


def test_cross_attention_matches_jax():
    """attn_apply with a context (no rope, not causal, keys of another
    length) and attn_decode_readonly over that context's K/V."""
    jcfg, cfg = _cfgs("llama-3.2-vision-90b")
    params = JB.attn_init(jax.random.key(3), jcfg, cross=True)
    tparams = _t(params)
    rng = np.random.default_rng(6)
    b, s, n = 2, 5, jcfg.n_ctx_tokens
    x = rng.normal(size=(b, s, jcfg.d_model)).astype(np.float32)
    ctx = rng.normal(size=(b, n, jcfg.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(s, dtype=np.int32), (b, s))
    jy, _ = JB.attn_apply(params, jcfg, jnp.asarray(x), jnp.asarray(pos),
                          ctx=jnp.asarray(ctx))
    ty, _ = B.attn_apply(tparams, cfg, torch.from_numpy(x),
                         torch.from_numpy(pos.copy()),
                         ctx=torch.from_numpy(ctx))
    _close(ty, jy)
    kv = {}
    for name, w in (("k", "wk"), ("v", "wv")):
        t = ctx @ np.asarray(params[w])
        kv[name] = t.reshape(b, n, jcfg.n_kv_heads, jcfg.d_head).transpose(
            0, 2, 1, 3).copy()
    jd = JB.attn_decode_readonly(params, jcfg, jnp.asarray(x[:, :1]),
                                 jax.tree.map(jnp.asarray, kv))
    td = B.attn_decode_readonly(tparams, cfg, torch.from_numpy(x[:, :1]),
                                {k: torch.from_numpy(v)
                                 for k, v in kv.items()})
    _close(td, jd)
    # the decode over the context's cache is the full cross-attention's
    # first position
    _close(td, ty[:, :1])
