"""The port's model stack (``repro_torch.models``, ``launch.serve``)
against the JAX package's on the same weights: ``lm.init`` of the JAX
package, carried across with ``params_from_numpy``, at reduced configs on
the CPU (where attention and WKV6 take their plain versions, as the JAX
package's model takes its jnp oracles). Every config of ``ARCHS``:
frames models are fed frames and cross-attention models a context, as
``tests/test_models.py``'s ``tiny_batch`` feeds them."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.launch.serve import serve_batch as jax_serve_batch  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro_torch.configs import ARCHS, get_config  # noqa: E402
from repro_torch.launch.serve import serve_batch  # noqa: E402
from repro_torch.models import lm  # noqa: E402

ARCH_IDS = list(ARCHS)
# the bound of tests/test_models.py's prefill-versus-decode check: f32
# compute, where the two frameworks differ only in summation order
TOL = 1e-4


def _cfgs(arch, **over):
    """The same reduced config in both packages."""
    over.setdefault("compute_dtype", "float32")
    return (dataclasses.replace(jax_get_config(arch).reduced(), **over),
            dataclasses.replace(get_config(arch).reduced(), **over))


def _weights(jcfg, cfg, seed=0):
    jp = jlm.init(jcfg, jax.random.key(seed))
    tree = jax.tree.map(np.asarray, jp)
    return jp, lm.params_from_numpy(cfg, tree, device="cpu")


def _tokens(cfg, b=2, s=16, seed=3):
    rng = np.random.default_rng(seed)
    return rng.integers(0, cfg.vocab_size, size=(b, s), dtype=np.int32)


def _inputs(cfg, b=2, s=16, seed=3):
    """(numpy batch for the full sequence, function giving step i's
    numpy batch): tokens, or frames for a frames model; and a context
    for a cross-attention model (read by ``forward`` only)."""
    rng = np.random.default_rng(seed)
    if cfg.frontend == "frames":
        frames = rng.normal(size=(b, s, cfg.d_model)).astype(np.float32)
        full = {"frames": frames}
        step = lambda i: {"frames": frames[:, i:i + 1]}  # noqa: E731
    else:
        toks = _tokens(cfg, b, s, seed)
        full = {"tokens": toks}
        step = lambda i: {"tokens": toks[:, i:i + 1]}  # noqa: E731
    if cfg.n_ctx_tokens:
        full["ctx"] = rng.normal(
            size=(b, cfg.n_ctx_tokens, cfg.d_model)).astype(np.float32)
    return full, step


def _jb(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _tb(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _cross_kv(cfg, tree, ctx):
    """{pattern position: (k, v)} of every cross-attention block over
    ``ctx``, stacked over groups as the decode state holds them: (G, B,
    KV, Nctx, Dh), ctx @ wk and ctx @ wv in f32 numpy."""
    out = {}
    for p, blk in enumerate(cfg.pattern):
        if blk.mixer != "cross_attn":
            continue
        mixer = tree["blocks"][p]["mixer"]
        kv = []
        for name in ("wk", "wv"):
            w = np.asarray(mixer[name], np.float32)        # (G, D, KV*Dh)
            t = np.einsum("bnd,gde->gbne", ctx, w)
            t = t.reshape(*t.shape[:3], cfg.n_kv_heads, cfg.d_head)
            kv.append(np.ascontiguousarray(t.transpose(0, 1, 3, 2, 4)))
        out[p] = kv
    return out


def _fill_cross(jcfg, jst, tst, tree, ctx):
    """Fill both packages' cross-attention decode caches with the same
    K/V of ``ctx`` (no entry point of either package fills them);
    returns the JAX state."""
    jst = list(jst)
    for p, (k, v) in _cross_kv(jcfg, tree, ctx).items():
        jst[p] = {"kv": {"k": jnp.asarray(k), "v": jnp.asarray(v)}}
        tst[p]["kv"]["k"].copy_(torch.from_numpy(k))
        tst[p]["kv"]["v"].copy_(torch.from_numpy(v))
    return tuple(jst)


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32),
                               rtol=tol, atol=tol)


def test_configs_match_the_jax_package():
    from repro.configs import ARCHS as JAX_ARCHS
    assert ARCHS == JAX_ARCHS
    for arch in ARCHS:
        assert dataclasses.asdict(get_config(arch)) == \
            dataclasses.asdict(jax_get_config(arch))
        assert dataclasses.asdict(get_config(arch).reduced()) == \
            dataclasses.asdict(jax_get_config(arch).reduced())


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_forward_and_prefill_match_jax(arch):
    """x and the MoE auxiliary loss of ``forward``, and ``prefill``."""
    jcfg, cfg = _cfgs(arch)
    jp, tp = _weights(jcfg, cfg)
    full, _ = _inputs(cfg)
    jx, jaux = jlm.forward(jp, jcfg, _jb(full))
    tx, taux = lm.forward(tp, cfg, _tb(full))
    _close(tx, jx)
    _close(taux, jaux)
    assert (float(taux) > 0) == (cfg.moe is not None)
    _close(lm.prefill(tp, cfg, _tb(full)), jlm.prefill(jp, jcfg, _jb(full)))


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_decode_steps_match_jax(arch):
    """8 decode steps: logits at every step and the state after them
    (cross-attention caches as ``decode_state_init`` leaves them)."""
    jcfg, cfg = _cfgs(arch)
    jp, tp = _weights(jcfg, cfg)
    b, seq = 2, 8
    _, step = _inputs(cfg, b, seq)
    jst = jlm.decode_state_init(jcfg, b, seq)
    tst = lm.decode_state_init(cfg, b, seq, device="cpu")
    for i in range(seq):
        jl, jst = jlm.decode_step(jp, jcfg, jst, _jb(step(i)),
                                  jnp.full((b,), i, jnp.int32))
        tl, tst = lm.decode_step(tp, cfg, tst, _tb(step(i)),
                                 torch.full((b,), i, dtype=torch.int32))
        _close(tl, jl)
    jleaves = jax.tree.leaves(jst)
    tleaves = list(lm.tree_leaves(tst))
    assert len(jleaves) == len(tleaves)
    for j, t in zip(jleaves, tleaves):
        assert tuple(t.shape) == j.shape
        _close(t, j)


def test_chunked_attention_matches_jax():
    """attn_chunk=8 takes _chunked_attention in both packages."""
    jcfg, cfg = _cfgs("llama3-8b", attn_chunk=8)
    jp, tp = _weights(jcfg, cfg)
    toks = _tokens(cfg, s=32)
    jx, _ = jlm.forward(jp, jcfg, {"tokens": jnp.asarray(toks)})
    tx, _ = lm.forward(tp, cfg, {"tokens": torch.from_numpy(toks)})
    _close(tx, jx)
    plain, _ = lm.forward(tp, dataclasses.replace(cfg, attn_chunk=0),
                          {"tokens": torch.from_numpy(toks)})
    _close(tx, plain)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_prefill_matches_teacher_forced_decode(arch):
    """The port's own prefill-versus-decode equivalence (KV cache,
    recurrent and conv state), at the bound of tests/test_models.py: MoE
    at ample capacity (the two groupings drop different tokens by
    design), frames models on embedding rows as there, and
    cross-attention with the prefill's context in the decode cache."""
    _, cfg = _cfgs(arch)
    if cfg.moe is not None:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, capacity_factor=8.0))
    tp = lm.init(cfg, 1, device="cpu")
    b, seq = 2, 8
    full, _ = _inputs(cfg, b, seq)
    if cfg.frontend == "frames":
        emb = tp["embed"].numpy()
        toks = _tokens(cfg, b, seq)
        full["frames"] = emb[toks]
    step = lambda i: {k: v[:, i:i + 1] for k, v in full.items()  # noqa
                      if k != "ctx"}
    par = lm.prefill(tp, cfg, _tb(full))
    st = lm.decode_state_init(cfg, b, seq, device="cpu")
    if cfg.n_ctx_tokens:
        tree = lm._tree_map(lambda t: t.numpy(), tp)
        for p, (k, v) in _cross_kv(cfg, tree, full["ctx"]).items():
            st[p]["kv"]["k"].copy_(torch.from_numpy(k))
            st[p]["kv"]["v"].copy_(torch.from_numpy(v))
    for i in range(seq):
        logits, st = lm.decode_step(tp, cfg, st, _tb(step(i)),
                                    torch.full((b,), i, dtype=torch.int32))
    _close(par, logits)


def test_kv_update_dus_matches_onehot():
    _, cfg = _cfgs("llama3-8b", compute_dtype="bfloat16")
    tp = lm.init(cfg, 0, device="cpu")
    toks = torch.from_numpy(_tokens(cfg, s=4))

    def roll(c):
        st = lm.decode_state_init(c, 2, 8, device="cpu")
        return torch.stack([lm.decode_step(
            tp, c, st, {"tokens": toks[:, i:i + 1]},
            torch.full((2,), i, dtype=torch.int32))[0] for i in range(4)])

    assert torch.equal(roll(cfg), roll(dataclasses.replace(cfg,
                                                           kv_update="dus")))


@pytest.mark.parametrize("arch", ["llama3-8b", "rwkv6-3b", "musicgen-large",
                                  "granite-moe-1b-a400m",
                                  "jamba-1.5-large-398b",
                                  "llama-3.2-vision-90b"])
def test_serve_batch_greedy_tokens_match_jax(arch):
    jcfg, cfg = _cfgs(arch)
    jp, tp = _weights(jcfg, cfg)
    kw = dict(batch=2, prompt_len=6, gen=5, seed=0, quiet=True)
    want = jax_serve_batch(jcfg, **kw)["tokens"]
    got = serve_batch(cfg, params=tp, device="cpu", **kw)["tokens"]
    np.testing.assert_array_equal(got, want)
    sampled = serve_batch(cfg, params=tp, device="cpu", greedy=False, **kw)
    assert sampled["tokens"].shape == want.shape
    assert ((0 <= sampled["tokens"]) & (sampled["tokens"] < cfg.vocab_size)
            ).all()


@pytest.mark.parametrize("arch", ["llama3-8b", "rwkv6-3b"])
def test_bf16_prefill_near_jax(arch):
    """bf16 compute: the two frameworks round bf16 at different places
    (matmul outputs, fused casts), so the bound is 3e-2 of max|logit|,
    the bf16 bound of tests/test_kernels.py, not the f32 one."""
    jcfg, cfg = _cfgs(arch, compute_dtype="bfloat16")
    jp, tp = _weights(jcfg, cfg)
    toks = _tokens(cfg)
    want = np.asarray(jlm.prefill(jp, jcfg, {"tokens": jnp.asarray(toks)}))
    got = lm.prefill(tp, cfg, {"tokens": torch.from_numpy(toks)}).numpy()
    assert np.abs(got - want).max() <= 3e-2 * np.abs(want).max()


def test_params_from_numpy_rejects_a_wrong_tree():
    jcfg, cfg = _cfgs("smollm-135m")
    tree = jax.tree.map(np.asarray, jlm.init(jcfg, jax.random.key(0)))
    tree["final_norm"] = tree["final_norm"][:-1]
    with pytest.raises(ValueError):
        lm.params_from_numpy(cfg, tree, device="cpu")
    del tree["final_norm"]
    with pytest.raises(ValueError):
        lm.params_from_numpy(cfg, tree, device="cpu")


def test_cross_attention_decode_over_a_filled_cache_matches_jax():
    """llama-3.2-vision: 8 decode steps with both packages' cross caches
    filled with the same context's K/V, logits at every step and the
    state after them."""
    jcfg, cfg = _cfgs("llama-3.2-vision-90b")
    jp, tp = _weights(jcfg, cfg)
    tree = jax.tree.map(np.asarray, jp)
    b, seq = 2, 8
    full, step = _inputs(cfg, b, seq)
    jst = jlm.decode_state_init(jcfg, b, seq)
    tst = lm.decode_state_init(cfg, b, seq, device="cpu")
    jst = _fill_cross(jcfg, jst, tst, tree, full["ctx"])
    for i in range(seq):
        jl, jst = jlm.decode_step(jp, jcfg, jst, _jb(step(i)),
                                  jnp.full((b,), i, jnp.int32))
        tl, tst = lm.decode_step(tp, cfg, tst, _tb(step(i)),
                                 torch.full((b,), i, dtype=torch.int32))
        _close(tl, jl)
    for j, t in zip(jax.tree.leaves(jst), lm.tree_leaves(tst)):
        _close(t, j)


@pytest.mark.parametrize("arch,drop", [("llama-3.2-vision-90b", "ctx"),
                                       ("musicgen-large", "frames")])
def test_forward_without_ctx_or_frames_matches_jax(arch, drop):
    """A vision model's forward without a context (its cross-attention
    blocks then attend causally over x, with rope), and a frames model's
    forward on tokens (looked up in the embedding), as in the JAX
    package."""
    jcfg, cfg = _cfgs(arch)
    jp, tp = _weights(jcfg, cfg)
    full, _ = _inputs(cfg)
    full.pop(drop)
    full.setdefault("tokens", _tokens(cfg))
    jx, _ = jlm.forward(jp, jcfg, _jb(full))
    tx, _ = lm.forward(tp, cfg, _tb(full))
    _close(tx, jx)


@pytest.mark.parametrize("kv_update,dtype", [("onehot", "float32"),
                                             ("onehot", "bfloat16"),
                                             ("dus", "float32")])
def test_int8_kv_state_as_the_jax_package(kv_update, dtype):
    """``kv_cache_dtype="int8"`` as the JAX package has it: the same state
    tree (int8 k/v, f32 scales); under onehot, 3 steps with the JAX
    package's logits and its state after them, the cache promoted to the
    compute dtype and the scales gone; under dus, a TypeError on the
    first step. f32 within TOL; bf16 logits within 1e-2 (the bound of
    test_decode_past_the_cache_raises) and the bf16 cache within 3e-2 of
    its max (test_bf16_prefill_near_jax's bound): the two packages round
    K and V to bf16 at different places."""
    jcfg, cfg = _cfgs("smollm-135m", kv_cache_dtype="int8",
                      kv_update=kv_update, compute_dtype=dtype)
    jp, tp = _weights(jcfg, cfg)
    b, seq = 2, 4

    def spec(leaves):
        return [(tuple(t.shape), str(t.dtype).replace("torch.", ""))
                for t in leaves]

    jst = jlm.decode_state_init(jcfg, b, seq)
    tst = lm.decode_state_init(cfg, b, seq, device="cpu")
    assert spec(lm.tree_leaves(tst)) == spec(jax.tree.leaves(jst))
    assert sorted(tst[0]["kv"]) == ["k", "k_scale", "v", "v_scale"]
    toks = _tokens(cfg, b, seq)
    step = (lambda i: {"tokens": toks[:, i:i + 1]})  # noqa: E731
    if kv_update == "dus":
        with pytest.raises(TypeError):
            jlm.decode_step(jp, jcfg, jst, _jb(step(0)),
                            jnp.zeros((b,), jnp.int32))
        with pytest.raises(TypeError):
            lm.decode_step(tp, cfg, tst, _tb(step(0)),
                           torch.zeros((b,), dtype=torch.int32))
        return
    bound = TOL if dtype == "float32" else 1e-2
    for i in range(3):
        jl, jst = jlm.decode_step(jp, jcfg, jst, _jb(step(i)),
                                  jnp.full((b,), i, jnp.int32))
        tl, tst = lm.decode_step(tp, cfg, tst, _tb(step(i)),
                                 torch.full((b,), i, dtype=torch.int32))
        _close(tl, jl, bound)
    assert sorted(tst[0]["kv"]) == ["k", "v"]
    assert spec(lm.tree_leaves(tst)) == spec(jax.tree.leaves(jst))
    assert tst[0]["kv"]["k"].dtype == getattr(torch, dtype)
    for j, t in zip(jax.tree.leaves(jst), lm.tree_leaves(tst)):
        if dtype == "float32":
            _close(t, j)
        else:
            want = np.asarray(j, np.float32)
            assert np.abs(t.float().numpy() - want).max() \
                <= 3e-2 * np.abs(want).max()


@pytest.mark.parametrize("kv_update,dtype,bound",
                         [("onehot", "float32", 1e-6),
                          ("dus", "bfloat16", 1e-2)])
def test_decode_past_the_cache_raises(kv_update, dtype, bound):
    """Steps 0-3 into a 4-slot cache match the JAX package within
    ``bound`` (absolute): the largest errors read on these inputs on the
    CPU were 2.6e-7 (f32, onehot; the frameworks differ in summation
    order only) and 4.9e-3 (bf16, dus; 2.5 bf16 ulps at the logits'
    0.36, as the two round bf16 at different places), and each bound
    sits about 2-4x above its reading. Step 4 is past the cache,
    where the JAX package drops (onehot) or clamps (dus) the update and
    corrupts the cache, and the port raises a ValueError that names the
    cache length."""
    jcfg, cfg = _cfgs("smollm-135m", compute_dtype=dtype,
                      kv_update=kv_update)
    jp, tp = _weights(jcfg, cfg)
    toks = _tokens(cfg, b=2, s=5)
    jst = jlm.decode_state_init(jcfg, 2, 4)
    tst = lm.decode_state_init(cfg, 2, 4, device="cpu")
    for i in range(4):
        jl, jst = jlm.decode_step(jp, jcfg, jst,
                                  {"tokens": jnp.asarray(toks[:, i:i + 1])},
                                  jnp.full((2,), i, jnp.int32))
        tl, tst = lm.decode_step(tp, cfg, tst,
                                 {"tokens": torch.from_numpy(
                                     toks[:, i:i + 1])},
                                 torch.full((2,), i, dtype=torch.int32))
        err = np.abs(tl.float().numpy() - np.asarray(jl, np.float32)).max()
        assert err <= bound, (i, err)
    with pytest.raises(ValueError, match="length 4"):
        lm.decode_step(tp, cfg, tst, {"tokens": torch.from_numpy(
            toks[:, 4:5])}, torch.full((2,), 4, dtype=torch.int32))


@pytest.mark.parametrize("compute,cache", [("float32", "bfloat16"),
                                           ("bfloat16", "float32")])
def test_dus_over_a_cache_of_another_type_raises_as_jax(compute, cache):
    """``kv_update="dus"`` with a float KV cache whose ``kv_cache_dtype``
    is not the compute dtype (a bfloat16 cache under f32 compute, the
    default config's f32 setting): the JAX package's first decode step
    raises ``TypeError`` (lax.scatter of mixed types), and so does the
    port's, where it used to run over its promoted cache. Under
    ``"onehot"`` both run the f32 case (both raise on the bf16 one:
    ``test_onehot_f32_cache_under_bf16_compute_as_jax``)."""
    b, seq = 2, 4
    for kv_update in ("dus", "onehot")[:2 if compute == "float32" else 1]:
        jcfg, cfg = _cfgs("smollm-135m", compute_dtype=compute,
                          kv_cache_dtype=cache, kv_update=kv_update)
        jp, tp = _weights(jcfg, cfg)
        tok = _tokens(cfg, b, 1)
        jst = jlm.decode_state_init(jcfg, b, seq)
        tst = lm.decode_state_init(cfg, b, seq, device="cpu")

        def jstep():
            return jlm.decode_step(jp, jcfg, jst, _jb({"tokens": tok}),
                                   jnp.zeros((b,), jnp.int32))[0]

        def tstep():
            return lm.decode_step(tp, cfg, tst, _tb({"tokens": tok}),
                                  torch.zeros((b,), dtype=torch.int32))[0]

        if kv_update == "dus":
            with pytest.raises(TypeError, match="same dtypes"):
                jstep()
            with pytest.raises(TypeError, match="same dtypes"):
                tstep()
        else:
            _close(tstep(), jstep())


def test_onehot_f32_cache_under_bf16_compute_as_jax():
    """A float32 KV cache under bf16 compute and ``kv_update="onehot"``
    (smollm-135m reduced, batch 2, cache 4): the JAX package's attention
    output takes the wider type, f32, and with it the residual stream, so
    its first ``decode_step`` raises ``TypeError`` at its ``lax.scan``
    over the groups (carry input and output of different types). The
    port raises the same error before it touches the state."""
    b, seq = 2, 4
    jcfg, cfg = _cfgs("smollm-135m", compute_dtype="bfloat16",
                      kv_cache_dtype="float32", kv_update="onehot")
    jp, tp = _weights(jcfg, cfg)
    tok = _tokens(cfg, b, 1)
    jst = jlm.decode_state_init(jcfg, b, seq)
    tst = lm.decode_state_init(cfg, b, seq, device="cpu")
    assert {t.dtype for t in lm.tree_leaves(tst)} == {torch.float32}
    assert {a.dtype for a in jax.tree.leaves(jst)} == {np.dtype("float32")}
    with pytest.raises(TypeError, match="carry input and carry output"):
        jlm.decode_step(jp, jcfg, jst, _jb({"tokens": tok}),
                        jnp.zeros((b,), jnp.int32))
    with pytest.raises(TypeError, match="carry input and carry output"):
        lm.decode_step(tp, cfg, tst, _tb({"tokens": tok}),
                       torch.zeros((b,), dtype=torch.int32))
    assert not any(bool(t.any()) for t in lm.tree_leaves(tst))
