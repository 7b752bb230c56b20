"""The port's model stack (``repro_torch.models``, ``launch.serve``)
against the JAX package's on the same weights: ``lm.init`` of the JAX
package, carried across with ``params_from_numpy``, at reduced configs on
the CPU (where attention and WKV6 take their plain versions, as the JAX
package's model takes its jnp oracles)."""
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

ARCH_IDS = ["llama3-8b", "rwkv6-3b", "smollm-135m"]
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
    jcfg, cfg = _cfgs(arch)
    jp, tp = _weights(jcfg, cfg)
    toks = _tokens(cfg)
    jx, _ = jlm.forward(jp, jcfg, {"tokens": jnp.asarray(toks)})
    tx = lm.forward(tp, cfg, {"tokens": torch.from_numpy(toks)})
    _close(tx, jx)
    _close(lm.prefill(tp, cfg, {"tokens": torch.from_numpy(toks)}),
           jlm.prefill(jp, jcfg, {"tokens": jnp.asarray(toks)}))


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_decode_steps_match_jax(arch):
    """8 decode steps: logits at every step and the state after them."""
    jcfg, cfg = _cfgs(arch)
    jp, tp = _weights(jcfg, cfg)
    toks = _tokens(cfg, s=8)
    b, seq = toks.shape
    jst = jlm.decode_state_init(jcfg, b, seq)
    tst = lm.decode_state_init(cfg, b, seq, device="cpu")
    for i in range(seq):
        jl, jst = jlm.decode_step(jp, jcfg, jst,
                                  {"tokens": jnp.asarray(toks[:, i:i + 1])},
                                  jnp.full((b,), i, jnp.int32))
        tl, tst = lm.decode_step(tp, cfg, tst,
                                 {"tokens": torch.from_numpy(
                                     toks[:, i:i + 1])},
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
    tx = lm.forward(tp, cfg, {"tokens": torch.from_numpy(toks)})
    _close(tx, jx)
    plain = lm.forward(tp, dataclasses.replace(cfg, attn_chunk=0),
                       {"tokens": torch.from_numpy(toks)})
    _close(tx, plain)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_prefill_matches_teacher_forced_decode(arch):
    """The port's own prefill-versus-decode equivalence (KV cache and
    recurrent state), at the bound of tests/test_models.py."""
    _, cfg = _cfgs(arch)
    tp = lm.init(cfg, 1, device="cpu")
    toks = torch.from_numpy(_tokens(cfg, s=8))
    b, seq = toks.shape
    par = lm.prefill(tp, cfg, {"tokens": toks})
    st = lm.decode_state_init(cfg, b, seq, device="cpu")
    for i in range(seq):
        logits, st = lm.decode_step(tp, cfg, st, {"tokens": toks[:, i:i + 1]},
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


@pytest.mark.parametrize("arch", ["llama3-8b", "rwkv6-3b"])
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


@pytest.mark.parametrize("arch", ["jamba-1.5-large-398b", "dbrx-132b",
                                  "llama-3.2-vision-90b", "musicgen-large"])
def test_unported_blocks_raise(arch):
    cfg = get_config(arch).reduced()
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        lm.init(cfg, device="cpu")


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
