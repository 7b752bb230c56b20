"""The port's Jamba (``configs/jamba2_mini.py``: Mamba-1 and attention
7:1, MoE every other layer, no positions in attention, RMSNorms inside
the Mamba mixer, an unnormalised router) against the benchmark's plain
reference (``cmpibench/reference/jamba.py``), on the CPU in f32 with
seeded weights at a small size: the full forward's logits; a prefill
that fills the decode state, then decode steps through it, against the
reference's full forward over the prompt and the fed tokens (and the
same for granite's attention-only model against its reference); and
the held-expert shares of one MoE layer adding up to the whole layer.

The MoE runs at capacity factor 8 where the program's grouping (a row
a group in ``moe_apply``'s prefill) and the reference's (the serve
step's rows as one) differ, so that no group drops a token: the
capacity rule itself is held to the reference through the benchmark's
expert-parallel path (``cmpibench/tests``)."""
import dataclasses
import json
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from cmpibench.reference.granite import Granite  # noqa: E402
from cmpibench.reference.jamba import Jamba  # noqa: E402
from repro_torch.configs import PortConfig, get_config  # noqa: E402
from repro_torch.models import blocks as B  # noqa: E402
from repro_torch.models import lm  # noqa: E402

TOL = 1e-4


def _cfg(**over):
    cfg = get_config("jamba2-mini").reduced(compute_dtype="float32",
                                            kv_cache_dtype="float32")
    over.setdefault("moe", dataclasses.replace(cfg.moe, capacity_factor=8.0))
    return dataclasses.replace(
        cfg, mamba=dataclasses.replace(cfg.mamba, dt_rank=4), **over)


def _m(cfg) -> dict:
    """The reference's view of ``cfg``: the published config's keys."""
    return {"num_hidden_layers": cfg.n_layers, "hidden_size": cfg.d_model,
            "num_attention_heads": cfg.n_heads,
            "num_key_value_heads": cfg.n_kv_heads,
            "intermediate_size": cfg.d_ff,
            "router_experts": cfg.moe.n_experts, "num_experts": cfg.n_held,
            "held_expert_offset": cfg.moe_held_offset,
            "num_experts_per_tok": cfg.moe.top_k,
            "vocab_size": cfg.vocab_size, "mamba_d_state": cfg.mamba.d_state,
            "mamba_dt_rank": cfg.mamba.dt_rank, "rms_norm_eps": cfg.norm_eps,
            "attn_layer_period": 8, "attn_layer_offset": 4,
            "expert_layer_period": 2, "expert_layer_offset": 1}


def _params(cfg, seed=3):
    """``lm.init``'s weights, every vector leaf (norms, biases, D) moved
    off its constant so that it counts."""
    p = lm.init(cfg, seed, device="cpu")
    g = torch.Generator().manual_seed(seed + 1)
    for t in lm.tree_leaves(p):
        if t.dim() == 2 and t.shape[0] == cfg.n_groups:
            t.add_(0.1 * torch.randn(t.shape, generator=g))
    return p


def _flat(cfg, p) -> dict:
    """The reference's weights: layer ``g * len(pattern) + i`` is group g
    of pattern position i."""
    w = {"embed": p["embed"], "head": p["head"],
         "final_norm": p["final_norm"]}
    n = len(cfg.pattern)
    for i, blk in enumerate(p["blocks"]):
        for g in range(cfg.n_groups):
            for name, t in {**blk["mixer"], **blk["ffn"],
                            "norm1": blk["norm1"],
                            "norm2": blk["norm2"]}.items():
                w[f"{g * n + i}.{name}"] = t[g]
    return w


def _tokens(cfg, b, s, seed=7):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.integers(0, cfg.vocab_size, size=(b, s)))


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=tol,
                               atol=tol)


def test_the_preset_is_the_published_pattern():
    cfg = get_config("jamba2-mini")
    assert isinstance(cfg, PortConfig)
    kinds = [(b.mixer, b.ffn) for b in cfg.pattern]
    m = dict(_m(cfg), num_hidden_layers=8)
    from cmpibench.reference.jamba import layer_kinds
    assert kinds == layer_kinds(m)
    assert kinds[4] == ("attn", "dense") and kinds.count(("attn", "dense")) \
        + kinds.count(("attn", "moe")) == 1
    assert (cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
            cfg.d_head, cfg.d_ff, cfg.vocab_size) == (
        32, 4096, 32, 8, 128, 14336, 65536)
    assert (cfg.moe.n_experts, cfg.moe.top_k, cfg.mamba.d_state,
            cfg.mamba.d_conv, cfg.mamba.expand, cfg.mamba.dt_rank) == (
        16, 2, 16, 4, 2, 256)
    assert not cfg.attn_rope and cfg.mamba_inner_norms \
        and not cfg.moe_renormalize
    # the JAX package's presets keep today's behaviour
    gr = get_config("granite-moe-1b-a400m")
    assert gr.attn_rope and not gr.mamba_inner_norms \
        and gr.moe_renormalize and gr.n_held == 32


def test_forward_logits_match_the_reference():
    """Two groups of the 8-layer pattern, two rows."""
    cfg = _cfg()
    p = _params(cfg)
    toks = _tokens(cfg, 2, 24)
    x, _ = lm.forward(p, cfg, {"tokens": toks})
    got = lm._logits(p, cfg, x)
    ref = Jamba(_m(cfg), _flat(cfg, p), model_size=1,
                capacity_factor=cfg.moe.capacity_factor)
    want = ref.logits(toks, 1)              # every position's logits
    assert got.shape == want.shape == (2, 24, cfg.vocab_size)
    _close(got, want)


@pytest.mark.parametrize("prompt", [3, 64, 70])
def test_prefill_fills_the_state_and_decode_goes_on(prompt):
    """A prefill of ``prompt`` tokens (shorter than the conv, one whole
    scan chunk, a chunk and a part) with a state to fill, then 4 decode
    steps through it, against the reference's full forward over the
    prompt and the fed tokens."""
    cfg = _cfg()
    p = _params(cfg)
    gen, b = 5, 2
    seq = _tokens(cfg, b, prompt + gen)
    st = lm.decode_state_init(cfg, b, prompt + gen, device="cpu")
    got = [lm.prefill(p, cfg, {"tokens": seq[:, :prompt]}, state=st)]
    for i in range(prompt, prompt + gen - 1):
        pos = torch.full((b,), i, dtype=torch.int32)
        out, _ = lm.decode_step(p, cfg, st, {"tokens": seq[:, i:i + 1]},
                                pos)
        got.append(out)
    ref = Jamba(_m(cfg), _flat(cfg, p), model_size=1,
                capacity_factor=cfg.moe.capacity_factor)
    want = ref.logits(seq[:, :prompt + gen - 1], prompt)
    _close(torch.stack(got, 1), want)
    # the prefill alone gives the logits it gives without a state
    _close(lm.prefill(p, cfg, {"tokens": seq[:, :prompt]}), got[0])


def test_granite_prefill_fills_the_kv_cache():
    """granite-moe's attention-only model: a prefill filling the cache
    (keys after rope) and 3 decode steps through it against the
    reference's forward over each prefix."""
    from cmpibench.systems.ep_serve import model_config
    from cmpibench.tests.cpu_cells import TINY_GRANITE
    from cmpibench.weights import program_params, reference_params
    conf = json.loads((Path(__file__).resolve().parents[1] / "cmpibench"
                       / "configs" / "granite-moe-1b-a400m-ep4.json")
                      .read_text())
    conf.update(TINY_GRANITE, compute_dtype="float32",
                kv_cache_dtype="float32", capacity_factor=8.0)
    cfg = model_config(conf)
    p = program_params(conf, 11, "cpu", 0, 1)
    ref = Granite(conf, reference_params(conf, 11, "cpu"), model_size=1,
                  capacity_factor=8.0)
    prompt, gen, b = 10, 4, 2
    seq = _tokens(cfg, b, prompt + gen, seed=2)
    st = lm.decode_state_init(cfg, b, prompt + gen, device="cpu")
    got = [lm.prefill(p, cfg, {"tokens": seq[:, :prompt]}, state=st)]
    for i in range(prompt, prompt + gen - 1):
        pos = torch.full((b,), i, dtype=torch.int32)
        out, _ = lm.decode_step(p, cfg, st, {"tokens": seq[:, i:i + 1]},
                                pos)
        got.append(out)
    want = [ref.prefill(seq[:, :prompt + i]) for i in range(gen)]
    _close(torch.stack(got, 1), torch.stack(want, 1))


@pytest.mark.parametrize("arch", ["rwkv6-3b", "llama-3.2-vision-90b"])
def test_a_prefill_fills_no_state_of_other_mixers(arch):
    cfg = get_config(arch).reduced(compute_dtype="float32")
    p = lm.init(cfg, 0, device="cpu")
    st = lm.decode_state_init(cfg, 1, 8, device="cpu")
    with pytest.raises(NotImplementedError):
        lm.prefill(p, cfg, {"tokens": torch.zeros(1, 4, dtype=torch.long)},
                   state=st)


@pytest.mark.parametrize("renormalize", [False, True])
def test_held_shares_add_up_to_the_whole_layer(renormalize):
    """16 experts top-2: chip 0 holding experts 0-7 and chip 1 holding
    8-15 give, summed, the layer with all 16, in the program and in the
    reference, and the two agree."""
    base = _cfg(moe=dataclasses.replace(get_config("jamba2-mini").moe,
                                        capacity_factor=8.0),
                moe_renormalize=renormalize)
    whole = B.moe_init(torch.Generator().manual_seed(5), base)
    x = torch.randn(2, 12, base.d_model,
                    generator=torch.Generator().manual_seed(6))
    want, _ = B.moe_apply(whole, base, x)
    parts, refs = [], []
    m = _m(base)
    for lo in (0, 8):
        cfg = dataclasses.replace(base, moe_held=8, moe_held_offset=lo)
        held = {k: (v[lo:lo + 8] if k != "router" else v)
                for k, v in whole.items()}
        y, _ = B.moe_apply(held, cfg, x)
        parts.append(y)
        if not renormalize:       # the published router does not
            ref = Jamba(dict(m, num_experts=8, held_expert_offset=lo),
                        {f"0.{k}": v for k, v in held.items()},
                        model_size=1, capacity_factor=8.0)
            refs.append(ref._moe_steps(0, x, x.shape[1]))
    _close(parts[0] + parts[1], want)
    assert parts[0].abs().sum() > 0 and parts[1].abs().sum() > 0
    if refs:
        _close(refs[0], parts[0])
        _close(refs[0] + refs[1], want)


def test_the_mixer_and_the_fill_record_spans_and_counters():
    """While the tracer records: ``mamba.mixer`` around ``mamba.scan``,
    ``serve.state_fill`` for each state write, ``mamba_scan_chunks`` and
    ``state_fill_bytes`` counted; nothing while it is off."""
    from types import SimpleNamespace

    from repro_torch.core.trace import Tracer
    cfg = _cfg()
    p = _params(cfg)
    blk = lm._group(p["blocks"], 0)
    st = lm._group(lm.decode_state_init(cfg, 2, 70, device="cpu"), 0)
    tr = Tracer(enabled=False)
    fake = SimpleNamespace(tracer=tr)
    x = torch.randn(2, 70, cfg.d_model, generator=torch.Generator()
                    .manual_seed(8))
    B.mamba_apply(blk[0]["mixer"], cfg, x, state=st[0]["ssm"], dist=fake)
    assert not tr.span_rows() and not tr.metrics.counters
    tr.start()
    B.mamba_apply(blk[0]["mixer"], cfg, x, state=st[0]["ssm"], dist=fake)
    pos = torch.arange(70).expand(2, 70)
    B.attn_apply(blk[4]["mixer"], cfg, x, pos, cache=st[4]["kv"], dist=fake)
    tr.stop()
    rows = tr.span_rows()
    names = [r[0] for r in rows]
    assert names[:2] == ["mamba.mixer", "serve.state_fill"]
    assert names.count("mamba.scan") == 1
    assert names.count("serve.state_fill") == 4      # conv, h, k, v
    scan = rows[names.index("mamba.scan")]
    assert scan[3] == 0                              # under the mixer
    kv = 2 * st[4]["kv"]["k"][:, :, :70].numel() * 4
    ssm = sum(t.numel() * t.element_size() for t in st[0]["ssm"].values())
    assert tr.metrics.counters == {"mamba_scan_chunks": 2,
                                   "state_fill_bytes": kv + ssm}
