"""Config registry: ``get_config(arch_id)`` and the assigned-architecture list."""
from __future__ import annotations

import importlib

from repro_torch.configs.base import (  # noqa: F401
    BlockSpec,
    InputShape,
    MambaConfig,
    ModelConfig,
    MoEConfig,
    PortConfig,
    RWKVConfig,
    SHAPES,
    shape_applicable,
)

_MODULES = {
    "dbrx-132b": "repro_torch.configs.dbrx_132b",
    "granite-moe-1b-a400m": "repro_torch.configs.granite_moe_1b_a400m",
    "llama-3.2-vision-90b": "repro_torch.configs.llama_3_2_vision_90b",
    "llama3-8b": "repro_torch.configs.llama3_8b",
    "smollm-135m": "repro_torch.configs.smollm_135m",
    "glm4-9b": "repro_torch.configs.glm4_9b",
    "command-r-plus-104b": "repro_torch.configs.command_r_plus_104b",
    "jamba-1.5-large-398b": "repro_torch.configs.jamba_1_5_large_398b",
    "rwkv6-3b": "repro_torch.configs.rwkv6_3b",
    "musicgen-large": "repro_torch.configs.musicgen_large",
}

# models of the port alone (``PortConfig``s): the JAX package computes
# none of them, so they stay out of ``ARCHS``, the ten it mirrors
_PORT_MODULES = {
    "jamba2-mini": "repro_torch.configs.jamba2_mini",
}

ARCHS = tuple(_MODULES)


def get_config(arch_id: str) -> ModelConfig:
    mods = {**_MODULES, **_PORT_MODULES}
    if arch_id not in mods:
        raise KeyError(f"unknown arch {arch_id!r}; known: {sorted(mods)}")
    return importlib.import_module(mods[arch_id]).CONFIG


def optimized(cfg: ModelConfig) -> ModelConfig:
    """The §Perf-proven beyond-paper flags, per family (EXPERIMENTS.md):
    ZeRO-3 weight sharding, scatter KV updates, TP-resident serve params,
    vocab-parallel greedy decode, flash-decoding; expert-parallel
    shard_map MoE for MoE archs; context-parallel attention when heads
    cannot split the 16-way model axis."""
    import dataclasses as _dc
    over: dict = dict(fsdp_dim="output", kv_update="dus",
                      serve_fsdp=False, decode_return="token",
                      decode_attn="flashdecode")
    if cfg.moe is not None:
        over["moe_shard"] = "ep_a2a"
    if cfg.n_heads and cfg.n_heads % 16 != 0:
        over["attn_seq_shard"] = True
    return _dc.replace(cfg, **over)
