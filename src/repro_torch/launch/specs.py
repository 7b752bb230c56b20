"""Meta-device stand-ins for every model input (the JAX package's
``repro.launch.specs``, whose ``ShapeDtypeStruct``s become tensors on the
``meta`` device): the dry run never allocates. ``batch_specs`` covers
the batch; params / optimizer / decode-state specs come from the
respective ``*_specs`` helpers of ``models.lm`` and ``train.optimizer``.

Modality frontends are stubs as in the JAX package: ``[audio]`` archs
receive precomputed frame embeddings (B, S, d_model); ``[vlm]`` archs
receive precomputed patch embeddings (B, n_ctx_tokens, d_model) as
cross-attention context.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import InputShape, ModelConfig
from repro_torch.models import lm
from repro_torch.train import optimizer as opt


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def batch_specs(cfg: ModelConfig, shape: InputShape) -> dict[str,
                                                             torch.Tensor]:
    B = shape.global_batch
    L = 1 if shape.kind == "decode" else shape.seq_len
    cdt = getattr(torch, cfg.compute_dtype)
    d: dict[str, torch.Tensor] = {}
    if cfg.frontend == "frames":
        d["frames"] = _meta((B, L, cfg.d_model), cdt)
    else:
        d["tokens"] = _meta((B, L), torch.int32)
    if shape.kind == "train":
        d["labels"] = _meta((B, L), torch.int32)
    if cfg.n_ctx_tokens and shape.kind != "decode":
        d["ctx"] = _meta((B, cfg.n_ctx_tokens, cfg.d_model), cdt)
    return d


def param_specs(cfg: ModelConfig):
    return lm.param_specs(cfg)


def opt_state_specs(cfg: ModelConfig, oc: opt.OptConfig | None = None):
    oc = oc or opt.for_model(cfg)
    return opt.state_specs(oc, lm.param_specs(cfg))


def decode_specs(cfg: ModelConfig, shape: InputShape):
    state = lm.decode_state_specs(cfg, shape.global_batch, shape.seq_len)
    pos = _meta((shape.global_batch,), torch.int32)
    return state, pos
