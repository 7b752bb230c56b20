"""Optimizers: AdamW, Adafactor and SGD over the port's parameter trees.

The JAX package's ``train/optimizer.py`` in torch ops. State tensors
mirror the parameter tree (Adafactor keeps the factored second moment
for tensors whose last two dims are both >= ``factored_dims_min``). All
update math is f32; parameters keep ``cfg.param_dtype``. Leaves are
walked in ``lm.tree_leaves`` order, ``jax.tree.leaves``' order, and
``params["blocks"]`` holds real tuples.

The JAX package returns new trees; ``apply_updates`` here writes the new
parameters and moments into the tensors it is given (same arithmetic,
half the memory) and returns them. Every scalar (the step count, the
learning rate, the gradient norm) stays a tensor on the parameters'
device, so a step reads nothing back to the host.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any

import torch

from repro_torch.models.lm import _tree_map, tree_leaves

Params = Any


@dataclass(frozen=True)
class OptConfig:
    name: str = "adamw"            # adamw | adafactor | sgd
    lr: float = 3e-4
    warmup_steps: int = 100
    decay_steps: int = 10_000
    min_lr_ratio: float = 0.1
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    # adafactor
    factored_dims_min: int = 128   # factor 2nd moment only if both dims >= this


def lr_at(oc: OptConfig, step) -> torch.Tensor:
    """Linear warmup -> cosine decay to min_lr_ratio, as an f32 tensor on
    ``step``'s device (``step``: an int or an integer tensor)."""
    step = torch.as_tensor(step).float()
    warm = torch.clamp((step + 1) / max(oc.warmup_steps, 1), max=1.0)
    prog = torch.clamp((step - oc.warmup_steps)
                       / max(oc.decay_steps - oc.warmup_steps, 1), 0.0, 1.0)
    cos = 0.5 * (1 + torch.cos(math.pi * prog))
    return oc.lr * warm * (oc.min_lr_ratio + (1 - oc.min_lr_ratio) * cos)


# --------------------------------------------------------------------------
# state init
# --------------------------------------------------------------------------

def _factored(shape, oc: OptConfig) -> bool:
    return (len(shape) >= 2
            and shape[-1] >= oc.factored_dims_min
            and shape[-2] >= oc.factored_dims_min)


def _zeros(shape, like: torch.Tensor) -> torch.Tensor:
    return torch.zeros(shape, dtype=torch.float32, device=like.device)


def init(oc: OptConfig, params: Params) -> Params:
    """Zero state on the parameters' device; ``count`` an int32 scalar."""
    first = next(tree_leaves(params))
    count = torch.zeros((), dtype=torch.int32, device=first.device)
    if oc.name == "adamw":
        return {"mu": _tree_map(lambda p: _zeros(p.shape, p), params),
                "nu": _tree_map(lambda p: _zeros(p.shape, p), params),
                "count": count}
    if oc.name == "adafactor":
        def vr(p):
            if _factored(p.shape, oc):
                return _zeros(p.shape[:-1], p)                  # row stats
            return _zeros((), p)

        def vc(p):
            if _factored(p.shape, oc):
                return _zeros(p.shape[:-2] + p.shape[-1:], p)
            return _zeros(p.shape, p)                           # full 2nd mom

        return {"vr": _tree_map(vr, params), "vc": _tree_map(vc, params),
                "count": count}
    if oc.name == "sgd":
        return {"count": count}
    raise ValueError(oc.name)


def state_specs(oc: OptConfig, param_shapes: Params) -> Params:
    """The state's shapes and dtypes as tensors on the ``meta`` device
    (the JAX package's ``jax.eval_shape``); ``param_shapes`` is any tree
    of tensors, e.g. ``lm.init(cfg, device="meta")``."""
    return init(oc, _tree_map(
        lambda p: torch.empty(p.shape, dtype=p.dtype, device="meta"),
        param_shapes))


# --------------------------------------------------------------------------
# update
# --------------------------------------------------------------------------

def global_norm(tree) -> torch.Tensor:
    leaves = [torch.sum(torch.square(x.float())) for x in tree_leaves(tree)]
    return torch.sqrt(torch.sum(torch.stack(leaves)))


def clip_by_global_norm(grads, max_norm: float):
    """(f32 grads scaled to a global norm of at most ``max_norm``, the
    norm before scaling)."""
    gn = global_norm(grads)
    scale = _clip_scale(gn, max_norm)
    return _tree_map(lambda g: g.float() * scale, grads), gn


def _clip_scale(gn: torch.Tensor, max_norm: float) -> torch.Tensor:
    return torch.clamp(max_norm / torch.clamp(gn, min=1e-9), max=1.0)


def _write(p: torch.Tensor, new_f32: torch.Tensor) -> None:
    p.copy_(new_f32.to(p.dtype))


@torch.no_grad()
def apply_updates(oc: OptConfig, params: Params, grads: Params,
                  state: Params) -> tuple[Params, Params, dict]:
    """One optimizer step, written into ``params`` and ``state`` (see the
    module docstring). Returns (params, state, metrics)."""
    # clip_by_global_norm, one leaf at a time (no second set of grads)
    gn = global_norm(grads)
    scale = _clip_scale(gn, oc.grad_clip)
    count = state["count"] + 1
    lr = lr_at(oc, state["count"])
    p_leaves = list(tree_leaves(params))
    g_leaves = (g.float() * scale for g in tree_leaves(grads))
    c = count.float()

    if oc.name == "adamw":
        b1, b2 = oc.b1, oc.b2
        bc1 = 1 - b1 ** c
        bc2 = 1 - b2 ** c
        for p, g, m, v in zip(p_leaves, g_leaves, tree_leaves(state["mu"]),
                              tree_leaves(state["nu"])):
            m.mul_(b1).add_((1 - b1) * g)
            v.mul_(b2).add_((1 - b2) * torch.square(g))
            step = (m / bc1) / (torch.sqrt(v / bc2) + oc.eps)
            if p.ndim >= 2:  # decoupled weight decay on matrices only
                step = step + oc.weight_decay * p.float()
            _write(p, p.float() - lr * step)

    elif oc.name == "adafactor":
        beta2 = 1.0 - c ** -0.8           # Adafactor's schedule
        eps = 1e-30
        for p, g, vr, vc in zip(p_leaves, g_leaves, tree_leaves(state["vr"]),
                                tree_leaves(state["vc"])):
            g2 = torch.square(g) + eps
            if _factored(p.shape, oc):
                vr.copy_(beta2 * vr + (1 - beta2) * g2.mean(dim=-1))
                vc.copy_(beta2 * vc + (1 - beta2) * g2.mean(dim=-2))
                denom = (vr / torch.clamp(vr.mean(dim=-1, keepdim=True),
                                          min=eps))[..., None] \
                    * vc[..., None, :]
                step = g / torch.sqrt(torch.clamp(denom, min=eps))
            else:
                vr.copy_(beta2 * vr + (1 - beta2) * g2.mean())
                vc.copy_(beta2 * vc + (1 - beta2) * g2)
                step = g / torch.sqrt(torch.clamp(vc, min=eps))
            # RMS update clipping (Adafactor d=1.0)
            rms = torch.sqrt(torch.mean(torch.square(step)) + eps)
            step = step / torch.clamp(rms, min=1.0)
            if p.ndim >= 2:
                step = step + oc.weight_decay * p.float()
            _write(p, p.float() - lr * step)

    elif oc.name == "sgd":
        for p, g in zip(p_leaves, g_leaves):
            _write(p, p.float() - lr * g)
    else:
        raise ValueError(oc.name)

    state["count"] = count
    return params, state, {"grad_norm": gn, "lr": lr}


def for_model(cfg) -> OptConfig:
    return OptConfig(name=cfg.optimizer)

