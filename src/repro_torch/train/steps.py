"""Step functions: train_step, serve_prefill, serve_decode (the JAX
package's ``repro.train.steps``).

Each ``make_*`` function closes over (cfg, dist) and returns the step
and its sharding trees (``distributed.sharding.P``, leaf for leaf the
JAX package's). ``dist`` is a ``DistContext`` (a rank's view of the
mesh), or None for one card with no collectives. The functions take the
global batch and compute on the rank's rows of it; they run where the
parameters lie.

Gradient accumulation bounds activation memory: the microbatch count is
chosen so that one microbatch holds ~TOKENS_PER_MICRO tokens a data
shard.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Any, Optional

import torch

from repro_torch.configs.base import InputShape, ModelConfig
from repro_torch.core.trace import NULL_TRACER, SP_DECODE, SP_PREFILL
from repro_torch.distributed import sharding as shd
from repro_torch.distributed.context import DistContext
from repro_torch.distributed.sharding import P
from repro_torch.models import lm
from repro_torch.train import optimizer as opt

TOKENS_PER_MICRO = 8_192   # per data shard, per microbatch


# --------------------------------------------------------------------------
# helpers
# --------------------------------------------------------------------------

def dp_total(mesh) -> int:
    t = 1
    for a in shd.dp_axes(mesh):
        t *= shd.axis_size(mesh, a)
    return t


def pick_grad_accum(shape: InputShape, mesh) -> int:
    """Microbatch count: divide the local batch until one microbatch is
    ~TOKENS_PER_MICRO tokens (>=1 sequence)."""
    local_seqs = max(1, shape.global_batch // dp_total(mesh))
    target = max(1, TOKENS_PER_MICRO // shape.seq_len)
    ga = max(1, local_seqs // max(target, 1))
    while local_seqs % ga:
        ga -= 1
    return ga


def make_dist(cfg: ModelConfig, shape: InputShape,
              dist: Optional[DistContext]) -> Optional[DistContext]:
    """``dist`` with ``batch_shardable`` set for ``shape`` (the global
    batch splits over more than one dp rank), over the same
    sub-communicators."""
    if dist is None:
        return None
    n = dp_total(dist)
    return dist.with_batch_shardable(shape.global_batch % n == 0 and n > 1)


def _model_partial(cfg: ModelConfig, dist: DistContext, path: str,
                   leaf) -> bool:
    """Whether a model rank's gradient of the leaf at ``path`` holds its
    own slice alone: the vocab table and head under the vocab-parallel
    functions, and a whole expert leaf under ``blocks.moe_apply_ep``."""
    if dist.model_size <= 1:
        return False
    if path.startswith(("embed", "head")):
        return dist.vocab_parallel(cfg)
    E = cfg.moe.n_experts if cfg.moe is not None else 0
    return (cfg.moe_shard == "ep_a2a" and E % dist.model_size == 0
            and path.endswith(("w_gate", "w_up", "w_down"))
            and leaf.ndim == 4 and leaf.shape[1] == E)


def _aux_is_shard_0s(cfg: ModelConfig, dist: DistContext) -> bool:
    """Whether the MoE layers run ``blocks.moe_apply_ep``, whose aux the
    JAX package returns from data shard 0 on every shard (its
    ``shard_map`` declares ``out_specs=P()`` unchecked), so that its
    step reports shard 0's aux in ``loss`` and ``aux``; the gradient is
    still the mean of the shards' aux gradients."""
    return (cfg.moe is not None and cfg.moe_shard == "ep_a2a"
            and dist.model_size > 1
            and cfg.moe.n_experts % dist.model_size == 0)


def reduce_grads(cfg: ModelConfig, dist: Optional[DistContext], params,
                 grads: list) -> list:
    """The gradients of the global batch from a rank's ``grads`` (leaves
    in ``lm.tree_leaves`` order): each leaf a model rank holds a slice
    of summed over ``model``, then every leaf averaged over the dp ranks
    where they took different rows. Other leaves are computed whole on
    every model rank, and are not summed."""
    if dist is None:
        return grads
    out = []
    for path, p, g in zip(shd.leaf_paths(params), lm.tree_leaves(params),
                          grads):
        if _model_partial(cfg, dist, path, p):
            g = dist.comms["model"].allreduce(g.contiguous())
        if dist.bspec is not None:
            g = dist.dp_comm.allreduce(g.contiguous()) / dist.dp_size
        out.append(g)
    return out


# --------------------------------------------------------------------------
# train
# --------------------------------------------------------------------------

@dataclass(frozen=True)
class TrainStep:
    fn: Any                  # (params, opt_state, batch) -> (p, o, metrics)
    in_shardings: tuple      # (params, opt_state, batch)
    out_shardings: tuple
    grad_accum: int
    grads: Any               # (params, batch) -> (grads, metrics)


def make_train_step(cfg: ModelConfig, shape: InputShape,
                    dist: Optional[DistContext], *,
                    oc: Optional[opt.OptConfig] = None,
                    grad_accum: Optional[int] = None) -> TrainStep:
    """The train step with ``ga`` microbatches (``pick_grad_accum`` unless
    given), the JAX package's ``lax.scan`` over microbatches of its global
    batch.

    ``grads(params, batch)`` splits the global batch into ``ga``
    microbatches of consecutive rows, takes the rank's rows of each
    (``shard_batch``), runs ``loss_fn`` and ``backward`` on each and sums
    the gradients in f32, divides by ``ga`` (at ``ga == 1`` the gradients
    are taken as they are) and reduces them over the ranks
    (``reduce_grads``). It returns them with the metrics: the means over
    microbatches, then over the dp ranks (``tokens`` their sum), except
    that under ``blocks.moe_apply_ep`` ``aux``, and the aux term of
    ``loss``, are data shard 0's, as the JAX package reports them.
    ``fn(params, opt_state, batch)`` runs ``grads`` and then
    ``apply_updates`` in place."""
    oc = oc or opt.for_model(cfg)
    ga = pick_grad_accum(shape, dist) if grad_accum is None else grad_accum
    d = make_dist(cfg, shape, dist)
    if shape.global_batch % ga or (
            d is not None and d.bspec is not None
            and (shape.global_batch // ga) % d.dp_size):
        raise ValueError(f"global batch {shape.global_batch} does not split "
                         f"into {ga} microbatches over the dp ranks")

    def grads_of(params, batch):
        leaves = list(lm.tree_leaves(params))
        for p in leaves:
            p.requires_grad_(True)
        rows = next(iter(batch.values())).shape[0] // ga
        acc, stats = None, []
        for i in range(ga):
            mb = {k: v[i * rows:(i + 1) * rows] for k, v in batch.items()}
            if d is not None:
                mb = d.shard_batch(mb)
            total, m = lm.loss_fn(params, cfg, mb, dist=d)
            total.backward()
            g = [torch.zeros_like(p) if p.grad is None else p.grad
                 for p in leaves]
            for p in leaves:
                p.grad = None
            if ga == 1:
                acc = g
            elif acc is None:
                acc = [x.float() for x in g]
            else:
                for a, x in zip(acc, g):
                    a.add_(x.float())
            stats.append(torch.stack([total.detach(), m["aux"].detach(),
                                      m["tokens"].detach()]))
        grads = acc if ga == 1 else [a / ga for a in acc]
        total, aux, tokens = torch.stack(stats).mean(0).unbind()
        if d is not None and d.bspec is not None:
            if _aux_is_shard_0s(cfg, d):
                # the dp mean below then gives data shard 0's aux, and
                # the mean total with its aux term swapped for shard 0's
                w = d.dp_size if d.dp_index == 0 else 0
                total = total + lm.AUX_WEIGHT * (w - 1) * aux
                aux = w * aux
            vec = d.dp_comm.allreduce(torch.stack([total, aux, tokens]))
            total, aux, tokens = (vec * torch.tensor(
                [1 / d.dp_size, 1 / d.dp_size, 1.0],
                device=vec.device)).unbind()
        return (lm.tree_unflatten(params, reduce_grads(cfg, d, params,
                                                       grads)),
                {"loss": total, "aux": aux, "tokens": tokens})

    def train_step(params, opt_state, batch):
        grads, metrics = grads_of(params, batch)
        _, _, om = opt.apply_updates(oc, params, grads, opt_state)
        return params, opt_state, dict(metrics, **om)

    pspec = shd.param_pspecs(cfg, dist)
    ospec = opt_specs(cfg, dist, oc, pspec)
    bspec = shd.batch_pspecs(cfg, shape, dist)
    mspec = {k: P() for k in ("loss", "aux", "tokens", "grad_norm", "lr")}
    return TrainStep(fn=train_step, in_shardings=(pspec, ospec, bspec),
                     out_shardings=(pspec, ospec, mspec), grad_accum=ga,
                     grads=grads_of)


def opt_specs(cfg: ModelConfig, mesh, oc: opt.OptConfig, pspec):
    """Specs for the optimizer state (ZeRO-1 over ``data``)."""
    pshapes = lm.param_specs(cfg)
    sshapes = opt.state_specs(oc, pshapes)

    if oc.name == "adamw":
        mom = shd.opt_state_pspecs(cfg, mesh, pspec, pshapes)
        return {"mu": mom, "nu": mom, "count": P()}
    if oc.name == "adafactor":
        def drop_last(spec: P, leaf, full) -> P:
            parts = (list(spec) + [None] * len(full.shape))[: len(full.shape)]
            return P(*parts[: len(leaf.shape)])

        vr = shd.map_leaves(drop_last, sshapes["vr"], shd.spec_leaves(pspec),
                            lm.tree_leaves(sshapes["vr"]),
                            lm.tree_leaves(pshapes))

        # vc drops the second-to-last dim: take spec minus that axis
        def vc_spec(spec: P, leaf, full) -> P:
            parts = list(spec) + [None] * (len(full.shape) - len(spec))
            if len(leaf.shape) == len(full.shape):       # unfactored
                return P(*parts)
            parts = parts[:-2] + [parts[-1]]
            return P(*parts[: len(leaf.shape)])

        vc = shd.map_leaves(vc_spec, sshapes["vc"], shd.spec_leaves(pspec),
                            lm.tree_leaves(sshapes["vc"]),
                            lm.tree_leaves(pshapes))
        return {"vr": vr, "vc": vc, "count": P()}
    return {"count": P()}


# --------------------------------------------------------------------------
# serve
# --------------------------------------------------------------------------

@dataclass(frozen=True)
class ServeStep:
    fn: Any
    in_shardings: tuple
    out_shardings: Any


def make_serve_prefill(cfg: ModelConfig, shape: InputShape,
                       dist: Optional[DistContext]) -> ServeStep:
    """``fn(params, batch, state=None)``: ``lm.prefill`` of the rank's
    rows of the global batch, without autograd; the rank's last-position
    logits. Given ``state`` (the rank's ``lm.decode_state_init`` at its
    rows, zeros), the prefill also fills it, as a prefill server hands a
    request to decode (attention and Mamba layers; ``lm.forward``), and
    ``fn`` returns (logits, state): ``make_serve_decode``'s step then
    goes on from position ``shape.seq_len``."""
    d = make_dist(cfg, shape, dist)
    tr = d.tracer if d is not None else NULL_TRACER

    @torch.no_grad()
    def serve_prefill(params, batch, state=None):
        sp = -1
        if tr.enabled:
            sp = tr.push_span(SP_PREFILL)
        try:
            if d is not None:
                batch = d.shard_batch(batch)
            logits = lm.prefill(params, cfg, batch, dist=d, state=state)
            return logits if state is None else (logits, state)
        finally:
            if tr.enabled:
                tr.pop_span(sp)

    pspec = shd.param_pspecs(cfg, dist, serve=True)
    bspec = dict(shd.batch_pspecs(
        cfg, dataclasses.replace(shape, kind="prefill"), dist))
    bspec.pop("labels", None)
    bdim = bspec[next(iter(bspec))][0]
    return ServeStep(fn=serve_prefill, in_shardings=(pspec, bspec),
                     out_shardings=P(bdim, None))


def make_serve_decode(cfg: ModelConfig, shape: InputShape,
                      dist: Optional[DistContext]) -> ServeStep:
    """``fn(params, state, batch, pos)``: one ``lm.decode_step`` of the
    rank's rows of the global batch and ``pos`` (B,), without autograd.
    ``state`` is the rank's: ``lm.decode_state_init`` at its rows, the
    caches whole (its specs split them over ``model`` too, a placement
    the port does not compute on), updated in place. Returns (the rank's
    logits, or its greedy tokens where ``decode_return == "token"`` and
    the vocab is split over ``model``; the state)."""
    d = make_dist(cfg, shape, dist)
    tr = d.tracer if d is not None else NULL_TRACER

    @torch.no_grad()
    def serve_decode(params, state, batch, pos):
        sp = -1
        if tr.enabled:
            sp = tr.push_span(SP_DECODE)
        try:
            if d is not None:
                batch = d.shard_batch(batch)
                pos = d.shard_batch({"pos": pos})["pos"]
            return lm.decode_step(params, cfg, state, batch, pos, dist=d)
        finally:
            if tr.enabled:
                tr.pop_span(sp)

    pspec = shd.param_pspecs(cfg, dist, serve=True)
    sspec = shd.decode_state_pspecs(cfg, shape, dist)
    one = dataclasses.replace(shape, seq_len=1)
    bspec = dict(shd.batch_pspecs(
        cfg, dataclasses.replace(one, kind="decode"), dist))
    bspec.pop("labels", None)
    bspec.pop("ctx", None)     # cross-attn context lives in the static cache
    bdim = bspec[next(iter(bspec))][0]
    token_mode = (cfg.decode_return == "token" and d is not None
                  and d.vocab_parallel(cfg))
    out0 = P(bdim) if token_mode else P(bdim, None)
    return ServeStep(fn=serve_decode,
                     in_shardings=(pspec, sspec, bspec, P(bdim)),
                     out_shardings=(out0, sspec))
