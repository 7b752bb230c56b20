"""cMPI's cross-pod gradient schedule, over the port's ``Comm`` (the JAX
package's ``repro.distributed.schedules``).

The paper's lesson (route traffic over the cheapest memory-like fabric,
and keep the expensive hop THIN) is a hierarchical gradient sync:

    in-pod reduce-scatter over ``data`` (full bytes)
      -> cross-pod allreduce over ``pod`` on 1/|data| of the bytes,
         optionally int8-compressed (compression.py)
      -> in-pod allgather over ``data``

In the JAX package these are ``psum_scatter``/``psum``/``all_gather`` in a
``shard_map``. Here they are the port's own collectives, so a training
step's gradients literally cross the shared pool: a CUDA gradient enters
and leaves it through the ``cellcopy`` kernel (the collectives take the
input's device). ``make_cmpi_train_step`` builds the per-rank step:
params and optimizer state replicated, the batch split over the dp axes.
It targets the small configs (smollm, granite), as the JAX package's
does.
"""
from __future__ import annotations

import torch

from repro_torch.core.comm import Comm
from repro_torch.distributed import compression as C
from repro_torch.distributed.context import DistContext
from repro_torch.models import lm
from repro_torch.train import optimizer as opt


def sync_grads(grads, data_comm: Comm, pod_comm: Comm | None = None,
               compression: str = "none"):
    """The hierarchical gradient allreduce of every leaf, collective over
    ``data_comm`` and ``pod_comm``: flattened in f32 and zero-padded to a
    multiple of the data size n, its n blocks reduce-scattered over
    ``data_comm`` (rank d holds the sum of block d, the JAX package's
    ``psum_scatter(tiled=False)``), that shard summed over ``pod_comm``
    (``psum_int8`` under ``compression="int8"``: one scale for the whole
    shard, as there), the shards allgathered over ``data_comm`` in rank
    order and reshaped. Returns the tree of f32 sums. However large a
    leaf, the collectives bound the pool they lease (``Comm``'s
    ``lease_cap``)."""
    if compression not in ("none", "int8"):
        raise ValueError(f"compression {compression!r}: 'none' or 'int8'")
    n = data_comm.size

    def leaf(g):
        gf = g.float().reshape(-1)
        pad = (-gf.numel()) % n
        if pad:
            gf = torch.cat([gf, gf.new_zeros(pad)])
        # the ring reduce-scatter leaves block (d + 1) % n on rank d: the
        # blocks go in rolled by one, so that rank d holds block d
        shard = data_comm.reduce_scatter(torch.roll(gf.reshape(n, -1), 1, 0))
        if pod_comm is not None:
            shard = (C.psum_int8(shard, pod_comm) if compression == "int8"
                     else pod_comm.allreduce(shard))
        full = data_comm.allgather(shard)
        return full[:g.numel()].reshape(g.shape)

    return lm.tree_unflatten(grads, [leaf(g) for g in lm.tree_leaves(grads)])


class CmpiTrainStep:
    """One rank's training step with the explicit cMPI gradient sync:
    ``grads`` (``loss_fn`` on the rank's rows of the batch, backward),
    ``sync`` (``sync_grads``, then / dp_total), ``update`` (the loss and
    metrics averaged over dp, ``optimizer.apply_updates`` in place).
    Calling it runs the three."""

    def __init__(self, cfg, dist: DistContext, oc: opt.OptConfig,
                 compression: str):
        self.cfg, self.dist, self.oc = cfg, dist, oc
        self.compression = compression
        self.data_comm = dist.comms[dist.dp[-1]]
        self.pod_comm = dist.comms["pod"] if "pod" in dist.dp else None

    def grads(self, params, batch) -> tuple:
        """(gradient tree, metrics) of ``loss_fn`` on the rank's rows of
        the global ``batch``; a leaf the loss does not reach gets zeros,
        as ``jax.value_and_grad`` gives it."""
        leaves = list(lm.tree_leaves(params))
        for p in leaves:
            p.requires_grad_(True)
        total, metrics = lm.loss_fn(params, self.cfg,
                                    self.dist.shard_batch(batch))
        total.backward()
        grads = lm.tree_unflatten(params, [
            torch.zeros_like(p) if p.grad is None else p.grad
            for p in leaves])
        for p in leaves:
            p.grad = None
        return grads, dict(metrics, loss=total.detach())

    def sync(self, grads):
        """The gradients summed over the dp ranks, then averaged."""
        n = self.dist.dp_size
        grads = sync_grads(grads, self.data_comm, self.pod_comm,
                           self.compression)
        return lm.tree_unflatten(grads, [g / n for g in
                                         lm.tree_leaves(grads)])

    def update(self, params, opt_state, grads, metrics) -> dict:
        """Each metric's mean over the dp ranks (one allreduce of them
        all); ``apply_updates`` in place on ``params`` and
        ``opt_state``. Returns the metrics with the optimizer's."""
        keys = sorted(metrics)
        vec = torch.stack([metrics[k].detach().float() for k in keys])
        vec = self.dist.dp_comm.allreduce(vec) / self.dist.dp_size
        _, _, om = opt.apply_updates(self.oc, params, grads, opt_state)
        return dict(zip(keys, vec.unbind()), **om)

    def __call__(self, params, opt_state, batch) -> tuple:
        grads, metrics = self.grads(params, batch)
        grads = self.sync(grads)
        return params, opt_state, self.update(params, opt_state, grads,
                                              metrics)


def make_cmpi_train_step(cfg, shape, dist: DistContext, *, oc=None,
                         compression: str = "none") -> CmpiTrainStep:
    """The per-rank train step with the EXPLICIT cMPI gradient sync.

    The global batch is split over the dp axes; params and optimizer
    state are replicated and updated in place. The loss is the rank's
    local mean; the gradients are synchronized by ``sync_grads`` and
    divided by the dp size; the returned ``loss`` (the total, with the
    MoE term) and metrics are their means over dp, as the JAX package's
    ``pmean``s. No other collective touches the gradients."""
    if not dist.dp:
        raise ValueError("make_cmpi_train_step needs a data-parallel axis")
    if shape.global_batch % dist.dp_size:
        raise ValueError(f"global batch {shape.global_batch} does not "
                         f"split over {dist.dp_size} data-parallel ranks")
    return CmpiTrainStep(cfg, dist, oc or opt.for_model(cfg), compression)
