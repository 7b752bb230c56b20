"""Gradient compression for the thin cross-pod hop (the JAX package's
``repro.distributed.compression``).

cMPI's lesson is that the thin fabric (the CXL link there, the pod axis
here) must carry as few bytes as possible. After the in-pod
reduce-scatter each rank owns 1/|data| of the gradient; the cross-pod
exchange of that shard is quantized to int8 with one scale per block
(block = last axis).

``psum_int8`` sums the quantized values in int32 (an exact integer
allreduce) and rescales once by the largest scale of the ranks, as the
JAX package does. That rescale is its fault, reproduced here on purpose
(``ROADMAP.md`` Queue 3): each rank quantized with its own scale, so a
rank whose block is small contributes q ~ 127 that the larger scale
then inflates. The error is bounded by scale/2 per element only when the
ranks' scales agree.
"""
from __future__ import annotations

import torch

from repro_torch.core.comm import Comm
from repro_torch.models.lm import tree_leaves, tree_unflatten

def int8_encode(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """-> (q int8, scale f32 per last-axis block)."""
    xf = x.float()
    amax = xf.abs().amax(dim=-1, keepdim=True)
    scale = torch.clamp(amax / 127.0, min=1e-12)
    q = torch.clamp(torch.round(xf / scale), -127, 127).to(torch.int8)
    return q, scale


def int8_decode(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale


def quantize_error(x: torch.Tensor) -> torch.Tensor:
    q, s = int8_encode(x)
    return x.float() - int8_decode(q, s)


def psum_int8(x: torch.Tensor, comm: Comm) -> torch.Tensor:
    """Compressed sum over ``comm``: int8-quantize locally, allreduce the
    quantized values in int32 (exact), and apply the ranks' largest
    scale (a max-allreduce of the scales): one quantized value per
    element and one scale per block. The result
    is the JAX package's ``psum_int8``, its scale fault included (see the
    module docstring)."""
    q, scale = int8_encode(x)
    qsum = comm.allreduce(q.to(torch.int32))
    smax = comm.allreduce(scale, op=torch.maximum)
    return (qsum.float() * smax).to(x.dtype)


class ErrorFeedback:
    """Residual carry: feed the quantization error into the next step's
    gradients. The state is a tree of f32 residuals shaped as the
    gradient tree."""

    @staticmethod
    def init(grads):
        return tree_unflatten(grads, [torch.zeros(g.shape,
                                                  dtype=torch.float32,
                                                  device=g.device)
                                      for g in tree_leaves(grads)])

    @staticmethod
    def apply(grads, residual):
        """-> (compensated grads, fn(compressed) -> new residual)."""
        comp = tree_unflatten(grads, [
            g.float() + r for g, r in zip(tree_leaves(grads),
                                          tree_leaves(residual))])

        def new_residual(compressed):
            return tree_unflatten(comp, [
                c - d.float() for c, d in zip(tree_leaves(comp),
                                              tree_leaves(compressed))])

        return comp, new_residual
