"""DistContext: a rank's view of the mesh (the JAX package's
``repro.distributed.context``).

In the JAX package a ``DistContext`` carries a device mesh, and its
vocab-parallel functions are ``shard_map``s over it. In the port each
device of that mesh is a rank of a ``Comm`` (one process, or one thread,
on one card), and the mesh's axes are sub-communicators split from it.
Ranks map to mesh coordinates in the device order of the JAX package's
``launch.mesh.make_test_mesh`` (row-major: the last axis varies
fastest), so rank r holds the shard that device r holds there.

  * ``constrain_act``, ``constrain_seq``, ``constrain_kv`` and
    ``constrain_scores`` are identities: each rank already holds its
    local tensor, so there is no layout for a compiler to constrain.
  * ``shard_batch`` cuts a global batch to the rank's rows over the dp
    axes (``bspec``), and ``shard_leaf`` any tensor to the rank's block
    under a spec of ``distributed.sharding``: the block device r holds
    under the JAX package's ``NamedSharding`` of the same spec.
  * ``vp_embed``, ``vp_cross_entropy`` and ``vp_greedy_token`` compute on
    the rank's vocab slice of the (replicated) table and reduce over the
    ``model`` communicator: sum, max and min allreduces.

Under autograd every collective inside a loss is an
``autograd.Function`` with the gradient the JAX package's ``jax.grad``
computes through its ``shard_map``: a sum whose result every rank uses
(the replicated downstream loss) passes its gradient through unchanged,
and an activation that enters the rank's vocab slice replicated over
``model`` gets its gradient summed over ``model`` (the transpose of a
replicated input). The max of the cross-entropy is a constant shift,
taken without gradient as there.
"""
from __future__ import annotations

import copy
import math
from typing import Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.comm import Comm
from repro_torch.core.trace import NULL_TRACER

AXES = ("pod", "data", "model")


class _SumOver(torch.autograd.Function):
    """Forward: the sum over ``comm``'s ranks. Backward: the gradient as
    it is (every rank uses the sum, and computes its own part of the
    loss's gradient from it)."""

    @staticmethod
    def forward(ctx, x, comm):
        return comm.allreduce(x.contiguous())

    @staticmethod
    def backward(ctx, g):
        return g, None


class _Replicated(torch.autograd.Function):
    """Forward: the input as it is, replicated over ``comm``'s ranks.
    Backward: the gradient summed over the ranks, each of which used the
    input on its own slice."""

    @staticmethod
    def forward(ctx, x, comm):
        ctx.comm = comm
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return ctx.comm.allreduce(g.contiguous()), None


class _OnceOver(torch.autograd.Function):
    """Forward: the input as it is. Backward: the gradient / ``n``: a
    value each of ``n`` ranks computes alike from inputs whose gradient
    is then summed over them (``_Replicated``), so that it counts once."""

    @staticmethod
    def forward(ctx, x, n):
        ctx.n = n
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g / ctx.n, None


class DistContext:
    """``comm``'s ranks as a mesh of ``shape`` over ``axes`` (a subset of
    ``("pod", "data", "model")`` in that order, as the JAX package's
    meshes name them). Building it is collective over ``comm``: every
    rank splits one sub-communicator per axis and one over the
    data-parallel axes together.

    ``batch_shardable`` is the JAX package's flag: False where the global
    batch does not split over the dp axes, and then every dp rank takes
    the whole batch (``bspec`` is None). ``with_batch_shardable`` gives a
    copy with only the flag changed, over the same sub-communicators."""

    def __init__(self, comm: Comm, shape: tuple[int, ...],
                 axes: tuple[str, ...] = ("data", "model"), *,
                 batch_shardable: bool = True):
        if len(shape) != len(axes) or [a for a in AXES if a in axes] \
                != list(axes):
            raise ValueError(f"mesh axes {axes} of shape {shape}: a "
                             f"subset of {AXES} in that order, one size "
                             "each")
        if math.prod(shape) != comm.size:
            raise ValueError(f"mesh {dict(zip(axes, shape))} has "
                             f"{math.prod(shape)} devices; the comm has "
                             f"{comm.size} ranks")
        self.comm = comm
        self.batch_shardable = batch_shardable
        self.shape = dict(zip(axes, shape))
        coords, r = {}, comm.rank
        for a in reversed(axes):
            coords[a] = r % self.shape[a]
            r //= self.shape[a]
        self.coords = {a: coords[a] for a in axes}
        # one sub-communicator per axis: the ranks that differ only in
        # that axis' coordinate, ranked by it
        self.comms: dict[str, Comm] = {}
        for a in axes:
            rest = [self.coords[b] for b in axes if b != a]
            self.comms[a] = comm.split(self._flat(rest, a), key=self.coords[a])
        dp = self.dp
        rest = [self.coords[b] for b in axes if b not in dp]
        self.dp_comm: Optional[Comm] = comm.split(
            self._flat(rest, *dp), key=self.dp_index) if dp else None

    @property
    def tracer(self):
        """The tracer of the communicator the mesh is built over, which
        its sub-communicators share: the model code's spans go there."""
        return getattr(self.comm, "tracer", NULL_TRACER)

    def with_batch_shardable(self, flag: bool) -> "DistContext":
        """This context with ``batch_shardable`` set to ``flag`` (no
        collective: the sub-communicators are shared)."""
        out = copy.copy(self)
        out.batch_shardable = flag
        return out

    def _flat(self, coords: list[int], *skip: str) -> int:
        """Row-major index of ``coords`` over the axes not in ``skip``."""
        i = 0
        for c, a in zip(coords, [a for a in self.shape if a not in skip]):
            i = i * self.shape[a] + c
        return i

    # ------------------------------------------------------------------
    @property
    def dp(self) -> tuple[str, ...]:
        return tuple(a for a in ("pod", "data") if a in self.shape)

    @property
    def dp_size(self) -> int:
        return math.prod(self.shape[a] for a in self.dp)

    @property
    def dp_index(self) -> int:
        """This rank's block of a batch split over the dp axes in
        ``P(("pod", "data"))`` order."""
        return self._flat([self.coords[a] for a in self.dp],
                          *[a for a in self.shape if a not in self.dp])

    @property
    def bspec(self) -> Optional[tuple[str, ...]]:
        """The batch dim's spec: the dp axes where the batch splits over
        them, else None (replicated)."""
        return self.dp if (self.dp and self.batch_shardable) else None

    @property
    def model_size(self) -> int:
        return self.shape.get("model", 1)

    def axis_index(self, name: str) -> int:
        return self.coords.get(name, 0)

    def shard_batch(self, batch: dict) -> dict:
        """This rank's rows of a global batch split over the dp axes
        (leading axis), as the JAX package's ``P(("pod", "data"))``; the
        whole batch where ``bspec`` is None."""
        if self.bspec is None:
            return batch
        return {k: self.shard_leaf(v, (self.bspec,), name=f"batch[{k!r}]")
                for k, v in batch.items()}

    def shard_leaf(self, x, spec, *, name: str = "leaf"):
        """This rank's block of ``x`` under ``spec`` (one entry a leading
        dim: None, an axis name, or a tuple of names; dims past the spec
        are whole). A dim split over several axes takes the row-major
        index of the rank's coordinates over them in the listed order, as
        ``NamedSharding`` lays it out. Every split dim must divide."""
        if len(spec) > x.ndim:
            raise ValueError(f"{name}: spec {tuple(spec)} has more entries "
                             f"than the {x.ndim} dims of {tuple(x.shape)}")
        for dim, part in enumerate(spec):
            if part is None:
                continue
            names = (part,) if isinstance(part, str) else tuple(part)
            n, i = 1, 0
            for a in names:
                if a not in self.shape:
                    raise ValueError(f"{name}: axis {a!r} is not in the mesh "
                                     f"{self.shape}")
                n *= self.shape[a]
                i = i * self.shape[a] + self.coords[a]
            if x.shape[dim] % n:
                raise ValueError(f"{name}: dim {dim} of {tuple(x.shape)} "
                                 f"does not split over {names} ({n} ways)")
            per = x.shape[dim] // n
            x = x.narrow(dim, i * per, per)
        return x

    # the JAX package's sharding constraints: each rank holds its local
    # tensor, so there is nothing to constrain
    def constrain_act(self, x):
        return x

    def constrain_seq(self, x):
        return x

    def constrain_kv(self, x):
        return x

    def constrain_scores(self, x):
        return x

    def vocab_parallel(self, cfg: ModelConfig) -> bool:
        return (cfg.vocab_parallel and self.model_size > 1
                and cfg.padded_vocab % self.model_size == 0)

    # the collectives of a layer computed per model rank (the
    # expert-parallel MoE), with the gradients of the shard_map's
    def sum_over_model(self, x):
        """The sum of ``x`` over ``model``; its gradient as it is."""
        return _SumOver.apply(x, self.comms["model"])

    def replicated_over_model(self, x):
        """``x``, used by each model rank on its own part; its gradient
        summed over ``model``."""
        return _Replicated.apply(x, self.comms["model"])

    def once_over_model(self, x):
        """``x``, which every model rank computes alike; its gradient
        divided by the model size, so that the sum of a
        ``replicated_over_model`` input's gradient counts it once."""
        return _OnceOver.apply(x, self.model_size)

    def _slice(self, table, cfg: ModelConfig):
        """(this rank's rows of the (padded_vocab, D) table, their first
        global index, the slice's length)."""
        shard = cfg.padded_vocab // self.model_size
        lo = self.axis_index("model") * shard
        return table[lo:lo + shard], lo, shard

    # ------------------------------------------------------------------
    def vp_embed(self, table, tokens, cfg: ModelConfig):
        """The embedding rows of ``tokens`` (B, S) in the compute dtype:
        each rank looks up the tokens in its vocab slice (zeros for the
        others') and the rows are summed over ``model``."""
        tab, lo, shard = self._slice(table, cfg)
        local = tokens.long() - lo
        ok = (local >= 0) & (local < shard)
        x = tab[local.clamp(0, shard - 1)].to(getattr(torch,
                                                      cfg.compute_dtype))
        x = torch.where(ok[..., None], x, torch.zeros((), dtype=x.dtype,
                                                      device=x.device))
        return _SumOver.apply(x, self.comms["model"])

    def vp_cross_entropy(self, head, x, labels, cfg: ModelConfig):
        """Per-token cross-entropy (B, S) in f32 without the full logits:
        the rank's logits slice, their max over ``model`` (a constant
        shift, without gradient), the sums of exp and of the label's
        logit over ``model``."""
        hd, lo, shard = self._slice(head, cfg)
        comm = self.comms["model"]
        x = _Replicated.apply(x, comm)
        logits = (x @ hd.to(x.dtype).T).float()
        gidx = lo + torch.arange(shard, device=x.device)
        logits = torch.where(gidx < cfg.vocab_size, logits,
                             torch.full((), -1e30, device=x.device))
        m = comm.allreduce(logits.detach().amax(dim=-1), op=torch.maximum)
        s = _SumOver.apply(torch.exp(logits - m[..., None]).sum(dim=-1),
                           comm)
        local = labels.long() - lo
        ok = (local >= 0) & (local < shard)
        ll = torch.take_along_dim(logits, local.clamp(0, shard - 1)[..., None],
                                  dim=-1)[..., 0]
        ll = _SumOver.apply(torch.where(ok, ll, torch.zeros(
            (), device=x.device)), comm)
        return torch.log(s) + m - ll

    def vp_greedy_token(self, head, x, cfg: ModelConfig):
        """Greedy next token (B,) int32 without the (B, V) logits on any
        rank: the rank's argmax, then the largest max and the smallest
        index holding it over ``model`` (two scalars a row on the
        wire)."""
        hd, lo, shard = self._slice(head, cfg)
        comm = self.comms["model"]
        logits = (x @ hd.to(x.dtype).T).float()
        gidx = lo + torch.arange(shard, device=x.device)
        logits = torch.where(gidx < cfg.vocab_size, logits,
                             torch.full((), -math.inf, device=x.device))
        lmax = logits.amax(dim=-1)
        larg = logits.argmax(dim=-1).int() + lo
        gmax = comm.allreduce(lmax, op=torch.maximum)
        cand = torch.where(lmax >= gmax, larg, torch.full(
            (), cfg.padded_vocab, dtype=torch.int32, device=x.device))
        return comm.allreduce(cand, op=torch.minimum)
