"""Divisibility-aware sharding rules (the JAX package's
``repro.distributed.sharding``), as a placement model of the port's ranks.

The mesh is 2D ``("data", "model")`` or 3D ``("pod", "data", "model")``:
anything with a ``.shape`` mapping of axis to size (a ``DistContext``,
or a stand-in such as the JAX package's tests' ``FakeMesh``), or None
for one card. A spec is a ``P``: per leading dim None, an axis name, or
a tuple of axis names, leaf for leaf the JAX package's
``PartitionSpec``. The rules are that package's, branch for branch:
weights tensor-parallel over ``model`` on flattened projection dims,
optionally FSDP over ``data`` (HSDP: replicated across pods), and any
rule whose dim does not divide by its axis falls back to replication
for that dim.

In the JAX package GSPMD lays the tensors out by these specs. In the
port they say where each leaf's blocks live, and
``DistContext.shard_leaf`` cuts a block by them; the model does not
become tensor-parallel. Attention and dense FFN weights stay whole on
every rank, and so do the KV caches of a rank's rows. The one place the
port computes on blocks is the expert-parallel MoE
(``blocks.moe_apply_ep``), whose expert leaves ``shard_experts`` cuts.
"""
from __future__ import annotations

from typing import Any, Optional

from repro_torch.configs.base import InputShape, ModelConfig
from repro_torch.models import lm


class P(tuple):
    """A partition spec: one entry a dim (None, an axis name, or a tuple
    of axis names); equal, as a tuple, to the JAX package's
    ``PartitionSpec`` of the same entries, which stores an entry of one
    name as the name and an empty one as None."""

    def __new__(cls, *parts):
        def canon(p):
            if isinstance(p, (tuple, list)):
                p = tuple(p)
                return None if not p else p[0] if len(p) == 1 else p
            return p
        return super().__new__(cls, map(canon, parts))

    def __repr__(self) -> str:
        return f"P{tuple.__repr__(self)}"


def _shape(mesh) -> dict:
    return {} if mesh is None else mesh.shape


def axis_size(mesh, name) -> int:
    return _shape(mesh).get(name, 1)


def dp_axes(mesh) -> tuple[str, ...]:
    return tuple(a for a in ("pod", "data") if a in _shape(mesh))


def _maybe(mesh, axis: Optional[str], dim: int) -> Optional[str]:
    """axis if dim is divisible by its size (and axis exists) else None."""
    if axis is None:
        return None
    sz = axis_size(mesh, axis)
    if sz > 1 and dim % sz == 0:
        return axis
    return None


def leaf_paths(tree, path: str = ""):
    """The paths of a tree's leaves in ``lm.tree_leaves`` order, as the
    JAX package's rules spell them: keys and indices joined by ``/``."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from leaf_paths(tree[k], f"{path}/{k}" if path else str(k))
    elif isinstance(tree, (tuple, list)):
        for i, v in enumerate(tree):
            yield from leaf_paths(v, f"{path}/{i}" if path else str(i))
    else:
        yield path


def spec_leaves(tree):
    """The ``P`` leaves of a spec tree, dict keys in sorted order (the
    order of ``jax.tree.leaves``)."""
    if isinstance(tree, P):
        yield tree
    elif isinstance(tree, dict):
        for k in sorted(tree):
            yield from spec_leaves(tree[k])
    else:
        for v in tree:
            yield from spec_leaves(v)


def map_leaves(fn, like, *leaves):
    """A tree shaped as ``like`` whose leaves are ``fn`` of the items of
    ``leaves`` (iterables in ``lm.tree_leaves`` order: a tree's leaves,
    ``leaf_paths``, ``spec_leaves``) taken together."""
    return lm.tree_unflatten(like, [fn(*xs) for xs in zip(*leaves)])


def param_pspecs(cfg: ModelConfig, mesh, *, serve: bool = False) -> Any:
    """Spec tree matching ``lm.init(cfg)``.

    ``serve=True`` drops FSDP unless cfg.serve_fsdp: a serving step reads
    every weight every step, so data-axis sharding of params turns into a
    per-step all-gather of the full model. TP-only layouts keep weights
    resident."""
    specs = lm.param_specs(cfg)
    shape = _shape(mesh)
    use_fsdp = cfg.fsdp and (cfg.serve_fsdp or not serve)
    fsdp = "data" if (use_fsdp and "data" in shape) else None
    m = "model" if "model" in shape else None

    def block_rule(path: str, dims) -> P:
        # all block leaves have leading n_groups dim
        if "norm" in path or path.endswith(("mix_k", "mix_r", "mix_x", "w0",
                                            "dt_bias", "conv_b", "D", "u")):
            if path.endswith(("w0", "dt_bias", "conv_b", "D")):
                return P(None, _maybe(mesh, m, dims[1]))
            return P(*([None] * len(dims)))
        if path.endswith(("wq", "w_gate", "w_up", "in_proj", "cm_k")) \
                and len(dims) == 3:
            if cfg.fsdp_dim == "output" and fsdp:
                # ZeRO-3: stack (model, data) on the OUTPUT dim
                both = _maybe(mesh, m, dims[2])
                if both and dims[2] % (axis_size(mesh, m)
                                       * axis_size(mesh, fsdp)) == 0:
                    return P(None, None, (m, fsdp))
                return P(None, None, both)
            return P(None, _maybe(mesh, fsdp, dims[1]),
                     _maybe(mesh, m, dims[2]))
        if path.endswith(("wk", "wv")):
            if cfg.fsdp_dim == "output" and fsdp:
                both = _maybe(mesh, m, dims[2])
                if both and dims[2] % (axis_size(mesh, m)
                                       * axis_size(mesh, fsdp)) == 0:
                    return P(None, None, (m, fsdp))
                return P(None, _maybe(mesh, fsdp, dims[1]) if not both
                         else None, both)
            return P(None, _maybe(mesh, fsdp, dims[1]),
                     _maybe(mesh, m, dims[2]))
        if path.endswith(("wo", "w_down", "out_proj", "cm_v")) \
                and len(dims) == 3:
            return P(None, _maybe(mesh, m, dims[1]),
                     _maybe(mesh, fsdp, dims[2]))
        if path.endswith(("wr", "wg", "cm_r")):
            return P(None, _maybe(mesh, fsdp, dims[1]),
                     _maybe(mesh, m, dims[2]))
        if path.endswith("router"):
            return P(None, _maybe(mesh, fsdp, dims[1]), None)
        if path.endswith(("w_gate", "w_up")) and len(dims) == 4:  # (G,E,D,F)
            if cfg.moe_shard == "ffn":
                # per-expert TP over d_ff
                return P(None, None, _maybe(mesh, fsdp, dims[2]),
                         _maybe(mesh, m, dims[3]))
            if cfg.fsdp_dim == "output":
                # fsdp on the OUTPUT dim F (not the contraction dim D)
                return P(None, _maybe(mesh, m, dims[1]), None,
                         _maybe(mesh, fsdp, dims[3]))
            return P(None, _maybe(mesh, m, dims[1]),
                     _maybe(mesh, fsdp, dims[2]), None)
        if path.endswith("w_down") and len(dims) == 4:           # (G,E,F,D)
            if cfg.moe_shard == "ffn":
                return P(None, None, _maybe(mesh, m, dims[2]),
                         _maybe(mesh, fsdp, dims[3]))
            if cfg.fsdp_dim == "output":
                return P(None, _maybe(mesh, m, dims[1]), None,
                         _maybe(mesh, fsdp, dims[3]))
            return P(None, _maybe(mesh, m, dims[1]),
                     _maybe(mesh, fsdp, dims[2]), None)
        if path.endswith("conv_w"):
            return P(None, None, _maybe(mesh, m, dims[2]))
        if path.endswith("x_proj"):
            return P(None, _maybe(mesh, m, dims[1]), None)
        if path.endswith("dt_proj"):
            return P(None, None, _maybe(mesh, m, dims[2]))
        if path.endswith("A_log"):
            return P(None, _maybe(mesh, m, dims[1]), None)
        if path.endswith("w_a"):
            return P(None, _maybe(mesh, fsdp, dims[1]), None)
        if path.endswith("w_b"):
            return P(None, None, _maybe(mesh, m, dims[2]))
        # default: replicate
        return P(*([None] * len(dims)))

    def rule(path: str, leaf) -> P:
        if path.startswith(("embed", "head")):
            return P(_maybe(mesh, m, leaf.shape[0]), None)
        if path.startswith("final_norm"):
            return P(None)
        return block_rule(path, tuple(leaf.shape))

    return map_leaves(rule, specs, leaf_paths(specs), lm.tree_leaves(specs))


def batch_pspecs(cfg: ModelConfig, shape: InputShape, mesh) -> dict[str, P]:
    dp = dp_axes(mesh)
    dp_total = 1
    for a in dp:
        dp_total *= axis_size(mesh, a)
    bdim: Any = dp if (dp and shape.global_batch % dp_total == 0) else None
    out: dict[str, P] = {}
    if cfg.frontend == "frames":
        out["frames"] = P(bdim, None, None)
    else:
        out["tokens"] = P(bdim, None)
    if shape.kind == "train":
        out["labels"] = P(bdim, None)
    if cfg.n_ctx_tokens:
        out["ctx"] = P(bdim, None, None)
    return out


def decode_state_pspecs(cfg: ModelConfig, shape: InputShape, mesh) -> Any:
    """Specs for ``lm.decode_state_init``'s tree. KV caches are split over
    the batch (data axes) and over sequence (model axis), the
    flash-decoding layout; when the batch does not split (long_500k,
    B=1) the sequence dim takes every axis. The port's rank holds the
    whole cache of its rows (``blocks.attn_apply``)."""
    dp = dp_axes(mesh)
    dp_total = 1
    for a in dp:
        dp_total *= axis_size(mesh, a)
    batch_ok = bool(dp) and shape.global_batch % dp_total == 0
    bdim: Any = dp if batch_ok else None
    seq_axes: Any = "model" if batch_ok else (dp + ("model",) if dp
                                              else "model")

    state_specs = lm.decode_state_specs(cfg, shape.global_batch,
                                        shape.seq_len)

    def rule(path: str, leaf) -> P:
        dims = tuple(leaf.shape)
        if "/kv/" in path or path.endswith(("/k", "/v")):
            # (G, B, KV, S, Dh): shard seq; the cross-attention cache too
            if cfg.kv_shard == "batch" and batch_ok:
                return P(None, bdim, None, None, None)
            seq = dims[3]
            ax = seq_axes
            if isinstance(ax, tuple):
                tot = 1
                for a in ax:
                    tot *= axis_size(mesh, a)
                ax = ax if seq % tot == 0 else "model"
            return P(None, bdim, None, _maybe(mesh, ax, seq)
                     if isinstance(ax, str) else ax, None)
        if path.endswith("k_scale") or path.endswith("v_scale"):
            return P(None, bdim, None, None)
        if path.endswith("/conv"):
            return P(None, bdim, None, _maybe(mesh, "model", dims[3]))
        if path.endswith("/h"):
            return P(None, bdim, _maybe(mesh, "model", dims[2]), None)
        if path.endswith("/S"):
            return P(None, bdim, None, None, None)
        if path.endswith(("x_prev", "cm_x_prev")):
            return P(None, bdim, _maybe(mesh, "model", dims[2]))
        return P(*([None] * len(dims)))

    return map_leaves(rule, state_specs, leaf_paths(state_specs),
                      lm.tree_leaves(state_specs))


def opt_state_pspecs(cfg: ModelConfig, mesh, param_specs_tree,
                     params_shape) -> Any:
    """ZeRO-1: moment tensors take the param spec plus a ``data`` shard on
    the first free divisible dim (optimizer state is never replicated
    over data)."""
    del cfg
    shape = _shape(mesh)

    def zero1(spec: P, leaf) -> P:
        if "data" not in shape:
            return spec
        parts = list(spec) + [None] * (len(leaf.shape) - len(spec))
        if any(p == "data" or (isinstance(p, tuple) and "data" in p)
               for p in parts):
            return spec
        dsz = axis_size(mesh, "data")
        for i, (p, dim) in enumerate(zip(parts, leaf.shape)):
            if p is None and dim % dsz == 0 and dim >= dsz:
                parts[i] = "data"
                return P(*parts)
        return spec

    return map_leaves(zero1, params_shape, spec_leaves(param_specs_tree),
                      lm.tree_leaves(params_shape))


def shard_experts(params, cfg: ModelConfig, dist):
    """``params`` as a rank of ``dist`` holds them under
    ``moe_shard="ep_a2a"``: each stacked MoE expert leaf (G, E, ...) cut
    over ``model`` to the rank's block of experts by ``param_pspecs(...,
    serve=True)`` (a copy, so that the whole leaf can be freed), every
    other leaf as it is (the port is not tensor-parallel).
    ``blocks.moe_apply_ep`` takes either form; no other MoE path takes a
    block, so any other ``moe_shard`` raises."""
    if cfg.moe_shard != "ep_a2a":
        raise ValueError(f"shard_experts: moe_shard={cfg.moe_shard!r}; only "
                         "'ep_a2a' runs on a rank's block of the experts")

    def cut(path, leaf, spec):
        if path.endswith(("w_gate", "w_up", "w_down")) and leaf.ndim == 4:
            return dist.shard_leaf(leaf, spec, name=path).clone()
        return leaf

    return map_leaves(cut, params, leaf_paths(params), lm.tree_leaves(params),
                      spec_leaves(param_pspecs(cfg, dist, serve=True)))
