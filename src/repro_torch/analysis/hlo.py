"""The dry-run roofline: H100 constants, and a counter of one call's FLOPs,
bytes and collective traffic (the JAX package's ``repro.analysis.hlo``).

Nothing here is HLO. The module keeps the reference's name so that a
reader finds the counterpart; where the reference parses the compiled
HLO text (``analyze_module`` and its parser: ``shape_bytes``, ``Instr``,
``Computation``, none of which the port has), the port runs the step
once under a ``TorchDispatchMode`` (``count``) and counts what it
dispatches.
The three roofline terms are those of the reference:

  compute term    = FLOPs_per_device / PEAK_FLOPS      [s]
  memory term     = bytes_per_device / HBM_BW          [s]
  collective term = wire_bytes_per_device / LINK_BW    [s]

Per-op accounting (one rank's program, as it dispatches):

  * FLOPs  — the dot FLOPs of ``mm``/``addmm``/``bmm``/``baddbmm``/
    ``mv``/``dot`` (2 * prod(out dims) * contracted size) and of
    ``convolution`` and its backward (2 * prod(out) * window), the
    reference's rule. Other ops count no FLOPs.
  * bytes  — each op's tensor inputs plus outputs; views (ops whose
    schema returns an alias that is not written) and allocations are
    excluded, as the reference excludes its view and plumbing ops. The
    port is not fused, so every intermediate crosses HBM here: these
    bytes are an upper proxy of the traffic, where the reference's are
    those of XLA's fused module.
  * kernels — the hand-written kernels are ``ctypes`` calls that no
    dispatch mode sees. Each wrapper charges its kernel's work formula
    (``ops.work`` of ``kernels/*``) on every route, and the torch ops it
    runs meanwhile count nothing (``kernels.charged``). Inside ``count``,
    all-``meta`` tensors take the kernels' ``"meta"`` route, so a step
    counts on the meta device without allocating.
  * wire   — the collectives a ``DistContext`` runs, as recorded by the
    dry run's stand-in communicator (``record_collective``), with the
    reference's ring factors per kind:
               all-reduce          2(S-1)/S * buffer
               all-gather          (S-1)/S  * result
               reduce-scatter      (S-1)    * result   (= (S-1)/S * input)
               all-to-all          (S-1)/S  * buffer
               collective-permute  1        * buffer
"""
from __future__ import annotations

from collections import defaultdict
from dataclasses import dataclass, field

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch import kernels

# one H100 SXM (NVIDIA's data sheet): dense bf16 and TF32 on the tensor
# cores and f32 outside them, HBM3, and the host link to the mapped pool,
# PCIe 5.0 x16 (32 GT/s x 16 lanes, 128b/130b) in one direction, which
# every collective of the port crosses
PEAK_FLOPS_BY_DTYPE = {"bfloat16": 989e12, "float32": 67e12, "tf32": 495e12}
PEAK_FLOPS = PEAK_FLOPS_BY_DTYPE["bfloat16"]
HBM_BW = 3.35e12             # bytes/s
LINK_BW = 32e9 * 16 * 128 / 130 / 8   # bytes/s to the pool


def bound_ms(flops: float, nbytes: float, dtype: str) -> tuple[float, str]:
    """The least time the card could take for ``flops`` at ``dtype``'s
    peak and ``nbytes`` at HBM's rate: (ms, ``"operations"`` or
    ``"bytes"``, whichever bounds)."""
    ops_s = flops / PEAK_FLOPS_BY_DTYPE[dtype]
    mem_s = nbytes / HBM_BW
    return max(ops_s, mem_s) * 1e3, ("operations" if ops_s >= mem_s
                                      else "bytes")


def _wire_bytes(kind: str, rb: int, s: int) -> float:
    if kind.startswith("collective-permute"):
        return float(rb)
    if s <= 1:
        return 0.0
    if kind.startswith("all-reduce"):
        return 2.0 * (s - 1) / s * rb
    if kind.startswith("all-gather"):
        return (s - 1) / s * rb
    if kind.startswith("reduce-scatter"):
        return float(s - 1) * rb
    if kind.startswith("all-to-all"):
        return (s - 1) / s * rb
    return float(rb)


@dataclass
class ModuleStats:
    """What ``count`` saw of one call: the reference's fields, plus the
    kernels' charged work (``kernels``: name -> launches, flops, bytes,
    already inside ``flops`` and ``bytes_``), the wire bytes by
    communicator group (``wire_by_group``: the axes it spans, joined by
    ``+``) and the dispatched ops' FLOPs by op and output shape
    (``dot_flops``: ``"mm(4, 576)"`` -> FLOPs)."""
    flops: float = 0.0
    bytes_: float = 0.0
    wire_bytes: dict[str, float] = field(default_factory=dict)
    coll_counts: dict[str, float] = field(default_factory=dict)
    top_ops: list[tuple[str, int, int, float]] = field(default_factory=list)
    top_bytes_ops: list[tuple[str, float, float]] = field(
        default_factory=list)       # (op, bytes, calls)
    kernels: dict[str, dict] = field(default_factory=dict)
    wire_by_group: dict[str, float] = field(default_factory=dict)
    dot_flops: dict[str, float] = field(default_factory=dict)

    @property
    def total_wire_bytes(self) -> float:
        return sum(self.wire_bytes.values())


def _prod(xs) -> int:
    n = 1
    for x in xs:
        n *= int(x)
    return n


def _conv_flops(out, weight) -> int:
    return 2 * _prod(out.shape) * _prod(weight.shape[1:])


def _flops(func, args, out) -> int:
    name = func.overloadpacket.__name__
    if name == "mm":
        a, b = args[0], args[1]
        return 2 * a.shape[0] * a.shape[1] * b.shape[1]
    if name == "addmm":
        a, b = args[1], args[2]
        return 2 * a.shape[0] * a.shape[1] * b.shape[1]
    if name == "bmm":
        a, b = args[0], args[1]
        return 2 * a.shape[0] * a.shape[1] * a.shape[2] * b.shape[2]
    if name == "baddbmm":
        a, b = args[1], args[2]
        return 2 * a.shape[0] * a.shape[1] * a.shape[2] * b.shape[2]
    if name == "mv":
        return 2 * _prod(args[0].shape)
    if name == "dot":
        return 2 * args[0].shape[0]
    if name in ("convolution", "_convolution"):
        return _conv_flops(out, args[1])
    if name == "convolution_backward":
        grad_out, weight, mask = args[0], args[2], args[-1]
        return (int(mask[0]) + int(mask[1])) * _conv_flops(grad_out, weight)
    return 0


_NO_TRAFFIC = {"empty", "empty_like", "empty_strided", "new_empty",
               "new_empty_strided", "_unsafe_view", "lift_fresh",
               "_local_scalar_dense", "resize_", "set_"}


def _is_view(func) -> bool:
    if func.overloadpacket.__name__ in _NO_TRAFFIC:
        return True
    rets = func._schema.returns
    return bool(rets) and all(
        r.alias_info is not None and not r.alias_info.is_write
        for r in rets)


def _nbytes(x) -> int:
    """Bytes of the tensors in ``x`` (a tensor, or tuples, lists and dict
    values of them)."""
    if isinstance(x, torch.Tensor):
        return x.numel() * x.element_size()
    if isinstance(x, (tuple, list)):
        return sum(_nbytes(y) for y in x)
    if isinstance(x, dict):
        return sum(_nbytes(y) for y in x.values())
    return 0


def _functional(func) -> bool:
    """No argument or return of ``func`` aliases or mutates a tensor."""
    got = _FUNCTIONAL.get(func)
    if got is None:
        sc = func._schema
        got = _FUNCTIONAL[func] = not any(
            a.alias_info is not None for a in (*sc.arguments, *sc.returns))
    return got


_FUNCTIONAL: dict = {}
_PLAIN = (int, float, bool, str, type(None), torch.dtype, torch.device,
          torch.layout, torch.memory_format)


def _desc(x):
    """A hashable description of a meta op's argument, or a ``KeyError``
    where it has none (a tensor off the meta device, an odd value)."""
    if isinstance(x, torch.Tensor):
        if not x.is_meta:
            raise KeyError(x.device)
        return (tuple(x.shape), x.stride(), x.dtype, x.storage_offset())
    if isinstance(x, (tuple, list)):
        return tuple(_desc(y) for y in x)
    if isinstance(x, dict):
        return tuple((k, _desc(v)) for k, v in sorted(x.items()))
    if isinstance(x, _PLAIN):
        return x
    raise KeyError(type(x))


def _meta_like(desc):
    shape, stride, dtype = desc
    return torch.empty_strided(shape, stride, dtype=dtype, device="meta")


class _Counter(TorchDispatchMode):
    """The dispatch mode behind ``count``; ``paused`` > 0 inside a
    kernel's ``charged`` block."""

    def __init__(self):
        super().__init__()
        self.paused = 0
        self.flops = 0
        self.bytes_ = 0
        self.by_op: dict = defaultdict(lambda: [0, 0])   # bytes, calls
        self.kernels: dict = {}
        self.colls: list = []
        self.dots: dict = defaultdict(int)
        self.memo: dict = {}

    def _run(self, func, args, kwargs):
        """``func(*args, **kwargs)``. A functional op on meta tensors
        depends on its arguments' shapes, strides and dtypes alone, and
        its output is made from the memo of an earlier call with the
        same ones (the meta device's own shape functions are slow)."""
        if not _functional(func):
            return func(*args, **kwargs)
        try:
            key = (func, _desc(args), _desc(kwargs))
        except KeyError:
            return func(*args, **kwargs)
        outs = self.memo.get(key)
        if outs is not None:
            kind, descs = outs
            made = [_meta_like(d) for d in descs]
            return made[0] if kind is None else kind(made)
        out = func(*args, **kwargs)
        # only meta outputs: a factory op's arguments name no tensor, and
        # its device may be the card's
        if isinstance(out, torch.Tensor) and out.is_meta:
            self.memo[key] = (None, [(tuple(out.shape), out.stride(),
                                      out.dtype)])
        elif isinstance(out, (tuple, list)) and out and all(
                isinstance(o, torch.Tensor) and o.is_meta for o in out):
            self.memo[key] = (type(out), [(tuple(o.shape), o.stride(),
                                           o.dtype) for o in out])
        return out

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = self._run(func, args, kwargs or {})
        if self.paused:
            return out
        f = _flops(func, args, out)
        if f:
            self.flops += f
            shape = tuple(out.shape) if isinstance(out, torch.Tensor) else ()
            self.dots[f"{func.overloadpacket.__name__}{shape}"] += f
        if not _is_view(func):
            nb = _nbytes(args) + _nbytes(kwargs) + _nbytes(out)
            self.bytes_ += nb
            rec = self.by_op[func.overloadpacket.__name__]
            rec[0] += nb
            rec[1] += 1
        return out

    def charge(self, name: str, flops: float, nbytes: float) -> None:
        k = self.kernels.setdefault(name, {"launches": 0, "flops": 0,
                                           "bytes": 0})
        k["launches"] += 1
        k["flops"] += flops
        k["bytes"] += nbytes
        self.flops += flops
        self.bytes_ += nbytes

    def collective(self, kind: str, nbytes: int, size: int,
                   group: str) -> None:
        self.colls.append((kind, int(nbytes), int(size), group))

    def stats(self) -> ModuleStats:
        st = ModuleStats(flops=float(self.flops), bytes_=float(self.bytes_),
                         kernels={k: dict(v) for k, v in
                                  self.kernels.items()},
                         dot_flops={k: float(v) for k, v in
                                    self.dots.items()})
        calls: dict = defaultdict(int)
        for kind, nb, size, group in self.colls:
            w = _wire_bytes(kind, nb, size)
            st.wire_bytes[kind] = st.wire_bytes.get(kind, 0.0) + w
            st.coll_counts[kind] = st.coll_counts.get(kind, 0.0) + 1
            st.wire_by_group[group] = st.wire_by_group.get(group, 0.0) + w
            calls[(kind, nb, size, group)] += 1
        st.top_ops = sorted(((kind, nb, size, float(n))
                             for (kind, nb, size, _), n in calls.items()),
                            key=lambda t: -(t[1] * t[3]))[:12]
        st.top_bytes_ops = sorted(
            ((op, float(b), float(n)) for op, (b, n) in self.by_op.items()),
            key=lambda t: -t[1])[:12]
        return st


def count(fn, *args, **kwargs) -> ModuleStats:
    """Run ``fn(*args, **kwargs)`` once and count it: FLOPs, bytes, the
    kernels' charged work and the collectives recorded meanwhile. Inside
    the call, all-``meta`` tensors may reach the kernels' wrappers (the
    ``"meta"`` route); outside it they raise as before."""
    c = _Counter()
    kernels.COUNTERS.append(c)
    try:
        with c:
            fn(*args, **kwargs)
    finally:
        kernels.COUNTERS.remove(c)
    return c.stats()


def record_collective(kind: str, nbytes: int, size: int,
                      group: str) -> None:
    """Record one collective of ``kind`` (the reference's HLO names:
    ``all-reduce``, ``all-gather``, ...) over ``nbytes`` of buffer and a
    group of ``size`` ranks spanning ``group``, with the active count."""
    if kernels.COUNTERS:
        kernels.COUNTERS[-1].collective(kind, nbytes, size, group)


# --------------------------------------------------------------------------
# roofline
# --------------------------------------------------------------------------

@dataclass
class Roofline:
    flops_per_device: float
    bytes_per_device: float
    wire_bytes_per_device: float
    model_flops_per_device: float

    @property
    def compute_s(self) -> float:
        return self.flops_per_device / PEAK_FLOPS

    @property
    def memory_s(self) -> float:
        return self.bytes_per_device / HBM_BW

    @property
    def collective_s(self) -> float:
        return self.wire_bytes_per_device / LINK_BW

    @property
    def bottleneck(self) -> str:
        terms = {"compute": self.compute_s, "memory": self.memory_s,
                 "collective": self.collective_s}
        return max(terms, key=terms.get)

    @property
    def useful_flops_ratio(self) -> float:
        """MODEL_FLOPS / counted FLOPs — catches remat / redundancy
        waste."""
        if self.flops_per_device <= 0:
            return 0.0
        return self.model_flops_per_device / self.flops_per_device

    @property
    def roofline_fraction(self) -> float:
        """Useful-compute seconds / max(all terms): what fraction of the
        compute roofline the step achieves if the dominant term is the
        critical path."""
        dom = max(self.compute_s, self.memory_s, self.collective_s)
        if dom <= 0:
            return 0.0
        return (self.model_flops_per_device / PEAK_FLOPS) / dom

    def as_dict(self) -> dict:
        return {
            "flops_per_device": self.flops_per_device,
            "bytes_per_device": self.bytes_per_device,
            "wire_bytes_per_device": self.wire_bytes_per_device,
            "model_flops_per_device": self.model_flops_per_device,
            "compute_s": self.compute_s,
            "memory_s": self.memory_s,
            "collective_s": self.collective_s,
            "bottleneck": self.bottleneck,
            "useful_flops_ratio": self.useful_flops_ratio,
            "roofline_fraction": self.roofline_fraction,
        }


def model_flops(cfg, shape, chips: int) -> float:
    """Analytic MODEL_FLOPS for the step, per device.

    train: 6 * N_active * tokens      (fwd 2N + bwd 4N)
    prefill: 2 * N_active * tokens
    decode: 2 * N_active * batch      (one token per sequence)
    """
    n_active = cfg.param_counts()["active"]
    if shape.kind == "train":
        tokens = shape.global_batch * shape.seq_len
        total = 6.0 * n_active * tokens
    elif shape.kind == "prefill":
        tokens = shape.global_batch * shape.seq_len
        total = 2.0 * n_active * tokens
    else:
        total = 2.0 * n_active * shape.global_batch
    return total / chips
