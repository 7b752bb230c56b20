"""Hand-written CUDA kernels of the port and their plain PyTorch versions.

Every wrapper picks its route with ``route``: tensors on the CPU take the
plain version, tensors on the card launch the kernel, and anything else
(a mix, or another device such as ``meta``) raises. There is no fallback
from one route to the other.

The one exception is the dry run's counter (``analysis.hlo.count``):
while a counter is active, all-``meta`` tensors take the ``"meta"``
route, on which a wrapper launches nothing and returns an empty output
of the kernel's shape and dtype. On every route a wrapper charges its
kernel's work (``charge``) to the active counter, if any: the kernels
are ``ctypes`` calls that no dispatch mode sees.
"""
from __future__ import annotations

import contextlib

import torch

# the active counters, innermost last (``analysis.hlo.count`` pushes one)
COUNTERS: list = []


def route(name: str, *ts: torch.Tensor) -> str:
    """``"cpu"`` or ``"cuda"``: where all of ``ts`` lie; ``"meta"`` for
    all-meta tensors while a counter is active; raises otherwise."""
    kinds = {t.device.type for t in ts}
    if kinds == {"cpu"}:
        return "cpu"
    if kinds == {"cuda"}:
        return "cuda"
    if kinds == {"meta"} and COUNTERS:
        return "meta"
    raise ValueError(f"{name}: tensors on {sorted(kinds)}; all on the "
                     "CPU (plain version) or all on the card (kernel)")


def itemsize(dtype) -> int:
    """Bytes of an element of ``dtype``: a torch dtype or its name."""
    return (getattr(torch, dtype) if isinstance(dtype, str)
            else dtype).itemsize


def charge(name: str, flops: float, nbytes: float) -> None:
    """Charge one launch of kernel ``name`` and its work to the active
    counter, if any."""
    if COUNTERS:
        COUNTERS[-1].charge(name, flops, nbytes)


@contextlib.contextmanager
def charged(name: str, flops: float, nbytes: float):
    """Charge one launch of kernel ``name`` and its work (``flops``,
    ``nbytes``) to the active counter, and count none of the torch ops
    run inside the block (the launch's plumbing, or the plain version
    standing in for the kernel on the CPU)."""
    if not COUNTERS:
        yield
        return
    charge(name, flops, nbytes)
    c = COUNTERS[-1]
    c.paused += 1
    try:
        yield
    finally:
        c.paused -= 1
