"""Hand-written CUDA kernels of the port and their plain PyTorch versions.

Every wrapper picks its route with ``route``: tensors on the CPU take the
plain version, tensors on the card launch the kernel, and anything else
(a mix, or another device such as ``meta``) raises. There is no fallback
from one route to the other.
"""
from __future__ import annotations

import torch


def route(name: str, *ts: torch.Tensor) -> str:
    """``"cpu"`` or ``"cuda"``: where all of ``ts`` lie; raises otherwise."""
    kinds = {t.device.type for t in ts}
    if kinds == {"cpu"}:
        return "cpu"
    if kinds == {"cuda"}:
        return "cuda"
    raise ValueError(f"{name}: tensors on {sorted(kinds)}; all on the "
                     "CPU (plain version) or all on the card (kernel)")
