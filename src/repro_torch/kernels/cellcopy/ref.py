"""Plain PyTorch versions of the cellcopy kernel.

The wrappers in ``ops`` use these for tensors on the CPU, and
``chip_smoke.py`` holds the CUDA kernel against them on the card.
"""
from __future__ import annotations

import torch


def row_sums(cells: torch.Tensor) -> torch.Tensor:
    """Wrapping u32 sum of each row of an int32 ``(n, words)`` tensor.
    The low 32 bits of the signed int64 sum equal the unsigned sum mod
    2^32, so the arithmetic stays in integers end to end."""
    s = cells.to(torch.int64).sum(dim=1) & 0xFFFFFFFF
    return s.to(torch.int32).view(torch.uint32)


def cellcopy_ref(src: torch.Tensor):
    return src.clone(), row_sums(src)


def cell_sums_ref(buf: torch.Tensor, cell_bytes: int,
                  n_cells: int) -> torch.Tensor:
    """Per-cell sums of a flat uint8 message zero-padded to ``n_cells``
    cells of ``cell_bytes`` (a multiple of 4) — the sums
    ``copy_message`` reports."""
    flat = torch.zeros(n_cells * cell_bytes, dtype=torch.uint8,
                       device=buf.device)
    flat[:buf.numel()] = buf
    return row_sums(flat.view(torch.int32).reshape(n_cells, -1))


def copy_bytes_ref(dst: torch.Tensor, src: torch.Tensor,
                   cell_bytes: int) -> torch.Tensor:
    """``dst[:] = src`` for flat uint8 tensors; returns the per-cell
    sums of the message (ragged tail zero-padded)."""
    dst.copy_(src)
    n_cells = -(-src.numel() // cell_bytes)
    return cell_sums_ref(src, cell_bytes, n_cells)
