"""Communication skeletons of the paper's Fig-10 applications.

* CG (NPB class D): per iteration, dot-product allreduces (8 B) plus
  row/column vector exchanges with ~log2(p) partners. Communication is a
  SMALL fraction of runtime (<15%, paper §4.4); compute dominates and
  strong-scales ~1/p.

* miniAMR (proxy AMR, block size 4^3): per step, face halo exchanges with
  ~6 neighbors plus refinement consensus allreduces. Each rank keeps a
  CONSTANT number of blocks as p grows (the paper gives every process a
  fixed grid-block count), so compute per rank is flat and the
  communication fraction grows with scale (>62%, paper §4.4).

Both emit (compute, sendrecv, allreduce) action streams for
perfmodel.simulator.Engine. Calibration constants are chosen to land in
the paper's reported regimes at 8 procs/node.
"""
from __future__ import annotations

import math
from typing import Iterator

KB = 1024


# --------------------------------------------------------------------------
# CG — conjugate gradient (NPB class D: na=1,500,000, ~100 iterations)
# --------------------------------------------------------------------------

CG_NA = 1_500_000            # class D problem rows
CG_ITERS = 100
CG_FLOP_PER_ROW = 2_700.0    # calibrated: class D ~4e11 flop/iter total
CG_CORE_FLOPS = 6.0e9        # per-core effective flop/s


def cg_program(rank: int, n_ranks: int, *, iters: int = CG_ITERS
               ) -> Iterator:
    rows = CG_NA / n_ranks
    t_compute = rows * CG_FLOP_PER_ROW / CG_CORE_FLOPS
    # CG on a 2D process grid: exchanges with log2(p) partners per iter
    npart = max(1, int(math.log2(max(n_ranks, 2))))
    xfer = int(rows * 8 / max(npart, 1))     # vector segment bytes
    for _ in range(iters):
        yield ("compute", t_compute)
        for k in range(npart):
            peer = rank ^ (1 << k)
            if peer < n_ranks:
                yield ("sendrecv", peer, xfer, k)
        # two dot products per iteration
        yield ("allreduce", 8)
        yield ("allreduce", 8)


# --------------------------------------------------------------------------
# miniAMR — adaptive mesh refinement proxy (block size 4x4x4)
# --------------------------------------------------------------------------

AMR_BLOCKS_PER_RANK = 8        # constant per rank (paper's configuration)
AMR_BLOCK = 4                  # 4x4x4 cells
AMR_VARS = 4                   # variable groups exchanged separately
AMR_STEPS = 40
AMR_FLOP_PER_CELL = 60_000.0
AMR_CORE_FLOPS = 6.0e9
AMR_BLOCK_BYTES = AMR_BLOCK ** 3 * 40 * 4   # full block payload (40 fp32 vars)


def miniamr_program(rank: int, n_ranks: int, *, steps: int = AMR_STEPS
                    ) -> Iterator:
    """Halo exchange is MANY TINY messages (one per block-face-variable:
    a 4x4 face of 4-byte cells = 64 B) — latency-bound, which is where the
    16 us Ethernet vs 18 us CX-6 alpha decides small-scale performance.
    Every ~20 steps, refinement REDISTRIBUTES whole blocks across nodes —
    bandwidth-bound, which is what sinks Ethernet beyond ~8 nodes
    (paper §4.4: 'at small scales latency-dominated, at larger scales
    bandwidth becomes the limiting factor')."""
    cells = AMR_BLOCKS_PER_RANK * AMR_BLOCK ** 3
    t_compute = cells * AMR_FLOP_PER_CELL / AMR_CORE_FLOPS
    face = AMR_BLOCK * AMR_BLOCK * 2                  # 32 B: one face, one var
    nodes = max(1, n_ranks // 8)
    cross = 1.0 - 1.0 / nodes if nodes > 1 else 0.0
    redis = int(AMR_BLOCKS_PER_RANK * AMR_BLOCK_BYTES * cross)
    for step in range(steps):
        yield ("compute", t_compute)
        for axis in range(3):
            stride = max(1, round(n_ranks ** (axis / 3)))
            for s in (+stride, -stride):
                peer = (rank + s) % n_ranks
                if peer == rank:
                    continue
                for b in range(AMR_BLOCKS_PER_RANK):
                    for v in range(AMR_VARS):
                        yield ("sendrecv", peer, face, 64 + axis)
        # refinement: consensus + block redistribution (half the blocks
        # move, every 10 steps — the bandwidth-bound phase)
        if step % 10 == 5:
            yield ("allreduce", AMR_BLOCKS_PER_RANK * 8)
            if redis:
                yield ("sendrecv", (rank + n_ranks // 2) % n_ranks,
                       redis // 2, 99)
