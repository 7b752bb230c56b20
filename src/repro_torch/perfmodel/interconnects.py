"""Analytical interconnect models calibrated to the paper's Table 1 and
Figs 5-11.

We have neither the Niagara 2.0 CXL box nor the Mellanox NICs, so — exactly
like the paper does for >4 nodes via SimGrid — performance claims are
reproduced through calibrated alpha-beta models:

    T_raw(size)  = alpha + size / bandwidth          (fabric)
    T_mpi(size)  = t_proto + T_raw(size) + coherence (MPI layer)

Calibration anchors (paper Table 1 / §2 / §4):
  main memory        100 ns   132.8 GB/s
  TCP over Ethernet   16 us   117.8 MB/s
  TCP over CX-6 Dx    18 us    11.5 GB/s
  RoCEv2 CX-6 Dx     1.6 us    10.8 GB/s
  RoCEv2 CX-3        ~2 us      7.0 GB/s
  InfiniBand CX-6   ~600 ns    25.0 GB/s
  CXL SHM (cached)   790 ns     9.9 GB/s
  CXL SHM (flushed)  2.2 us     9.5 GB/s

MPI-level anchors (Figs 5-8, OMB on 2 nodes):
  one-sided  CXL ~12 us flat to 16 KB;  TCP-Eth ~630 us;  TCP-CX6 ~620 us
  two-sided  CXL ~12 us;  TCP-Eth ~160 us;  TCP-CX6 ~55 us
  one-sided bw saturates ~8,600 MB/s (16p);  two-sided ~6,050 MB/s (-30%,
  double copy);  TCP-CX6 climbs to ~10,150 MB/s at 32p for large messages.
  CXL bandwidth DECLINES beyond 16 KB messages (CPU-mediated copies contend
  in the memory hierarchy); NIC offload does not.

Coherence modes (Fig 11): clflush serial per line; clflushopt ~4x parallel;
uncacheable pays a PCIe transaction per word (MPS packetization) — >4,000 us
beyond 2 KB.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

CACHELINE = 64
KB = 1024
MB = 1024 * 1024
GB = 1024 ** 3


@dataclass(frozen=True)
class Interconnect:
    name: str
    alpha: float                 # fabric latency, seconds
    bandwidth: float             # fabric peak, bytes/s
    # MPI-layer protocol overheads (seconds)
    t_onesided: float            # OMB one-sided per-op overhead (win sync)
    t_twosided: float            # OMB two-sided per-op overhead
    # CPU-mediated transfer? (CXL: every byte moves via CPU `mov`)
    cpu_mediated: bool = False
    # aggregate fabric ceiling for multi-process bw tests, bytes/s
    fabric_peak: float = 0.0
    # two-sided aggregate ceiling if different (NIC duplex pipelines)
    fabric_peak_twosided: float = 0.0
    # per-process ceiling (NIC pipelines; CXL per-core copy throughput)
    proc_peak: float = 0.0
    # message size at which the NIC pipeline reaches half of peak
    half_size: float = 0.0

    # ------------------------------------------------------------------
    def raw_latency(self, size: int) -> float:
        return self.alpha + size / self.bandwidth

    def _contention(self, size: int, procs: int) -> float:
        """CPU-mediated fabrics lose bandwidth beyond 16 KB messages as
        concurrent copies contend in the memory hierarchy (paper §3.6)."""
        if not self.cpu_mediated or size <= 16 * KB:
            return 1.0
        return 1.0 + 0.25 * math.log2(size / (16 * KB)) \
            * (0.5 + procs / 16.0)

    def mpi_latency(self, size: int, *, onesided: bool,
                    procs: int = 2) -> float:
        t = self.t_onesided if onesided else self.t_twosided
        lat = t + self.raw_latency(size)
        if self.cpu_mediated and size > 16 * KB:
            # paper §4.2: CXL latency grows proportionally beyond 16 KB —
            # concurrent CPU copies contend in the memory hierarchy
            lat += (size / self.bandwidth) * (0.75 * size / (16 * KB) - 1.0)
        return lat

    def mpi_bandwidth(self, size: int, procs: int, *,
                      onesided: bool) -> float:
        """Aggregate OMB-style bandwidth (bytes/s) for `procs` concurrent
        pairs streaming `size`-byte messages (window of 64 in flight —
        per-message protocol overhead amortizes)."""
        t_proto = (self.t_onesided if onesided else self.t_twosided) / 64.0
        per_msg = t_proto + size / self.bandwidth
        if self.cpu_mediated:
            # every message pays its coherence epilogue (Fig 11):
            # flush-call base + clflushopt-parallel per-line cost
            lines = max(1, (size + CACHELINE - 1) // CACHELINE)
            per_msg += 2.2e-6 + (lines - 1) * 0.125e-6 / 4.0
        agg = procs * size / per_msg
        peak = self.fabric_peak or self.bandwidth
        if not onesided and self.fabric_peak_twosided:
            peak = self.fabric_peak_twosided
        if self.half_size:                    # NIC pipeline fill
            peak = peak * size / (size + self.half_size)
        if self.cpu_mediated:                 # paper §3.6: memory-hierarchy
            peak = peak / self._contention(size, procs)   # contention
        caps = [peak]
        if self.proc_peak:
            caps.append(self.proc_peak * procs)
        agg = min(agg, *caps)
        if self.cpu_mediated and not onesided:
            agg *= 0.70          # double copy through the queue (paper: -30%)
        return agg


# --------------------------------------------------------------------------
# Table-1 instances
# --------------------------------------------------------------------------

MAIN_MEMORY = Interconnect(
    "main_memory", 100e-9, 132.8 * GB, 0.4e-6, 0.4e-6,
    fabric_peak=132.8 * GB, proc_peak=20 * GB)

ETHERNET_TCP = Interconnect(
    "tcp_ethernet", 16e-6, 117.8 * MB, 614e-6, 144e-6,
    fabric_peak=120 * MB, proc_peak=117.8 * MB)

MELLANOX_TCP = Interconnect(
    "tcp_cx6dx", 18e-6, 11.5 * GB, 602e-6, 37e-6,
    fabric_peak=10.65 * GB, fabric_peak_twosided=13.1 * GB,
    proc_peak=0.45 * GB, half_size=12 * KB)

ROCE_CX6 = Interconnect(
    "rocev2_cx6dx", 1.6e-6, 10.8 * GB, 4e-6, 2e-6,
    fabric_peak=10.8 * GB, proc_peak=2 * GB)

ROCE_CX3 = Interconnect(
    "rocev2_cx3", 2e-6, 7.0 * GB, 5e-6, 3e-6,
    fabric_peak=7.0 * GB, proc_peak=1.5 * GB)

INFINIBAND_CX6 = Interconnect(
    "ib_cx6", 0.6e-6, 25.0 * GB, 2e-6, 1.2e-6,
    fabric_peak=25.0 * GB, proc_peak=5 * GB)

CXL_SHM_NOFLUSH = Interconnect(
    "cxl_shm_cached", 790e-9, 9.9 * GB, 10.6e-6, 10.6e-6,
    cpu_mediated=True, fabric_peak=9.4 * GB, proc_peak=0.9725 * GB)

CXL_SHM = Interconnect(
    "cxl_shm", 2.2e-6, 9.5 * GB, 10.6e-6, 10.6e-6,
    cpu_mediated=True, fabric_peak=9.02 * GB, proc_peak=0.9725 * GB)

INTERCONNECTS = {
    ic.name: ic for ic in (
        MAIN_MEMORY, ETHERNET_TCP, MELLANOX_TCP, ROCE_CX6, ROCE_CX3,
        INFINIBAND_CX6, CXL_SHM_NOFLUSH, CXL_SHM)
}


# --------------------------------------------------------------------------
# coherence-mode latency (Fig 11: memset of `size` bytes + coherence)
# --------------------------------------------------------------------------

_FLUSH_BASE = 2.2e-6          # single-line flush + fence
_FLUSH_PER_LINE = 0.50e-6     # clflush: serial per line
_FLUSHOPT_PAR = 4.0           # clflushopt flushes ~4 lines in parallel
_UC_PER_BYTE = 2.0e-6         # uncacheable: PCIe transaction per word


def coherence_latency(size: int, mode: str) -> float:
    """Seconds for a memset of `size` bytes under each coherence mode."""
    lines = max(1, (size + CACHELINE - 1) // CACHELINE)
    if mode == "clflush":
        return _FLUSH_BASE + (lines - 1) * _FLUSH_PER_LINE
    if mode == "clflushopt":
        return _FLUSH_BASE + (lines - 1) * _FLUSH_PER_LINE / _FLUSHOPT_PAR
    if mode == "uncacheable":
        return 1.0e-6 + size * _UC_PER_BYTE
    if mode == "cached":          # no coherence (single-host only)
        return 100e-9 + size / (132.8 * GB)
    raise ValueError(mode)


def protocol_time(stats, interconnect: Interconnect = CXL_SHM,
                  mode: str = "clflushopt") -> float:
    """Attach time to a ``repro_torch.core.coherence.ProtocolStats``
    counter set (the counters of a ``CoherentView``): data motion
    at fabric bandwidth + per-line coherence + fences. This converts the
    executable protocol's event counts into modeled seconds."""
    t = (stats.written_bytes + stats.read_bytes) / interconnect.bandwidth
    per_line = (_FLUSH_PER_LINE / _FLUSHOPT_PAR if mode == "clflushopt"
                else _FLUSH_PER_LINE)
    t += stats.flush_lines * per_line
    t += stats.fences * 50e-9
    t += stats.nt_ops * interconnect.alpha
    t += stats.uncached_ops * (CACHELINE * _UC_PER_BYTE)
    return t
