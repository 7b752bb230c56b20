"""cMPI core in PyTorch: the two-sided message plane and one-sided
windows.

The same modules as the JAX package's ``repro.core``, ported: the wire
format (arena, queue cells, staging objects, matchbox entries), the three
pt2pt protocols and every ``ProtocolStats`` counter are unchanged.
What is new is that payloads may be CUDA tensors: the pool is pinned and
mapped into the GPU, and device bytes enter and leave it through the
``cellcopy`` kernel (``repro_torch/csrc/cellcopy.cu``).

  pool        — CXL-pool stand-ins (local / real shared memory /
                incoherent); host ``memview`` and GPU ``device_view``
                windows; ``pool_from_numpy`` adopts a pool image
  coherence   — software cache-coherence protocol (§3.5); ProtocolStats
                counts payload copies (copies / copied_bytes)
  arena       — CXL SHM Arena: multi-level-hash named objects (§3.1)
  ringqueue   — SPSC queue matrix for two-sided pt2pt (§3.3)
  pt2pt       — the pt2pt ENGINE: eager, staged and posted rendezvous,
                the matchbox, PoolBuffer / PoolView / Registration
  comm        — ``Comm``, the v2 public API: method collectives,
                split()/dup(), MPI-4 persistent requests, tuning
  sched       — collective schedule IR (Send/Recv/Reduce/Copy DAGs)
  progress    — the shared progress engine; ReduceOp runs as a torch op
  collectives — the collective launch layer over the schedule engine
  rma         — one-sided windows (``comm.win_allocate``,
                ``win_create_dynamic``): put/get, rput/rget/raccumulate,
                notified access, window collectives, fence/PSCW/locks
  runtime     — thread and process (``spawn``) runtimes
  trace       — flight recorder + metrics registry
  profile     — the measured machine profile behind ``tuning="auto"``

The pre-v2 names (``Communicator``, the free-function collectives) are
served lazily, each access with a ``DeprecationWarning``.
"""
import warnings as _warnings
from importlib import import_module as _import_module

from repro_torch.core.arena import (PAPER_ARENA, Arena, ArenaFullError,
                                    ObjHandle)
from repro_torch.core.coherence import CoherentView, ProtocolStats
from repro_torch.core.comm import (Comm, PersistentCollRequest,
                                   PersistentRequest, startall)
from repro_torch.core.pool import (CACHELINE, IncoherentPool, LocalPool,
                                   Pool, RankCache, Registration,
                                   SharedMemoryPool, as_u8, pool_from_numpy)
from repro_torch.core.progress import (CollRequest, ProgressEngine, testall,
                                       waitall, waitany)
from repro_torch.core.pt2pt import (ANY_TAG, DEFAULT_MB_SLOTS,
                                    TAG_RESERVED_BASE, Matchbox, PoolBuffer,
                                    PoolView, Request)
from repro_torch.core.ringqueue import (DEFAULT_CELL_SIZE, OPTIMAL_CELL_SIZE,
                                        QueueMatrix, SPSCQueue)
from repro_torch.core.rma import DynamicWindow, Window
from repro_torch.core.runtime import RankEnv, run_processes, run_threads
from repro_torch.core.sched import (BufRef, CopyOp, RecvOp, ReduceOp,
                                    Schedule, SendOp, compile_schedule)
from repro_torch.core.sync import PSCW, BakeryLock, RWLock, SeqBarrier
from repro_torch.core.trace import (EV_NAMES, Histogram, Metrics, Tracer,
                                    as_tracer, chrome_events, merge_dumps,
                                    summarize_dumps)

# pre-v2 API surface: served lazily so each access emits a
# DeprecationWarning while old code keeps working unchanged
_DEPRECATED = {
    "Communicator": ("repro_torch.core.pt2pt", "Communicator",
                     "repro_torch.core.Comm"),
    "bcast": ("repro_torch.core.collectives", "bcast", "Comm.bcast"),
    "reduce": ("repro_torch.core.collectives", "reduce", "Comm.reduce"),
    "allreduce": ("repro_torch.core.collectives", "allreduce",
                  "Comm.allreduce"),
    "allgather_ring": ("repro_torch.core.collectives", "allgather_ring",
                       "Comm.allgather"),
    "allgather_bruck": ("repro_torch.core.collectives", "allgather_bruck",
                        "Comm.allgather(algo='bruck')"),
    "reduce_scatter_ring": ("repro_torch.core.collectives",
                            "reduce_scatter_ring", "Comm.reduce_scatter"),
    "alltoall": ("repro_torch.core.collectives", "alltoall",
                 "Comm.alltoall"),
    "barrier_dissemination": ("repro_torch.core.collectives",
                              "barrier_dissemination", "Comm.barrier"),
}


def __getattr__(name: str):
    entry = _DEPRECATED.get(name)
    if entry is None:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    module, attr, replacement = entry
    _warnings.warn(
        f"repro_torch.core.{name} is deprecated; use {replacement} instead "
        f"(the Comm API v2 facade)",
        DeprecationWarning, stacklevel=2)
    return getattr(_import_module(module), attr)


def __dir__():
    return sorted(list(globals()) + list(_DEPRECATED))
