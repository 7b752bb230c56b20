"""Host-side coordination over cMPI: the control-plane callers of the
``Comm`` method collectives (the JAX package's
``repro.distributed.host_coord``).

The gradient synchronization runs in ``schedules.py``; the hosts still
have to agree on checkpoint manifests, reduce scalar training metrics
across ranks, and advance data-pipeline epochs in lockstep. These helpers
run those flows over the port's ``Comm`` with ndarray views end to end:
metric vectors and manifest bytes travel as numpy views (the comm takes
them as CPU tensors), never through copies of their bytes. Large
manifests ride the communicator's rendezvous path.

Results are host values whatever the comm's device: a comm on the card
hands back CUDA tensors, which are read once at this boundary.
"""
from __future__ import annotations

import json

import numpy as np

from repro_torch.core.comm import Comm


def allreduce_metrics(comm: Comm, metrics: dict[str, float],
                      op=np.add) -> dict[str, float]:
    """Reduce a {name: scalar} dict across all ranks (sum by default).
    Keys must match on every rank; values travel as one float64 vector."""
    keys = sorted(metrics)
    vec = np.array([float(metrics[k]) for k in keys], np.float64)
    out = comm.allreduce(vec, op=op)
    return dict(zip(keys, out.tolist()))


def bcast_manifest(comm: Comm, manifest: dict | None,
                   root: int = 0) -> dict:
    """Broadcast a JSON-serializable manifest (checkpoint index, data
    epoch plan, elastic membership) from ``root`` to every rank.

    The JSON bytes are wrapped as a uint8 ndarray view, with no copy,
    into the broadcast tree; decoding happens once at the consumer
    boundary."""
    if comm.rank == root:
        blob = json.dumps(manifest, sort_keys=True).encode()
        arr = np.frombuffer(blob, np.uint8)
    else:
        arr = None
    out = comm.bcast(arr, root=root)
    return json.loads(out.cpu().numpy().tobytes().decode())


def sync_epoch(comm: Comm, epoch: int, root: int = 0) -> int:
    """Advance the data-pipeline epoch in lockstep: every rank adopts
    the root's epoch counter (a barrier + 8-byte broadcast)."""
    comm.barrier()
    out = comm.bcast(np.array([epoch], np.int64), root=root)
    return int(out[0])


def agree_max_step(comm: Comm, step: int) -> int:
    """Elastic-restart helper: the cluster resumes from the HIGHEST step
    any surviving rank holds a complete checkpoint for."""
    out = comm.allreduce(np.array([step], np.int64), op=np.maximum)
    return int(out[0])
