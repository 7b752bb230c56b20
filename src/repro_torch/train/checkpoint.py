"""Checkpointing: async, restart-bitwise-identical; filesystem or
cMPI-arena backed (the JAX package's ``train/checkpoint.py`` over torch
tensors).

Filesystem layout, the JAX package's:
    <dir>/step_<N>/manifest.json       (step, leaf shapes/dtypes)
    <dir>/step_<N>/leaf_<i>.npy
    <dir>/LATEST                       (atomic pointer, written LAST)

Leaf ``i`` is the ``i``-th tensor in ``lm.tree_leaves`` order, which is
``jax.tree.leaves``' order, so a checkpoint the JAX package wrote
restores here and the other way round (the manifest's ``treedef`` string
is informational only). A bfloat16 leaf, which numpy has no type for, is
written as its 16-bit patterns (uint16) with ``"bfloat16"`` in the
manifest, and read back by that name.

The LATEST pointer is renamed into place only after every leaf is
written, so a crash mid-save can never corrupt the restore point (step
fencing). ``save_async`` copies the tensors to the host now and writes
them on a background thread, so the train loop overlaps I/O with
compute.

The ARENA backend checkpoints into cMPI shared-memory objects, the CXL
use case the paper cites for HPC (checkpointing into the pooled memory
[21, 22]): peers, or a restarted job on another node of the pod, restore
through ``Arena.open`` without touching a filesystem. A CUDA leaf enters
its object through the pool's device window with the ``cellcopy`` kernel
(``CoherentView.write_release``, which synchronises the stream before it
returns) and leaves it the same way (``Arena.read_into``), with no host
copy; a CPU leaf takes the host path. The manifest is written last.
"""
from __future__ import annotations

import json
import os
import threading
from pathlib import Path

import numpy as np
import torch

from repro_torch.core.arena import Arena
from repro_torch.core.pool import as_u8
from repro_torch.models.lm import tree_leaves, tree_unflatten


def _dtype_name(t: torch.Tensor) -> str:
    return str(t.dtype).removeprefix("torch.")


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    """A host copy of ``t`` (bf16 as its uint16 bit patterns)."""
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16)
    return t.numpy()


def _from_numpy(a: np.ndarray, dtype_name: str) -> torch.Tensor:
    if dtype_name == "bfloat16":
        return torch.from_numpy(
            np.ascontiguousarray(a).view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(np.asarray(a, dtype=np.dtype(dtype_name)))


def _treedef(tree) -> str:
    return repr(tree_unflatten(tree, ["*"] * sum(1 for _ in
                                                 tree_leaves(tree))))


# --------------------------------------------------------------------------
# filesystem backend
# --------------------------------------------------------------------------

class CheckpointManager:
    def __init__(self, directory: str | Path):
        self.dir = Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        self._thread: threading.Thread | None = None
        self._sweep_stale_tmps()

    def _sweep_stale_tmps(self) -> None:
        """Remove .LATEST.<pid>.<tid>.tmp leftovers from writers that
        died between write and rename. Only files from DEAD processes
        are swept — a live writer (this process's own async thread, or
        a concurrent run) must keep its tmp until its atomic rename."""
        for p in self.dir.glob(".LATEST.*.tmp"):
            try:
                pid = int(p.name.split(".")[2])
                os.kill(pid, 0)                 # raises if pid is gone
            except (IndexError, ValueError, ProcessLookupError):
                try:
                    p.unlink()
                except FileNotFoundError:
                    pass
            except PermissionError:
                pass                            # pid alive, not ours

    # ---------------- save ----------------
    def save(self, step: int, tree) -> None:
        """Write ``tree`` now. An async save still running is waited for
        first: both may write the same step's files."""
        self.wait()
        self._write(step, self._host(tree), _treedef(tree))

    def save_async(self, step: int, tree) -> None:
        self.wait()
        arrs = self._host(tree)                 # device to host now
        self._thread = threading.Thread(
            target=self._write, args=(step, arrs, _treedef(tree)),
            daemon=True)
        self._thread.start()

    @staticmethod
    def _host(tree) -> list:
        return [(_to_numpy(t), _dtype_name(t)) for t in tree_leaves(tree)]

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def _write(self, step: int, arrs, treedef: str) -> None:
        d = self.dir / f"step_{step}"
        d.mkdir(parents=True, exist_ok=True)
        manifest = {"step": step, "treedef": treedef, "leaves": []}
        for i, (a, dtype) in enumerate(arrs):
            np.save(d / f"leaf_{i}.npy", a)
            manifest["leaves"].append(
                {"i": i, "shape": list(a.shape), "dtype": dtype})
        (d / "manifest.json").write_text(json.dumps(manifest))
        # unique tmp per writer: an abandoned async writer (e.g. a run
        # killed mid-save) and a resumed run's writer must never race on
        # one tmp path — the rename itself stays the atomic publish
        tmp = self.dir / f".LATEST.{os.getpid()}.{threading.get_ident()}.tmp"
        try:
            tmp.write_text(str(step))
            os.replace(tmp, self.dir / "LATEST")   # atomic publish
        except BaseException:
            tmp.unlink(missing_ok=True)
            raise

    # ---------------- restore ----------------
    def latest_step(self) -> int | None:
        p = self.dir / "LATEST"
        if not p.exists():
            return None
        return int(p.read_text().strip())

    def restore(self, tree_like, step: int | None = None):
        """(step, a tree shaped as ``tree_like`` whose leaves take the
        type and device of its leaves), or (None, None) with no
        checkpoint."""
        if step is None:
            step = self.latest_step()
            if step is None:
                return None, None
        d = self.dir / f"step_{step}"
        manifest = json.loads((d / "manifest.json").read_text())
        leaves = list(tree_leaves(tree_like))
        if len(leaves) != len(manifest["leaves"]):
            raise ValueError("checkpoint/model structure mismatch: "
                             f"{len(manifest['leaves'])} leaves in the "
                             f"checkpoint, {len(leaves)} in the tree")
        out = [_from_numpy(np.load(d / f"leaf_{i}.npy"), meta["dtype"])
               .to(device=leaf.device, dtype=leaf.dtype)
               for i, (meta, leaf) in enumerate(zip(manifest["leaves"],
                                                    leaves))]
        return step, tree_unflatten(tree_like, out)


# --------------------------------------------------------------------------
# cMPI arena backend — checkpoint into the shared pool
# --------------------------------------------------------------------------

class ArenaCheckpoint:
    """Checkpoints as named arena objects: ``<tag>:manifest`` (JSON) and
    ``<tag>:leaf<i>`` (raw bytes). A restarted rank (or a peer node sharing
    the pool) restores via open() — no filesystem, no network. A CUDA
    leaf needs a pool mapped into the GPU (``device="cuda"``)."""

    def __init__(self, arena: Arena, tag: str = "ckpt"):
        self.arena = arena
        self.tag = tag

    def _destroy_if_exists(self, name: str) -> None:
        try:
            self.arena.destroy(self.arena.open(name))
        except FileNotFoundError:
            pass

    def save(self, step: int, tree) -> None:
        manifest = {"step": step, "leaves": []}
        for i, x in enumerate(tree_leaves(tree)):
            data = as_u8(x.detach().contiguous())
            name = f"{self.tag}:leaf{i}"
            self._destroy_if_exists(name)
            h = self.arena.create(name, max(len(data), 1))
            # a CUDA leaf: cellcopy into the device window, stream synced
            self.arena.write(h, 0, data)
            manifest["leaves"].append(
                {"shape": list(x.shape), "dtype": _dtype_name(x)})
        mb = json.dumps(manifest).encode()
        self._destroy_if_exists(f"{self.tag}:manifest")
        h = self.arena.create(f"{self.tag}:manifest", len(mb))
        self.arena.write(h, 0, mb)       # manifest LAST: publication order

    def restore(self, tree_like):
        """(step, a tree shaped as ``tree_like``): each leaf read into a
        fresh tensor on its ``tree_like`` leaf's device, then cast to that
        leaf's type."""
        h = self.arena.open(f"{self.tag}:manifest")
        manifest = json.loads(self.arena.read(h, 0, h.size))
        leaves = list(tree_leaves(tree_like))
        out = []
        for i, (meta, leaf) in enumerate(zip(manifest["leaves"], leaves)):
            t = torch.empty(meta["shape"], device=leaf.device,
                            dtype=getattr(torch, meta["dtype"]))
            if t.numel():
                self.arena.read_into(
                    self.arena.open(f"{self.tag}:leaf{i}"), 0, as_u8(t))
            out.append(t.to(leaf.dtype))
        return manifest["step"], tree_unflatten(tree_like, out)
