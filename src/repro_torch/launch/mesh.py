"""Production meshes as placements (the JAX package's
``repro.launch.mesh``). Functions only; nothing here spawns a rank.

Single pod: (16, 16) ("data", "model")    = 256 devices
Multi-pod:  (2, 16, 16) ("pod", "data", "model") = 512 devices

The JAX package builds a device mesh over forced host devices. The port
has no device mesh: a mesh is ``Placement``, whose ``.shape`` maps each
axis to its size, which is what ``distributed.sharding`` reads and what
the dry run (``launch/dryrun.py``) builds its rank-0 ``DistContext``
over. A real run places ranks with ``DistContext`` over a ``Comm``.

The ``pod`` axis is the expensive fabric (cross-pod): the cMPI-derived
rule is that it must carry thin traffic only (hierarchical collectives,
optionally compressed) — see distributed/schedules.py.
"""
from __future__ import annotations

import math
from dataclasses import dataclass


@dataclass(frozen=True)
class Placement:
    """A mesh of ``axes`` of ``sizes``, as a placement: ``.shape`` maps
    each axis to its size in mesh order."""
    sizes: tuple[int, ...]
    axes: tuple[str, ...]

    def __post_init__(self):
        if len(self.sizes) != len(self.axes):
            raise ValueError(f"mesh {self.sizes} over axes {self.axes}: "
                             "one size an axis")

    @property
    def shape(self) -> dict[str, int]:
        return dict(zip(self.axes, self.sizes))

    @property
    def size(self) -> int:
        return math.prod(self.sizes)


def make_production_mesh(*, multi_pod: bool = False) -> Placement:
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return Placement(shape, axes)


def make_test_mesh(shape=(2, 2), axes=("data", "model")) -> Placement:
    """Small mesh for CPU tests."""
    return Placement(tuple(shape), tuple(axes))


MESHES = {
    "single": dict(multi_pod=False, chips=256, tag="pod16x16"),
    "multi": dict(multi_pod=True, chips=512, tag="pod2x16x16"),
}
