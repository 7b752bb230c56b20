"""The port's schedule compiler against the JAX package's: for every
config of the verifier's matrix (up to 8 ranks), every rank's compiled
schedule has the same nodes (kind, peer, round tag, byte ranges,
dependencies) and the same slot sizes, rounds and chunking."""
import dataclasses
from collections import defaultdict

import pytest

torch = pytest.importorskip("torch")

from repro.analysis.verify import iter_matrix  # noqa: E402
from repro.core import sched as ref_sched  # noqa: E402
from repro_torch.core import sched as port_sched  # noqa: E402

MAX_N = 8
_BY_KIND = defaultdict(list)
for _cfg in iter_matrix(MAX_N):
    _BY_KIND[_cfg["kind"]].append(_cfg)


class _View:
    """What ``compile_schedule`` reads of a communicator."""

    def __init__(self, n: int, rank: int):
        self.size, self.rank, self._sched_cache = n, rank, {}


def _plain(x):
    """Package-independent form: dataclasses by class name and fields."""
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return (type(x).__name__,
                {f.name: _plain(getattr(x, f.name))
                 for f in dataclasses.fields(x)})
    if isinstance(x, (list, tuple)):
        return [_plain(v) for v in x]
    if isinstance(x, dict):
        return {k: _plain(v) for k, v in x.items()}
    return x


def _compile(mod, cfg: dict, rank: int):
    kw = {k: v for k, v in cfg.items() if k not in ("kind", "n")}
    return mod.compile_schedule(_View(cfg["n"], rank), cfg["kind"], **kw)


@pytest.mark.parametrize("kind", sorted(_BY_KIND))
def test_schedules_match_reference(kind):
    for cfg in _BY_KIND[kind]:
        for rank in range(cfg["n"]):
            got = _plain(_compile(port_sched, cfg, rank))
            want = _plain(_compile(ref_sched, cfg, rank))
            assert got == want, (cfg, rank)
