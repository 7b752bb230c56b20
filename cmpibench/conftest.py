"""The benchmark's CPU tests build their tiny checkout with
``tests.tiny_cells.make_root``, which has a tiny cell for every cell of
BENCHMARK.json. ``tests.cpu_cells.make_root`` knows the first four cells
alone and raises on any later one a metric names, so its callers here
get the other (``PERF.md``, Open questions: the one-line repair of
``cpu_cells`` belongs to a benchmark change)."""
from cmpibench.tests import cpu_cells, tiny_cells

cpu_cells.make_root = tiny_cells.make_root
