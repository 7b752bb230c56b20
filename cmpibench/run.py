"""The benchmark of the PyTorch/CUDA port of cMPI: one run of one cell.

    python3 cmpibench/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

Prints, as the last line of standard output, one JSON object: whether
the outputs were correct, the requests or messages attempted and
failed, the cell's metrics (end to end with ``--trace 0``, per layer
with ``--trace 1``) and the device; the numbers compared, each beside
its limit, come last in it and as the last lines of standard error.
Exits non-zero, printing no result, without enough CUDA devices.
"""
import sys
from pathlib import Path

_ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(_ROOT / "src"), str(_ROOT)]

if __name__ == "__main__":
    from cmpibench.harness import main
    sys.exit(main(sys.argv[1:]))
