"""Fig-10-style strong-scaling study on the event simulator: CG and
miniAMR over CXL SHM vs TCP fabrics, 8 procs/node. Host code only: the
simulator runs no kernel and needs no card.

    PYTHONPATH=src python examples_torch/scaling_study.py --nodes 2 4 8 16
"""
import argparse
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "src"))

from repro_torch.perfmodel.apps import (cg_program,  # noqa: E402
                                        miniamr_program)
from repro_torch.perfmodel.interconnects import (CXL_SHM,  # noqa: E402
                                                 ETHERNET_TCP, MELLANOX_TCP)
from repro_torch.perfmodel.simulator import Engine  # noqa: E402


def main(argv=None) -> dict:
    """Prints the two tables and returns them: ``{app: {nodes: {fabric:
    total_s, "cxl_comm_fraction": x}}}``."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--nodes", type=int, nargs="*", default=[2, 4, 8, 16])
    args = ap.parse_args(argv)

    out: dict = {}
    for app, maker, kw in (("CG", cg_program, {"iters": 20}),
                           ("miniAMR", miniamr_program, {"steps": 20})):
        print(f"\n== {app} (8 procs/node) ==")
        print(f"{'nodes':>6s} {'cxl_shm':>10s} {'tcp_cx6':>10s} "
              f"{'tcp_eth':>10s} {'cxl comm%':>10s}")
        for nodes in args.nodes:
            n = nodes * 8
            res = {}
            for ic in (CXL_SHM, MELLANOX_TCP, ETHERNET_TCP):
                res[ic.name] = Engine(n, ic, procs_per_node=8).run(
                    lambda r: maker(r, n, **kw))
            c = res["cxl_shm"]
            print(f"{nodes:6d} {c['total_s']:9.3f}s "
                  f"{res['tcp_cx6dx']['total_s']:9.3f}s "
                  f"{res['tcp_ethernet']['total_s']:9.3f}s "
                  f"{c['comm_fraction'] * 100:9.1f}%")
            out.setdefault(app, {})[nodes] = {
                **{k: v["total_s"] for k, v in res.items()},
                "cxl_comm_fraction": c["comm_fraction"]}
    return out


if __name__ == "__main__":
    main()
