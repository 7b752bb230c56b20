"""Tour of the Comm API v2 over real processes, with CUDA tensors:
method collectives on pool-resident round buffers, split()/dup()
sub-communicators, the hierarchical allreduce, persistent requests, and
the auto-tuned eager threshold. Every payload is a tensor on the card
and crosses the pool through the ``cellcopy`` kernel.

    python examples_torch/comm_v2_tour.py                # on the card
    python examples_torch/comm_v2_tour.py --device cpu   # on the CPU
"""
import argparse
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "src"))

import torch  # noqa: E402

from repro_torch.core import run_processes  # noqa: E402
from repro_torch.kernels.cellcopy import ops  # noqa: E402

N = 4
VEC = 1 << 16                # 512 KB of float64 per collective


def prog(env):
    ops.LAUNCHES = 0
    comm = env.comm
    dev = comm.device
    report = {}
    report["threshold"] = (comm.eager_threshold, comm.probed_crossover)

    # ---- method collectives (bulk -> pool-resident round buffers) ----
    ramp = torch.arange(VEC, dtype=torch.float64, device=dev) + 1
    x = ramp * (comm.rank + 1)
    st = env.arena.view.stats
    s0 = st.snapshot()
    total = comm.allreduce(x, algo="ring")
    delta = st.delta(s0)
    report["allreduce_copied"] = delta["copied_bytes"]
    report["allreduce_paths"] = {k: v for k, v in
                                 delta["path_copied_bytes"].items() if v}
    # integer-valued float64: every order of the adds gives the exact sum
    report["allreduce_ok"] = bool(torch.equal(total, ramp * 10))

    # ---- split: two rows of two ranks, remapped ranks ----------------
    row = comm.split(color=comm.rank // 2, key=comm.rank)
    row_sum = row.allreduce(torch.tensor([float(comm.rank)], device=dev))
    report["row"] = (row.rank, row.parent_ranks, float(row_sum[0]))

    # ---- dup: congruent comm with isolated traffic -------------------
    clone = comm.dup()
    word = torch.tensor(list(f"r{clone.rank}".encode()), dtype=torch.uint8,
                        device=dev)
    clone.send((clone.rank + 1) % N, word, tag=1)
    msg, _ = clone.recv((clone.rank - 1) % N, tag=1)
    report["dup_msg"] = bytes(msg.cpu().numpy()).decode()

    # ---- hierarchical allreduce over split() groups ------------------
    h = comm.allreduce(x, algo="hier")
    report["hier_equals_ring"] = bool(torch.equal(h, total))

    # ---- persistent requests: stable arena footprint -----------------
    peer = (comm.rank + 1) % N
    src = (comm.rank - 1) % N
    sbuf = torch.zeros(VEC, dtype=torch.float64, device=dev)
    rbuf = torch.zeros(VEC, dtype=torch.float64, device=dev)
    psend = comm.send_init(peer, sbuf, tag=7)
    precv = comm.recv_init(src, rbuf, tag=7)
    comm.barrier()
    slots0 = None
    rounds_ok = True
    for i in range(8):
        sbuf.fill_(comm.rank * 100 + i)
        psend.start(); precv.start()
        precv.wait(); psend.wait()
        rounds_ok = rounds_ok and bool(torch.all(rbuf == src * 100 + i))
        if i == 0:
            slots0 = env.arena.stats()["slots_used"]
    comm.barrier()
    report["slots_stable"] = env.arena.stats()["slots_used"] == slots0
    report["persistent_ok"] = rounds_ok
    comm.barrier()                # every rank has read the count
    psend.free()
    precv.free()
    report["launches"] = ops.LAUNCHES
    return report


CHECKS = ("allreduce_ok", "hier_equals_ring", "slots_stable",
          "persistent_ok")


def main(argv=None) -> dict:
    """Runs the tour on ``N`` processes, prints each rank's report and
    returns ``{"ranks": [report, ...], "seconds": s}``; raises if a
    rank's checks fail."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)
    t0 = time.perf_counter()
    res = run_processes(N, prog, pool_bytes=128 << 20,
                        eager_threshold="auto", timeout=300,
                        device=args.device)
    seconds = time.perf_counter() - t0
    print(f"== Comm API v2 on {N} real processes ({args.device}) ==")
    for r, rep in enumerate(res):
        thr, cross = rep["threshold"]
        print(f"rank {r}: auto eager_threshold={thr}B "
              f"(probe crossover: {cross or 'beyond range'}); "
              f"allreduce copied {rep['allreduce_copied']}B; "
              f"row={rep['row']}; dup got '{rep['dup_msg']}'; "
              f"persistent-req slots stable: {rep['slots_stable']}; "
              f"cellcopy launches {rep['launches']}")
    bad = [(r, k) for r, rep in enumerate(res) for k in CHECKS
           if not rep[k]]
    if bad:
        raise RuntimeError(f"comm_v2_tour: checks failed (rank, check): "
                           f"{bad}")
    print(f"\nhierarchical == ring result on every rank; "
          f"persistent requests left the arena footprint flat: True "
          f"({seconds:.1f} s)")
    return {"ranks": res, "seconds": seconds}


if __name__ == "__main__":
    main()
