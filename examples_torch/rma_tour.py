"""Tour of the one-sided (RMA v2) API over real processes, with CUDA
tensors: rput/rget ping-pong with request overlap, the notified-put
producer/consumer fast path (zero receiver-side payload copies), and the
get-based window allgather — all on one shared-memory window, with every
byte accounted in the ``rma_*`` ProtocolStats buckets. Each payload is a
tensor on the card and crosses the window through the ``cellcopy``
kernel; ``local_view`` reads the rank's own segment of the pool in place.

    python examples_torch/rma_tour.py                # on the card
    python examples_torch/rma_tour.py --device cpu   # on the CPU
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
MSG = 256 << 10              # 256 KiB rput/rget payload (chunked)
SHARD = 8 << 10              # 8 KiB per-rank allgather shard


def _ramp(n: int, start: int, dev) -> torch.Tensor:
    """``(arange(n) + start) mod 256`` as uint8 on ``dev``."""
    return ((torch.arange(n, device=dev) + start) % 256).to(torch.uint8)


def prog(env):
    ops.LAUNCHES = 0
    comm = env.comm
    dev = comm.device
    r, n = comm.rank, comm.size
    win = comm.win_allocate("tour", 1 << 20)
    report = {}
    st = env.arena.view.stats

    # ---- rput/rget ping-pong: local-completion requests --------------
    # Rank r rputs into its OWN segment (publish), fences, then rgets
    # its neighbour's segment. Both requests are pumped by the shared
    # progress engine one chunk per tick — the arithmetic between
    # issue and wait() runs while chunks move.
    src = _ramp(MSG, r, dev)
    win.fence()
    put_req = win.rput(r, 0, src, chunk_bytes="auto")
    overlap = float(torch.sqrt(torch.arange(4096.0, device=dev)).sum())
    put_req.wait()
    win.fence()
    peer = (r + 1) % n
    dst = torch.zeros(MSG, dtype=torch.uint8, device=dev)
    win.rget(peer, 0, dst, chunk_bytes="auto").wait()
    report["pingpong_ok"] = bool(torch.equal(dst, _ramp(MSG, peer, dev)))
    report["overlap"] = overlap > 0
    win.fence()

    # ---- notified put: producer/consumer, zero receiver copies -------
    # Even rank 2k produces for odd rank 2k+1. The payload moves
    # origin -> window once (counted as rma_notify at the ORIGIN); the
    # consumer spins on one non-temporal counter word and then reads
    # the data in place — its own copied-byte counters never move.
    slot = 512 << 10                      # clear of the ping-pong region
    if r % 2 == 0 and r + 1 < n:
        note = torch.tensor(list(f"batch-from-{r}".encode()),
                            dtype=torch.uint8, device=dev)
        win.put_notify(r + 1, slot, note)
        report["notify"] = "produced"
    elif r % 2 == 1:
        c0 = st.copied_bytes
        win.wait_notify(r - 1)
        seen = win.local_view(slot, 32)
        report["recv_copies"] = st.copied_bytes - c0   # stays 0
        payload = bytes(seen.cpu().numpy()).split(b"\0", 1)[0]
        report["notify"] = payload.decode()
    win.fence()

    # ---- get-based allgather: payloads never ride the wire -----------
    shard = torch.full((SHARD // 8,), float(r), dtype=torch.float64,
                       device=dev)
    gathered = win.allgather(shard)
    exp = torch.arange(n, dtype=torch.float64, device=dev).repeat_interleave(
        SHARD // 8)
    report["allgather_ok"] = bool(torch.equal(gathered, exp))

    report["paths"] = {k: v for k, v in st.path_copied_bytes.items()
                       if k.startswith("rma_") and v}
    win.free()
    report["launches"] = ops.LAUNCHES
    return report


CHECKS = ("pingpong_ok", "overlap", "allgather_ok")


def main(argv=None) -> dict:
    """Runs the tour on ``N`` processes, prints each rank's report and
    returns ``{"ranks": [report, ...], "seconds": s}``; raises if a
    rank's checks fail or a notified-put consumer copied a byte."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)
    t0 = time.perf_counter()
    res = run_processes(N, prog, pool_bytes=128 << 20, timeout=300,
                        device=args.device)
    seconds = time.perf_counter() - t0
    print(f"== RMA v2 tour on {N} real processes ({args.device}) ==")
    for r, rep in enumerate(res):
        print(f"rank {r}: {rep}")
    consumers = [rep for rep in res if "recv_copies" in rep]
    ok = all(rep["recv_copies"] == 0 for rep in consumers)
    print(f"\nnotified-put consumers copied 0 payload bytes on their "
          f"side: {ok} ({seconds:.1f} s)")
    bad = [(r, k) for r, rep in enumerate(res) for k in CHECKS
           if not rep[k]]
    if bad or not ok or not consumers:
        raise RuntimeError(f"rma_tour: checks failed (rank, check): {bad}; "
                           f"consumers copied 0 bytes: {ok}")
    return {"ranks": res, "seconds": seconds}


if __name__ == "__main__":
    main()
