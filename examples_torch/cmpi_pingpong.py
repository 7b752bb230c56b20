"""cMPI ping-pong: the paper's core mechanism live — two REAL processes
exchanging messages through shared memory (the CXL SHM stand-in), with the
arena, SPSC queues, MPI-4 persistent requests (Comm API v2) and one-sided
RMA windows, vs. a localhost TCP baseline.

The messages are CUDA tensors: they enter and leave the pinned, mapped
pool through the ``cellcopy`` kernel. The TCP baseline moves the same
device buffers (device -> host, ``sendall``, ``recv_into``, host ->
device, on each side), so both columns pay for the same endpoints. Each
rank sends its own byte pattern and checks every message it received,
byte for byte, after the timed loop. Each column and size first moves
``WARMUP`` untimed messages (the first launches and copies of a process
cost milliseconds); they land in the rows the last timed ones overwrite.

    python examples_torch/cmpi_pingpong.py                # on the card
    python examples_torch/cmpi_pingpong.py --device cpu   # on the CPU
"""
import argparse
import functools
import multiprocessing as mp
import socket
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "src"))

import torch  # noqa: E402

from repro_torch.core import run_processes  # noqa: E402
from repro_torch.kernels.cellcopy import ops  # noqa: E402

SIZES = [8, 512, 4096, 65536]
ITERS = 100
WARMUP = 3          # untimed messages a size and column, into the last rows
COLUMNS = ("two", "pers", "one")


def pattern(size: int, rank: int, device) -> torch.Tensor:
    """The bytes rank ``rank`` sends at ``size``: a ramp, never zeros."""
    i = torch.arange(size, device=device)
    return ((i * (2 * rank + 3) + size + 17 * rank + 1) % 256).to(
        torch.uint8)


def _one_thread(device) -> int:
    """On the CPU, run this endpoint's copies on one thread (a 64 KiB
    copy split over the thread pool costs milliseconds on a shared
    host); returns the thread count to restore."""
    n = torch.get_num_threads()
    if torch.device(device).type == "cpu":
        torch.set_num_threads(1)
    return n


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def _exact(rows: torch.Tensor, want: torch.Tensor) -> bool:
    """Every row (one received message each) equals ``want``."""
    return bool(torch.equal(rows, want.expand_as(rows)))


def prog(env, iters: int = ITERS):
    ops.LAUNCHES = 0
    comm, rank = env.comm, env.rank
    dev = comm.device
    _one_thread(dev)
    peer = 1 - rank
    out: dict = {}
    exact: dict = {}
    # two-sided over the SPSC queue matrix; message i lands in its row
    for s in SIZES:
        mine, theirs = pattern(s, rank, dev), pattern(s, peer, dev)
        rows = torch.zeros((iters, s), dtype=torch.uint8, device=dev)
        comm.barrier()
        for i in range(-WARMUP, iters):
            if i == 0:
                t0 = time.perf_counter()
            if rank == 0:
                comm.send(1, mine, tag=1)
                comm.recv_into(1, rows[i % iters], tag=2)
            else:
                comm.recv_into(0, rows[i % iters], tag=1)
                comm.send(0, mine, tag=2)
        _sync(dev)
        out[("two", s)] = (time.perf_counter() - t0) / iters / 2
        exact[("two", s)] = _exact(rows, theirs)
    # two-sided again through MPI-4 persistent requests (Comm API v2):
    # the wire plan is fixed once, start()/wait() reuse it every iter;
    # each arrival is copied on the device into its row (enqueued only)
    for s in SIZES:
        sbuf = pattern(s, rank, dev)
        rbuf = torch.zeros(s, dtype=torch.uint8, device=dev)
        rows = torch.zeros((iters, s), dtype=torch.uint8, device=dev)
        psend = comm.send_init(peer, sbuf, tag=3)
        precv = comm.recv_init(peer, rbuf, tag=3)
        comm.barrier()
        for i in range(-WARMUP, iters):
            if i == 0:
                t0 = time.perf_counter()
            if rank == 0:
                psend.start().wait()
                precv.start(); precv.wait()
            else:
                precv.start(); precv.wait()
                psend.start().wait()
            rows[i % iters].copy_(rbuf)
        _sync(dev)
        out[("pers", s)] = (time.perf_counter() - t0) / iters / 2
        exact[("pers", s)] = _exact(rows, pattern(s, peer, dev))
        comm.barrier()
        psend.free()
        precv.free()
    # one-sided put/get through an RMA window between fences: rank 0
    # puts its message into rank 1's segment and reads it all back
    win = comm.win_allocate("demo", max(SIZES) + 64)
    for s in SIZES:
        mine = pattern(s, rank, dev)
        rows = torch.zeros((iters, s), dtype=torch.uint8, device=dev)
        win.fence()
        for i in range(-WARMUP, iters):
            if i == 0:
                t0 = time.perf_counter()
            if rank == 0:
                win.put(1, 0, mine)
                win.get_into(1, 0, rows[i % iters])
        _sync(dev)
        out[("one", s)] = (time.perf_counter() - t0) / iters / 2
        win.fence()
        exact[("one", s)] = (_exact(rows, mine) if rank == 0 else bool(
            torch.equal(win.local_view(0, s), pattern(s, 0, dev))))
        win.fence()
    win.free()
    out["exact"] = exact
    out["launches"] = ops.LAUNCHES
    return out


# ---------------------------------------------------------------------------
# the localhost TCP baseline, over the same device buffers
# ---------------------------------------------------------------------------

def _recv_exact(conn: socket.socket, view: memoryview) -> None:
    got = 0
    while got < len(view):
        n = conn.recv_into(view[got:])
        if n == 0:
            raise ConnectionError("peer closed the connection")
        got += n


def _tcp_server(q, sizes: list, iters: int, device: str) -> None:
    """Echo side: for each message, ``recv_into`` a host buffer, copy it
    to the device, then send this side's device pattern back through a
    host buffer. Reports whether every message arrived byte-exact."""
    _one_thread(device)
    srv = socket.socket()
    srv.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
    srv.bind(("127.0.0.1", 0))
    srv.listen(1)
    srv.settimeout(60)
    q.put(srv.getsockname()[1])
    conn, _ = srv.accept()
    conn.settimeout(60)
    conn.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
    exact = {}
    for s in sizes:
        mine = pattern(s, 1, device)
        rows = torch.zeros((iters, s), dtype=torch.uint8, device=device)
        rbuf, sbuf = bytearray(s), bytearray(s)
        rhost = torch.frombuffer(rbuf, dtype=torch.uint8)
        shost = torch.frombuffer(sbuf, dtype=torch.uint8)
        view = memoryview(rbuf)
        for i in range(-WARMUP, iters):
            _recv_exact(conn, view)
            rows[i % iters].copy_(rhost)                  # host -> device
            shost.copy_(mine)                     # device -> host
            conn.sendall(sbuf)
        exact[s] = _exact(rows, pattern(s, 0, device))
    conn.close()
    srv.close()
    q.put(exact)


def tcp_pingpong(sizes: list, iters: int, device: str) -> tuple:
    """Half round-trip seconds per size over localhost TCP, and whether
    every message arrived byte-exact on both sides. The server is a
    spawned process (a CUDA context does not survive ``fork``)."""
    ctx = mp.get_context("spawn")
    q = ctx.Queue()
    p = ctx.Process(target=_tcp_server, args=(q, sizes, iters, device),
                    daemon=True)
    p.start()
    threads = _one_thread(device)
    try:
        port = q.get(timeout=120)
        cli = socket.create_connection(("127.0.0.1", port), timeout=60)
        cli.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        times, exact = {}, {}
        for s in sizes:
            mine = pattern(s, 0, device)
            rows = torch.zeros((iters, s), dtype=torch.uint8, device=device)
            rbuf, sbuf = bytearray(s), bytearray(s)
            rhost = torch.frombuffer(rbuf, dtype=torch.uint8)
            shost = torch.frombuffer(sbuf, dtype=torch.uint8)
            view = memoryview(rbuf)
            for i in range(-WARMUP, iters):
                if i == 0:
                    t0 = time.perf_counter()
                shost.copy_(mine)                 # device -> host
                cli.sendall(sbuf)
                _recv_exact(cli, view)
                rows[i % iters].copy_(rhost)              # host -> device
            _sync(device)
            times[s] = (time.perf_counter() - t0) / iters / 2.0
            exact[s] = _exact(rows, pattern(s, 1, device))
        cli.close()
        server_exact = q.get(timeout=120)
    finally:
        torch.set_num_threads(threads)
        p.join(timeout=30)
        if p.is_alive():
            p.kill()
            p.join(10)
    return times, {s: exact[s] and server_exact[s] for s in sizes}


def main(argv=None) -> dict:
    """Runs the ping-pong and the TCP baseline, prints the table and
    returns ``{"us": {column: {size: us}}, "exact": ..., "launches":
    [per rank], "ranks": [report, ...]}``; raises if a message arrived
    different."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--iters", type=int, default=ITERS)
    args = ap.parse_args(argv)
    if args.iters < 1:
        ap.error("--iters must be at least 1")
    shm = run_processes(2, functools.partial(prog, iters=args.iters),
                        pool_bytes=64 << 20, cell_size=65536,
                        device=args.device)
    tcp, tcp_exact = tcp_pingpong(SIZES, args.iters, args.device)
    us = {c: {s: shm[0][(c, s)] * 1e6 for s in SIZES} for c in COLUMNS}
    us["tcp"] = {s: tcp[s] * 1e6 for s in SIZES}
    print(f"{'size':>8s} {'cMPI two-sided':>16s} {'cMPI persistent':>16s} "
          f"{'cMPI one-sided':>16s} {'localhost TCP':>15s}")
    for s in SIZES:
        print(f"{s:8d} {us['two'][s]:13.1f} us "
              f"{us['pers'][s]:13.1f} us "
              f"{us['one'][s]:13.1f} us "
              f"{us['tcp'][s]:12.1f} us")
    print(f"\n({args.device}: CPython per-op cost dominates the absolute "
          f"numbers; the calibrated\n model in repro_torch.perfmodel "
          f"carries the paper's hardware-level ratios.)")
    exact = {f"{c}:{s}": all(r["exact"][(c, s)] for r in shm)
             for c in COLUMNS for s in SIZES}
    exact.update({f"tcp:{s}": tcp_exact[s] for s in SIZES})
    bad = [k for k, ok in exact.items() if not ok]
    if bad:
        raise RuntimeError(f"cmpi_pingpong: messages differ: {bad}")
    return {"us": us, "exact": exact,
            "launches": [r["launches"] for r in shm], "ranks": shm}


if __name__ == "__main__":
    main()
