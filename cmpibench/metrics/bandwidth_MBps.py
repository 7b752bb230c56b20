"""Payload bytes landed in the receiver's CUDA tensors by windows that
completed within the window, over the window's length, in MB/s."""


def read(run):
    for r in run["reports"]:
        if "windows" in r:
            end = r["t0"] + r["seconds"]
            landed = sum(n for t, n in r["windows"] if t <= end)
            return landed / r["seconds"] / 1e6
    return None
