"""Per cent of the payload bytes that took the posted rendezvous path
(ProtocolStats.path_copied_bytes), both ranks."""

PATHS = ("eager", "rndv_staged", "rndv_posted")


def read(run):
    got = {p: sum(r["path_bytes"].get(p, 0) for r in run["reports"])
           for p in PATHS}
    total = sum(got.values())
    return 100.0 * got["rndv_posted"] / total if total else None
