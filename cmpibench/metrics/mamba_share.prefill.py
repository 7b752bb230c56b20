"""Per cent of rank 0's prefill time (its ``prefill`` spans in the
window) spent inside the program's ``mamba.mixer`` spans, which the
hybrid serve loop copies from the program's tracer in a traced run.
None where the run has no such span."""
from cmpibench import yardstick


def read(run):
    r = run["reports"][0]
    lo = r["t0_ns"]
    hi = lo + int(r["seconds"] * 1e9)
    spans = r.get("spans") or []
    pre = yardstick.clip([(s, e) for n, s, e in spans if n == "prefill"],
                         lo, hi)
    mixer = [(s, e) for n, s, e in spans if n == "mamba.mixer"]
    if not pre or not mixer:
        return None
    inside = [iv for a, b in pre for iv in yardstick.clip(mixer, a, b)]
    return 100.0 * yardstick.covered(inside) / yardstick.covered(pre)
