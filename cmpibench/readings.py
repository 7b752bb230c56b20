"""What the metric readers under ``metrics/`` share: the events of the
window, counted once a data row, and the device trace's sums."""
from __future__ import annotations

from cmpibench import yardstick


def messages(run: dict) -> int:
    """Messages received over the run's loop, both ranks."""
    return sum(r["messages_received"] for r in run["reports"])


def counter(run: dict, key: str) -> int:
    return sum(r[key] for r in run["reports"])


def row_events(run: dict, in_window: bool = True) -> list[tuple]:
    """``(kind, done, rows, pos, wall)`` of every step a data row's
    leader completed, within its window where ``in_window``."""
    out = []
    for r in run["reports"]:
        if not r.get("leader"):
            continue
        end = r["t0"] + r["seconds"]
        out += [e for e in r["events"]
                if not in_window or r["t0"] <= e[1] <= end]
    return out


def tokens(events, *, prompt: bool) -> int:
    """The first token when a prefill completes, with its prompt tokens
    where ``prompt``, and a decode step's tokens when it completes."""
    return sum(rows * (pos * prompt + 1) if kind == "prefill" else rows
               for kind, _, rows, pos, _ in events)


def model_flops(run: dict, events) -> int:
    m = run["config"]
    return sum(yardstick.prefill_flops(m, rows, pos) if kind == "prefill"
               else yardstick.decode_flops(m, rows, pos)
               for kind, _, rows, pos, _ in events)


def mfu(run: dict):
    """Model FLOPs of the window's prefills and decode steps (the frozen
    formula in ``yardstick``), over the window's length times one H100's
    dense bf16 peak, in per cent."""
    ev = row_events(run)
    if not ev:
        return None
    return 100.0 * model_flops(run, ev) / (run["seconds"]
                                           * yardstick.PEAK_BF16_FLOPS)


def device_time(run: dict, match) -> tuple[float, int]:
    """Seconds and count of the traced operations whose name ``match``
    accepts, over the whole traced span (not clipped to the window)."""
    ev = [e for e in run["trace"]["events"] if match(e[0])]
    return sum(e[2] - e[1] for e in ev) / 1e9, len(ev)


def idle_share(run: dict):
    """Per cent of the window in which no rank's operation ran on the card;
    None where the trace saw no operation."""
    t = run.get("trace")
    if not t or not t["events"]:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])


def collective_share(run: dict):
    """Per cent of each rank's window spent inside the collectives of its
    sub-communicators (the traced run's spans), averaged over ranks."""
    shares = []
    for r in run["reports"]:
        lo = r["t0_ns"]
        hi = lo + int(r["seconds"] * 1e9)
        iv = [(s, e) for n, s, e in r.get("spans", [])
              if n.startswith("collective:")]
        shares.append(yardstick.covered(yardstick.clip(iv, lo, hi))
                      / (hi - lo))
    return 100.0 * sum(shares) / len(shares) if shares else None
