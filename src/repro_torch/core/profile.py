"""Measured machine profile: the single source for every tuned constant.

The comm core carries four policies that used to be hand-tuned magic:

  1. the eager/rendezvous crossover (``eager_threshold="auto"`` init
     ping-pong probe),
  2. the chunk size for pipelined large collectives
     (``auto_chunk_bytes``'s fixed ``8x-crossover / payload//8`` rule),
  3. the hierarchical-allreduce group size (``_hier_group``'s
     nearest-sqrt divisor heuristic),
  4. the matchbox strip depth (``DEFAULT_MB_SLOTS = 4``).

``benchmarks/roofline.py --profile`` runs an ERT-style per-host sweep
(copy/reduce bandwidth per working-set size, pt2pt eager-vs-posted
crossover, an end-to-end chunk-size sweep over a real chunked
iallreduce, strip-scan and spill-promote cost) and writes the results
here as a cached,
schema-versioned ``artifacts/bench/machine_profile.json``.
``Comm(tuning="auto")`` loads it — freshness- and host-checked — and
derives all four constants from measurements (the derivations live in
this module so they are unit-testable without a sweep). A missing or
stale profile falls back LOUDLY to the old heuristics.

Every value that shapes the wire format (chunk size, matchbox depth)
must be identical on all ranks: ranks agree via a max-allreduce at
``Comm`` init (the ``_chunk_probe_base`` idiom), and the matchbox depth
— fixed before the shared region is even sized — is derived
deterministically from the shared profile file, with a post-init
agreement check that hard-fails on divergence.
"""
from __future__ import annotations

import json
import os
import platform
import time
import warnings
from pathlib import Path
from typing import Optional

SCHEMA_VERSION = 1
DEFAULT_PATH = Path("artifacts/bench") / "machine_profile.json"
ENV_PATH = "REPRO_MACHINE_PROFILE"          # overrides the default path
ENV_MAX_AGE = "REPRO_PROFILE_MAX_AGE_S"
DEFAULT_MAX_AGE_S = 24 * 3600.0

# bandwidth knee: the largest working set still delivering this
# fraction of the peak measured bandwidth (ERT's ceiling-break point)
KNEE_FRACTION = 0.8

# matchbox depth bounds: never shallower than the historical default,
# never deeper than a strip scan can stay cheap relative to one claim
MB_DEPTH_MIN = 4
MB_DEPTH_MAX = 32

# hier tier ratio clamp: a measured cache/DRAM ratio outside this range
# is a measurement artifact, not a real hierarchy
TIER_RATIO_MIN = 1.0
TIER_RATIO_MAX = 64.0


def host_fingerprint() -> str:
    """Cheap identity of the measured host: a profile from a different
    machine (or container shape) must not be trusted."""
    return (f"{platform.node()}|{platform.machine()}"
            f"|cpus={os.cpu_count()}")


def profile_path(path: str | os.PathLike | None = None) -> Path:
    if path is not None:
        return Path(path)
    env = os.environ.get(ENV_PATH)
    return Path(env) if env else DEFAULT_PATH


# --------------------------------------------------------------------------
# policy derivations (pure functions — unit-tested without a sweep)
# --------------------------------------------------------------------------

def derive_eager_threshold(crossover_bytes: int) -> int:
    """Largest size still sent eagerly: half the measured crossover —
    the same safety margin the init probe applies when rendezvous wins
    at the smallest probed size."""
    return max(64, int(crossover_bytes) // 2)


def derive_chunk_floor(crossover_bytes: int,
                       best_chunk_bytes: int) -> int:
    """Pipeline chunk size from the MEASURED chunk-size sweep (a real
    chunked iallreduce timed at each candidate chunk): the measured
    argmax, never below the rendezvous-amortization floor of 8x the
    crossover, never below 64 KiB (tag-window pressure). The copy-
    bandwidth knee alone is NOT the answer — a knee-sized chunk keeps
    every tile cache-resident but multiplies the per-chunk engine
    round-trip cost, and on hosts where yields are expensive that
    overhead swamps the cache win; only the end-to-end sweep sees both
    forces. ``best_chunk_bytes == 0`` means unchunked won everywhere
    probed — returns 0, and ``auto_chunk_bytes`` disables chunking."""
    if int(best_chunk_bytes) <= 0:
        return 0
    return max(64 * 1024, 8 * int(crossover_bytes),
               int(best_chunk_bytes))


def derive_tier_ratio(cache_gbps: float, dram_gbps: float) -> float:
    """Measured intra/inter tier bandwidth ratio for hier grouping."""
    if dram_gbps <= 0:
        return TIER_RATIO_MIN
    r = float(cache_gbps) / float(dram_gbps)
    return min(TIER_RATIO_MAX, max(TIER_RATIO_MIN, r))


def derive_mb_depth(spill_promote_us: float,
                    strip_scan_us_per_slot: float) -> int:
    """Strip depth where scanning one more slot costs about what one
    spill+promote cycle saves: depth ~ promote-cost / per-slot scan
    cost, clamped to [4, 32]."""
    if strip_scan_us_per_slot <= 0:
        return MB_DEPTH_MIN
    d = round(float(spill_promote_us) / float(strip_scan_us_per_slot))
    return int(min(MB_DEPTH_MAX, max(MB_DEPTH_MIN, d)))


# --------------------------------------------------------------------------
# the profile object
# --------------------------------------------------------------------------

class MachineProfile:
    """Validated view over one ``machine_profile.json``."""

    REQUIRED = ("schema", "host", "created",
                "eager_crossover_bytes", "copy_knee_bytes",
                "best_chunk_bytes",
                "cache_gbps", "dram_gbps",
                "strip_scan_us_per_slot", "spill_promote_us",
                "yield_cost_us")

    def __init__(self, data: dict, path: Optional[Path] = None):
        missing = [k for k in self.REQUIRED if k not in data]
        if missing:
            raise ValueError(f"machine profile missing fields: {missing}")
        self.data = data
        self.path = path

    # -- raw fields ----------------------------------------------------
    @property
    def eager_crossover(self) -> int:
        return int(self.data["eager_crossover_bytes"])

    @property
    def copy_knee(self) -> int:
        return int(self.data["copy_knee_bytes"])

    @property
    def best_chunk(self) -> int:
        return int(self.data["best_chunk_bytes"])

    @property
    def yield_cost_us(self) -> float:
        return float(self.data["yield_cost_us"])

    @property
    def smoke(self) -> bool:
        return bool(self.data.get("smoke", False))

    # -- derived policies ----------------------------------------------
    @property
    def eager_threshold(self) -> int:
        return derive_eager_threshold(self.eager_crossover)

    @property
    def chunk_floor(self) -> int:
        return derive_chunk_floor(self.eager_crossover, self.best_chunk)

    @property
    def tier_ratio(self) -> float:
        return derive_tier_ratio(float(self.data["cache_gbps"]),
                                 float(self.data["dram_gbps"]))

    @property
    def mb_depth(self) -> int:
        return derive_mb_depth(
            float(self.data["spill_promote_us"]),
            float(self.data["strip_scan_us_per_slot"]))

    # -- freshness ------------------------------------------------------
    def stale_reason(self, now: Optional[float] = None) -> Optional[str]:
        """None when the profile is trustworthy on this host, else a
        human-readable reason (schema drift, foreign host, age)."""
        if int(self.data["schema"]) != SCHEMA_VERSION:
            return (f"schema {self.data['schema']} != "
                    f"{SCHEMA_VERSION}")
        if self.data["host"] != host_fingerprint():
            return (f"host fingerprint mismatch "
                    f"({self.data['host']!r} != "
                    f"{host_fingerprint()!r})")
        max_age = float(os.environ.get(ENV_MAX_AGE, DEFAULT_MAX_AGE_S))
        age = (time.time() if now is None else now) \
            - float(self.data["created"])
        if age > max_age:
            return f"profile is {age / 3600.0:.1f} h old (max " \
                   f"{max_age / 3600.0:.1f} h)"
        return None


def load_profile_info(path: str | os.PathLike | None = None, *,
                      quiet: bool = False
                      ) -> tuple[Optional[MachineProfile], Optional[str]]:
    """``(profile, reject_reason)``: the profile when it is fresh and
    trustworthy (reason None), else ``(None, reason)`` — the reason a
    long-lived process can SURFACE (``Comm.tuning_status``,
    ``trace_report()``) instead of losing it after the one warning."""
    p = profile_path(path)
    if not p.exists():
        return None, f"no machine profile at {p}"
    try:
        prof = MachineProfile(json.loads(p.read_text()), p)
    except (ValueError, OSError, json.JSONDecodeError) as e:
        reason = f"unreadable machine profile {p}: {e}"
        if not quiet:
            warnings.warn(f"ignoring {reason}", RuntimeWarning,
                          stacklevel=2)
        return None, reason
    reason = prof.stale_reason()
    if reason is not None:
        if not quiet:
            warnings.warn(
                f"ignoring stale machine profile {p}: {reason}; "
                f"falling back to heuristic tuning (regenerate with "
                f"`python -m benchmarks.roofline --profile`)",
                RuntimeWarning, stacklevel=2)
        return None, f"stale machine profile {p}: {reason}"
    return prof, None


def load_profile(path: str | os.PathLike | None = None, *,
                 quiet: bool = False) -> Optional[MachineProfile]:
    """Load a FRESH machine profile or return None. Stale / foreign /
    malformed profiles are rejected with a loud warning (the caller
    falls back to the heuristic policies) — silent mis-tuning from a
    recycled CI artifact is the failure mode this guards against.
    ``load_profile_info`` additionally returns the rejection reason."""
    return load_profile_info(path, quiet=quiet)[0]


def write_profile(data: dict,
                  path: str | os.PathLike | None = None) -> Path:
    """Stamp schema/host/created and write atomically. ``data`` holds
    the measured fields (see ``MachineProfile.REQUIRED`` plus the raw
    sweep curves the report prints)."""
    out = dict(data)
    out["schema"] = SCHEMA_VERSION
    out["host"] = host_fingerprint()
    out["created"] = time.time()
    MachineProfile(out)                      # validate before writing
    p = profile_path(path)
    p.parent.mkdir(parents=True, exist_ok=True)
    tmp = p.with_suffix(".tmp")
    tmp.write_text(json.dumps(out, indent=2, sort_keys=True) + "\n")
    tmp.replace(p)
    return p
