"""The one traffic generator: every mix under ``traffic/`` is a data file
of parameters that this module reads. Everything is drawn from the run's
``--seed`` with NumPy, so both ranks of a run, and the check after it,
draw the same schedule, payloads and prompts without exchanging them.

Message mixes (``"loop": "pingpong"`` or ``"stream"``): the sizes of a
block are the mix's ``sizes``, each ``per_block`` times, in an order
drawn per block, so every seed sends the same sizes in another order.
Each message takes its payload from an offset, drawn too, into one
seeded byte string (``payload``). Serving mixes (``"loop": "serve"``):
every batch's prompt ids are drawn from the seed.
"""
from __future__ import annotations

import hashlib

import numpy as np

MASK64 = (1 << 64) - 1


def stream_seed(seed: int, *what) -> int:
    """A 63-bit seed for one named stream of the run's ``seed`` (a
    ``torch.Generator`` takes it as it is)."""
    h = hashlib.sha256(repr((int(seed) & MASK64,) + what).encode())
    return int.from_bytes(h.digest()[:8], "little") >> 1


def rng(seed: int, *what) -> np.random.Generator:
    return np.random.default_rng(stream_seed(seed, *what))


def payload(traffic: dict, seed: int) -> np.ndarray:
    """The seeded bytes every message of the run is cut from."""
    return rng(seed, "payload").integers(
        0, 256, traffic["payload_bytes"], dtype=np.uint8)


class MessagePlan:
    """Message ``i``'s size, payload offsets (one per direction: the
    ping's and the pong's) and whether the check keeps it (``kept``;
    every message where ``keep_share`` is 1)."""

    def __init__(self, traffic: dict, seed: int):
        self.t = traffic
        self.seed = seed
        self.block = len(traffic["sizes"]) * traffic["per_block"]
        self._cache: dict[int, tuple] = {}

    def _block(self, b: int) -> tuple:
        got = self._cache.get(b)
        if got is None:
            t = self.t
            g = rng(self.seed, "block", b)
            sizes = np.repeat(np.asarray(t["sizes"], dtype=np.int64),
                              t["per_block"])
            sizes = g.permutation(sizes)
            align = t["align"]
            room = (t["payload_bytes"] - sizes) // align + 1
            offs = g.integers(0, room, size=(2, len(sizes))) * align
            kept = g.random(len(sizes)) < t.get("keep_share", 1.0)
            got = (sizes, offs, kept)
            self._cache = {b: got}        # one block live at a time
        return got

    def __call__(self, i: int) -> tuple[int, int, int, bool]:
        sizes, offs, kept = self._block(i // self.block)
        j = i % self.block
        return int(sizes[j]), int(offs[0, j]), int(offs[1, j]), \
            bool(kept[j])


def prompts(traffic: dict, seed: int, batch: int, vocab: int) -> np.ndarray:
    """Batch ``batch``'s global prompt ids (rows, prompt_len), int64."""
    return rng(seed, "prompts", batch).integers(
        0, vocab, size=(traffic["rows"], traffic["prompt_len"]),
        dtype=np.int64)


def sample(seed: int, what: str, n: int, k: int, must=()) -> list[int]:
    """``k`` of ``range(n)`` drawn from the seed, with ``must`` in them."""
    chosen = [m for m in must if 0 <= m < n]
    rest = [i for i in rng(seed, "sample", what).permutation(n).tolist()
            if i not in chosen]
    return sorted(chosen + rest[:max(0, k - len(chosen))])
