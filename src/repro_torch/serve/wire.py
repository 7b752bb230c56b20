"""Wire structs and deterministic synthetic content for the serve tier.

Every control message is a fixed-width little array of int64 words so
the router/worker pools can pre-plan them as MPI-4 persistent requests
(``send_init``/``recv_init``): admission is a hot loop, not a malloc
loop.  Two frames exist:

  ADMIT  router -> worker   [MSG_ADMIT, sid, epoch, prompt, gen,
                             n_pages, packed_page * max_pages]
  STOP   router -> worker   [MSG_STOP, 0, ...]          (same width)
  DONE   worker -> router   [MSG_DONE, worker, sid, epoch, tokens,
                             checksum, steps, 0]
  BEAT   worker -> router   [MSG_BEAT, worker, 0, 0, tokens, 0,
                             steps, 0]                  (same width)

``epoch`` tracks re-admissions after a worker death: the router only
accepts a DONE whose (sid, epoch) matches the live assignment, so a
straggler completion from a retired placement can never double-count.

Page placements travel packed as ``home << 32 | slot`` — the router is
the single allocator of page slots, workers just obey the placement.

All synthetic content (decode tokens, KV page bytes) is a pure
function of ``(session, position, seed)`` so a re-routed session
regenerates byte-identical pages on a different worker and the router
can verify end-to-end checksums without ever holding the data.

The frames, ``splitmix64`` and the page bytes (numpy ``PCG64``) are the
JAX package's bit for bit, so one seed gives the same sessions, pages
and checksums in both packages; ``page_checksum`` also takes a tensor
(on any device) and gives the same integer.
"""
from __future__ import annotations

import numpy as np
import torch

MSG_ADMIT = 1
MSG_STOP = 2
MSG_DONE = 3
MSG_BEAT = 4

DONE_WORDS = 8
VOCAB = 50257
_U64 = (1 << 64) - 1


def admit_words(max_pages: int) -> int:
    return 6 + int(max_pages)


def pack_page(home: int, slot: int) -> int:
    return (int(home) << 32) | int(slot)


def unpack_page(word: int) -> tuple[int, int]:
    w = int(word)
    return w >> 32, w & 0xFFFFFFFF


# --------------------------------------------------------------------------
# deterministic synthetic content
# --------------------------------------------------------------------------

def _mix(x: int) -> int:
    """splitmix64 finalizer — the usual avalanche over 64-bit ints."""
    x &= _U64
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & _U64
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & _U64
    return x ^ (x >> 31)


def token(sid: int, pos: int, seed: int) -> int:
    """The decode token of session ``sid`` at KV position ``pos``."""
    return _mix(seed * 0x9E3779B97F4A7C15 + sid * 0x632BE59BD9B4E019
                + pos) % VOCAB


def page_fill(sid: int, page: int, seed: int, nbytes: int) -> np.ndarray:
    """The KV bytes of page ``page`` of session ``sid`` — regenerable
    anywhere, so a fault-rerouted session reproduces identical pages."""
    rng = np.random.Generator(np.random.PCG64(
        _mix(seed * 0xD6E8FEB86659FD93 + sid * 0xCA5A826395121157 + page)))
    return rng.integers(0, 256, nbytes, dtype=np.uint8)


def page_checksum(u8) -> int:
    """Byte sum plus 31 per byte, mod 2^31, of a numpy array or a tensor
    (a CUDA tensor is summed on the card)."""
    if isinstance(u8, torch.Tensor):
        t = u8.contiguous().reshape(-1).view(torch.uint8)
        return int((int(t.sum(dtype=torch.int64)) + 31 * t.numel())
                   % (1 << 31))
    u8 = np.ascontiguousarray(u8).reshape(-1).view(np.uint8)
    return int((int(u8.astype(np.uint64).sum()) + 31 * u8.size)
               % (1 << 31))


def fold(acc: int, value: int) -> int:
    """Order-sensitive checksum fold (tokens, then page checksums)."""
    return (acc * 1000003 + int(value)) % (1 << 31)


def session_checksum(sid: int, prompt: int, gen: int, page_tokens: int,
                     page_bytes: int, seed: int) -> int:
    """What a correct serve of this session must report: every decoded
    token folded in KV order, then every page's checksum."""
    acc = 0
    for t in range(gen):
        acc = fold(acc, token(sid, prompt + t, seed))
    n_pages = pages_for(prompt, gen, page_tokens)
    for p in range(n_pages):
        acc = fold(acc, page_checksum(page_fill(sid, p, seed, page_bytes)))
    return acc


def pages_for(prompt: int, gen: int, page_tokens: int) -> int:
    total = int(prompt) + int(gen)
    return -(-total // int(page_tokens))


# --------------------------------------------------------------------------
# frame encode/decode (in place — the buffers are persistent)
# --------------------------------------------------------------------------

def encode_admit(buf: np.ndarray, sid: int, epoch: int, prompt: int,
                 gen: int, pages: list[int]) -> None:
    buf[0] = MSG_ADMIT
    buf[1] = sid
    buf[2] = epoch
    buf[3] = prompt
    buf[4] = gen
    buf[5] = len(pages)
    buf[6:6 + len(pages)] = pages
    buf[6 + len(pages):] = 0


def encode_stop(buf: np.ndarray) -> None:
    buf[:] = 0
    buf[0] = MSG_STOP


def decode_admit(buf: np.ndarray) -> dict:
    n = int(buf[5])
    return dict(sid=int(buf[1]), epoch=int(buf[2]), prompt=int(buf[3]),
                gen=int(buf[4]),
                pages=[unpack_page(w) for w in buf[6:6 + n]])


def encode_done(buf: np.ndarray, worker: int, sid: int, epoch: int,
                tokens: int, checksum: int, steps: int) -> None:
    buf[:] = 0
    buf[0] = MSG_DONE
    buf[1] = worker
    buf[2] = sid
    buf[3] = epoch
    buf[4] = tokens
    buf[5] = checksum
    buf[6] = steps


def encode_beat(buf: np.ndarray, worker: int, tokens: int,
                steps: int) -> None:
    buf[:] = 0
    buf[0] = MSG_BEAT
    buf[1] = worker
    buf[4] = tokens
    buf[6] = steps


def decode_status(buf: np.ndarray) -> dict:
    return dict(kind=int(buf[0]), worker=int(buf[1]), sid=int(buf[2]),
                epoch=int(buf[3]), tokens=int(buf[4]),
                checksum=int(buf[5]), steps=int(buf[6]))
