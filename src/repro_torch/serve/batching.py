"""Request batching for the serving engine — a copy of what the synchronous
drain needs from ``repro.serve.batching`` (numpy only, engine-agnostic).

  * ``RequestQueue`` — thread-safe FIFO of ``Request`` entries (admission
    control, deadlines and the async drain trigger wait for a later slice);
  * ``SlotFuture`` — the result handle ``submit`` returns; one
    notification resolves a whole drain's futures;
  * pow2 shape buckets (``pow2_buckets``/``bucket_for``) and head-to-tail
    slab packing (``iter_slabs``/``pack_slabs``);
  * per-request accounting (``RequestStats``/``EngineStats``).
"""

from __future__ import annotations

import collections
import concurrent.futures
import dataclasses
import threading
import time
from typing import Any, Deque, List, Optional, Sequence, Tuple

import numpy as np

# Window of recent per-request records kept by ``EngineStats`` (bounded, so
# a long-running engine does not grow without limit).
PER_REQUEST_WINDOW = 4096


@dataclasses.dataclass
class RequestStats:
    request_id: int
    n_queries: int
    latency_s: float              # wall time inside the engine for this req
    model_version: int = 0        # handle version this request was served at


@dataclasses.dataclass
class EngineStats:
    n_requests: int = 0
    n_queries: int = 0
    n_padded: int = 0             # wasted pad rows actually computed
    n_flushes: int = 0            # drain cycles that served >= 1 request
    total_time_s: float = 0.0
    per_request: Deque[RequestStats] = dataclasses.field(
        default_factory=lambda: collections.deque(maxlen=PER_REQUEST_WINDOW))

    @property
    def queries_per_s(self) -> float:
        return self.n_queries / self.total_time_s if self.total_time_s else 0.0


# ---- futures --------------------------------------------------------------

class SlotFuture:
    """A request's result handle, resolved by the flush that serves it. It
    shares its queue's condition variable, so ``resolve`` settles a whole
    drain's futures under one lock with one notification. ``result`` waits
    (with an optional timeout) and ``done`` polls, as on a
    ``concurrent.futures.Future``."""

    __slots__ = ("request_id", "n", "_cond", "_done", "_value")

    def __init__(self, request_id: int, n: int, cond: threading.Condition):
        self.request_id = request_id
        self.n = n
        self._cond = cond
        self._done = False                         # guarded-by: _cond
        self._value: Any = None                    # guarded-by: _cond

    @staticmethod
    def resolve(pairs: Sequence[Tuple["SlotFuture", Any]]) -> None:
        """Set the result of each (future, result) pair."""
        if not pairs:
            return
        cond = pairs[0][0]._cond
        with cond:
            for fut, value in pairs:
                fut._done, fut._value = True, value
            cond.notify_all()

    def result(self, timeout: Optional[float] = None):
        deadline = None if timeout is None else time.monotonic() + timeout
        with self._cond:
            while not self._done:
                left = None if deadline is None \
                    else deadline - time.monotonic()
                if left is not None and left <= 0:
                    raise concurrent.futures.TimeoutError()
                self._cond.wait(timeout=left)
            return self._value

    def done(self) -> bool:
        with self._cond:
            return self._done


# ---- queue ----------------------------------------------------------------

@dataclasses.dataclass
class Request:
    """One queued request: opaque payload + its row count and future."""

    rid: int
    payload: Any
    n: int
    future: Any
    t_submit: float


class RequestQueue:
    """Thread-safe FIFO of requests; ``put`` hands out ``SlotFuture``s
    that share this queue's condition variable."""

    def __init__(self):
        self._cond = threading.Condition()
        self._entries: List[Request] = []   # guarded-by: _cond
        self._next_id = 0                   # guarded-by: _cond

    def put(self, payload: Any, n: int):
        """Enqueue one request of ``n`` rows; returns its future."""
        with self._cond:
            rid = self._next_id
            self._next_id += 1
            fut = SlotFuture(rid, n, self._cond)
            self._entries.append(
                Request(rid, payload, n, fut, time.monotonic()))
        return fut

    def drain(self) -> List[Request]:
        """Atomically take everything queued (FIFO order)."""
        with self._cond:
            out, self._entries = self._entries, []
            return out

    def restore(self, entries: Sequence[Request]) -> None:
        """Put drained entries back at the FRONT (failed-flush retry)."""
        with self._cond:
            self._entries = list(entries) + self._entries


# ---- shape buckets --------------------------------------------------------

def pow2_buckets(min_bucket: int, max_batch: int) -> List[int]:
    """Power-of-two widths: min_bucket, 2*min_bucket, ..., max_batch."""
    if not 0 < min_bucket <= max_batch:
        raise ValueError(f"need 0 < min_bucket <= max_batch, got "
                         f"min_bucket={min_bucket} max_batch={max_batch}")
    out, b = [], min_bucket
    while b < max_batch:
        out.append(b)
        b *= 2
    out.append(max_batch)
    return out


def bucket_for(buckets: Sequence[int], size: int) -> int:
    """Smallest bucket holding ``size`` rows (widest bucket for overflow —
    callers split anything larger across multiple slabs)."""
    for b in buckets:
        if size <= b:
            return b
    return buckets[-1]


# ---- slab packing ---------------------------------------------------------

def iter_slabs(entries: Sequence[Request], max_batch: int,
               buckets: Sequence[int]):
    """Head-to-tail pack 2-D float payloads into pow2-bucketed slabs.

    Yields ``(slab, take, owners)`` per device batch: ``slab`` is a
    (bucket, M) float32 array whose first ``take`` rows are real, ``owners``
    maps each real row back to its request id. Row-wise kernel math keeps
    valid rows independent of the zero padding.
    """
    if not entries:
        return
    stream = np.concatenate([e.payload for e in entries], axis=0)
    owners = np.concatenate(
        [np.full(e.n, e.rid, np.int64) for e in entries])
    pos = 0
    while pos < stream.shape[0]:
        take = min(max_batch, stream.shape[0] - pos)
        bucket = bucket_for(buckets, take)
        slab = np.zeros((bucket, stream.shape[1]), np.float32)
        slab[:take] = stream[pos:pos + take]
        yield slab, take, owners[pos:pos + take]
        pos += take


def pack_slabs(entries: Sequence[Request], max_batch: int,
               buckets: Sequence[int]):
    """Pack drained entries into pow2-bucketed slabs with a result plan.

    Returns ``(slabs, plan)``: ``slabs`` is a list of ``(slab, take)``
    (first ``take`` rows of each (bucket, M) slab are real); ``plan`` gives
    per entry (same order) its ``(slab_idx, row_in_slab, row_in_entry, n)``
    segments, so result assembly is pure slicing.
    """
    plan: List[List[Tuple[int, int, int, int]]] = [[] for _ in entries]
    slabs = []
    cursor = [0, 0]                       # (entry index, rows taken of it)
    live = [i for i, e in enumerate(entries) if e.n]
    for slab, take, _owners in iter_slabs(
            [entries[i] for i in live], max_batch, buckets):
        row = 0
        while row < take:
            i = live[cursor[0]]
            m = min(entries[i].n - cursor[1], take - row)
            plan[i].append((len(slabs), row, cursor[1], m))
            row += m
            cursor[1] += m
            if cursor[1] == entries[i].n:
                cursor[0] += 1
                cursor[1] = 0
        slabs.append((slab, take))
    return slabs, plan


__all__ = [
    "EngineStats", "PER_REQUEST_WINDOW", "Request",
    "RequestQueue", "RequestStats", "SlotFuture",
    "bucket_for", "iter_slabs", "pack_slabs", "pow2_buckets",
]
