"""Request batching and queueing for the serving engine (port of
``repro.serve.batching``; numpy on the host, with the staging ring in
pinned memory when the engine serves from the card):

  * ``RequestQueue`` — thread-safe FIFO of ``Request`` entries with an
    optional admission bound: when the queued work exceeds ``max_queries``
    the queue either REJECTS the new request (``QueueFullError``) or SHEDS
    the oldest queued ones (their futures fail) to admit it. A condition
    variable lets a background drainer sleep until a size-or-deadline
    trigger fires (``wait_for_work``).
  * ``RequestFuture`` — a ``concurrent.futures.Future`` carrying the
    request id/size.
  * ``SlotFuture``/``FlushSlots`` — the engine's futures: one result slot
    table and ONE ``threading.Event`` per flush; every future of a drain is
    resolved by slab index with a single event broadcast
    (``RequestQueue(slot_futures=True)``).
  * ``SlabArena`` — preallocated host staging: requests copy their rows
    into a ring buffer at SUBMIT time, so the flusher's pack step is a
    slice (``pack_slabs``), not a gather-and-concatenate; per-bucket frame
    pools absorb the non-contiguous leftovers without per-flush
    allocation. With ``pin=True`` the ring and the frames are page-locked,
    so a slab's host->device copy runs asynchronously from them.
  * pow2 shape buckets (``pow2_buckets``/``bucket_for``) and slab packing
    (``pack_slabs`` arena-aware plan packing and ``iter_slabs`` head-to-tail
    rows).
  * per-request accounting (``RequestStats``/``EngineStats``).
  * ``left_pad_pack`` — the decode engine's prompt waves, left-padded.

Payloads are opaque to the queue: only their row count ``n`` matters to it
and to the packers, which copy rows of whatever dtype the arena holds.
"""

from __future__ import annotations

import collections
import concurrent.futures
import dataclasses
import threading
import time
from typing import Any, Deque, List, Optional, Sequence, Tuple

import numpy as np
import torch


# ---- accounting -----------------------------------------------------------

# Window of recent per-request records kept by ``EngineStats``: enough for
# stable p50/p99 estimates, bounded so a long-running async engine cannot
# grow without limit (requests beyond the window age out oldest-first).
PER_REQUEST_WINDOW = 4096

@dataclasses.dataclass
class RequestStats:
    request_id: int
    n_queries: int
    latency_s: float              # wall time inside the engine for this req
    model_version: int = 0        # handle version this request was served at
    queue_wait_s: float = 0.0     # submit -> start-of-serve wait (async path)


@dataclasses.dataclass
class EngineStats:
    n_requests: int = 0
    n_queries: int = 0
    n_padded: int = 0             # wasted pad rows actually computed
    n_compiles: int = 0           # distinct (bucket) programs built
    n_rejected: int = 0           # admissions refused (QueueFullError)
    n_shed: int = 0               # queued requests dropped to admit newer
    n_flushes: int = 0            # drain cycles that served >= 1 request
    n_retries: int = 0            # drain attempts retried after a fault
    n_deadline_expired: int = 0   # requests failed on the request deadline
    n_donated: int = 0            # dispatches through donated entry points
    n_warmup_compiles: int = 0    # programs built by the start() warmup pass
    n_zero_copy_slabs: int = 0    # slabs served as arena slices (no copy)
    n_arena_fallback: int = 0     # submits that missed the arena ring
    n_routed_mp: int = 0          # sharded slabs routed model-parallel
    n_routed_dp: int = 0          # sharded slabs routed data-parallel
    n_routed_single: int = 0      # sharded slabs routed single-device
    max_inflight_drains: int = 0  # peak pipelined drains in flight at once
    n_h2d_bytes: int = 0          # query-slab bytes copied host -> card
    total_time_s: float = 0.0
    # Ring of the most recent PER_REQUEST_WINDOW requests (bounded: a
    # long-running async engine must not accumulate one record per request
    # forever). Aggregate counters above cover the full history; the ring
    # feeds the percentile estimates.
    per_request: Deque[RequestStats] = dataclasses.field(
        default_factory=lambda: collections.deque(maxlen=PER_REQUEST_WINDOW))

    def routing_summary(self) -> str:
        """Compact ``policy:count`` rendering of the sharded routing
        decisions (bench ``derived`` strings); "-" when nothing routed
        (single-device models)."""
        parts = [(p, getattr(self, f"n_routed_{p}"))
                 for p in ("mp", "dp", "single")]
        return ",".join(f"{p}:{n}" for p, n in parts if n) or "-"

    def latency_percentiles(self, qs=(50, 99)) -> Tuple[float, ...]:
        """Per-request latency percentiles in seconds over the retained
        window (last ``PER_REQUEST_WINDOW`` requests), one per entry of
        ``qs`` (default p50/p99); (0.0, ...) before any request is served."""
        lat = [r.latency_s for r in self.per_request] or [0.0]
        return tuple(float(np.percentile(lat, q)) for q in qs)


def format_latency(seconds: float) -> str:
    """Render a latency for human-facing derived strings.

    µs below 0.1 ms (sub-millisecond percentiles must not round down to
    "0.00ms"), ms below 1 s, seconds above. JSON rows keep the raw
    seconds — only the display string is quantized.
    """
    if seconds < 1e-4:
        return f"{seconds * 1e6:.1f}us"
    if seconds < 1.0:
        return f"{seconds * 1e3:.2f}ms"
    return f"{seconds:.3f}s"


# ---- queue ----------------------------------------------------------------

class QueueFullError(RuntimeError):
    """Admission control refused a request (queue at capacity)."""


class ShedError(RuntimeError):
    """This queued request was shed to admit a newer one."""


class RequestFuture(concurrent.futures.Future):
    """Future for one request's result, tagged with its queue identity."""

    def __init__(self, request_id: int, n: int):
        super().__init__()
        self.request_id = request_id
        self.n = n


# SlotFuture lifecycle states (terminal unless _PENDING).
_PENDING, _CANCELLED, _EXCEPTION, _RESULT = range(4)


class FlushSlots:
    """One flush's shared result table: the flusher publishes ``results``
    (list indexed by slab order) or ``error`` exactly once, then sets
    ``event`` — a single broadcast resolves every future of the drain.

    A "void" publish (event set with BOTH fields still None) means the
    flush failed and its entries were restored for retry; waiters go back
    to sleep until a later flush rebinds them.
    """

    __slots__ = ("event", "results", "error")

    def __init__(self):
        self.event = threading.Event()
        self.results: Optional[List[Any]] = None
        self.error: Optional[BaseException] = None


class SlotFuture:
    """Zero-churn replacement for ``RequestFuture`` on the hot path.

    Instead of one lock + condition variable per request
    (``concurrent.futures.Future`` carries both), every SlotFuture of a
    queue shares the queue's condition variable for the pre-bind wait and
    resolves through a per-flush ``FlushSlots`` table by index: the
    flusher publishes the whole result list and fires ONE event.

    Supports the ``concurrent.futures.Future`` surface the engines and
    tests use: ``result``/``exception`` (with timeout), ``done``,
    ``cancel``/``cancelled``, ``set_result``/``set_exception``.
    """

    __slots__ = ("request_id", "n", "_cond", "_slots", "_index",
                 "_state", "_value")

    def __init__(self, request_id: int, n: int, cond: threading.Condition):
        self.request_id = request_id
        self.n = n
        self._cond = cond
        self._slots: Optional[FlushSlots] = None   # guarded-by: _cond
        self._index = -1                           # guarded-by: _cond
        self._state = _PENDING                     # guarded-by: _cond
        self._value: Any = None                    # guarded-by: _cond

    # -- flusher side -------------------------------------------------------

    @staticmethod
    def bind(pairs: Sequence[Tuple["SlotFuture", int]],
             slots: FlushSlots) -> None:
        """Attach (future, result-index) pairs to one flush's slot table
        with a single notification."""
        if not pairs:
            return
        cond = pairs[0][0]._cond
        with cond:
            for fut, idx in pairs:
                if fut._state == _PENDING:
                    fut._slots, fut._index = slots, idx
            cond.notify_all()

    @staticmethod
    def unbind(futures: Sequence["SlotFuture"]) -> None:
        """Detach futures from their flush (failed flush, entries being
        restored for retry). The flusher must still void-publish the old
        ``FlushSlots`` afterwards so in-flight waiters wake and re-wait."""
        if not futures:
            return
        cond = futures[0]._cond
        with cond:
            for fut in futures:
                fut._slots, fut._index = None, -1

    # -- waiter side --------------------------------------------------------

    def _outcome(self, timeout: Optional[float]):
        deadline = None if timeout is None else time.monotonic() + timeout
        while True:
            with self._cond:
                while True:
                    if self._state == _CANCELLED:
                        return "cancelled", None
                    if self._state == _EXCEPTION:
                        return "exception", self._value
                    if self._state == _RESULT:
                        return "result", self._value
                    slots, index = self._slots, self._index
                    if slots is not None:
                        break
                    left = None if deadline is None \
                        else deadline - time.monotonic()
                    if left is not None and left <= 0:
                        raise concurrent.futures.TimeoutError()
                    self._cond.wait(timeout=left)
            # Even with the deadline already past, a published table still
            # resolves: event.wait(0) just reads the flag.
            left = None if deadline is None \
                else max(0.0, deadline - time.monotonic())
            if not slots.event.wait(timeout=left):
                raise concurrent.futures.TimeoutError()
            if slots.error is not None:
                return "exception", slots.error
            if slots.results is not None:
                return "result", slots.results[index]
            # Void publish: flush failed, entries restored for retry.
            # Drop the stale binding (unless already rebound) and re-wait.
            with self._cond:
                if self._slots is slots:
                    self._slots, self._index = None, -1

    def result(self, timeout: Optional[float] = None):
        kind, value = self._outcome(timeout)
        if kind == "cancelled":
            raise concurrent.futures.CancelledError()
        if kind == "exception":
            raise value
        return value

    def exception(self, timeout: Optional[float] = None):
        kind, value = self._outcome(timeout)
        if kind == "cancelled":
            raise concurrent.futures.CancelledError()
        return value if kind == "exception" else None

    def done(self) -> bool:
        with self._cond:
            if self._state != _PENDING:
                return True
            slots = self._slots
        return slots is not None and slots.event.is_set() and \
            (slots.results is not None or slots.error is not None)

    def running(self) -> bool:
        return False

    def cancelled(self) -> bool:
        with self._cond:
            return self._state == _CANCELLED

    def cancel(self) -> bool:
        with self._cond:
            if self._state == _CANCELLED:
                return True
            if self._state != _PENDING or self._slots is not None:
                return False
            self._state = _CANCELLED
            self._cond.notify_all()
        return True

    # Direct per-future resolution stays available for the fault paths
    # (deadline expiry, shed) where no flush table exists. Terminal states
    # win; late sets after a broadcast resolution are ignored.
    def set_result(self, value) -> None:
        with self._cond:
            if self._state != _PENDING:
                return
            self._state, self._value = _RESULT, value
            self._cond.notify_all()

    def set_exception(self, exc: BaseException) -> None:
        with self._cond:
            if self._state != _PENDING:
                return
            self._state, self._value = _EXCEPTION, exc
            self._cond.notify_all()


@dataclasses.dataclass
class Request:
    """One queued request: opaque payload + its row count and future.

    ``arena_start`` is the row offset of this request's staged copy inside
    the engine's ``SlabArena`` (None = payload lives in ``payload`` only).
    """

    rid: int
    payload: Any
    n: int
    future: Any
    t_submit: float
    arena_start: Optional[int] = None


class RequestQueue:
    """Thread-safe bounded FIFO with admission control and a drain trigger.

    ``max_queries`` bounds the total queued row count (None = unbounded).
    ``policy`` picks what happens when an admission would exceed it:
    "reject" raises ``QueueFullError`` at ``put``; "shed" drops the OLDEST
    queued requests (failing their futures with ``ShedError``) until the
    new one fits — latency-loving head drop, matching LM-serving practice
    where a stale queued request is worth less than a fresh one. A request
    larger than the whole capacity is always rejected.

    ``slot_futures=True`` makes ``put`` hand out ``SlotFuture``s (sharing
    this queue's condition variable) instead of ``RequestFuture``s — the
    zero-churn hot path. ``on_shed`` is called (outside the lock, before
    the shed futures are failed) with the list of dropped ``Request``
    entries so the owner can reclaim resources (e.g. arena rows).
    """

    def __init__(self, max_queries: Optional[int] = None,
                 policy: str = "reject", slot_futures: bool = False,
                 on_shed=None):
        if policy not in ("reject", "shed"):
            raise ValueError(f"unknown admission policy {policy!r}")
        if max_queries is not None and max_queries < 1:
            raise ValueError(f"max_queries must be >= 1, got {max_queries}")
        self.max_queries = max_queries
        self.policy = policy
        self.slot_futures = slot_futures
        self.on_shed = on_shed
        self._cond = threading.Condition()
        self._entries: List[Request] = []   # guarded-by: _cond
        self._depth = 0               # queued rows     guarded-by: _cond
        self._next_id = 0                   # guarded-by: _cond
        self.n_rejected = 0                 # guarded-by: _cond
        self.n_shed = 0                     # guarded-by: _cond
        self.depth_peak = 0                 # guarded-by: _cond

    # -- producer side ------------------------------------------------------

    def put(self, payload: Any, n: int,
            arena_start: Optional[int] = None) -> Tuple[Any, List[Any]]:
        """Enqueue one request of ``n`` rows.

        Returns (future, shed) where ``shed`` lists the futures of any
        requests dropped to admit this one (empty unless policy="shed").
        Raises ``QueueFullError`` when the request cannot be admitted.
        """
        with self._cond:
            shed_entries: List[Request] = []
            if self.max_queries is not None and \
                    self._depth + n > self.max_queries:
                if n > self.max_queries or self.policy == "reject":
                    self.n_rejected += 1
                    raise QueueFullError(
                        f"queue at capacity ({self._depth}/"
                        f"{self.max_queries} rows queued, request adds {n})")
                while self._entries and self._depth + n > self.max_queries:
                    old = self._entries.pop(0)
                    self._depth -= old.n
                    self.n_shed += 1
                    shed_entries.append(old)
            rid = self._next_id
            self._next_id += 1
            if self.slot_futures:
                fut: Any = SlotFuture(rid, n, self._cond)
            else:
                fut = RequestFuture(rid, n)
            self._entries.append(
                Request(rid, payload, n, fut, time.monotonic(), arena_start))
            self._depth += n
            self.depth_peak = max(self.depth_peak, self._depth)
            self._cond.notify_all()
        if shed_entries and self.on_shed is not None:
            self.on_shed(shed_entries)
        for e in shed_entries:
            e.future.set_exception(ShedError("shed by admission control"))
        return fut, [e.future for e in shed_entries]

    # -- consumer side ------------------------------------------------------

    @property
    def depth(self) -> int:
        """Queued rows (not requests)."""
        with self._cond:
            return self._depth

    def __len__(self) -> int:
        with self._cond:
            return len(self._entries)

    def drain(self) -> List[Request]:
        """Atomically take everything queued (FIFO order)."""
        with self._cond:
            out, self._entries = self._entries, []
            self._depth = 0
            return out

    def take(self, n_requests: int) -> List[Request]:
        """Atomically take up to ``n_requests`` entries from the head."""
        with self._cond:
            out = self._entries[:n_requests]
            self._entries = self._entries[n_requests:]
            for e in out:
                self._depth -= e.n
            return out

    def restore(self, entries: Sequence[Request]) -> None:
        """Put drained entries back at the FRONT (failed-flush retry)."""
        with self._cond:
            self._entries = list(entries) + self._entries
            self._depth += sum(e.n for e in entries)
            self._cond.notify_all()

    def kick(self) -> None:
        """Wake any ``wait_for_work`` sleeper (e.g. on engine shutdown)."""
        with self._cond:
            self._cond.notify_all()

    def coalesce(self, max_rows: int, stall_s: float,
                 stop: threading.Event) -> None:
        """Post-trigger arrival damper: after a flush trigger fires, keep
        YIELDING the core to submitter threads as long as rows keep
        arriving, so a wave of concurrent submitters lands in one drain
        instead of one drain per submit. Returns once no new rows have
        arrived for ``stall_s`` seconds, ``max_rows`` is queued, or
        ``stop`` is set. ``time.sleep(0)`` (sched_yield) instead of a
        timed condition wait: sub-millisecond ``Condition.wait(timeout)``
        overshoots its timeout ~2-3x on Linux, while a yield loop tracks
        arrivals at scheduler granularity — worst-case cost is one quiet
        ``stall_s``, and each yield hands the core to whoever has work."""
        if stall_s <= 0:
            return
        with self._cond:
            last = self._depth
        if not 0 < last < max_rows:
            return
        t_stall = time.perf_counter()
        while not stop.is_set():
            time.sleep(0)                  # yield: let submitters run
            with self._cond:
                d = self._depth
            if d >= max_rows or d == 0:
                return
            if d != last:
                last, t_stall = d, time.perf_counter()
            elif time.perf_counter() - t_stall >= stall_s:
                return

    def wait_for_work(self, min_queries: int, max_wait_s: float,
                      stop: threading.Event) -> bool:
        """Sleep until a flush trigger fires: queued rows reach
        ``min_queries``, OR the oldest entry has waited ``max_wait_s``
        since submit, OR ``stop`` is set. Returns True when there is
        anything queued (the caller should drain), False otherwise.
        """
        with self._cond:
            while not stop.is_set():
                if self._entries:
                    if self._depth >= min_queries:
                        return True
                    age = time.monotonic() - self._entries[0].t_submit
                    if age >= max_wait_s:
                        return True
                    self._cond.wait(timeout=max_wait_s - age)
                else:
                    self._cond.wait(timeout=0.1)
            return bool(self._entries)


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

    Concatenates every entry's ``payload`` rows into one flat stream and
    yields ``(slab, take, owners)`` per device batch: ``slab`` is a
    (bucket, M) float32 array whose first ``take`` rows are real,
    ``owners`` maps each real row back to its request id. Row-wise kernel
    math makes valid rows independent of the zero padding, so per-request
    results are exactly the unbatched ones.
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


class SlabArena:
    """Preallocated host staging ring for request rows.

    Submitters copy their query rows into one pinned ``(capacity, M)``
    buffer at submit time (``stage``); the flusher packs slabs as SLICES
    of that buffer (``pack_slabs``) instead of gather-and-concatenate, and
    releases each request's rows once its results are assembled
    (``release``). Rows are handed out as contiguous runs from a ring:
    FIFO staging + FIFO release means reclamation is almost always a
    cheap released-prefix pop.

    Per-bucket frame pools (``acquire_frame``/``release_frame``) cover the
    slabs that cannot be served as one contiguous arena slice — those are
    copied into a reused frame, never a fresh allocation in steady state.

    With ``pin=True`` the ring and every frame live in page-locked host
    memory (a host->device copy from them is asynchronous); that needs
    CUDA, so only an engine serving from the card asks for it. The caller
    that copies a slab to the device owns the timing of ``release`` and
    ``release_frame``: not before the copy has completed.

    Thread-safe; stats counters are read racily for reporting.
    """

    def __init__(self, n_features: int, capacity_rows: int,
                 dtype=np.float32, max_frames_per_bucket: int = 8,
                 pin: bool = False):
        if capacity_rows < 1 or n_features < 1:
            raise ValueError("SlabArena needs capacity_rows, n_features >= 1")
        self.n_features = int(n_features)
        self.capacity = int(capacity_rows)
        self.pinned = bool(pin)
        self.buf = host_array((self.capacity, self.n_features), dtype, pin)
        self._lock = threading.Lock()
        # Live staged runs, FIFO: [start, n, released]. guarded-by: _lock
        self._segs: Deque[list] = collections.deque()
        self._tail = 0                      # guarded-by: _lock
        self._high_water = 0                # guarded-by: _lock
        self._frames: dict = {}             # bucket -> [frame]  gb: _lock
        self._max_frames = max_frames_per_bucket
        self.n_staged = 0                   # guarded-by: _lock
        self.n_reused_rows = 0              # guarded-by: _lock
        self.n_fallback = 0                 # guarded-by: _lock
        self.n_frame_allocs = 0             # guarded-by: _lock

    # -- row ring -----------------------------------------------------------

    @staticmethod
    def _find_run(n: int, capacity: int, head: Optional[int],
                  tail: int) -> Optional[int]:
        """Pure ring geometry: first start row fitting an ``n``-row run,
        given the oldest live start (``head``, None when empty) and the
        next free row (``tail``). Caller snapshots state under ``_lock``."""
        if head is None:                    # ring empty
            return 0 if n <= capacity else None
        if tail > head:                     # one occupied span [head, tail)
            if capacity - tail >= n:
                return tail
            if head >= n:
                return 0                    # wrap
            return None
        if tail < head:                     # wrapped: occupied both ends
            return tail if head - tail >= n else None
        return None                         # tail == head: ring full

    def stage(self, x: np.ndarray) -> Optional[int]:
        """Copy ``x`` (n, M) into the ring; returns the start row, or None
        when the ring cannot hold it (caller keeps its own copy)."""
        n = int(x.shape[0])
        if n == 0 or n > self.capacity:
            with self._lock:
                self.n_fallback += 1
            return None
        with self._lock:
            if not self._segs:
                self._tail = 0
            head = self._segs[0][0] if self._segs else None
            start = self._find_run(n, self.capacity, head, self._tail)
            if start is None:
                self.n_fallback += 1
                return None
            self._segs.append([start, n, False])
            self._tail = start + n
            self.n_staged += 1
            if start + n <= self._high_water:
                self.n_reused_rows += n
            else:
                self._high_water = max(self._high_water, start + n)
        # Copy OUTSIDE the lock: the run is exclusively ours once reserved,
        # and the queue entry referencing it is only published afterwards.
        self.buf[start:start + n] = x
        return start

    def release(self, start: int) -> None:
        """Return one staged run to the ring (results assembled)."""
        with self._lock:
            for seg in self._segs:
                if seg[0] == start and not seg[2]:
                    seg[2] = True
                    break
            while self._segs and self._segs[0][2]:
                self._segs.popleft()
            if not self._segs:
                self._tail = 0

    # -- frame pool ---------------------------------------------------------

    def acquire_frame(self, bucket: int) -> np.ndarray:
        """A reusable (bucket, M) scratch slab for non-contiguous packs."""
        with self._lock:
            pool = self._frames.get(bucket)
            if pool:
                return pool.pop()
            self.n_frame_allocs += 1
        return host_array((bucket, self.n_features), self.buf.dtype,
                          self.pinned)

    def release_frame(self, frame: np.ndarray) -> None:
        with self._lock:
            pool = self._frames.setdefault(int(frame.shape[0]), [])
            if len(pool) < self._max_frames:
                pool.append(frame)

    def stats(self) -> dict:
        with self._lock:
            return {"n_staged": self.n_staged,
                    "n_reused_rows": self.n_reused_rows,
                    "n_fallback": self.n_fallback,
                    "n_frame_allocs": self.n_frame_allocs,
                    "live_runs": len(self._segs)}


def host_array(shape, dtype, pin: bool) -> np.ndarray:
    """A zeroed host array; page-locked (through PyTorch's pinned host
    allocator, which keeps it alive as the array's base) when ``pin``."""
    dtype = np.dtype(dtype)
    if not pin:
        return np.zeros(shape, dtype)
    nbytes = int(np.prod(shape)) * dtype.itemsize
    raw = torch.zeros((nbytes,), dtype=torch.uint8, pin_memory=True)
    return raw.numpy().view(dtype).reshape(shape)


def pack_slabs(entries: Sequence[Request], max_batch: int,
               buckets: Sequence[int], arena: Optional[SlabArena] = None):
    """Plan-pack drained entries into pow2-bucketed slabs.

    The arena-aware successor to ``iter_slabs``: when a slab's rows form
    one contiguous run of arena-staged requests (the common FIFO case),
    the slab IS a slice of the arena buffer — zero copies on the pack
    path. Otherwise rows are copied into a pooled frame. Pad rows of a
    zero-copy slab are whatever the arena holds; row-wise kernel math
    keeps valid rows independent of them, and the pad outputs are never
    read back.

    Returns ``(slabs, plan, frames)``:
      * ``slabs`` — list of ``(slab, take, zero_copy)``; first ``take``
        rows of each (bucket, M) ``slab`` are real.
      * ``plan`` — per entry (same order) a list of
        ``(slab_idx, row_in_slab, row_in_entry, n)`` segments mapping its
        rows to slab positions; result assembly is pure slicing.
      * ``frames`` — pooled frames to hand back via ``release_frame``
        once the flush's device results are on host.
    """
    plan: List[List[Tuple[int, int, int, int]]] = [[] for _ in entries]
    slabs: List[Tuple[np.ndarray, int, bool]] = []
    frames: List[np.ndarray] = []
    runs = []                    # (entry_idx, kind, ref, n_rows)
    for i, e in enumerate(entries):
        if e.n == 0:
            continue
        if arena is not None and e.arena_start is not None:
            runs.append((i, "arena", e.arena_start, e.n))
        else:
            runs.append((i, "mem", e.payload, e.n))
    if not runs:
        return slabs, plan, frames
    n_features = arena.n_features if arena is not None else \
        int(runs[0][2].shape[1])
    dtype = arena.buf.dtype if arena is not None else runs[0][2].dtype
    remaining = sum(n for (_i, _k, _ref, n) in runs)
    r, r_off = 0, 0
    while r < len(runs):
        # Best-fit tail split: pad rows cost real compute on row-
        # proportional backends, so when the leftover rows would pad far
        # past a smaller bucket (e.g. 66 rows -> a 128 slab), cut a FULL
        # smaller slab first (64 + an 8-tail beats 128 by 56 pad rows).
        # Only split when it saves at least two min-buckets of rows —
        # below that the extra program dispatch costs more than the pad.
        cap = max_batch
        if remaining < max_batch:
            b1 = bucket_for(buckets, remaining)
            lower = max((b for b in buckets if b <= remaining), default=None)
            if lower is not None and lower < remaining:
                rest = bucket_for(buckets, remaining - lower)
                if b1 - (lower + rest) >= 2 * buckets[0]:
                    cap = lower
        take = 0
        pieces = []              # (entry_idx, kind, ref, src_off, n)
        while r < len(runs) and take < cap:
            i, kind, ref, n = runs[r]
            m = min(n - r_off, cap - take)
            pieces.append((i, kind, ref, r_off, m))
            take += m
            r_off += m
            if r_off == n:
                r, r_off = r + 1, 0
        remaining -= take
        bucket = bucket_for(buckets, take)
        slab = None
        if arena is not None and all(p[1] == "arena" for p in pieces):
            s0 = pieces[0][2] + pieces[0][3]
            end = s0
            for (_i, _k, ref, off, m) in pieces:
                if ref + off != end:
                    end = -1
                    break
                end += m
            if end >= 0 and s0 + bucket <= arena.capacity:
                slab = arena.buf[s0:s0 + bucket]
        zero_copy = slab is not None
        if not zero_copy:
            if arena is not None:
                slab = arena.acquire_frame(bucket)
                frames.append(slab)
            else:
                slab = np.zeros((bucket, n_features), dtype)
            row = 0
            for (_i, kind, ref, off, m) in pieces:
                if kind == "arena":
                    slab[row:row + m] = arena.buf[ref + off:ref + off + m]
                else:
                    slab[row:row + m] = ref[off:off + m]
                row += m
            if take < bucket:
                slab[take:bucket] = 0.0   # frames are reused: scrub pads
        row = 0
        for (i, _k, _ref, off, m) in pieces:
            plan[i].append((len(slabs), row, off, m))
            row += m
        slabs.append((slab, take, zero_copy))
    return slabs, plan, frames


def left_pad_pack(prompts: Sequence[Sequence[int]], slots: int,
                  pad_id: int = 0) -> Tuple[np.ndarray, int]:
    """Pack up to ``slots`` token prompts into one LEFT-padded int32 wave.

    Returns (toks, plen): toks is (slots, plen) with prompt i right-aligned
    in row i (rows beyond len(prompts) stay all-pad), plen the longest
    prompt. Left padding keeps the last prompt token in the last column, so
    one uniform-length prefill position works for the whole wave.
    """
    if not prompts:
        raise ValueError("left_pad_pack needs at least one prompt")
    if len(prompts) > slots:
        raise ValueError(f"{len(prompts)} prompts > {slots} slots")
    plen = max(len(p) for p in prompts)
    toks = np.full((slots, plen), pad_id, np.int32)
    for i, prompt in enumerate(prompts):
        if len(prompt):
            toks[i, plen - len(prompt):] = prompt
    return toks, plen


__all__ = [
    "EngineStats", "FlushSlots", "PER_REQUEST_WINDOW", "QueueFullError",
    "Request", "RequestFuture", "RequestQueue", "RequestStats", "ShedError",
    "SlabArena", "SlotFuture", "bucket_for", "format_latency", "host_array",
    "iter_slabs", "left_pad_pack", "pack_slabs", "pow2_buckets",
]
