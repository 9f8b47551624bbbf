"""Batched kPCA projection-serving engine (port of
``repro.serve.kpca_engine``).

Variable-size requests are packed head-to-tail into fixed-width slabs padded
up to POWER-OF-TWO shape buckets; each slab is copied host -> device, scored
(``oos.projector`` of the drain's model version for a ``FittedKpca``, the
``ShardedRouter`` for a ``ShardedFittedKpca``) and copied back, and
per-request results are sliced off the slabs. The projection kernel's
summation order depends on the support set alone, so on the card a
request's scores are bit-identical however it was batched
(tests/test_torch_gpu.py); on the CPU the plain version agrees to fp32
rounding.

The request path is asynchronous: ``submit`` returns a future at once; a
background flusher (``start``/``close``, or the context manager) drains the
queue on a size, deadline or eager trigger and resolves the futures.
``flush`` is the synchronous drain (same packing, same kernels: the async
path is result-exact against it), ``project_many`` the one-call
convenience. The JAX mechanisms become these on the card:

  * host staging: requests are copied into a page-locked ``SlabArena`` at
    submit time, so a slab is usually a slice of it; ``query_dtype=
    torch.bfloat16`` rounds them to bf16 on the host there (round to
    nearest even, as ``ml_dtypes`` does for the JAX package), so a slab
    crosses PCIe and is read from device memory at half the bytes, and the
    kernel widens it on load;
  * the host -> device copy is ``non_blocking`` on one CUDA stream the
    engine owns; every thread that launches (the caller of ``flush``, the
    device-runner) enters that stream, so a drain's copies, kernels and
    device -> host copies are ordered. Staged rows go back to the arena
    only once the copies that read them have completed;
  * ``donate=True``: each bucket's device slab is one buffer, reused
    (``copy_`` into it) instead of a new allocation per slab;
  * ``warmup``: one eager run per (bucket, routing policy) builds the
    kernels, warms the caching allocator and fills the compile bookkeeping
    (``stats.n_compiles`` stays 0 for traffic after it);
  * the device-runner thread stages and launches a drain's slabs, then
    waits for its results and resolves its futures, while the flusher packs
    the next drain (``pipeline_depth`` drains in flight). On the card the
    serving host is the bottleneck (PERF.md), and a third Python thread for
    the results was measured slower, not faster.

Admission control (``queue_factor``, "reject" or "shed"), request deadlines
(``DeadlineExceededError``), retries with backoff and the
``inject_fault``/``on_fault`` hooks follow the JAX engine's contract.
"""

from __future__ import annotations

import collections
import concurrent.futures
import contextlib
import dataclasses
import threading
import time
from typing import Any, List, Optional, Sequence, Union

import numpy as np
import torch

from ..core import oos
from ..core.oos import FittedKpca, ShardedFittedKpca
from ..device import DeviceLike, resolve_device
from ..faults.errors import DeadlineExceededError
from ..launch.mesh import make_serving_mesh
from ..obs import metrics, trace
from .batching import (EngineStats, FlushSlots, QueueFullError,
                       RequestFuture, RequestQueue, RequestStats, SlabArena,
                       SlotFuture, pack_slabs, pow2_buckets)
from .publisher import ModelHandle
from .sharded import ShardedRouter

QUERY_DTYPES = (None, torch.float32, torch.bfloat16)
BF16_STAGING = 4       # pinned bf16 staging buffers per bucket


@dataclasses.dataclass
class KpcaServeConfig:
    """The JAX engine's knobs, less ``use_pallas``/``interpret`` (the
    engine's device decides: the card's kernels, or the plain version on
    the CPU)."""

    max_batch: int = 128          # widest bucket = slab width
    min_bucket: int = 8           # narrowest bucket (absorbs tiny tails)
    query_dtype: Any = None       # torch.bfloat16 for half-size slabs
    # -- async flusher / admission control --------------------------------
    queue_factor: Optional[int] = None  # queue bound = max_batch * k rows;
    #                                     None = unbounded, no admission
    admission: str = "reject"     # "reject" new or "shed" oldest when full
    flush_max_wait_s: float = 0.005   # deadline trigger: max queue wait of
    #                                   the oldest request before a flush
    flush_min_queries: Optional[int] = None  # size trigger (None: max_batch)
    flush_eager: bool = True      # idle flusher drains on ANY queued work
    flush_coalesce_s: float = 0.0002  # arrival damper while the previous
    #                                   drain still holds the device runner
    # -- hot-path plumbing -------------------------------------------------
    donate: bool = True           # reuse one device slab buffer per bucket
    warmup: bool = True           # run every pow2 bucket once at start()
    arena_factor: int = 4         # staging ring >= max_batch * factor rows
    pipeline_depth: int = 2       # max in-flight drains (fail-fast configs)
    # -- sharded routing ---------------------------------------------------
    routing: str = "auto"         # "auto" (crossover table) or a policy
    crossover: Any = None         # CrossoverTable override for "auto"
    # -- fault tolerance ---------------------------------------------------
    max_retries: int = 0          # extra serve attempts per drain
    retry_backoff_s: float = 0.02     # base backoff, doubled per attempt
    request_deadline_s: Optional[float] = None  # submit -> serve budget

    def buckets(self) -> List[int]:
        """Power-of-two widths: min_bucket, 2*min_bucket, ..., max_batch."""
        return pow2_buckets(self.min_bucket, self.max_batch)

    def queue_capacity(self) -> Optional[int]:
        if self.queue_factor is None:
            return None
        if self.queue_factor < 1:
            raise ValueError(
                f"queue_factor must be >= 1, got {self.queue_factor}")
        return self.max_batch * self.queue_factor


class _StagingRing:
    """BF16_STAGING pinned host buffers of one shape, handed out in turn;
    a buffer is handed out again only after the copy that last read it
    (``copied``, an event on the copying stream) has completed."""

    def __init__(self, shape, dtype):
        self.bufs = [torch.empty(shape, dtype=dtype, pin_memory=True)
                     for _ in range(BF16_STAGING)]
        self.events = [None] * BF16_STAGING
        self.k = -1

    def next(self) -> torch.Tensor:
        self.k = (self.k + 1) % BF16_STAGING
        if self.events[self.k] is not None:
            self.events[self.k].synchronize()
        return self.bufs[self.k]

    def copied(self, stream) -> None:
        event = torch.cuda.Event()
        event.record(stream)
        self.events[self.k] = event


# One slab's scores on the host: the (bucket, C) array (pinned and still
# being written until ``event`` completes, on the card), and its routing
# policy (None for a plain model).
_SlabOut = collections.namedtuple("_SlabOut", "host event policy")


class KpcaEngine:
    """Micro-batching projection server over a fitted kPCA artifact, on
    ``device`` (the card unless ``device="cpu"``).

    Accepts a ``FittedKpca`` or a ``ShardedFittedKpca`` (routed per slab by
    a ``ShardedRouter`` over ``mesh``: a list of devices, by default
    ``make_serving_mesh(n_shards)``; with too few devices every slab routes
    "single" on the engine's device), or a ``ModelHandle`` wrapping one.
    Each drain snapshots (model, version) once, so every slab of a drain
    scores against one version; ``RequestStats.model_version`` records it.

    ``inject_fault(model)`` is called at the top of every drain attempt
    (raising aborts it); ``on_fault(exc, handle) -> bool`` is called when
    an attempt failed and retries remain (True: retry at once).
    """

    def __init__(self,
                 model: Union[FittedKpca, ShardedFittedKpca, ModelHandle],
                 cfg: KpcaServeConfig = None, device: DeviceLike = "cuda",
                 mesh=None, inject_fault=None, on_fault=None):
        self.device = resolve_device(device)
        self.cfg = cfg or KpcaServeConfig()
        if self.cfg.query_dtype not in QUERY_DTYPES:
            raise ValueError(f"query_dtype must be one of {QUERY_DTYPES}, "
                             f"got {self.cfg.query_dtype}")
        self._bf16 = self.cfg.query_dtype == torch.bfloat16
        if isinstance(model, ModelHandle):
            self.handle = model
        else:
            self.handle = ModelHandle(model.to(self.device))
        model = self.handle.current()
        if not isinstance(model, (FittedKpca, ShardedFittedKpca)):
            raise TypeError("KpcaEngine serves a FittedKpca or a "
                            "ShardedFittedKpca")
        self._inject_fault = inject_fault
        self._on_fault = on_fault
        self._buckets = self.cfg.buckets()
        self._on_card = self.device.type == "cuda"
        # The engine's own stream: every copy and launch of a drain goes
        # on it, from whichever thread issues them (_device_ctx).
        self._stream = torch.cuda.Stream(self.device) if self._on_card \
            else None
        # _dispatch_lock orders concurrent drains' launches; _stats_lock
        # guards the accounting that submitters and drains both touch.
        self._dispatch_lock = threading.Lock()
        self._stats_lock = threading.Lock()
        self._compiled_shapes = set()         # guarded-by: _stats_lock
        self.stats = EngineStats()            # guarded-by: _stats_lock
        cap = self.cfg.queue_capacity()
        arena_rows = max(cap or 0, self.cfg.max_batch * self.cfg.arena_factor)
        self._arena = SlabArena(model.n_features, arena_rows,
                                pin=self._on_card)
        self._queue = RequestQueue(max_queries=cap,
                                   policy=self.cfg.admission,
                                   slot_futures=True,
                                   on_shed=self._release_entries)
        self._stop = threading.Event()
        self._flusher: Optional[threading.Thread] = None
        self._device_pool: Optional[concurrent.futures.ThreadPoolExecutor] \
            = None
        # Touched only where slabs are launched, which is serialized: on the
        # device-runner thread, or under _dispatch_lock when it is not up.
        self._slab_bufs = {}                  # bucket -> device slab
        self._bf16_ring = {}                  # bucket -> bf16 pinned ring
        self._projector = (None, None)        # (version, scores function)
        self._m_requests = metrics.counter(
            "serve_requests_total", "Requests served")
        self._m_queries = metrics.counter(
            "serve_queries_total", "Query rows served")
        self._m_padded = metrics.counter(
            "serve_padded_rows_total", "Wasted pad rows computed")
        self._m_rejected = metrics.counter(
            "serve_rejected_total", "Admissions refused (QueueFullError)")
        self._m_shed = metrics.counter(
            "serve_shed_total", "Queued requests shed to admit newer ones")
        self._m_flushes = metrics.counter(
            "serve_flushes_total", "Drain cycles that served >= 1 request")
        self._m_depth = metrics.gauge(
            "serve_queue_depth_rows", "Queued rows after the last drain")
        self._m_version = metrics.gauge(
            "serve_model_version", "Model version the last drain served")
        self._m_latency = metrics.histogram(
            "serve_request_latency_seconds", "Per-request device wall time")
        self._m_wait = metrics.histogram(
            "serve_queue_wait_seconds", "Submit -> start-of-serve wait")
        self._m_retries = metrics.counter(
            "serve_retries_total", "Drain attempts retried after a fault")
        self._m_expired = metrics.counter(
            "serve_deadline_expired_total",
            "Requests failed on the per-request deadline")
        self._m_zero_copy = metrics.counter(
            "serve_zero_copy_slabs_total",
            "Slabs dispatched as arena slices (no pack copy)")
        self._m_donated = metrics.counter(
            "serve_donated_total", "Slabs dispatched with buffer donation")
        self._m_arena_fallback = metrics.counter(
            "serve_arena_fallback_total",
            "Submits that missed the staging ring (malloc fallback)")
        self._m_warmup = metrics.counter(
            "serve_warmup_compiles_total",
            "Programs compiled by the start() warmup pass")

        if isinstance(model, ShardedFittedKpca):
            if mesh is None and self._on_card:
                mesh = make_serving_mesh(model.n_shards)
            self._router = ShardedRouter(
                mesh, home=self.device, policy=self.cfg.routing,
                crossover=self.cfg.crossover)
        else:
            if mesh is not None:
                raise ValueError("mesh is only meaningful for a "
                                 "ShardedFittedKpca model")
            if self.cfg.routing != "auto":
                raise ValueError("cfg.routing is only meaningful for a "
                                 "ShardedFittedKpca model")
            self._router = None

    @property
    def model(self):
        """The live model (read through the handle)."""
        return self.handle.current()

    @property
    def router(self) -> Optional[ShardedRouter]:
        """The sharded router (None for a plain model)."""
        return self._router

    def _release_entries(self, entries) -> None:
        """Return entries' staged arena rows (shed/expired/failed/served)."""
        for e in entries:
            if e.arena_start is not None:
                self._arena.release(e.arena_start)
                e.arena_start = None

    @contextlib.contextmanager
    def _device_ctx(self):
        """What a thread that copies or launches enters: the engine's
        device and stream on the card (PyTorch's current stream is per
        thread), nothing on the CPU."""
        if not self._on_card:
            yield
            return
        with torch.cuda.device(self.device), torch.cuda.stream(self._stream):
            yield

    def _settle(self) -> None:
        """Wait for every copy and launch issued so far (a failed drain:
        before its staged rows and frames go back to the arena)."""
        if self._stream is not None:
            self._stream.synchronize()

    # ---- request API -----------------------------------------------------

    def submit(self, x_query) -> SlotFuture:
        """Enqueue one (Q, M) request; returns its future at once. The rows
        are staged into the arena now, so the flusher's pack is a slice.

        Raises ``QueueFullError`` when admission control refuses it."""
        x = np.asarray(x_query, np.float32)
        if x.ndim != 2 or x.shape[1] != self.model.n_features:
            raise ValueError(
                f"request must be (Q, {self.model.n_features}), "
                f"got {x.shape}")
        arena_start = self._arena.stage(x) if x.shape[0] else None
        if arena_start is None and x.shape[0]:
            self._m_arena_fallback.inc()
        try:
            fut, shed = self._queue.put(x, n=x.shape[0],
                                        arena_start=arena_start)
        except QueueFullError:
            if arena_start is not None:
                self._arena.release(arena_start)
            with self._stats_lock:
                self.stats.n_rejected += 1
            self._m_rejected.inc()
            trace.instant("serve.rejected", n=x.shape[0])
            raise
        if shed:
            with self._stats_lock:
                self.stats.n_shed += len(shed)
            self._m_shed.inc(len(shed))
        return fut

    def flush(self) -> dict:
        """Serve every queued request synchronously; resolves the futures
        and returns {request_id: (Q, C) scores}. On failure (after
        ``cfg.max_retries``) the still-live requests go back to the front
        of the queue and the error raises; expired ones fail with
        ``DeadlineExceededError``."""
        entries = self._queue.drain()
        if not entries:
            return {}
        entries = list(entries)
        try:
            out, served = self._serve_with_recovery(entries)
        except BaseException:
            self._queue.restore(entries)
            raise
        self._resolve(served, out)
        return out

    def project_many(self, requests: Sequence[Any]) -> List[np.ndarray]:
        """Convenience: submit + flush a list of (Q_i, M) arrays; returns
        the per-request (Q_i, C) score arrays in submission order."""
        futs = [self.submit(x) for x in requests]
        self.flush()
        return [f.result() for f in futs]

    # ---- background flusher ----------------------------------------------

    def start(self) -> "KpcaEngine":
        """Start the device-runner threads, warm every bucket (unless
        ``cfg.warmup`` is off) and start the flusher (idempotent)."""
        if self._flusher is not None:
            return self
        if self._device_pool is None:
            self._device_pool = concurrent.futures.ThreadPoolExecutor(
                max_workers=1, thread_name_prefix="kpca-device")
        if self.cfg.warmup:
            self.warmup()
        self._stop.clear()
        self._flusher = threading.Thread(
            target=self._flush_loop, name="kpca-engine-flusher", daemon=True)
        self._flusher.start()
        return self

    def warmup(self) -> int:
        """Run the serve path once per pow2 bucket (and, for a sharded
        model, the policy the router picks for it): builds the kernels,
        warms the allocator and the placement cache. Returns the number of
        (bucket, policy) shapes first seen here."""
        model, version = self.handle.get()
        with self._stats_lock:
            built0 = self.stats.n_warmup_compiles
        with trace.span("serve.warmup", n_buckets=len(self._buckets)):
            for b in self._buckets:
                slab = np.zeros((b, model.n_features), self._arena.buf.dtype)
                pool = self._device_pool
                with self._dispatch_lock:
                    run = pool.submit(self._launch, model, version, slab,
                                      True) if pool is not None \
                        else self._launch(model, version, slab, True)
                out = run.result() if pool is not None else run
                if out.event is not None:
                    out.event.synchronize()
        with self._stats_lock:
            built = self.stats.n_warmup_compiles - built0
        if built:
            self._m_warmup.inc(built)
        return built

    def close(self, drain: bool = True) -> None:
        """Stop the flusher (joined) and settle the queue: serve what is
        still queued when ``drain``, else cancel it. ``flush``/``submit``
        keep working afterwards (synchronous mode)."""
        if self._flusher is not None:
            self._stop.set()
            self._queue.kick()
            self._flusher.join(timeout=30.0)
            if self._flusher.is_alive():       # pragma: no cover
                raise RuntimeError("flusher thread failed to stop")
            self._flusher = None
        if drain:
            self.flush()
        else:
            dropped = self._queue.drain()
            self._release_entries(dropped)
            for e in dropped:
                e.future.cancel()
        if self._device_pool is not None:
            self._device_pool.shutdown(wait=True)
            self._device_pool = None

    @property
    def running(self) -> bool:
        return self._flusher is not None

    def __enter__(self) -> "KpcaEngine":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.close(drain=exc[0] is None)

    def _flush_loop(self) -> None:
        # Eager: an idle flusher drains on ANY queued work; batching then
        # emerges from backpressure while a drain is in flight.
        trigger = 1 if self.cfg.flush_eager \
            else (self.cfg.flush_min_queries or self.cfg.max_batch)
        # Pipelined drains hand the launches, the result wait, assembly and
        # resolution to the device-runner; retries, deadlines and recovery
        # hooks need the synchronous drain, so those configs keep it.
        pipelined = (self._device_pool is not None
                     and self.cfg.max_retries == 0
                     and self.cfg.request_deadline_s is None
                     and self._on_fault is None)
        inflight: collections.deque = collections.deque()
        last_n = 0                    # requests in the previous drain
        try:
            while True:
                has_work = self._queue.wait_for_work(
                    trigger, self.cfg.flush_max_wait_s, self._stop)
                if self._stop.is_set():
                    return            # close() settles whatever remains
                if not has_work:
                    continue
                while inflight and inflight[0].done():
                    inflight.popleft().result()
                if inflight:
                    # The runner is busy: hold the drain open until it
                    # frees or a full batch forms.
                    while (not inflight[0].done() and not self._stop.is_set()
                           and self._queue.depth < self.cfg.max_batch):
                        time.sleep(5e-5)
                    while inflight and inflight[0].done():
                        inflight.popleft().result()
                    if last_n > 1:
                        self._queue.coalesce(self.cfg.max_batch,
                                             self.cfg.flush_coalesce_s,
                                             self._stop)
                elif last_n > 1:
                    # the last drain resolved a wave of submitters: let
                    # the wave land as one slab
                    self._queue.coalesce(self.cfg.max_batch,
                                         self.cfg.flush_coalesce_s,
                                         self._stop)
                entries = self._queue.drain()
                if not entries:
                    continue
                entries = list(entries)
                last_n = len(entries)
                if pipelined:
                    while len(inflight) >= self.cfg.pipeline_depth:
                        inflight.popleft().result()
                    try:
                        inflight.append(self._dispatch_async(entries))
                    except BaseException as e:   # fail THIS batch only
                        self._fail_entries(entries, e)
                    with self._stats_lock:
                        if len(inflight) > self.stats.max_inflight_drains:
                            self.stats.max_inflight_drains = len(inflight)
                    continue
                try:
                    out, served = self._serve_with_recovery(entries)
                except BaseException as e:   # fail THIS batch, keep serving
                    self._fail_entries(entries, e)
                    continue
                self._resolve(served, out)
        finally:
            while inflight:
                inflight.popleft().result()

    def _fail_entries(self, entries, exc: BaseException) -> None:
        """Fail one drain's futures with ``exc``; its staged rows return to
        the arena once the copies in flight have completed."""
        self._settle()
        self._release_entries(entries)
        for en in entries:
            if not en.future.done():
                en.future.set_exception(exc)

    @staticmethod
    def _resolve(entries, out: dict) -> None:
        """Resolve one drain's futures: one slot-table publish and ONE
        event broadcast for the whole drain."""
        with trace.span("serve.resolve", n_requests=len(entries)):
            slot_pairs, results = [], []
            for e in entries:
                if isinstance(e.future, SlotFuture):
                    slot_pairs.append((e.future, len(results)))
                    results.append(out[e.rid])
                elif not e.future.done():
                    e.future.set_result(out[e.rid])
            if slot_pairs:
                slots = FlushSlots()
                slots.results = results
                SlotFuture.bind(slot_pairs, slots)
                slots.event.set()

    # ---- internals -------------------------------------------------------

    def _expire(self, entries: list) -> list:
        """Split off deadline-expired requests; their futures fail NOW with
        ``DeadlineExceededError``. Returns the still-live entries."""
        ddl = self.cfg.request_deadline_s
        if ddl is None:
            return entries
        now = time.monotonic()
        live, expired = [], []
        for e in entries:
            waited = now - e.t_submit
            if waited > ddl:
                expired.append(e)
                if not e.future.done():
                    e.future.set_exception(DeadlineExceededError(waited, ddl))
            else:
                live.append(e)
        n_expired = len(expired)
        if n_expired:
            self._release_entries(expired)
            with self._stats_lock:
                self.stats.n_deadline_expired += n_expired
            self._m_expired.inc(n_expired)
            if trace.is_enabled():
                trace.instant("serve.deadline_expired", n=n_expired)
        return live

    def _serve_with_recovery(self, entries: list) -> tuple:
        """``_serve`` under the fault contract: drop expired requests
        before every attempt, retry up to ``cfg.max_retries`` times
        (``on_fault`` between attempts; every attempt re-reads the handle),
        raise once retries are exhausted. Prunes ``entries`` in place to
        the live subset and returns ``(out, served)``."""
        attempt = 0
        while True:
            live = self._expire(entries)
            entries[:] = live
            if not live:
                return {}, []
            try:
                return self._serve(live), live
            except BaseException as e:
                if attempt >= self.cfg.max_retries:
                    raise
                attempt += 1
                handled = False
                if self._on_fault is not None:
                    try:
                        handled = bool(self._on_fault(e, self.handle))
                    except BaseException:
                        handled = False
                with self._stats_lock:
                    self.stats.n_retries += 1
                self._m_retries.inc()
                if trace.is_enabled():
                    trace.instant("serve.retry", attempt=attempt,
                                  error=type(e).__name__, handled=handled)
                if not handled:
                    self._stop.wait(
                        self.cfg.retry_backoff_s * (2 ** (attempt - 1)))

    def _serve(self, entries) -> dict:
        # One consistent (model, version) snapshot for the whole drain.
        model, version = self.handle.get()
        if self._inject_fault is not None:
            self._inject_fault(model)
        t_start = time.monotonic()
        # pack (slices), launch every slab under _dispatch_lock (on the
        # device-runner when it is up), then wait and assemble, no lock.
        with trace.span("serve.pack", n_requests=len(entries)):
            slabs, plan, frames = pack_slabs(
                entries, self.cfg.max_batch, self._buckets, self._arena)
        ok = False
        try:
            pool = self._device_pool
            with trace.span("serve.dispatch", n_slabs=len(slabs)):
                with self._dispatch_lock:
                    if pool is not None:
                        launched = pool.submit(self._run_slabs, model,
                                               version, slabs)
                    else:
                        launched = self._run_slabs(model, version, slabs)
            with trace.span("serve.gather", n_slabs=len(slabs)):
                done = launched.result() if pool is not None else launched
                dts, host, padded, zero_copy, policies = \
                    self._collect(slabs, done)
            ok = True
        finally:
            if not ok:
                self._settle()       # copies from the frames may be in flight
            for f in frames:
                self._arena.release_frame(f)
        return self._commit(entries, plan, dts, host, padded, zero_copy,
                            policies, len(slabs), model, version, t_start)

    def _dispatch_async(self, entries):
        """Pipelined drain: pack here, then queue the slabs' launches and,
        behind them, the wait, assembly and resolution as two tasks of the
        device-runner (FIFO: in drain order). Returns the second's
        future."""
        model, version = self.handle.get()
        if self._inject_fault is not None:
            self._inject_fault(model)
        t_start = time.monotonic()
        with trace.span("serve.pack", n_requests=len(entries)):
            slabs, plan, frames = pack_slabs(
                entries, self.cfg.max_batch, self._buckets, self._arena)
        pool = self._device_pool
        with trace.span("serve.dispatch", n_slabs=len(slabs)):
            with self._dispatch_lock:
                launched = pool.submit(self._run_slabs, model, version, slabs)
        return pool.submit(
            self._finalize, entries, slabs, plan, frames, launched, model,
            version, t_start)

    def _finalize(self, entries, slabs, plan, frames, launched, model,
                  version, t_start) -> None:
        """Results half of a pipelined drain: wait for the slabs, assemble,
        resolve, account. Never raises: a failed slab fails exactly this
        drain's futures."""
        try:
            ok = False
            try:
                with trace.span("serve.gather", n_slabs=len(slabs)):
                    done = launched.result()
                    dts, host, padded, zero_copy, policies = \
                        self._collect(slabs, done)
                ok = True
            finally:
                if not ok:
                    self._settle()
                for f in frames:
                    self._arena.release_frame(f)
            out, touched = self._assemble(entries, plan, dts, host, model)
            self._release_entries(entries)
        except BaseException as e:           # fail THIS batch only
            self._fail_entries(entries, e)
            return
        self._resolve(entries, out)
        self._account(entries, dts, touched, padded, zero_copy, policies,
                      len(slabs), version, t_start)

    @staticmethod
    def _collect(slabs, done):
        """Wait for one drain's slabs on the host. Returns (per-slab
        seconds, host score arrays, pad rows, zero-copy count, per-slab
        routing policies)."""
        dts, host, policies = [], [], []
        padded, zero_copy = 0, 0
        for (slab, take, zc), (res, dt) in zip(slabs, done):
            t0 = time.perf_counter()
            if res.policy == "mp" and trace.is_enabled():
                with trace.span("serve.psum", rows=int(slab.shape[0])):
                    if res.event is not None:
                        res.event.synchronize()
            elif res.event is not None:
                res.event.synchronize()
            dts.append(dt + time.perf_counter() - t0)
            host.append(res.host.numpy())
            policies.append(res.policy)
            padded += slab.shape[0] - take
            zero_copy += bool(zc)
        return dts, host, padded, zero_copy, policies

    def _commit(self, entries, plan, dts, host, padded, zero_copy,
                policies, n_slabs, model, version, t_start) -> dict:
        """Assembly + accounting tail of the synchronous drain."""
        out, touched = self._assemble(entries, plan, dts, host, model)
        self._release_entries(entries)
        self._account(entries, dts, touched, padded, zero_copy, policies,
                      n_slabs, version, t_start)
        return out

    @staticmethod
    def _assemble(entries, plan, dts, host, model):
        """Per-request results straight off the pack plan (a request in
        one slab gets a view of its scores). Returns (rid -> scores,
        rid -> device seconds touched)."""
        empty = np.zeros((0, model.n_components), np.float32)
        out, touched = {}, {}
        for e, segs in zip(entries, plan):
            if not segs:
                out[e.rid] = empty
                touched[e.rid] = 0.0
                continue
            if len(segs) == 1:
                si, row, _off, m = segs[0]
                out[e.rid] = host[si][row:row + m]
            else:
                buf = np.empty((e.n, host[segs[0][0]].shape[1]), np.float32)
                for si, row, off, m in segs:
                    buf[off:off + m] = host[si][row:row + m]
                out[e.rid] = buf
            touched[e.rid] = sum(dts[si] for si in {s[0] for s in segs})
        return out, touched

    def _account(self, entries, dts, touched, padded, zero_copy, policies,
                 n_slabs, version, t_start) -> None:
        """Stats + metric publication for one served drain."""
        waits = [max(0.0, t_start - e.t_submit) for e in entries]
        donated = n_slabs if self.cfg.donate else 0
        routed = collections.Counter(p for p in policies if p)
        with self._stats_lock:
            self.stats.n_routed_mp += routed.get("mp", 0)
            self.stats.n_routed_dp += routed.get("dp", 0)
            self.stats.n_routed_single += routed.get("single", 0)
            self.stats.n_padded += padded
            self.stats.total_time_s += sum(dts)
            self.stats.n_requests += len(entries)
            self.stats.n_queries += sum(e.n for e in entries)
            self.stats.n_flushes += 1
            self.stats.n_zero_copy_slabs += zero_copy
            self.stats.n_donated += donated
            self.stats.n_arena_fallback = self._arena.n_fallback
            for e, wait in zip(entries, waits):
                self.stats.per_request.append(RequestStats(
                    e.rid, e.n, touched[e.rid], version, queue_wait_s=wait))
        self._m_requests.inc(len(entries))
        self._m_queries.inc(sum(e.n for e in entries))
        self._m_padded.inc(padded)
        self._m_flushes.inc()
        self._m_depth.set(self._queue.depth)
        self._m_version.set(version)
        if zero_copy:
            self._m_zero_copy.inc(zero_copy)
        if donated:
            self._m_donated.inc(donated)
        self._m_latency.observe_many(list(touched.values()))
        self._m_wait.observe_many(waits)
        if trace.is_enabled():
            for e, wait in zip(entries, waits):
                trace.complete("serve.queue_wait", wait, rid=e.rid, n=e.n)

    def _stage_slab(self, slab: np.ndarray, warmup: bool = False,
                    policy: Optional[str] = None) -> torch.Tensor:
        """One packed host slab onto the engine's device, as the kernel
        reads it, plus the compile bookkeeping keyed (shape, dtype,
        policy). On the card the copy is ``non_blocking`` on the engine's
        stream, from pinned memory, into the bucket's reused buffer with
        ``donate``. bf16 slabs are rounded on the host first, into pinned
        staging (``_bf16_host``)."""
        host = torch.from_numpy(slab)
        if self._bf16:
            host = self._bf16_host(host)
        key = (tuple(host.shape), host.dtype, policy)
        with self._stats_lock:
            if key not in self._compiled_shapes:
                self._compiled_shapes.add(key)
                if warmup:
                    self.stats.n_warmup_compiles += 1
                else:
                    self.stats.n_compiles += 1
            if self._on_card:
                self.stats.n_h2d_bytes += host.numel() * host.element_size()
        if not self._on_card:
            return host
        if not self.cfg.donate:
            xq = host.to(self.device, non_blocking=True)
        else:
            buf = self._slab_bufs.get(host.shape[0])
            if buf is None:
                buf = torch.empty(host.shape, dtype=host.dtype,
                                  device=self.device)
                self._slab_bufs[host.shape[0]] = buf
            xq = buf.copy_(host, non_blocking=True)
        if self._bf16:
            # its staging buffer is free again once this copy has run
            self._bf16_ring[host.shape[0]].copied(self._stream)
        return xq

    def _bf16_host(self, host: torch.Tensor) -> torch.Tensor:
        """An fp32 host slab rounded to bf16 (to nearest even, as
        ``ml_dtypes`` rounds for the JAX package) in one cast: on the card
        into the next buffer of the bucket's pinned staging ring."""
        if not self._on_card:
            return host.to(torch.bfloat16)
        ring = self._bf16_ring.get(host.shape[0])
        if ring is None:
            ring = self._bf16_ring[host.shape[0]] = _StagingRing(
                host.shape, torch.bfloat16)
        return ring.next().copy_(host)

    def _project_fn(self, model, version):
        """The plain model's scores function for this version (its
        per-model operands formed once, on the engine's stream)."""
        if self._projector[0] != version:
            self._projector = (version, oos.projector(model.to(self.device)))
        return self._projector[1]

    def _launch(self, model, version, slab, warmup: bool = False):
        """Stage one slab and issue its work on the calling thread: the
        copy in, the kernels, and the copy of the scores out (into pinned
        host memory, complete when the returned event is)."""
        with self._device_ctx():
            if self._router is not None:
                policy = self._router.choose(int(slab.shape[0]), model)
                xq = self._stage_slab(slab, warmup=warmup, policy=policy)
                scores = self._router.dispatch(model, version, xq,
                                               policy).scores
            else:
                policy = None
                xq = self._stage_slab(slab, warmup=warmup)
                scores = self._project_fn(model, version)(xq)
            if not self._on_card:
                return _SlabOut(scores, None, policy)
            host = scores.to("cpu", non_blocking=True)
            event = torch.cuda.Event()
            event.record(self._stream)
            return _SlabOut(host, event, policy)

    def _run_slabs(self, model, version, slabs) -> list:
        """One drain's slabs, staged and launched in order on the calling
        thread (one device-runner task per drain, not per slab)."""
        return [self._run_slab(model, version, slab) for slab, _, _ in slabs]

    def _run_slab(self, model, version, slab):
        """Stage + launch one packed slab (the fault-injection seam: only
        real traffic goes through it). Returns ``(_SlabOut, seconds)``."""
        t0 = time.perf_counter()
        with trace.span("serve.device", rows=int(slab.shape[0])):
            out = self._launch(model, version, slab)
        return out, time.perf_counter() - t0


__all__ = ["EngineStats", "KpcaEngine", "KpcaServeConfig", "QueueFullError",
           "RequestFuture", "RequestStats"]
