"""Versioned model publishing: the trainer-to-server hand-off (port of
``repro.serve.publisher``).

``ModelHandle`` is a thread-safe, versioned, atomically-swappable reference
to a servable model. ``KpcaEngine`` reads THROUGH the handle: each drain
snapshots (model, version) once, so every slab of that drain scores against
one consistent model even if a publish lands mid-drain. Sharded models swap
per shard the same way (``refresh_shard``): the rebuilt model is still ONE
atomic publish, so a request never sees a mix of shard versions. Publishing
is a reference swap under a lock, never a copy, so it never blocks serving.

``BackgroundPublisher`` moves refresh + publish off the solver driver's
thread (coalescing latest-wins per target), and ``stream_chunks`` consumes a
``run_chunked`` iterator and republishes under a cadence policy
(``repro_torch.core.solver.resolve_refresh_policy``).
"""

from __future__ import annotations

import threading
from typing import Iterable, List, Optional, Tuple

from ..core import oos
from ..core.solver import resolve_refresh_policy
from ..obs import metrics, trace

# Module-level cached handles: every ModelHandle/BackgroundPublisher in the
# process shares these (publishes are process-wide events, and resolving
# once keeps registry lookups off the publish path).
_M_PUBLISHES = metrics.counter(
    "publish_swaps_total", "Model versions atomically published")
_M_COALESCED = metrics.counter(
    "publish_coalesced_total", "Snapshots dropped unpublished (latest-wins)")
_M_ERRORS = metrics.counter(
    "publish_errors_total", "Publisher worker jobs that raised")


class ModelHandle:
    """Thread-safe versioned reference to a servable kPCA model.

    The handle pins the model TYPE at construction (``FittedKpca`` or
    ``ShardedFittedKpca``) — and, for sharded models, the shard count: the
    engine builds its serving path for that type (and its router's device
    placement for that shard count), so a publish may change coefficients
    and shapes but not the artifact kind or the shard layout.
    """

    def __init__(self, model, version: int = 0):
        self._lock = threading.Lock()
        # Serializes the read-rebuild-publish cycle of refresh/
        # refresh_shard: two concurrent refreshes must not both rebuild
        # from the same base and silently drop one of the updates.
        self._refresh_lock = threading.Lock()
        self._model = model                 # guarded-by: _lock
        self._version = version             # guarded-by: _lock
        self._kind = type(model)
        # the engine's sharded path also pins its device placement to the
        # initial shard count, so that is part of the contract too
        self._n_shards = getattr(model, "n_shards", None)

    @property
    def version(self) -> int:
        with self._lock:
            return self._version

    def current(self):
        """The live model (convenience; use ``get`` when the matching
        version number matters)."""
        with self._lock:
            return self._model

    def get(self) -> Tuple[object, int]:
        """Consistent (model, version) snapshot — THE read path: take it
        once per batch so all work in the batch serves one version."""
        with self._lock:
            return self._model, self._version

    def publish(self, model) -> int:
        """Atomically swap in a new model; returns its version number.

        In-flight readers keep the snapshot they took; only subsequent
        ``get``/``current`` calls see the new model.
        """
        if not isinstance(model, self._kind):
            raise TypeError(
                f"handle serves {self._kind.__name__}, got "
                f"{type(model).__name__}")
        if self._n_shards is not None and model.n_shards != self._n_shards:
            raise ValueError(
                f"handle serves a {self._n_shards}-shard model (the "
                f"engine's mesh is pinned to it), got {model.n_shards} "
                f"shards — re-shard behind a new engine instead")
        with self._lock:
            self._model = model
            self._version += 1
            version = self._version
        trace.instant("publish.swap", version=version)
        _M_PUBLISHES.inc()
        return version

    def refresh(self, alpha) -> int:
        """Publish the current model rebuilt around live dual coefficients
        (``repro_torch.core.oos.refresh_coefficients`` — reuses the cached
        kernel-mean statistics; sharded models rebuild per shard). Returns
        the new version. Compressed models cannot refresh — build and
        ``publish`` a re-compressed model instead. Refreshes from
        different threads serialize, so none is silently lost."""
        with self._refresh_lock:
            with trace.span("publish.refresh"):
                model = oos.refresh_coefficients(self.current(), alpha)
            return self.publish(model)

    def refresh_shard(self, shard: int, alpha) -> int:
        """Publish the current SHARDED model with one shard's coefficient
        rows swapped (``repro_torch.core.oos.refresh_shard_coefficients`` —
        global centering rebuilt from the per-shard cached stats). The
        swap is still one atomic whole-model publish: concurrent readers
        see the old model or the new one, never a mix of shards; and
        concurrent refreshes serialize, so two threads swapping DIFFERENT
        shards both land. Returns the new version."""
        with self._refresh_lock:
            with trace.span("publish.refresh", shard=shard):
                model = oos.refresh_shard_coefficients(
                    self.current(), shard, alpha)
            return self.publish(model)


class BackgroundPublisher:
    """Non-blocking publish pipeline: hand coefficients over in O(1), a
    daemon thread does the refresh + publish.

    Jobs are coalesced LATEST-WINS per target — the whole model, or one
    shard index: if the producer outpaces the publisher, intermediate
    snapshots for the same target are dropped unpublished (``n_coalesced``
    counts them), because only the freshest coefficients matter to the
    serving side. Job order across targets is preserved (FIFO of targets).

    A worker-side failure is remembered and re-raised at the next
    ``drain``/``close`` on the caller's thread — the worker itself keeps
    serving later jobs. Use as a context manager to guarantee the thread
    is joined:

        with BackgroundPublisher(handle) as pub:
            for chunk in run_chunked(...):
                pub.refresh(chunk.state.alpha)      # never blocks
        # exit == drain (everything published) + join
    """

    def __init__(self, handle: ModelHandle):
        self.handle = handle
        self._cond = threading.Condition()
        self._jobs = {}                  # key -> payload   guarded-by: _cond
        self._order: List[tuple] = []    # FIFO of keys     guarded-by: _cond
        self._busy = False                  # guarded-by: _cond
        self._closed = False                # guarded-by: _cond
        self._errors: List[BaseException] = []  # guarded-by: _cond
        self.n_published = 0                # guarded-by: _cond
        self.n_coalesced = 0                # guarded-by: _cond
        self._thread = threading.Thread(
            target=self._run, name="kpca-publisher", daemon=True)
        self._thread.start()

    # -- producer side ------------------------------------------------------

    def refresh(self, alpha) -> None:
        """Queue a whole-model coefficient refresh (latest-wins)."""
        self._enqueue(("refresh", None), alpha)

    def refresh_shard(self, shard: int, alpha) -> None:
        """Queue a single-shard coefficient refresh (latest-wins per
        shard index)."""
        self._enqueue(("shard", shard), alpha)

    def publish(self, model) -> None:
        """Queue a prebuilt model publish (latest-wins)."""
        self._enqueue(("publish", None), model)

    def _enqueue(self, key, payload) -> None:
        with self._cond:
            if self._closed:
                raise RuntimeError("publisher is closed")
            coalesced = key in self._jobs
            if coalesced:
                self.n_coalesced += 1
            else:
                self._order.append(key)
            self._jobs[key] = payload
            self._cond.notify_all()
        if coalesced:
            _M_COALESCED.inc()
            trace.instant("publish.coalesced", target=str(key))

    # -- lifecycle ----------------------------------------------------------

    def drain(self, timeout: Optional[float] = None) -> None:
        """Block until every queued job has been published; re-raises the
        first worker-side error if any occurred since the last drain."""
        with self._cond:
            if not self._cond.wait_for(
                    lambda: not self._order and not self._busy,
                    timeout=timeout):
                raise TimeoutError("publisher did not drain in time")
            self._reraise_locked()

    def close(self, timeout: float = 30.0) -> None:
        """Drain remaining jobs, stop and JOIN the worker thread.
        Idempotent; re-raises a pending worker error."""
        with self._cond:
            self._closed = True
            self._cond.notify_all()
        self._thread.join(timeout=timeout)
        if self._thread.is_alive():      # pragma: no cover
            raise RuntimeError("publisher thread failed to stop")
        with self._cond:
            self._reraise_locked()

    def _reraise_locked(self) -> None:  # holds-lock: _cond
        if self._errors:
            err, self._errors = self._errors[0], []
            raise err

    def __enter__(self) -> "BackgroundPublisher":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    # -- worker -------------------------------------------------------------

    def _run(self) -> None:
        while True:
            with self._cond:
                while not self._order and not self._closed:
                    self._cond.wait()
                if not self._order:      # closed and fully drained
                    return
                key = self._order.pop(0)
                payload = self._jobs.pop(key)
                self._busy = True
            try:
                kind, shard = key
                with trace.span("publish.job", kind=kind,
                                shard=-1 if shard is None else shard):
                    if kind == "refresh":
                        self.handle.refresh(payload)
                    elif kind == "shard":
                        self.handle.refresh_shard(shard, payload)
                    else:
                        self.handle.publish(payload)
                ok = True
            except BaseException as e:   # remembered, reraised at drain
                ok = False
                _M_ERRORS.inc()
                with self._cond:
                    self._errors.append(e)
            with self._cond:
                if ok:
                    self.n_published += 1
                self._busy = False
                self._cond.notify_all()


def stream_chunks(chunks: Iterable, handle: ModelHandle,
                  every: Optional[int] = None, policy=None,
                  publisher: Optional[BackgroundPublisher] = None):
    """Drive a ``repro_torch.core.solver.run_chunked`` iterator to completion,
    refreshing ``handle`` from the live state under a cadence policy (and
    always at the last chunk, so the served model never lags the finished
    fit). Returns the final ``ChunkResult`` (None if the iterator was
    empty).

    Args:
      chunks: the driver's ``ChunkResult`` iterator.
      handle: publish target.
      every: fixed cadence shorthand — refresh each ``every`` chunks
        (``repro_torch.core.solver.EveryK``). Mutually exclusive with
        ``policy``; both None means every chunk.
      policy: pluggable cadence — anything
        ``repro_torch.core.solver.resolve_refresh_policy`` accepts: an int, the
        string "residual" (``ResidualImprovement``: publish only when the
        primal residual improved by >= 10% since the last publish), a
        ``should_refresh(ChunkResult) -> bool`` object, or a bare
        callable.
      publisher: route refreshes through a ``BackgroundPublisher`` so the
        driver loop never blocks on a publish; drained (all snapshots
        published, worker errors re-raised) before returning. The caller
        still owns ``close``.
    """
    if every is not None and policy is not None:
        raise ValueError("pass either every= or policy=, not both")
    pol = resolve_refresh_policy(policy if policy is not None else every)
    target = publisher if publisher is not None else handle
    # COKE-style cadence accounting: every should_refresh decision is an
    # event — "fired" (snapshot published) or "censored" (communication
    # saved), labeled by the policy that made it.
    pol_name = type(pol).__name__
    m_fired = metrics.counter(
        "solver_refresh_fired_total",
        "Refresh-policy decisions that published", policy=pol_name)
    m_censored = metrics.counter(
        "solver_refresh_censored_total",
        "Refresh-policy decisions that skipped a publish", policy=pol_name)
    last = None
    pending = False
    for chunk in chunks:
        last = chunk
        fired = pol.should_refresh(chunk)
        if trace.is_enabled():
            trace.instant("solver.refresh_decision", fired=fired,
                          policy=pol_name, t=int(chunk.state.t))
        if fired:
            m_fired.inc()
            target.refresh(chunk.state.alpha)
            pending = False
        else:
            m_censored.inc()
            pending = True
    if last is not None and pending:
        target.refresh(last.state.alpha)
    if publisher is not None:
        publisher.drain()
    return last


__all__ = ["BackgroundPublisher", "ModelHandle", "stream_chunks"]
