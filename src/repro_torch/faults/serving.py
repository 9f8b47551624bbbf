"""Serving-side fault injection + recovery: shard loss, publisher crash
(port of the JAX package's ``faults.serving``).

Injection and recovery are deliberately separate objects wired into the
same :class:`~repro_torch.serve.kpca_engine.KpcaEngine`:

- :class:`ShardLossInjector` is the engine's ``inject_fault`` hook — a
  deterministic stand-in for "the card serving shard s stopped
  answering". It raises :class:`~repro_torch.faults.errors.ShardLostError`
  on every dispatch that would still read the lost shard's rows, and
  goes quiet once the served model no longer has live rows there.
- :class:`ShardRebalancer` is the engine's ``on_fault`` recovery hook:
  on a ``ShardLostError`` it republishes the model with the lost shard
  zeroed (``core.oos.drop_shard`` — survivor centering rebuilt from the
  cached per-shard kernel-mean sums) through ONE atomic
  ``ModelHandle.publish``. Exactly-once: concurrent retries for the
  same shard contend on a lock and the loser observes the already-
  healed model (``shard_sizes[s] == 0``) and publishes nothing.

The engine's bounded retry re-reads the handle on every attempt, so the
attempt after the re-balance publish serves from the survivor model and
the in-flight futures resolve with real scores — zero hangs.

:class:`CrashingHandle` wraps a ``ModelHandle`` so scheduled
publish/refresh jobs raise — it proves the ``BackgroundPublisher``
remembers the error, keeps its worker alive, and keeps serving the last
good version.
"""

from __future__ import annotations

import threading
import time
from typing import Optional

from ..core import oos
from ..obs import metrics, trace
from .errors import InjectedCrashError, ShardLostError
from .plan import FaultPlan

_M_INJECTED_SHARD = metrics.counter(
    "faults_injected_total", "fault events activated", kind="shard_loss")
_M_INJECTED_CRASH = metrics.counter(
    "faults_injected_total", "fault events activated", kind="publisher_crash")
_M_REBALANCE = metrics.counter(
    "rebalance_publishes_total", "atomic shard-loss re-balance publishes")


class ShardLossInjector:
    """Deterministic shard-loss injection keyed off a :class:`FaultPlan`.

    ``__call__(model)`` is the engine's per-dispatch hook. Dispatches are
    counted under a lock (submitter/flusher threads race the counter);
    after dispatch ``at_dispatch`` of a ``ShardLoss`` event, any model
    still holding live rows for that shard raises ``ShardLostError``.
    """

    def __init__(self, plan: FaultPlan):
        self.plan = plan
        self._lock = threading.Lock()
        self._dispatches = 0
        self.n_raised = 0

    @property
    def dispatches(self) -> int:
        with self._lock:
            return self._dispatches

    def __call__(self, model) -> None:
        with self._lock:
            n = self._dispatches
            self._dispatches += 1
            dead = [ev.shard for ev in self.plan.shard_losses
                    if n >= ev.at_dispatch]
        sizes = getattr(model, "shard_sizes", None)
        if sizes is None:
            return                       # non-sharded model: nothing to lose
        for s in dead:
            if sizes[s] > 0:
                with self._lock:
                    self.n_raised += 1
                _M_INJECTED_SHARD.inc()
                if trace.is_enabled():
                    trace.instant("fault.injected", kind="shard_loss",
                                  shard=s, dispatch=n)
                raise ShardLostError(s, f"injected at dispatch {n}")


class ShardRebalancer:
    """Exactly-once shard-loss recovery for ``KpcaEngine.on_fault``.

    Returns True when the fault was handled (model republished or already
    healed) so the engine retries immediately instead of backing off.
    """

    def __init__(self):
        self._lock = threading.Lock()
        self.n_rebalances = 0

    def __call__(self, exc: BaseException, handle) -> bool:
        if not isinstance(exc, ShardLostError):
            return False
        with self._lock:
            model = handle.current()
            if getattr(model, "shard_sizes", None) is None:
                return False
            if model.shard_sizes[exc.shard] == 0:
                return True              # a concurrent retry already healed it
            t0 = time.perf_counter()
            handle.publish(oos.drop_shard(model, exc.shard))
            self.n_rebalances += 1
            _M_REBALANCE.inc()
            if trace.is_enabled():
                trace.complete("fault.recovery",
                               time.perf_counter() - t0,
                               kind="shard_loss", shard=exc.shard,
                               version=handle.version)
        return True


class CrashingHandle:
    """``ModelHandle`` wrapper whose scheduled jobs crash.

    Counts publish/refresh calls; call index ``at_job`` of each
    ``PublisherCrash`` event raises ``InjectedCrashError`` instead of
    applying the job. Reads (``get``/``current``/``version``) always
    pass through — a crashed publisher must not take serving down.
    """

    def __init__(self, handle, plan: FaultPlan):
        self.handle = handle
        self._crash_at = frozenset(
            int(ev.at_job) for ev in plan.publisher_crashes)
        self._lock = threading.Lock()
        self._jobs = 0
        self.n_crashes = 0

    def _maybe_crash(self, kind: str) -> None:
        with self._lock:
            n = self._jobs
            self._jobs += 1
            crash = n in self._crash_at
            if crash:
                self.n_crashes += 1
        if crash:
            _M_INJECTED_CRASH.inc()
            if trace.is_enabled():
                trace.instant("fault.injected", kind="publisher_crash",
                              job=n)
            raise InjectedCrashError(f"publisher job {n} ({kind}) crashed")

    def publish(self, model) -> int:
        self._maybe_crash("publish")
        return self.handle.publish(model)

    def refresh(self, alpha) -> int:
        self._maybe_crash("refresh")
        return self.handle.refresh(alpha)

    def refresh_shard(self, shard: int, alpha) -> int:
        self._maybe_crash("refresh_shard")
        return self.handle.refresh_shard(shard, alpha)

    def __getattr__(self, name):
        return getattr(self.handle, name)


def transient_faults(errors_before_success: int,
                     exc_factory=None) -> "_TransientInjector":
    """An ``inject_fault`` hook raising on the first N dispatches.

    Used by the launcher demo and tests to exercise retry-with-backoff
    without a sharded model.
    """
    return _TransientInjector(errors_before_success, exc_factory)


class _TransientInjector:
    def __init__(self, n: int, exc_factory: Optional[callable]):
        self._remaining = int(n)
        self._lock = threading.Lock()
        self._exc_factory = exc_factory or (
            lambda: InjectedCrashError("transient injected fault"))

    def __call__(self, model) -> None:
        with self._lock:
            if self._remaining <= 0:
                return
            self._remaining -= 1
        _M_INJECTED_CRASH.inc()
        raise self._exc_factory()


__all__ = ["ShardLossInjector", "ShardRebalancer", "CrashingHandle",
           "transient_faults"]
