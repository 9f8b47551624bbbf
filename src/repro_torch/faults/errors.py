"""Typed fault errors.

A copy of the JAX package's module of the same name (stdlib only), so the
port imports nothing of ``repro``; the names it publishes are the same in
both packages, so one dashboard reads either.

This module is a dependency LEAF: ``serve`` imports it (deadline/retry
surfaces these to futures) and ``faults.*`` imports it, so it must not
import anything from ``repro_torch`` beyond the stdlib. Every failure the fault
layer injects — and every failure the recovery machinery gives up on —
resolves in-flight futures with a subclass of :class:`FaultError`, never a
hang and never a bare ``Exception`` that callers cannot route on.
"""

from __future__ import annotations


class FaultError(RuntimeError):
    """Base class for injected faults and exhausted-recovery failures."""


class ShardLostError(FaultError):
    """A serving shard's rows became unreachable (injected or detected).

    ``shard`` is the shard index; the re-balance path
    (the JAX package's ``faults.serving.ShardRebalancer``) keys off it.
    """

    def __init__(self, shard: int, detail: str = ""):
        self.shard = int(shard)
        msg = f"shard {shard} lost"
        super().__init__(f"{msg}: {detail}" if detail else msg)


class DeadlineExceededError(FaultError):
    """A request sat in the serving path longer than its deadline.

    Raised onto the request's future — the request is dropped, not served
    late, so recovery storms cannot grow the queue without bound.
    """

    def __init__(self, waited_s: float, deadline_s: float):
        self.waited_s = float(waited_s)
        self.deadline_s = float(deadline_s)
        super().__init__(
            f"request waited {waited_s * 1e3:.1f}ms > "
            f"deadline {deadline_s * 1e3:.1f}ms")


class InjectedCrashError(FaultError):
    """A deliberate crash from a :class:`FaultPlan` (publisher jobs etc.)."""


class NodeDownError(FaultError):
    """An ADMM participant vanished; the driver must re-knit to continue."""

    def __init__(self, nodes, t: int):
        self.nodes = tuple(int(n) for n in nodes)
        self.t = int(t)
        super().__init__(f"node(s) {self.nodes} down at iteration {t}")


__all__ = [
    "FaultError",
    "ShardLostError",
    "DeadlineExceededError",
    "InjectedCrashError",
    "NodeDownError",
]
