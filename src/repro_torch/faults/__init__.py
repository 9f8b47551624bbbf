"""Deterministic fault injection + the recovery machinery it exercises
(port of the JAX package's ``faults``). Three layers:

- ``plan``: seeded, immutable :class:`FaultPlan` — what fails and when
  (node dropout, link loss/delay, straggler stalls, shard loss, publisher
  crashes). Same seed ⇒ same faults ⇒ same trajectory.
- ``comm`` + ``driver``: solver-side injection (``FaultyComm`` transport
  censoring, per-iteration slot masks) and recovery
  (:class:`FaultTolerantRun` — re-knit, state shrink, warm continuation).
- ``serving``: engine-side injection/recovery (shard loss + exactly-once
  re-balance publish, publisher crashes, transient faults for the retry
  path).

``errors``/``plan``/``comm`` are import-cycle leaves (``core.solver``
imports ``faults.comm`` on its masked path only); ``driver`` and
``serving`` pull in the
solver/serving stacks and load lazily via module ``__getattr__``.
"""

from .comm import FaultyComm
from .errors import (DeadlineExceededError, FaultError, InjectedCrashError,
                     NodeDownError, ShardLostError)
from .plan import (FaultPlan, LinkFault, NodeDropout, PublisherCrash,
                   ShardLoss, StragglerStall, link_delay)

_LAZY = {
    "FaultTolerantRun": "driver",
    "FaultEventRecord": "driver",
    "run_chunked_with_faults": "driver",
    "shrink_state": "driver",
    "ShardLossInjector": "serving",
    "ShardRebalancer": "serving",
    "CrashingHandle": "serving",
    "transient_faults": "serving",
}


def __getattr__(name: str):
    mod = _LAZY.get(name)
    if mod is None:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    import importlib
    return getattr(importlib.import_module(f".{mod}", __name__), name)


__all__ = [
    "FaultError", "ShardLostError", "DeadlineExceededError",
    "InjectedCrashError", "NodeDownError",
    "FaultPlan", "NodeDropout", "LinkFault", "StragglerStall", "ShardLoss",
    "PublisherCrash", "link_delay", "FaultyComm",
    *sorted(_LAZY),
]
