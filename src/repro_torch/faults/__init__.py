"""Typed fault errors of the serving path (a copy of the JAX package's
``faults.errors``)."""

from .errors import (DeadlineExceededError, FaultError, InjectedCrashError,
                     NodeDownError, ShardLostError)

__all__ = ["DeadlineExceededError", "FaultError", "InjectedCrashError",
           "NodeDownError", "ShardLostError"]
