"""The runners: one general generator per kind of traffic, chosen by the
mix's ``kind`` (``fit``, ``ring_fit``, ``serve``). Each runs a cell from
its files, times it, and returns an ``Outcome``."""

from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass
class Outcome:
    """What a runner hands back to ``run.py``."""

    setup_end: float                 # perf_counter when set-up ended
    end_to_end: dict                 # {metric: value} it measured
    attempted: int
    failed: int
    checks: dict                     # {number: value} compared
    memory_peak_bytes: int = 0
    counters: dict = dataclasses.field(default_factory=dict)
    digest: Optional[dict] = None    # trace digest (rank 0's on a ring)
    busy_s: Optional[float] = None   # averaged over the chips
    window_s: Optional[float] = None


def kind(name: str):
    """The runner module of a traffic kind."""
    import importlib
    if name not in ("fit", "ring_fit", "serve"):
        raise SystemExit(f"kpcabench: no runner for traffic kind {name!r}")
    return importlib.import_module(f"kpcabench.runners.{name}")


__all__ = ["Outcome", "kind"]
