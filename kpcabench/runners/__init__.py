"""The runners: one general generator per kind of traffic, chosen by the
mix's ``kind`` and found by file: ``runners/<kind>.py`` (``fit``,
``ring_fit``, ``serve``, ``train``, and whatever a later file adds). Each
runs a cell from its files, times it, and returns an ``Outcome``; one that
has a ``control(cell, seed, count, device)`` gives its cells' control
readings to ``kpcabench/control.py``."""

from __future__ import annotations

import dataclasses
import re
from pathlib import Path
from typing import Optional

HERE = Path(__file__).resolve().parent
KIND = re.compile(r"^[A-Za-z0-9][A-Za-z0-9_]{0,63}$")


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
    """The runner module of a traffic kind: ``runners/<name>.py``, where
    that file exists and its name is a module name."""
    import importlib
    if not KIND.match(str(name)) or not (HERE / f"{name}.py").is_file():
        raise SystemExit(f"kpcabench: no runner for traffic kind {name!r}")
    return importlib.import_module(f"kpcabench.runners.{name}")


__all__ = ["Outcome", "kind"]
