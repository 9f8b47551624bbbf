"""Low-overhead span tracer with Chrome-trace/Perfetto export.

A copy of the JAX package's module of the same name (stdlib only), so
the port imports nothing of ``repro``, plus a bridge to ``torch.profiler``
(below); the names it publishes are the same in both packages, so one
dashboard reads either.

The flight recorder for the serving + solver stack: instrumented code
brackets work in named spans —

    from repro_torch.obs import trace

    with trace.span("serve.pack", requests=len(entries)):
        slabs = list(iter_slabs(...))

and a run launched with ``--trace-out trace.json`` (the port's launchers
``python -m repro_torch.launch.serve_kpca`` and ``python -m
repro_torch.launch.train``) writes every recorded span as a Chrome-trace
JSON that ``chrome://tracing`` or https://ui.perfetto.dev renders as a
per-thread timeline (docs/OBSERVABILITY.md lists the span taxonomy; the
port's fit spans are listed in PERF.md, section 3).

While a torch profiler records, an enabled tracer also opens every span
as a ``torch.profiler.record_function`` range of the same name, so the
span sits in the profiler's host timeline on the device events' clock,
and the profiler's launch correlation ties each kernel to the span that
launched it. ``instant`` and ``complete`` stay in the ring buffer only (a
profiler range cannot be backdated). torch is looked up, never imported.

Design constraints, in order:

  1. **Zero-cost when disabled.** Tracing is off by default; ``span()``
     then returns one process-wide no-op context-manager singleton —
     no span object, no buffer append, no lock. The hot serving path
     pays a function call and an identity ``with``.
  2. **Bounded memory.** Events land in a fixed-capacity ring buffer
     (latest wins); a long-running server can trace forever and export
     the most recent window. ``n_dropped`` counts overwritten events.
  3. **Thread-safe, monotonic.** Spans may open/close on any thread;
     timestamps come from ``time.perf_counter_ns`` (monotonic, ns), and
     the buffer append is one short lock acquisition per *completed*
     span — never held while user code runs.

Spans must be entered via ``with`` — a span created and never exited is
never recorded and corrupts the nesting the viewer reconstructs from
timestamps. The repro-lint rule ``span-not-closed`` enforces this
statically (docs/STATIC_ANALYSIS.md).

For durations that do not nest on one thread (e.g. a request's
queue-wait measured between the submitter thread and the flusher
thread), ``complete(name, duration_s)`` records an already-finished
span ending now; ``instant(name)`` records a point event.
"""

from __future__ import annotations

import json
import sys
import threading
import time
from typing import Any, Dict, List, Optional

_DEFAULT_CAPACITY = 65536


class _NoopSpan:
    """Identity context manager returned by ``span()`` while tracing is
    disabled: one process-wide instance, allocation-free per call."""

    __slots__ = ()

    def __enter__(self) -> "_NoopSpan":
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        return False

    def annotate(self, **attrs) -> "_NoopSpan":
        return self


NOOP_SPAN = _NoopSpan()


def _profiler_range(name: str):
    """An entered ``record_function`` range named ``name`` while a torch
    profiler records, else None. torch is taken from ``sys.modules``, so
    a process that never imported it pays a dict lookup."""
    torch = sys.modules.get("torch")
    if torch is None or not torch.autograd._profiler_enabled():
        return None
    rng = torch.autograd.profiler.record_function(name)
    rng.__enter__()
    return rng


class Span:
    """One live span: records a complete ("X") event on ``__exit__`` —
    including on the exception path, so a raising body still closes its
    span and the trace tree stays well-formed. While a torch profiler
    records, it is also a ``record_function`` range."""

    __slots__ = ("_tracer", "name", "attrs", "_t0", "_range")

    def __init__(self, tracer: "Tracer", name: str, attrs: Dict[str, Any]):
        self._tracer = tracer
        self.name = name
        self.attrs = attrs
        self._t0 = 0
        self._range = None

    def __enter__(self) -> "Span":
        self._range = _profiler_range(self.name)
        self._t0 = time.perf_counter_ns()
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        end = time.perf_counter_ns()
        if self._range is not None:
            self._range.__exit__(exc_type, exc, tb)
        self._tracer._record("X", self.name, self._t0, end - self._t0,
                             self.attrs)
        return False

    def annotate(self, **attrs) -> "Span":
        """Attach attributes discovered mid-span (exported as ``args``)."""
        self.attrs.update(attrs)
        return self


def _json_safe(v):
    return v if isinstance(v, (str, int, float, bool, type(None))) else str(v)


class Tracer:
    """Thread-safe fixed-capacity ring buffer of trace events.

    Use the module-level API (``enable``/``span``/``export``) for the
    process-wide tracer; standalone instances are for tests and scoped
    measurements (e.g. the bench harness timing one suite).
    """

    def __init__(self, capacity: int = _DEFAULT_CAPACITY):
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        self.capacity = capacity
        self._lock = threading.Lock()
        self._buf: List[Optional[tuple]] = [None] * capacity
        self._pos = 0                       # events ever recorded
        self._thread_names: Dict[int, str] = {}

    # -- recording ----------------------------------------------------------

    def span(self, name: str, **attrs) -> Span:
        """A span context manager recording into THIS tracer (the module
        function routes to the process-wide tracer instead)."""
        return Span(self, name, attrs)

    def instant(self, name: str, **attrs) -> None:
        """A point event (Chrome phase "i") at the current time."""
        self._record("i", name, time.perf_counter_ns(), 0, attrs)

    def complete(self, name: str, duration_s: float, **attrs) -> None:
        """An already-finished span of ``duration_s`` seconds ending NOW —
        for durations measured across threads (queue waits) or from
        foreign clocks; only the duration must be meaningful."""
        dur = max(0, int(duration_s * 1e9))
        end = time.perf_counter_ns()
        self._record("X", name, end - dur, dur, attrs)

    def _record(self, ph: str, name: str, t0_ns: int, dur_ns: int,
                attrs: Dict[str, Any]) -> None:
        th = threading.current_thread()
        with self._lock:
            if th.ident not in self._thread_names:
                self._thread_names[th.ident] = th.name
            self._buf[self._pos % self.capacity] = (
                ph, name, t0_ns, dur_ns, th.ident, attrs)
            self._pos += 1

    # -- inspection ---------------------------------------------------------

    @property
    def n_recorded(self) -> int:
        """Events ever recorded (including ones the ring overwrote)."""
        with self._lock:
            return self._pos

    @property
    def n_dropped(self) -> int:
        """Events overwritten by ring wrap-around (ring keeps the latest)."""
        with self._lock:
            return max(0, self._pos - self.capacity)

    def events(self) -> List[tuple]:
        """Surviving events, oldest first: ``(ph, name, t0_ns, dur_ns,
        tid, attrs)`` tuples."""
        with self._lock:
            if self._pos <= self.capacity:
                return list(self._buf[:self._pos])
            i = self._pos % self.capacity
            return self._buf[i:] + self._buf[:i]

    def durations(self, name: str) -> List[float]:
        """Seconds per surviving complete span named ``name`` (oldest
        first) — the snapshot the bench harness aggregates phase means
        from."""
        return [e[3] / 1e9 for e in self.events()
                if e[0] == "X" and e[1] == name]

    def clear(self) -> None:
        with self._lock:
            self._buf = [None] * self.capacity
            self._pos = 0
            self._thread_names = {}

    # -- export -------------------------------------------------------------

    def to_chrome(self) -> dict:
        """The Chrome-trace JSON object: ``traceEvents`` of complete
        ("X") / instant ("i") events in microseconds plus ``thread_name``
        metadata, loadable by chrome://tracing and Perfetto."""
        with self._lock:
            names = dict(self._thread_names)
        out: List[dict] = []
        for tid, name in sorted(names.items()):
            out.append({"ph": "M", "name": "thread_name", "pid": 0,
                        "tid": tid, "args": {"name": name}})
        for ph, name, t0, dur, tid, attrs in self.events():
            ev = {"name": name, "ph": ph, "ts": t0 / 1e3, "pid": 0,
                  "tid": tid}
            if ph == "X":
                ev["dur"] = dur / 1e3
            else:
                ev["s"] = "t"
            if attrs:
                ev["args"] = {k: _json_safe(v) for k, v in attrs.items()}
            out.append(ev)
        return {"traceEvents": out, "displayTimeUnit": "ms"}

    def export(self, path: str) -> int:
        """Write ``to_chrome()`` to ``path``; returns the event count."""
        doc = self.to_chrome()
        with open(path, "w") as f:
            json.dump(doc, f)
            f.write("\n")
        return len(doc["traceEvents"])


# ---- process-wide tracer ---------------------------------------------------

_tracer: Optional[Tracer] = None


def enable(capacity: int = _DEFAULT_CAPACITY) -> Tracer:
    """Install (and return) a fresh process-wide tracer."""
    global _tracer
    _tracer = Tracer(capacity)
    return _tracer


def disable() -> None:
    """Remove the process-wide tracer; ``span()`` reverts to the no-op."""
    global _tracer
    _tracer = None


def install(tracer: Optional[Tracer]) -> None:
    """Swap in a specific tracer instance (None = disable) — lets a scoped
    measurement (the obs bench) run on its own tracer and hand the
    original back with its events intact."""
    global _tracer
    _tracer = tracer


def is_enabled() -> bool:
    return _tracer is not None


def active() -> Optional[Tracer]:
    """The process-wide tracer, or None while disabled."""
    return _tracer


def span(name: str, **attrs):
    """A ``with``-able span on the process-wide tracer — THE instrumentation
    entry point. Returns the no-op singleton while tracing is disabled."""
    t = _tracer
    if t is None:
        return NOOP_SPAN
    return Span(t, name, attrs)


def instant(name: str, **attrs) -> None:
    t = _tracer
    if t is not None:
        t.instant(name, **attrs)


def complete(name: str, duration_s: float, **attrs) -> None:
    t = _tracer
    if t is not None:
        t.complete(name, duration_s, **attrs)


def export(path: str) -> int:
    """Export the process-wide tracer's events (raises when disabled)."""
    t = _tracer
    if t is None:
        raise RuntimeError("tracing is not enabled (call trace.enable())")
    return t.export(path)


__all__ = ["NOOP_SPAN", "Span", "Tracer", "active", "complete", "disable",
           "enable", "export", "install", "instant", "is_enabled", "span"]
