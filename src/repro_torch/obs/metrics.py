"""Process-wide metrics registry: counters, gauges, fixed-bucket histograms.

A copy of the JAX package's module of the same name (stdlib only), so the
port imports nothing of ``repro``; the names it publishes are the same in
both packages, so one dashboard reads either.

Where the tracer (``repro_torch.obs.trace``) answers "what happened during this
window", the registry answers "how much, in total": monotonic counters
(``serve_requests_total``), point-in-time gauges (``serve_queue_depth_rows``)
and fixed-bucket histograms (``serve_request_latency_seconds``). Instrumented
code publishes through the module-level helpers —

    from repro_torch.obs import metrics
    metrics.counter("serve_rejected_total").inc()

— and a run launched with ``--metrics-out metrics.json`` writes the final
``snapshot()``. ``prometheus_text()`` emits the standard text exposition
format, so a real deployment can mount it on a ``/metrics`` endpoint
unchanged. Metric and label names follow Prometheus conventions
(``snake_case``, ``_total`` for counters, base-unit ``_seconds``/``_bytes``
suffixes); docs/OBSERVABILITY.md catalogs every name this repo emits.

Metrics are always on (there is no disabled state): every instrument is one
short per-metric lock acquisition, and hot paths amortize — the serving
engine publishes per *drain*, not per request, and batches per-request
latency samples through ``Histogram.observe_many`` under one acquisition.
Instrument handles are plain objects; call-sites on hot paths should look
them up once (``self._m_x = metrics.counter(...)``) and hold the handle.
"""

from __future__ import annotations

import bisect
import json
import threading
from typing import Dict, Iterator, List, Sequence, Tuple

# Latency-oriented default buckets (seconds): 100us .. 10s, log-ish.
DEFAULT_BUCKETS = (1e-4, 2.5e-4, 5e-4, 1e-3, 2.5e-3, 5e-3, 1e-2, 2.5e-2,
                   5e-2, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0)

_LabelItems = Tuple[Tuple[str, str], ...]


class _Metric:
    """Shared identity: name + sorted (label, value) pairs + help text."""

    kind = ""

    def __init__(self, name: str, help: str = "",
                 labels: _LabelItems = ()):
        self.name = name
        self.help = help
        self.labels = labels
        self._lock = threading.Lock()

    def label_dict(self) -> Dict[str, str]:
        return dict(self.labels)

    def snapshot(self) -> dict:
        raise NotImplementedError


class Counter(_Metric):
    """Monotonic accumulator; ``inc`` rejects negative deltas."""

    kind = "counter"

    def __init__(self, name: str, help: str = "", labels: _LabelItems = ()):
        super().__init__(name, help, labels)
        self._value = 0.0                   # guarded-by: _lock

    def inc(self, v: float = 1.0) -> None:
        if v < 0:
            raise ValueError(f"counter {self.name} cannot decrease ({v})")
        with self._lock:
            self._value += v

    @property
    def value(self) -> float:
        with self._lock:
            return self._value

    def snapshot(self) -> dict:
        return {"value": self.value}


class Gauge(_Metric):
    """Point-in-time value; settable and incrementable either direction."""

    kind = "gauge"

    def __init__(self, name: str, help: str = "", labels: _LabelItems = ()):
        super().__init__(name, help, labels)
        self._value = 0.0                   # guarded-by: _lock

    def set(self, v: float) -> None:
        with self._lock:
            self._value = float(v)

    def inc(self, v: float = 1.0) -> None:
        with self._lock:
            self._value += v

    @property
    def value(self) -> float:
        with self._lock:
            return self._value

    def snapshot(self) -> dict:
        return {"value": self.value}


class Histogram(_Metric):
    """Fixed-bucket histogram (cumulative ``le`` exposition, like
    Prometheus). Bucket edges are upper bounds in ascending order; samples
    above the last edge land in the implicit ``+Inf`` bucket."""

    kind = "histogram"

    def __init__(self, name: str, help: str = "", labels: _LabelItems = (),
                 buckets: Sequence[float] = DEFAULT_BUCKETS):
        super().__init__(name, help, labels)
        edges = tuple(float(b) for b in buckets)
        if not edges or list(edges) != sorted(set(edges)):
            raise ValueError(
                f"histogram {name} needs strictly increasing buckets, "
                f"got {buckets}")
        self.buckets = edges
        self._counts = [0] * (len(edges) + 1)   # guarded-by: _lock
        self._sum = 0.0                         # guarded-by: _lock
        self._count = 0                         # guarded-by: _lock

    def observe(self, v: float) -> None:
        i = bisect.bisect_left(self.buckets, v)
        with self._lock:
            self._counts[i] += 1
            self._sum += v
            self._count += 1

    def observe_many(self, values: Sequence[float]) -> None:
        """Batch a drain's worth of samples under ONE lock acquisition —
        the hot-path form (per-request latencies land here)."""
        if not values:
            return
        idx = [bisect.bisect_left(self.buckets, v) for v in values]
        with self._lock:
            for i in idx:
                self._counts[i] += 1
            self._sum += sum(values)
            self._count += len(values)

    @property
    def count(self) -> int:
        with self._lock:
            return self._count

    @property
    def sum(self) -> float:
        with self._lock:
            return self._sum

    def snapshot(self) -> dict:
        with self._lock:
            counts = list(self._counts)
            total, s = self._count, self._sum
        cum, out = 0, []
        for edge, c in zip(self.buckets, counts):
            cum += c
            out.append([edge, cum])
        return {"buckets": out, "count": total, "sum": s}


class MetricsRegistry:
    """Get-or-create registry keyed by (name, labels); one instance per
    process is the normal mode (``default_registry()``)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._metrics: Dict[tuple, _Metric] = {}    # guarded-by: _lock

    def _get(self, cls, name: str, help: str, labels: Dict[str, str],
             **extra) -> _Metric:
        key = (name, tuple(sorted((k, str(v)) for k, v in labels.items())))
        with self._lock:
            m = self._metrics.get(key)
            if m is None:
                m = cls(name, help, key[1], **extra)
                self._metrics[key] = m
        if not isinstance(m, cls):
            raise TypeError(f"metric {name!r} already registered as "
                            f"{m.kind}, requested {cls.kind}")
        return m

    def counter(self, name: str, help: str = "", **labels) -> Counter:
        return self._get(Counter, name, help, labels)

    def gauge(self, name: str, help: str = "", **labels) -> Gauge:
        return self._get(Gauge, name, help, labels)

    def histogram(self, name: str, help: str = "",
                  buckets: Sequence[float] = DEFAULT_BUCKETS,
                  **labels) -> Histogram:
        return self._get(Histogram, name, help, labels, buckets=buckets)

    def _sorted(self) -> List[_Metric]:
        with self._lock:
            items = list(self._metrics.items())
        return [m for _, m in sorted(items, key=lambda kv: kv[0])]

    def snapshot(self) -> dict:
        """JSON-ready view: every metric with kind, labels and values."""
        return {"metrics": [
            {"name": m.name, "kind": m.kind, "labels": m.label_dict(),
             **m.snapshot()} for m in self._sorted()]}

    def write_json(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(self.snapshot(), f, indent=2)
            f.write("\n")

    def prometheus_text(self) -> str:
        """Prometheus text exposition format (version 0.0.4)."""
        lines: List[str] = []
        seen_header = set()
        for m in self._sorted():
            if m.name not in seen_header:
                seen_header.add(m.name)
                if m.help:
                    lines.append(f"# HELP {m.name} {m.help}")
                lines.append(f"# TYPE {m.name} {m.kind}")
            if isinstance(m, Histogram):
                snap = m.snapshot()
                for edge, cum in snap["buckets"]:
                    lines.append(f"{m.name}_bucket"
                                 f"{_labels(m.labels, le=_fmt(edge))} {cum}")
                lines.append(f"{m.name}_bucket{_labels(m.labels, le='+Inf')}"
                             f" {snap['count']}")
                lines.append(
                    f"{m.name}_sum{_labels(m.labels)} {_fmt(snap['sum'])}")
                lines.append(
                    f"{m.name}_count{_labels(m.labels)} {snap['count']}")
            else:
                lines.append(f"{m.name}{_labels(m.labels)} {_fmt(m.value)}")
        return "\n".join(lines) + ("\n" if lines else "")

    def reset(self) -> None:
        """Drop every metric (tests; a live process never resets)."""
        with self._lock:
            self._metrics = {}

    def __iter__(self) -> Iterator[_Metric]:
        return iter(self._sorted())


def _fmt(v: float) -> str:
    return repr(int(v)) if float(v).is_integer() else repr(float(v))


def _labels(items: _LabelItems, **extra) -> str:
    pairs = list(items) + sorted(extra.items())
    if not pairs:
        return ""
    body = ",".join(f'{k}="{v}"' for k, v in pairs)
    return "{" + body + "}"


# ---- process-wide registry -------------------------------------------------

_default = MetricsRegistry()


def default_registry() -> MetricsRegistry:
    return _default


def counter(name: str, help: str = "", **labels) -> Counter:
    return _default.counter(name, help, **labels)


def gauge(name: str, help: str = "", **labels) -> Gauge:
    return _default.gauge(name, help, **labels)


def histogram(name: str, help: str = "",
              buckets: Sequence[float] = DEFAULT_BUCKETS,
              **labels) -> Histogram:
    return _default.histogram(name, help, buckets=buckets, **labels)


def snapshot() -> dict:
    return _default.snapshot()


def prometheus_text() -> str:
    return _default.prometheus_text()


def write_json(path: str) -> None:
    _default.write_json(path)


__all__ = ["Counter", "DEFAULT_BUCKETS", "Gauge", "Histogram",
           "MetricsRegistry", "counter", "default_registry", "gauge",
           "histogram", "prometheus_text", "snapshot", "write_json"]
