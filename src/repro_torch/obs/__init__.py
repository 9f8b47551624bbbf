"""Observability for the port: span tracing and metrics, copies of the JAX
package's stdlib-only ``obs.trace`` and ``obs.metrics``. The serving engine,
the router and the publisher publish their counters, gauges, histograms and
spans here under the JAX package's names."""

from . import metrics, trace

__all__ = ["metrics", "trace"]
