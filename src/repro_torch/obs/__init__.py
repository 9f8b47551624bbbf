"""Observability for the port: span tracing, metrics and communication
accounting, copies of the JAX package's stdlib-only ``obs.trace``,
``obs.metrics`` and ``obs.comm``. The solver, the fault layer, the serving
engine, the router and the publisher publish their counters, gauges,
histograms and spans here under the JAX package's names."""

from . import metrics, trace
from .comm import CommLedger, CommProfile

__all__ = ["CommLedger", "CommProfile", "metrics", "trace"]
