"""Shared ``--trace-out`` / ``--metrics-out`` wiring for the port's
launchers (a copy of the JAX package's ``obs.cli``, over the port's own
``obs.trace`` and ``obs.metrics``).

Every entry point that can produce a flight recording
(``repro_torch.launch.serve_kpca``) takes the same two flags:

    --trace-out trace.json      enable the span tracer; write Chrome-trace
                                JSON at exit (open in https://ui.perfetto.dev)
    --metrics-out metrics.json  write the final metrics-registry snapshot

Usage:

    add_obs_args(ap)
    args = ap.parse_args()
    with obs_session(args):
        ...                     # instrumented run
    # files written on exit (also on the exception path)
"""

from __future__ import annotations

import contextlib

from . import metrics, trace


def add_obs_args(ap) -> None:
    """Install the two observability flags on an ``ArgumentParser``."""
    ap.add_argument("--trace-out", default=None, metavar="PATH",
                    help="enable span tracing; write Chrome-trace JSON "
                         "(chrome://tracing / Perfetto) to PATH at exit")
    ap.add_argument("--metrics-out", default=None, metavar="PATH",
                    help="write the final metrics snapshot (JSON) to PATH "
                         "at exit")


@contextlib.contextmanager
def obs_session(args):
    """Enable tracing per ``args.trace_out`` around the body; export trace
    and metrics files on the way out (including the exception path, so a
    crashed run still leaves its recording behind)."""
    if args.trace_out:
        trace.enable()
    try:
        yield
    finally:
        if args.trace_out:
            n = trace.export(args.trace_out)
            print(f"wrote {n} trace events -> {args.trace_out}")
            trace.disable()
        if args.metrics_out:
            metrics.write_json(args.metrics_out)
            print(f"wrote metrics snapshot -> {args.metrics_out}")


__all__ = ["add_obs_args", "obs_session"]
