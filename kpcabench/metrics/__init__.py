"""Per-layer metric readers: ``<metric name>.py`` each, with one function
``read(ctx)`` returning the metric's value, or None where the run holds
nothing to read (then the line leaves the metric out). ``ctx`` carries
the cell (``cell``, ``config``, ``traffic``, ``chips``), the traced
window's digest (``digest``, ``kpcabench.tracing``; rank 0's on a ring)
and the run's counters (``counters``). The helpers below are what several
readers share."""

from __future__ import annotations

from ..work import PEAKS


def span(ctx, name: str):
    """The digest's record of a benchmark span, or None."""
    if ctx.digest is None:
        return None
    rec = ctx.digest["spans"].get(name)
    return rec if rec and rec["n"] else None


def idle_pct(ctx):
    """100 x the share of the traced window in which no device operation
    ran."""
    d = ctx.digest
    if d is None or not d["window_s"] or not d["busy_s"]:
        return None
    return 100.0 * (1.0 - d["busy_s"] / d["window_s"])


def ops_share_pct(ctx, match) -> float:
    """100 x the device seconds of operations whose name satisfies
    ``match`` over the device's busy seconds."""
    d = ctx.digest
    if d is None or not d["busy_s"]:
        return None
    sec = sum(s for name, (_, s) in d["ops"].items() if match(name))
    return 100.0 * sec / d["busy_s"]


def mfu_pct(ctx, ops: float):
    """100 x ``ops`` over the traced window at the TF32 peak of every chip
    the cell uses."""
    d = ctx.digest
    if d is None or not d["window_s"] or not ops:
        return None
    return 100.0 * ops / (d["window_s"] * PEAKS["tf32_flops_per_s"]
                          * ctx.chips)


def fits(ctx) -> int:
    """Fits in the traced window: one setup (or ring) span each."""
    rec = span(ctx, "setup") or span(ctx, "ring")
    return rec["n"] if rec else 0
