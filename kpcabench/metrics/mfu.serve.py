"""Serving's share of the card's peak: the products of the rows the
clients sent in the traced window (``work.project.rows``) over the window
at the TF32 peak. Bounds project_roofline. Moves serve_rows_per_s."""

from kpcabench.metrics import mfu_pct
from kpcabench.work import project


def read(ctx):
    rows = ctx.counters.get("rows")
    if not rows:
        return None
    ops, _ = project.rows(rows, ctx.counters["support_rows"],
                          ctx.config["features"], ctx.config["components"])
    return mfu_pct(ctx, ops)
