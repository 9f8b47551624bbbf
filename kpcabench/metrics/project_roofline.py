"""The project op's share of its roofline: the least time scoring the rows
the clients sent in the traced window could take (``work.project.rows``,
compute-bound at the TF32 peak; padding and slabs not counted) over the
device seconds of project's kernels (``kernels/project.json``). Moves
serve_rows_per_s."""

from kpcabench import tracing
from kpcabench.work import project, share_pct


def read(ctx):
    rows = ctx.counters.get("rows")
    if ctx.digest is None or not rows:
        return None
    ops, nbytes = project.rows(rows, ctx.counters["support_rows"],
                               ctx.config["features"],
                               ctx.config["components"])
    return share_pct(ops, nbytes, tracing.op_seconds(ctx.digest, "project"))
