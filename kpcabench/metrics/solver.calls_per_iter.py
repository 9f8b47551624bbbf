"""Device operations (kernels, copies, memsets) the solver issues an
iteration: those that start inside the ``run_admm`` span, over the
iterations the traced fits ran. Moves fit_device_s (and the host-bound
loop's wall time, which pays for each call)."""

from kpcabench.metrics import span


def read(ctx):
    rec = span(ctx, "solver")
    if rec is None:
        return None
    return rec["calls"] / (rec["n"] * ctx.config["iterations"])
