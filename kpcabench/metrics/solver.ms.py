"""Milliseconds a fit spends in ``core.admm.run_admm`` (the iterations,
each with its fused ``admm_step`` launch), synchronised, mean per fit of
the traced window; host clock. Moves fit_device_s."""

from kpcabench.metrics import span


def read(ctx):
    rec = span(ctx, "solver")
    return None if rec is None else 1e3 * rec["host_s"] / rec["n"]
