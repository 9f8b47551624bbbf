"""Milliseconds a fit spends in ``core.admm.build_setup`` (the node Grams,
global centring, the batched eigensolve), synchronised, mean per fit of
the traced window; host clock. Moves fit_device_s."""

from kpcabench.metrics import span


def read(ctx):
    rec = span(ctx, "setup")
    return None if rec is None else 1e3 * rec["host_s"] / rec["n"]
