"""Share of the traced fits' window in which no device operation ran.
Moves fit_device_s."""

from kpcabench.metrics import idle_pct


def read(ctx):
    return idle_pct(ctx)
