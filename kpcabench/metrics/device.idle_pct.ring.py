"""Share of rank 0's traced window in which no device operation ran on its
card. Moves ring_fit_s."""

from kpcabench.metrics import idle_pct


def read(ctx):
    return idle_pct(ctx)
