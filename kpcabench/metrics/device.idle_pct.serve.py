"""Share of the traced serving window in which no device operation ran.
Moves serve_rows_per_s."""

from kpcabench.metrics import idle_pct


def read(ctx):
    return idle_pct(ctx)
