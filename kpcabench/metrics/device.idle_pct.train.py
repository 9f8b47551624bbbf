"""Share of the traced training window (its steps and the probe the loop's
hook runs among them) in which no device operation ran. Moves
train_tokens_per_s."""

from kpcabench.metrics import idle_pct


def read(ctx):
    return idle_pct(ctx)
