"""Milliseconds the DKPCA activation probe takes when the loop's hook runs
it (the ``probe`` span, synchronised), mean per probe of the traced
window; host clock. Moves train_tokens_per_s."""

from kpcabench.metrics import span


def read(ctx):
    rec = span(ctx, "probe")
    return None if rec is None else 1e3 * rec["host_s"] / rec["n"]
