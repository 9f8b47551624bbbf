"""Milliseconds a training step takes in the traced window (the
``train.step`` span: ``step_fn`` until its loss reaches the host,
synchronised), mean per step; host clock. Moves train_tokens_per_s."""

from kpcabench.metrics import span


def read(ctx):
    rec = span(ctx, "train.step")
    return None if rec is None else 1e3 * rec["host_s"] / rec["n"]
