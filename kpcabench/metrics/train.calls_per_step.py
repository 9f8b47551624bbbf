"""Device operations (kernels, copies, memsets) a training step issues:
those that start inside the ``train.step`` span, over the traced steps.
Moves train_tokens_per_s (a host-bound step pays for each call)."""

from kpcabench.metrics import span


def read(ctx):
    rec = span(ctx, "train.step")
    return None if rec is None else rec["calls"] / rec["n"]
