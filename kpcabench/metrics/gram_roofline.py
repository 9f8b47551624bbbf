"""The gram op's share of its roofline in the fit: the least time the
Grams one fit needs could take (``work.gram.fit``: the pooled self-Gram,
compute-bound at the TF32 peak) over the device seconds of gram's kernels
(``kernels/gram.json``) per traced fit. Moves fit_device_s."""

from kpcabench import tracing
from kpcabench.metrics import fits
from kpcabench.work import gram, share_pct


def read(ctx):
    n = fits(ctx)
    if not n:
        return None
    ops, nbytes = gram.fit(ctx.config)
    return share_pct(n * ops, n * nbytes,
                     tracing.op_seconds(ctx.digest, "gram"))
