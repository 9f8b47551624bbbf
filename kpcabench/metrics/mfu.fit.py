"""The whole fit's share of the card's peak: the products one fit needs
(``work.fit.ops``) times the traced fits, over the traced window at the
TF32 peak. Bounds every kernel roofline of the fit. Moves fit_device_s."""

from kpcabench.metrics import fits, mfu_pct
from kpcabench.work import fit


def read(ctx):
    return mfu_pct(ctx, fits(ctx) * fit.ops(ctx.config))
