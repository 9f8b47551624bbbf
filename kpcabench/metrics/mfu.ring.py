"""The ring fit's share of the peak of every card it uses: the products
one fit needs (``work.fit.ops``) times the traced fits, over rank 0's
traced window at the TF32 peak of each chip. Moves ring_fit_s."""

from kpcabench.metrics import fits, mfu_pct
from kpcabench.work import fit


def read(ctx):
    return mfu_pct(ctx, fits(ctx) * fit.ops(ctx.config))
