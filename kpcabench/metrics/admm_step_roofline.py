"""The fused ADMM update's share of its roofline: the least time one fit's
calls could take (``work.admm_step.fit``, bound by the bytes of V and K
read once a call) over the device seconds of ``admm_step_kernel`` per
traced fit. Moves fit_device_s."""

from kpcabench import tracing
from kpcabench.metrics import fits
from kpcabench.work import admm_step, share_pct


def read(ctx):
    n = fits(ctx)
    if not n:
        return None
    ops, nbytes = admm_step.fit(ctx.config)
    return share_pct(n * ops, n * nbytes,
                     tracing.op_seconds(ctx.digest, "admm_step"))
