"""The whole training step's share of the card's peak: the products of the
traced steps' forward and backward passes (``work/lm_<family>.py``,
counted from the configuration's widths, recomputation not counted) over
the traced window, at the peak of the dtype the products run in
(``peaks.json``) on every chip the cell uses. Bounds every kernel roofline
of the step. Moves train_tokens_per_s."""

import importlib

from kpcabench.metrics import span
from kpcabench.work import PEAKS

PEAK_OF = {"bfloat16": "bf16_flops_per_s", "float32": "tf32_flops_per_s"}


def read(ctx):
    rec = span(ctx, "train.step")
    if rec is None or not ctx.digest["window_s"]:
        return None
    cfg, traffic = ctx.config, ctx.traffic
    work = importlib.import_module(f"kpcabench.work.lm_{cfg['family']}")
    ops = rec["n"] * work.step_ops(cfg, traffic["batch"], traffic["seq"])
    peak = PEAKS[PEAK_OF[cfg["compute_dtype"]]] * ctx.chips
    return 100.0 * ops / (ctx.digest["window_s"] * peak)
