"""NCCL kernels' share of rank 0's device busy time over the traced ring
fits. Moves ring_fit_s."""

from kpcabench.metrics import ops_share_pct


def read(ctx):
    return ops_share_pct(ctx, lambda name: "nccl" in name.lower())
