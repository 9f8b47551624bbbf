"""Plain PyTorch version of the centering kernel: what a CPU tensor runs,
and what the card-side checks hold the kernel against. Never a fallback for
a CUDA tensor."""

from __future__ import annotations

import torch


def center_reference(k: torch.Tensor) -> torch.Tensor:
    """Center a Gram block per the paper's §6.1 formula, batched over any
    leading dims:

    K_c = K - 1_m K / m - K 1_n / n + 1_m K 1_n / (mn), for K in R^{m x n}.

    A bf16 block is widened to fp32 first, as ``center_op`` widens it
    before its launch; the result is fp32.
    """
    if k.dtype == torch.bfloat16:
        k = k.float()
    col_mean = torch.mean(k, dim=-2, keepdim=True)
    row_mean = torch.mean(k, dim=-1, keepdim=True)
    tot_mean = torch.mean(k, dim=(-2, -1), keepdim=True)
    return k - col_mean - row_mean + tot_mean


__all__ = ["center_reference"]
