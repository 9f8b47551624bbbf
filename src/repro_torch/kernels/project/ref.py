"""Plain PyTorch versions of the projection kernel: what a CPU tensor runs,
and what the card-side checks hold the kernel against. Never a fallback for
a CUDA tensor."""

from __future__ import annotations

from typing import Optional

import torch

from ...core.kernels_math import KernelSpec
from ..gram.ref import gram_reference


def project_reference(spec: KernelSpec, x_query: torch.Tensor,
                      x_support: torch.Tensor, coefs: torch.Tensor,
                      row_mean_coef: Optional[torch.Tensor] = None,
                      bias: Optional[torch.Tensor] = None,
                      gamma: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(B, M) x (L, M) x (L, C) -> (B, C):
    scores = K @ coefs + rowmean(K) * row_mean_coef + bias. bf16 queries
    are widened to fp32 first (by ``gram_reference``), as the kernel widens
    them on load."""
    k = gram_reference(spec, x_query, x_support, gamma=gamma)
    out = k @ coefs
    if row_mean_coef is not None:
        out = out + torch.mean(k, dim=1, keepdim=True) * row_mean_coef[None]
    if bias is not None:
        out = out + bias[None, :]
    return out


def project_partial_reference(spec: KernelSpec, x_query: torch.Tensor,
                              x_support: torch.Tensor,
                              coefs_ext: torch.Tensor,
                              gamma: Optional[torch.Tensor] = None
                              ) -> torch.Tensor:
    """Raw (B, C+1) partials K(x_query, x_support) @ coefs_ext; the last
    column of ``coefs_ext`` is the valid-row indicator. bf16 queries are
    widened first."""
    return gram_reference(spec, x_query, x_support,
                          gamma=gamma) @ coefs_ext


__all__ = ["project_partial_reference", "project_reference"]
