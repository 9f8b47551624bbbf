"""Plain PyTorch version of the gram kernel: what a CPU tensor runs, and
what the card-side checks hold the kernel against. Never a fallback for a
CUDA tensor."""

from __future__ import annotations

from typing import Optional

import torch

from ...core.kernels_math import (KernelSpec, _self_k, pairwise_sqdist,
                                  resolve_gamma)


def gram_reference(spec: KernelSpec, x: torch.Tensor,
                   y: Optional[torch.Tensor] = None,
                   gamma: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Dense Gram matrix K[..., i, j] = K(x_i, y_j), batched over any
    leading dims of x and y."""
    if y is None:
        y = x
    if spec.kind == "rbf":
        g = resolve_gamma(spec, x) if gamma is None else gamma
        return torch.exp(-g * pairwise_sqdist(x, y))
    k = (x @ y.transpose(-1, -2)) * spec.scale
    if spec.kind == "poly":
        k = (k + spec.coef) ** spec.degree
    if spec.normalize:
        dx = _self_k(spec, x)
        dy = _self_k(spec, y)
        k = k / torch.sqrt(torch.clamp(dx[..., :, None] * dy[..., None, :],
                                       min=1e-12))
    return k


__all__ = ["gram_reference"]
