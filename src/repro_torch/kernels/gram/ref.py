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
    leading dims of x and y. bf16 operands are widened to fp32 first, as
    the kernel widens them on load; the result is fp32."""
    x = widen(x)
    y = x if y is None else widen(y)
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


def widen(x: torch.Tensor) -> torch.Tensor:
    """An operand as the kernels read it: bf16 widened (exactly) to fp32."""
    return x.float() if x.dtype == torch.bfloat16 else x


__all__ = ["gram_reference", "widen"]
