"""Public Gram entry: the tensor's device picks the kernel or the plain
version.

On a CUDA tensor: gamma resolution and the squared norms (rbf) or
self-kernels (linear/poly) in PyTorch, then ONE launch of the gram kernel
for the whole batch. On a CPU tensor: ``gram_reference``. Matches
``repro.kernels.gram.ops.gram_op`` (tests/test_torch_kernels.py).
"""

from __future__ import annotations

from typing import Optional

import torch

from ...core.kernels_math import KernelSpec, _self_k, resolve_gamma
from .._util import on_card
from .gram import gram_tiles
from .ref import gram_reference


def gram_op(spec: KernelSpec, x: torch.Tensor,
            y: Optional[torch.Tensor] = None,
            gamma: Optional[torch.Tensor] = None) -> torch.Tensor:
    """K[..., i, j] = K(x_i, y_j) for x (n, m) / y (k, m), or a batch
    x (Z, n, m) / y (Z, k, m). ``y=None`` means y = x."""
    operands = (x,) if y is None else (x, y)
    if not on_card(*operands):
        return gram_reference(spec, x, y, gamma=gamma)
    batched = x.dim() == 3
    xb = (x if batched else x[None]).contiguous()
    yb = xb if y is None else (y if batched else y[None]).contiguous()
    sx = row_norms(spec, xb)
    sy = sx if y is None else row_norms(spec, yb)
    out = gram_tiles(spec, xb, yb, sx, sy, gamma_operand(spec, x, gamma))
    return out if batched else out[0]


def gamma_operand(spec: KernelSpec, x: torch.Tensor,
                  gamma: Optional[torch.Tensor]) -> torch.Tensor:
    """The kernels' 0-d fp32 gamma on x's device: the given bandwidth, or
    the median heuristic on x (rbf); 0 for linear/poly, which ignore it."""
    if spec.kind != "rbf":
        return torch.zeros((), dtype=torch.float32, device=x.device)
    g = resolve_gamma(spec, x) if gamma is None else gamma
    return torch.as_tensor(g, dtype=torch.float32,
                           device=x.device).reshape(()).contiguous()


def row_norms(spec: KernelSpec, x: torch.Tensor) -> torch.Tensor:
    """What the kernels' epilogue takes per row: the squared norm (rbf) or
    the self-kernel (linear/poly)."""
    if spec.kind == "rbf":
        return torch.sum(x * x, dim=-1).contiguous()
    return _self_k(spec, x).contiguous()


__all__ = ["gamma_operand", "gram_op", "row_norms"]
