"""Public Gram entry: the tensor's device picks the kernel or the plain
version.

On a CUDA tensor: gamma resolution, then the gram kernels for the whole
batch (the split pass forms the row norms; ``y=None`` takes the symmetric
path). On a CPU tensor: ``gram_reference``. Matches
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
    x (Z, n, m) / y (Z, k, m). ``y=None`` (or y is x) means y = x."""
    operands = (x,) if y is None else (x, y)
    if not on_card(*operands):
        return gram_reference(spec, x, y, gamma=gamma)
    batched = x.dim() == 3
    xb = (x if batched else x[None]).contiguous()
    yb = None if y is None or y is x else (y if batched
                                          else y[None]).contiguous()
    out = gram_tiles(spec, xb, yb, gamma_operand(spec, x, gamma))
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
    """What the project kernel's epilogue takes per support row: the
    squared norm (rbf) or the self-kernel (linear/poly)."""
    if spec.kind == "rbf":
        return torch.sum(x * x, dim=-1).contiguous()
    return _self_k(spec, x).contiguous()


__all__ = ["gamma_operand", "gram_op", "row_norms"]
