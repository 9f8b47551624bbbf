"""Public centering entry: the tensor's device picks the kernel or the plain
version.

On a CUDA tensor: the centering kernels alone, means included (one launch
for a block that fits in shared memory, two otherwise), for the whole
batch, read through the input's own strides (``center_tiles``); no
PyTorch reduction. On a CPU tensor: ``center_reference``. Matches
``repro.kernels.centering.ops.center_op`` (tests/test_torch_kernels.py).
"""

from __future__ import annotations

import torch

from .._util import on_card
from .centering import center_tiles
from .ref import center_reference


def center_op(k: torch.Tensor) -> torch.Tensor:
    """Fused K_c = K - rowmean - colmean + totalmean (paper §6.1), batched
    over any leading dims of k (..., n, m); returns k's shape, fp32."""
    if k.dim() < 2:
        raise ValueError(f"center_op takes (..., n, m), got {tuple(k.shape)}")
    if not on_card(k):
        return center_reference(k)
    return center_tiles(k if k.dtype == torch.float32
                        else k.to(torch.float32))


__all__ = ["center_op"]
