"""Public centering entry: the tensor's device picks the kernel or the plain
version.

On a CUDA tensor: the row, column and total means in PyTorch (as the JAX
wrapper forms them), then ONE launch of the centering kernel for the whole
batch, read through the input's own strides. On a CPU tensor:
``center_reference``. Matches ``repro.kernels.centering.ops.center_op``
(tests/test_torch_kernels.py).
"""

from __future__ import annotations

import math

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
    kf = k.to(torch.float32)
    view = _two_batch_dims(kf)
    out = center_tiles(view, torch.mean(view, dim=-1).contiguous(),
                       torch.mean(view, dim=-2).contiguous(),
                       torch.mean(view, dim=(-2, -1)).contiguous())
    return out.reshape(kf.shape)


def _two_batch_dims(t: torch.Tensor) -> torch.Tensor:
    """t (..., n, m) as a (Z1, Z2, n, m) view with t's own strides: leading
    dims merge where their strides allow it. Past two unmergeable batch
    dims, the view is of a contiguous copy."""
    merged = []
    for size, stride in zip(t.shape[:-2], t.stride()[:-2]):
        if size == 1:
            continue
        if merged and merged[-1][1] == size * stride:
            merged[-1] = (merged[-1][0] * size, stride)
        else:
            merged.append((size, stride))
    if len(merged) > 2:
        t = t.contiguous()
        merged = [(math.prod(t.shape[:-2]), t.stride(-3))]
    while len(merged) < 2:
        merged.insert(0, (1, 0))
    (z1, s1), (z2, s2) = merged
    return t.as_strided((z1, z2) + tuple(t.shape[-2:]),
                        (s1, s2) + tuple(t.stride()[-2:]), t.storage_offset())


__all__ = ["center_op"]
