"""Launch wrapper of the hand-written Hopper centering kernel
(``csrc/center.cu``).

Replaces the TPU kernel ``src/repro/kernels/centering/centering.py:
center_tiles``. The kernel reads its input through four strides, so a
strided view (two batch dims, rows, columns) is centred in place of a copy;
the wrapper checks the operands, allocates the contiguous output with
``torch.empty`` and launches on PyTorch's current stream.
"""

from __future__ import annotations

import torch

from .._build import load_library
from .._util import check_kernel_operand, check_launch, ptr, stream_of


def center_tiles(k: torch.Tensor, row_mean: torch.Tensor,
                 col_mean: torch.Tensor,
                 tot_mean: torch.Tensor) -> torch.Tensor:
    """out[a, b, i, j] = k[a, b, i, j] - row_mean[a, b, i] - col_mean[a, b, j]
    + tot_mean[a, b] on the card.

    k (Z1, Z2, n, m) fp32 at any strides; row_mean (Z1, Z2, n), col_mean
    (Z1, Z2, m) and tot_mean (Z1, Z2) contiguous fp32. Returns (Z1, Z2, n, m)
    contiguous fp32.
    """
    dev = k.device
    if dev.type != "cuda" or k.dtype != torch.float32 or k.dim() != 4:
        raise ValueError(f"k must be a 4-d float32 CUDA tensor, got "
                         f"{k.dtype} {tuple(k.shape)} on {dev}")
    z1, z2, n, m = k.shape
    for name, t, shape in (("row_mean", row_mean, (z1, z2, n)),
                           ("col_mean", col_mean, (z1, z2, m)),
                           ("tot_mean", tot_mean, (z1, z2))):
        check_kernel_operand(name, t, len(shape), dev)
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} must be {shape}, got {tuple(t.shape)}")
    if min(z1, z2, n, m) < 1:
        raise ValueError(f"empty centering operand {tuple(k.shape)}")
    lib = load_library()
    out = torch.empty((z1, z2, n, m), dtype=torch.float32, device=dev)
    s1, s2, sn, sm = k.stride()
    with torch.cuda.device(dev):
        rc = lib.kpca_center(ptr(k), ptr(row_mean), ptr(col_mean),
                             ptr(tot_mean), ptr(out), z1, z2, n, m,
                             s1, s2, sn, sm, stream_of(dev))
    check_launch("center", rc)
    center_tiles.launches += 1
    return out


center_tiles.launches = 0

__all__ = ["center_tiles"]
