"""Launch wrapper of the hand-written Hopper gram kernels (``csrc/gram.cu``).

Replaces the TPU kernel ``src/repro/kernels/gram/gram.py:gram_tiles``. One
Gram is one C call that launches a split pass per operand (its 3xTF32
hi/lo halves at a padded row stride, and its row norms, into scratch) and
the tensor-core main kernel. The wrapper checks the operands, allocates
the output and the scratch with ``torch.empty`` and launches on PyTorch's
current stream.
"""

from __future__ import annotations

from typing import Optional

import torch

from ...core.kernels_math import KernelSpec
from .._build import load_library
from .._util import (SMS, cdiv, check_kernel_operand, check_launch,
                     launch_guard, stream_of)

KINDS = {"rbf": 0, "linear": 1, "poly": 2}
ROW_PAD = 32            # floats: one 128-byte TMA row, one K-tile
TILE_COLS = 128         # output columns per block


def padded_stride(m: int) -> int:
    """Row stride of the hi/lo scratch: m rounded up to a multiple of 32
    floats (the zero fill past m adds nothing to any product)."""
    return cdiv(m, ROW_PAD) * ROW_PAD


def tile_rows(z: int, n: int, k: int, symmetric: bool) -> int:
    """Output rows per block: 128 (two consumer warpgroups), or 64 where
    128-row tiles would leave the grid under one wave of the card's SMs. A
    symmetric Gram keeps square 128 x 128 tiles, so that a tile and its
    mirror are the same work."""
    if symmetric:
        return 128
    return 128 if z * cdiv(n, 128) * cdiv(k, TILE_COLS) >= SMS else 64


def gram_tiles(spec: KernelSpec, x: torch.Tensor, y: Optional[torch.Tensor],
               gamma: torch.Tensor) -> torch.Tensor:
    """K[z, i, j] = kfun(x[z, i], y[z, j]) on the card's tensor cores.

    x (Z, n, m) and y (Z, k, m) fp32 contiguous; ``y=None`` means y = x:
    the operand is split once and only tiles on or above the diagonal run,
    each mirrored, so K equals K^T exactly. gamma a 0-d fp32 tensor (read on
    the device, so no host sync). Returns (Z, n, k) fp32. Counts one launch
    per Gram (split passes included).
    """
    dev = x.device
    check_kernel_operand("x", x, 3, dev)
    check_kernel_operand("gamma", gamma, 0, dev)
    symmetric = y is None
    z, n, m = x.shape
    k = n
    if not symmetric:
        check_kernel_operand("y", y, 3, dev)
        k = y.shape[1]
        if y.shape != (z, k, m):
            raise ValueError(f"gram operands disagree: x {tuple(x.shape)}, "
                             f"y {tuple(y.shape)}")
    if min(z, n, k, m) < 1:
        raise ValueError(f"empty gram operands: x {tuple(x.shape)}")
    mp = padded_stride(m)
    rows = n if symmetric else n + k          # rows split: hi, lo, norm
    scratch = torch.empty((z * rows * (2 * mp + 1),), dtype=torch.float32,
                          device=dev)
    out = torch.empty((z, n, k), dtype=torch.float32, device=dev)
    lib = load_library()
    with launch_guard(dev):
        rc = lib.kpca_gram(
            x.data_ptr(), None if symmetric else y.data_ptr(),
            scratch.data_ptr(), gamma.data_ptr(), out.data_ptr(), z, n, k, m,
            mp, tile_rows(z, n, k, symmetric), KINDS[spec.kind],
            int(spec.degree), float(spec.coef), float(spec.scale),
            int(bool(spec.normalize)), stream_of(dev))
    check_launch("gram", rc)
    gram_tiles.launches += 1
    return out


gram_tiles.launches = 0

__all__ = ["KINDS", "gram_tiles", "padded_stride", "tile_rows"]
