"""Launch wrapper of the hand-written Hopper gram kernels (``csrc/gram.cu``).

Replaces the TPU kernel ``src/repro/kernels/gram/gram.py:gram_tiles``. One
Gram is one C call that launches a split pass per operand (its 3xTF32
hi/lo halves at a padded row stride, and its row norms, into scratch) and
the tensor-core main kernel: one block per output tile, or, where
``split_count`` says so (short rows, long features), a thread-block
cluster per Gram whose CTAs split the feature axis. The wrapper checks the
operands, allocates the output and the scratch with ``torch.empty`` and
launches on PyTorch's current stream.
"""

from __future__ import annotations

import functools
from typing import Optional

import torch

from ...core.kernels_math import KernelSpec
from .. import autotune
from .._build import load_library
from .._util import (SMS, cdiv, check_kernel_operand, check_launch,
                     launch_guard, stream_of)

KINDS = {"rbf": 0, "linear": 1, "poly": 2}
OPERAND_DTYPES = (torch.float32, torch.bfloat16)
ROW_PAD = 32            # floats: one 128-byte TMA row, one K-tile
TILE_COLS = 128         # output columns per block
SPLIT_TILE = 128        # rows and columns the short-row route's one tile holds
SPLIT_MIN_KTILES = 32   # K-tiles of ROW_PAD features before the axis splits
CLUSTER = 8             # CTAs a cluster: the portable maximum (PERF.md)


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


def split_count(n: int, k: int, m: int) -> int:
    """CTAs of the thread-block cluster that splits one Gram's feature axis
    (the short-row route), or 1 for one block per output tile. Split where
    the whole n x k output is one tile (n, k <= 128) and there are at least
    32 K-tiles (m > 992): there one block would walk every K-tile in series
    while the card's other SMs idle. A function of (n, k, m) alone, never of
    the batch, the card or the tile table: the split changes the summation
    order, so element z of a batch gets the bits of the same operands alone
    (the probe's ring on four cards is bitwise its world-1 ring), and no
    tuning knob can change a result."""
    if (n <= SPLIT_TILE and k <= SPLIT_TILE
            and cdiv(m, ROW_PAD) >= SPLIT_MIN_KTILES):
        return CLUSTER
    return 1


@autotune.register_dispatch_cache
@functools.lru_cache(maxsize=1024)
def dispatch_rows(z: int, n: int, k: int, m: int, symmetric: bool,
                  dtype: torch.dtype, device: torch.device) -> int:
    """Output rows per block of a launch on ``device``: the tile table's
    entry for this shape's bucket on this card where there is one, else
    ``tile_rows`` (resolved once per shape; ``set_default_table`` clears
    it)."""
    shape = (z, n, m) if symmetric else (z, n, k, m)
    knobs = autotune.dispatch_knobs("gram", shape, dtype, device)
    return knobs["rows"] if knobs else tile_rows(z, n, k, symmetric)


def gram_tiles(spec: KernelSpec, x: torch.Tensor, y: Optional[torch.Tensor],
               gamma: torch.Tensor, rows: Optional[int] = None
               ) -> torch.Tensor:
    """K[z, i, j] = kfun(x[z, i], y[z, j]) on the card's tensor cores.

    x (Z, n, m) and y (Z, k, m) contiguous, each fp32 or bf16 (a bf16
    operand is widened on load by the split pass's bf16 instance, and gives
    the bits of its widened fp32 copy); ``y=None`` means y = x: the operand
    is split once and only tiles on or above the diagonal run, each
    mirrored, so K equals K^T exactly. gamma a 0-d fp32 tensor (read on the
    device, so no host sync). ``rows``: output rows per block, 64 or 128
    (None: ``dispatch_rows``, the tile table's or the derived choice); the
    short-row route (``split_count(n, k, m) > 1``) sizes its own tile and
    ignores it. Returns (Z, n, k) fp32. Counts one launch per Gram (split
    passes included), and its bf16 launches apart.
    """
    dev = x.device
    check_kernel_operand("x", x, 3, dev, OPERAND_DTYPES)
    check_kernel_operand("gamma", gamma, 0, dev)
    symmetric = y is None
    z, n, m = x.shape
    k = n
    if not symmetric:
        check_kernel_operand("y", y, 3, dev, OPERAND_DTYPES)
        k = y.shape[1]
        if y.shape != (z, k, m):
            raise ValueError(f"gram operands disagree: x {tuple(x.shape)}, "
                             f"y {tuple(y.shape)}")
    if min(z, n, k, m) < 1:
        raise ValueError(f"empty gram operands: x {tuple(x.shape)}")
    if rows is None:
        rows = dispatch_rows(z, n, k, m, symmetric, x.dtype, dev)
    x_bf16 = x.dtype == torch.bfloat16
    y_bf16 = not symmetric and y.dtype == torch.bfloat16
    mp = padded_stride(m)
    split = n if symmetric else n + k         # rows split: hi, lo, norm
    scratch = torch.empty((z * split * (2 * mp + 1),), dtype=torch.float32,
                          device=dev)
    out = torch.empty((z, n, k), dtype=torch.float32, device=dev)
    lib = load_library()
    with launch_guard(dev):
        rc = lib.kpca_gram(
            x.data_ptr(), int(x_bf16), None if symmetric else y.data_ptr(),
            int(y_bf16), scratch.data_ptr(), gamma.data_ptr(),
            out.data_ptr(), z, n, k, m,
            mp, rows, split_count(n, k, m), KINDS[spec.kind],
            int(spec.degree), float(spec.coef), float(spec.scale),
            int(bool(spec.normalize)), stream_of(dev))
    check_launch("gram", rc)
    gram_tiles.launches += 1
    gram_tiles.bf16_launches += x_bf16 or y_bf16
    return out


gram_tiles.launches = 0
gram_tiles.bf16_launches = 0       # of launches: a bf16 operand

__all__ = ["KINDS", "dispatch_rows", "gram_tiles", "padded_stride",
           "split_count", "tile_rows"]
