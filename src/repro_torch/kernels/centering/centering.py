"""Launch wrapper of the hand-written Hopper centering kernels
(``csrc/center.cu``).

Replaces the TPU kernel ``src/repro/kernels/centering/centering.py:
center_tiles``, means included: the kernels form the row, column and total
sums themselves. A block that fits in shared memory is centred in one
launch; a larger one in two (per-tile partial sums into scratch, then the
means reduced in a fixed order and the centred block written), both from
one C call. The kernels read the input through two batch strides and its
row and column strides, so a strided view is centred without a copy. The
per-call Python is the operand check, the plan (cached per shape), the
output and scratch allocations and that one call.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Optional, Tuple

import torch

from .._build import load_library
from .._util import SMS, cdiv, check_launch, launch_guard, stream_of

SMALL_BYTES = 200 * 1024    # shared memory the one-launch path may take
SMALL_BLOCK = 64 * 1024     # blocks one SM centres alone faster than two passes
SMALL_THREADS = 1024        # threads per block of the one-launch path
TILE_COLS = 128             # columns per two-pass tile (one warp's row)
TARGET_BLOCKS = 2 * SMS     # two waves
MIN_ROWS, MAX_ROWS = 8, 256


@dataclasses.dataclass(frozen=True)
class CenterPlan:
    """How one centring runs: ``small`` (one launch, the block in shared
    memory) or two passes over tiles of ``rows`` x 128 (``slabs`` row
    slabs, ``col_tiles`` column tiles per block)."""

    small: bool
    rows: int = 0
    slabs: int = 0
    col_tiles: int = 0

    def scratch_floats(self, z: int, n: int, m: int) -> int:
        """Row partials (Z, col_tiles, n), column partials (Z, slabs, m)
        and tile totals (Z, slabs, col_tiles)."""
        return z * (self.col_tiles * n + self.slabs * m
                    + self.slabs * self.col_tiles)


@functools.lru_cache(maxsize=1024)
def center_plan(z: int, n: int, m: int) -> CenterPlan:
    """The path for Z blocks of (n, m): one launch through shared memory
    when the block, its sums and means fit in SMALL_BYTES and either the
    blocks fill a wave of SMs or each is at most SMALL_BLOCK (one SM
    centres a larger lone block slower than the two passes spread over
    many); otherwise row slabs of 8 to 256 rows, as many as bring the grid
    to about two waves, but no more slabs than rows per slab (each apply
    block reduces one column partial per slab)."""
    fits = 4 * (n * m + SMALL_THREADS + 2 * n + m + 1) <= SMALL_BYTES
    if fits and (z >= SMS or 4 * n * m <= SMALL_BLOCK):
        return CenterPlan(small=True)
    col_tiles = cdiv(m, TILE_COLS)
    slabs = min(cdiv(TARGET_BLOCKS, z * col_tiles), cdiv(n, MIN_ROWS),
                math.isqrt(n))
    slabs = max(cdiv(n, MAX_ROWS), slabs)
    rows = cdiv(n, slabs)
    return CenterPlan(small=False, rows=rows, slabs=cdiv(n, rows),
                      col_tiles=col_tiles)


@functools.lru_cache(maxsize=1024)
def merge_batch_dims(shape: Tuple[int, ...], strides: Tuple[int, ...]
                     ) -> Optional[Tuple[Tuple[int, int], Tuple[int, int]]]:
    """Leading (batch) dims of a tensor as ((Z1, s1), (Z2, s2)), merging
    neighbours whose strides allow it and dropping size-1 dims; None past
    two unmergeable dims (the caller then copies)."""
    merged = []
    for size, stride in zip(shape, strides):
        if size == 1:
            continue
        if merged and merged[-1][1] == size * stride:
            merged[-1] = (merged[-1][0] * size, stride)
        else:
            merged.append((size, stride))
    if len(merged) > 2:
        return None
    while len(merged) < 2:
        merged.insert(0, (1, 0))
    return tuple(merged)


def center_tiles(k: torch.Tensor) -> torch.Tensor:
    """out[..., i, j] = k[..., i, j] - colmean[..., j] - rowmean[..., i] +
    totmean[...] of every (n, m) block of k (..., n, m), fp32 at any
    strides, on the card. Returns k's shape, contiguous fp32. Counts one
    launch per centring."""
    dev = k.device
    if dev.type != "cuda" or k.dtype != torch.float32 or k.dim() < 2:
        raise ValueError(f"k must be a float32 CUDA tensor of (..., n, m), "
                         f"got {k.dtype} {tuple(k.shape)} on {dev}")
    shape = tuple(k.shape)
    batch = merge_batch_dims(shape[:-2], k.stride()[:-2])
    if batch is None:                    # past two unmergeable batch dims
        k = k.contiguous()
        batch = merge_batch_dims(shape[:-2], k.stride()[:-2])
    (z1, s1), (z2, s2) = batch
    n, m = shape[-2:]
    sn, sm = k.stride()[-2:]
    if min(z1, z2, n, m) < 1:
        raise ValueError(f"empty centering operand {shape}")
    plan = center_plan(z1 * z2, n, m)
    out = torch.empty(shape, dtype=torch.float32, device=dev)
    scratch = None if plan.small else torch.empty(
        (plan.scratch_floats(z1 * z2, n, m),), dtype=torch.float32,
        device=dev)
    vec = (sm == 1 and m % 4 == 0 and sn % 4 == 0 and s1 % 4 == 0
           and s2 % 4 == 0 and k.data_ptr() % 16 == 0)
    lib = load_library()
    with launch_guard(dev):
        rc = lib.kpca_center(
            k.data_ptr(), 0 if scratch is None else scratch.data_ptr(),
            out.data_ptr(), z1, z2, n, m, s1, s2, sn, sm, plan.rows,
            plan.slabs, plan.col_tiles, int(vec), stream_of(dev))
    check_launch("center", rc)
    center_tiles.launches += 1
    return out


center_tiles.launches = 0

__all__ = ["CenterPlan", "center_plan", "center_tiles", "merge_batch_dims"]
