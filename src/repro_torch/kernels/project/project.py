"""Launch wrapper of the hand-written Hopper projection kernel
(``csrc/project.cu``).

Replaces the TPU kernel ``src/repro/kernels/project/project.py:
project_tiles``. One C call, three launches on PyTorch's current stream: a
split pass shifts the queries and writes their 3xTF32 halves and norms; the
tensor-core partials kernel (``wgmma``; grid = 64-row support tiles x
feature slices, one thread-block cluster per tile, x query groups) writes
one (B, C+1) partial per support tile into scratch; the finalize kernel
sums the tiles in a fixed order and applies the centering epilogue (or
returns the raw partial sums). The support set's halves and norms are
formed once per model by ``projector`` (``prepare_support``, by the same
split pass; for rbf, shifted by the support's mean row). The tiling and the
feature slices depend on L alone, so a query's scores do not depend on how
many other queries share its batch.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from ...core.kernels_math import KernelSpec
from .._build import load_library
from .._util import (SMS, cdiv, check_kernel_operand, check_launch, on_card,
                     ptr, stream_of)
from ..gram.gram import KINDS, padded_stride
from ..gram.ops import row_norms

SUPPORT_TILE = 64      # kRows in csrc/project.cu: wgmma's M
MAX_SLICES = 8         # feature slices per support tile: a portable cluster
CP1_MAX = 32           # kCp1Max in csrc/project.cu: C + 1 <= 32


def support_chunking(n_support: int) -> tuple:
    """(support tiles, feature slices) for L support rows: 64-row tiles, and
    the largest of 1, 2, 4, 8 slices that keeps tiles x slices within half
    a wave of the card's SMs (at L2000, 2 slices ran B >= 64 faster than a
    full wave's 4 and B8 about as fast) — a function of L only, which keeps
    each query's summation order batch-independent. (The wave test is an
    exact-text target of scripts/project_ablate.py.)"""
    tiles = cdiv(n_support, SUPPORT_TILE)
    slices = 1
    while slices < MAX_SLICES and tiles * slices * 2 <= SMS // 2:
        slices *= 2
    return tiles, slices


class Support(NamedTuple):
    """A support set as the kernel reads it, formed once per model by
    ``prepare_support``: the TF32 halves of its rows less ``shift`` at a
    padded row stride, the shift ((M,), or None for none), and ``ss``, the
    squared norms (rbf) or self-kernels of those shifted rows."""

    hi: torch.Tensor
    lo: torch.Tensor
    shift: Optional[torch.Tensor]
    ss: torch.Tensor


def prepare_support(spec: KernelSpec, xs: torch.Tensor) -> Support:
    """The per-model half of the kernel's operands, for the (L, M) support
    rows xs. For rbf the rows are first shifted by the support's mean row,
    and the kernel shifts each query by it too: distances do not change,
    but the dot products and norms whose difference forms them shrink, and
    with them the fp32 rounding that the difference amplifies. On a CUDA
    tensor the split pass that splits the queries per call forms the halves
    and norms (one launch); on a CPU tensor its plain version does
    (``split_tf32``, ``row_norms``)."""
    shift = xs.mean(dim=0) if spec.kind == "rbf" else None
    if not on_card(xs):
        rows = xs if shift is None else xs - shift
        return Support(*split_tf32(rows), shift, row_norms(spec, rows))
    dev = xs.device
    check_kernel_operand("xs", xs, 2, dev)
    l, m = xs.shape
    if min(l, m) < 1:
        raise ValueError(f"empty project support: xs {tuple(xs.shape)}")
    mp = padded_stride(m)
    hi, lo = (torch.empty((l, mp), dtype=torch.float32, device=dev)
              for _ in range(2))
    ss = torch.empty((l,), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        rc = load_library().kpca_project_support(
            ptr(xs), ptr(shift), ptr(hi), ptr(lo), ptr(ss), l, m, mp,
            KINDS[spec.kind], int(spec.degree), float(spec.coef),
            float(spec.scale), int(bool(spec.normalize)), stream_of(dev))
    check_launch("project support split", rc)
    return Support(hi, lo, shift, ss)


def split_tf32(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The split pass's plain version, for a CPU tensor: (hi, lo) of a
    (L, M) fp32 operand for the 3xTF32 products: hi =
    rna(x), lo = rna(x - hi), each rounded to TF32 to nearest with ties away
    from zero (what ``cvt.rna.tf32.f32`` does, here by bit masking), at a
    row stride padded to a multiple of 32 floats with zeros."""
    l, m = x.shape
    mp = padded_stride(m)
    xp = torch.zeros((l, mp), dtype=torch.float32, device=x.device)
    xp[:, :m] = x
    hi = _tf32_rna(xp)
    return hi, _tf32_rna(xp - hi)


def _tf32_rna(t: torch.Tensor) -> torch.Tensor:
    bits = t.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def project_tiles(spec: KernelSpec, xq: torch.Tensor, support: Support,
                  a_ext: torch.Tensor, gamma: torch.Tensor, cvec=None,
                  bvec=None, inv_l: float = 0.0) -> torch.Tensor:
    """Fused projection on the card.

    xq (B, M) queries; ``support`` the (L, M) support set as the kernel
    reads it (``prepare_support``); a_ext (L, C+1) coefficients whose last
    column is the ones/indicator column; gamma 0-d. The kernel shifts and
    splits the queries itself and sums their norms in a batch-independent
    order. With ``cvec``/``bvec`` (C,) the result is (B, C) scores
    ``P[:, :C] + P[:, C] * inv_l * cvec + bvec``; without them it is the raw
    (B, C+1) partial ``K @ a_ext``.
    """
    dev = xq.device
    for name, t, nd in (("xq", xq, 2), ("support.hi", support.hi, 2),
                        ("support.lo", support.lo, 2),
                        ("support.ss", support.ss, 1), ("a_ext", a_ext, 2),
                        ("gamma", gamma, 0)):
        check_kernel_operand(name, t, nd, dev)
    b, m = xq.shape
    l, mp = support.hi.shape
    cp1 = a_ext.shape[1]
    if support.lo.shape != (l, mp) or support.ss.shape != (l,) or \
            a_ext.shape[0] != l or mp != padded_stride(m):
        raise ValueError(f"project operands disagree: xq {tuple(xq.shape)}, "
                         f"support {tuple(support.hi.shape)}, a_ext "
                         f"{tuple(a_ext.shape)}")
    if support.shift is not None:
        check_kernel_operand("support.shift", support.shift, 1, dev)
        if support.shift.shape != (m,):
            raise ValueError(f"support.shift must be ({m},), got "
                             f"{tuple(support.shift.shape)}")
    if min(b, l, m) < 1:
        raise ValueError(f"empty project operands: xq {tuple(xq.shape)}, "
                         f"support {tuple(support.hi.shape)}")
    if cp1 > CP1_MAX:
        raise ValueError(f"the project kernel takes at most {CP1_MAX - 1} "
                         f"components, got {cp1 - 1}")
    with_epilogue = cvec is not None
    if with_epilogue:
        if cp1 < 2:
            raise ValueError("a_ext needs the ones column after C >= 1 "
                             "coefficient columns")
        for name, t in (("cvec", cvec), ("bvec", bvec)):
            check_kernel_operand(name, t, 1, dev)
            if t.shape != (cp1 - 1,):
                raise ValueError(f"{name} must be ({cp1 - 1},), got "
                                 f"{tuple(t.shape)}")
    tiles, slices = support_chunking(l)
    lib = load_library()
    # the queries' TF32 halves and norms, then the support tiles' partials
    scratch = torch.empty((b * (2 * mp + 1) + tiles * b * cp1,),
                          dtype=torch.float32, device=dev)
    out = torch.empty((b, cp1 - 1 if with_epilogue else cp1),
                      dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        rc = lib.kpca_project(
            ptr(xq), ptr(support.hi), ptr(support.lo), ptr(support.shift),
            ptr(a_ext), ptr(support.ss), ptr(gamma),
            ptr(scratch), ptr(cvec), ptr(bvec), ptr(out), b, l, m, mp, cp1,
            slices, int(with_epilogue), float(inv_l), KINDS[spec.kind],
            int(spec.degree), float(spec.coef), float(spec.scale),
            int(bool(spec.normalize)), stream_of(dev))
    check_launch("project", rc)
    project_tiles.launches += 1
    return out


project_tiles.launches = 0

__all__ = ["CP1_MAX", "Support", "prepare_support", "project_tiles",
           "split_tf32", "support_chunking"]
