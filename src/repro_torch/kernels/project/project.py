"""Launch wrapper of the hand-written Hopper projection kernel
(``csrc/project.cu``).

Replaces the TPU kernel ``src/repro/kernels/project/project.py:
project_tiles``. Two launches on PyTorch's current stream: the partials
kernel (grid = support chunks x 32-query tiles) writes one (B, C+1) partial
per support chunk into scratch, and the finalize kernel sums the chunks in a
fixed order and applies the centering epilogue (or returns the raw partial
sums). The chunking depends on L alone, so a query's scores do not depend
on how many other queries share its batch.
"""

from __future__ import annotations

import torch

from ...core.kernels_math import KernelSpec
from .._build import load_library
from .._util import cdiv, check_kernel_operand, check_launch, ptr, stream_of
from ..gram.gram import KINDS

SUPPORT_TILE = 32      # kPL in csrc/project.cu
MAX_CHUNKS = 64        # support chunks aimed for; tiles per chunk follow
CP1_MAX = 32           # kCp1Max in csrc/project.cu: C + 1 <= 32


def support_chunking(n_support: int) -> tuple:
    """(tiles_per_chunk, n_chunks) for L support rows — a function of L
    only, which keeps each query's summation order batch-independent."""
    n_tiles = cdiv(n_support, SUPPORT_TILE)
    per = max(1, cdiv(n_tiles, MAX_CHUNKS))
    return per, cdiv(n_tiles, per)


def project_tiles(spec: KernelSpec, xq: torch.Tensor, xs: torch.Tensor,
                  a_ext: torch.Tensor, ss: torch.Tensor,
                  gamma: torch.Tensor, cvec=None, bvec=None,
                  inv_l: float = 0.0) -> torch.Tensor:
    """Fused projection on the card.

    xq (B, M) queries; xs (L, M) support; a_ext (L, C+1) coefficients whose
    last column is the ones/indicator column; ss (L,) the support rows'
    squared norms (rbf) or self-kernels (the kernel computes the queries'
    itself, in a batch-independent order); gamma 0-d. With ``cvec``/``bvec``
    (C,) the result is (B, C) scores ``P[:, :C] + P[:, C] * inv_l * cvec +
    bvec``; without them it is the raw (B, C+1) partial ``K @ a_ext``.
    """
    dev = xq.device
    for name, t, nd in (("xq", xq, 2), ("xs", xs, 2), ("a_ext", a_ext, 2),
                        ("ss", ss, 1), ("gamma", gamma, 0)):
        check_kernel_operand(name, t, nd, dev)
    b, m = xq.shape
    l, cp1 = a_ext.shape
    if xs.shape != (l, m) or ss.shape != (l,):
        raise ValueError(f"project operands disagree: xq {tuple(xq.shape)}, "
                         f"xs {tuple(xs.shape)}, a_ext {tuple(a_ext.shape)}")
    if min(b, l, m) < 1:
        raise ValueError(f"empty project operands: xq {tuple(xq.shape)}, "
                         f"xs {tuple(xs.shape)}")
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
    per, n_chunks = support_chunking(l)
    lib = load_library()
    scratch = torch.empty((n_chunks, b, cp1), dtype=torch.float32, device=dev)
    out = torch.empty((b, cp1 - 1 if with_epilogue else cp1),
                      dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        stream = stream_of(dev)
        rc = lib.kpca_project_partials(
            ptr(xq), ptr(xs), ptr(a_ext), ptr(ss), ptr(gamma),
            ptr(scratch), b, l, m, cp1, per, KINDS[spec.kind],
            int(spec.degree), float(spec.coef), float(spec.scale),
            int(bool(spec.normalize)), stream)
        check_launch("project partials", rc)
        rc = lib.kpca_project_finalize(
            ptr(scratch), ptr(cvec), ptr(bvec), ptr(out), n_chunks, b, cp1,
            int(with_epilogue), float(inv_l), stream)
    check_launch("project finalize", rc)
    project_tiles.launches += 1
    return out


project_tiles.launches = 0

__all__ = ["CP1_MAX", "project_tiles", "support_chunking"]
