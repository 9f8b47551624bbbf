"""Launch wrapper of the hand-written Hopper gram kernel (``csrc/gram.cu``).

Replaces the TPU kernel ``src/repro/kernels/gram/gram.py:gram_tiles``. The
kernel takes a batch of row-major operands and masks its own ragged edges,
so nothing is padded here: the wrapper checks the operands, allocates the
output with ``torch.empty`` and launches on PyTorch's current stream.
"""

from __future__ import annotations

import torch

from ...core.kernels_math import KernelSpec
from .._build import load_library
from .._util import check_kernel_operand, check_launch, ptr, stream_of

KINDS = {"rbf": 0, "linear": 1, "poly": 2}


def gram_tiles(spec: KernelSpec, x: torch.Tensor, y: torch.Tensor,
               sx: torch.Tensor, sy: torch.Tensor,
               gamma: torch.Tensor) -> torch.Tensor:
    """K[z, i, j] = kfun(x[z, i], y[z, j]) on the card.

    x (Z, n, m) and y (Z, k, m) fp32; sx (Z, n) and sy (Z, k) the squared
    norms (rbf) or self-kernels (linear/poly); gamma a 0-d fp32 tensor
    (read on the device, so no host sync). ``y`` may be ``x`` itself.
    Returns (Z, n, k) fp32.
    """
    dev = x.device
    for name, t, nd in (("x", x, 3), ("y", y, 3), ("sx", sx, 2),
                        ("sy", sy, 2), ("gamma", gamma, 0)):
        check_kernel_operand(name, t, nd, dev)
    z, n, m = x.shape
    k = y.shape[1]
    if y.shape != (z, k, m) or sx.shape != (z, n) or sy.shape != (z, k):
        raise ValueError(f"gram operands disagree: x {tuple(x.shape)}, "
                         f"y {tuple(y.shape)}, sx {tuple(sx.shape)}, "
                         f"sy {tuple(sy.shape)}")
    if min(z, n, k, m) < 1:
        raise ValueError(f"empty gram operands: x {tuple(x.shape)}, "
                         f"y {tuple(y.shape)}")
    lib = load_library()
    out = torch.empty((z, n, k), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        rc = lib.kpca_gram(
            ptr(x), ptr(y), ptr(sx), ptr(sy), ptr(gamma), ptr(out),
            z, n, k, m, n * m, k * m, n, k, n * k,
            KINDS[spec.kind], int(spec.degree), float(spec.coef),
            float(spec.scale), int(bool(spec.normalize)), stream_of(dev))
    check_launch("gram", rc)
    gram_tiles.launches += 1
    return out


gram_tiles.launches = 0

__all__ = ["KINDS", "gram_tiles"]
