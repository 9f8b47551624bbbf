"""Launch wrapper of the hand-written batched Jacobi eigensolve
(``csrc/eigh.cu``).

Replaces no TPU kernel (the JAX package calls ``jnp.linalg.eigh``): it takes
cuSOLVER's place for the fit's node Grams. One block per matrix, one launch
for the whole batch on PyTorch's current stream, A and V in shared memory for
the whole solve. The wrapper checks the operand, allocates the outputs with
``torch.empty`` and launches; it never synchronises, so the sweeps each
matrix took stay on the card until a caller reads them.
"""

from __future__ import annotations

import torch

from .._build import load_library
from .._util import check_kernel_operand, check_launch, ptr, stream_of

MAX_N = 168        # kMaxN in csrc/eigh.cu: A and V, 2 n (n + 1) floats
MAX_SWEEPS = 32    # kMaxSweeps


def sym_eigh(k: torch.Tensor):
    """Eigendecomposition of a batch of symmetric matrices on the card.

    k (B, n, n) contiguous fp32, 1 <= n <= ``MAX_N``; only its lower
    triangle is read. Returns (lam (B, n) ascending, vec (B, n, n) with the
    eigenvectors as columns, sweeps (B,) int32: the sweeps each matrix took,
    the last one rotating nothing unless it is ``MAX_SWEEPS``). A matrix
    holding NaN or inf gets NaN eigenpairs and 0 sweeps.
    """
    dev = k.device
    check_kernel_operand("k", k, 3, dev)
    b, n, n2 = k.shape
    if n != n2:
        raise ValueError(f"eigh takes square matrices, got {tuple(k.shape)}")
    if b < 1 or n < 1:
        raise ValueError(f"empty eigh operand: {tuple(k.shape)}")
    if n > MAX_N:
        raise ValueError(f"the eigh kernel holds A and V in shared memory and "
                         f"takes n <= {MAX_N}, got n={n}")
    lib = load_library()
    lam = torch.empty((b, n), dtype=torch.float32, device=dev)
    vec = torch.empty((b, n, n), dtype=torch.float32, device=dev)
    sweeps = torch.empty((b,), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        rc = lib.kpca_sym_eigh(ptr(k), ptr(lam), ptr(vec), ptr(sweeps), b, n,
                               stream_of(dev))
    check_launch("eigh", rc)
    sym_eigh.launches += 1
    return lam, vec, sweeps


sym_eigh.launches = 0

__all__ = ["MAX_N", "MAX_SWEEPS", "sym_eigh"]
