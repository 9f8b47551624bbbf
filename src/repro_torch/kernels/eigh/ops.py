"""Public symmetric eigensolve: the kernel where it applies, the library
elsewhere.

A matrix on the card with n <= ``eigh.MAX_N`` (fp32) goes to the Jacobi
kernel, its leading dims flattened into one batch. Everything else keeps
``torch.linalg.eigh`` as it was: CPU tensors (LAPACK, so the CPU tests see
the numbers they always saw) and, on the card, larger or non-fp32 matrices
(cuSOLVER), counted in ``eigh_op.library_calls``.
"""

from __future__ import annotations

import torch

from .eigh import MAX_N, sym_eigh


def eigh_op(k: torch.Tensor):
    """(lam (..., n) ascending, vec (..., n, n), eigenvectors as columns) of
    the symmetric k (..., n, n): ``torch.linalg.eigh``'s contract (its lower
    triangle is read)."""
    n = k.shape[-1]
    if k.device.type == "cuda":
        if k.dtype == torch.float32 and 1 <= n <= MAX_N and k.numel() > 0:
            lam, vec, _ = sym_eigh(k.reshape(-1, n, n).contiguous())
            return lam.reshape(k.shape[:-1]), vec.reshape(k.shape)
        eigh_op.library_calls += 1
    return torch.linalg.eigh(k)


eigh_op.library_calls = 0

__all__ = ["eigh_op"]
