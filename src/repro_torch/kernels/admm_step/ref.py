"""Plain PyTorch version of the fused local ADMM update: what a CPU tensor
runs, and what the card-side checks hold the kernel against. Never a
fallback for a CUDA tensor."""

from __future__ import annotations

import torch


def admm_local_update_reference(v, inv_den, k, b, g, rho_slots):
    """Same contract as ``ops.admm_local_update_op`` (J-batched): v, k
    (J, N, N); inv_den (J, N, 1); b, g (J, N, S); rho_slots (J, 1, S).
    Returns (alpha (J, N, 1), b_new (J, N, S), ka = K alpha (J, N, 1))."""
    rhs = torch.sum(rho_slots * g - b, dim=2, keepdim=True)     # (J, N, 1)
    t = (v.transpose(1, 2) @ rhs) * inv_den
    alpha = v @ t
    ka = k @ alpha
    b_new = b + rho_slots * (ka - g)
    return alpha, b_new, ka


__all__ = ["admm_local_update_reference"]
