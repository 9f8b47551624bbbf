"""Public fused-ADMM-update entry: the tensors' device picks the kernel or
the plain version.

Takes the JAX package's shapes (``repro.kernels.admm_step.ops.
admm_local_update_op``). The TPU's N <= 1024 VMEM guard has no counterpart:
the kernel states its own limit (``admm_step.MAX_N``, set by shared memory)
and raises past it; nothing falls back to the plain version.
"""

from __future__ import annotations

import torch

from .._util import on_card
from .admm_step import admm_local_update
from .ref import admm_local_update_reference


def admm_local_update_op(v: torch.Tensor, inv_den: torch.Tensor,
                         k: torch.Tensor, b: torch.Tensor, g: torch.Tensor,
                         rho_slots: torch.Tensor):
    """Fused eq. 12-13: v, k (J, N, N); inv_den (J, N, 1); b, g (J, N, S);
    rho_slots (J, 1, S). Returns (alpha (J, N, 1), b_new (J, N, S),
    ka = K alpha (J, N, 1))."""
    if not on_card(v, inv_den, k, b, g, rho_slots):
        return admm_local_update_reference(v, inv_den, k, b, g, rho_slots)
    return admm_local_update(v.contiguous(), inv_den.contiguous(),
                             k.contiguous(), b, g, rho_slots.contiguous())


__all__ = ["admm_local_update_op"]
