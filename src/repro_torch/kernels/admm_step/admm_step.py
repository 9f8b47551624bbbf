"""Launch wrapper of the hand-written Hopper fused ADMM local update
(``csrc/admm_step.cu``).

Replaces the TPU kernel ``src/repro/kernels/admm_step/admm_step.py:
admm_local_update``: one block per node, one launch for all J nodes on
PyTorch's current stream. Up to ``STAGED_MAX_N`` a block first copies its
node's V and K into shared memory (cp.async) and forms rhs while they land;
past it the block reads them from device memory. The wrapper checks the
operands, allocates the outputs with ``torch.empty`` and launches; b and g
are read through their strides.
"""

from __future__ import annotations

import torch

from .._build import load_library
from .._util import check_kernel_operand, check_launch, ptr, stream_of

MAX_N = 4096          # kMaxN in csrc/admm_step.cu: 3N floats of shared memory
STAGED_MAX_N = 168    # kStagedMaxN: V and K (2N^2 floats) fit beside them


def admm_local_update(v: torch.Tensor, inv_den: torch.Tensor,
                      k: torch.Tensor, b: torch.Tensor, g: torch.Tensor,
                      rho_slots: torch.Tensor):
    """Fused eq. 12-13 on the card.

    v, k (J, N, N), inv_den (J, N, 1) and rho_slots (J, 1, S) contiguous
    fp32; b, g (J, N, S) fp32 at any strides. Returns (alpha (J, N, 1),
    b_new (J, N, S), ka = K alpha (J, N, 1)), contiguous.
    """
    dev = v.device
    for name, t in (("v", v), ("inv_den", inv_den), ("k", k),
                    ("rho_slots", rho_slots)):
        check_kernel_operand(name, t, 3, dev)
    for name, t in (("b", b), ("g", g)):
        if t.device != dev or t.dtype != torch.float32 or t.dim() != 3:
            raise ValueError(f"{name} must be a 3-d float32 tensor on {dev}, "
                             f"got {t.dtype} {tuple(t.shape)} on {t.device}")
    j, n, _ = v.shape
    s = b.shape[2]
    if (k.shape != (j, n, n) or v.shape != (j, n, n)
            or inv_den.shape != (j, n, 1) or b.shape != (j, n, s)
            or g.shape != (j, n, s) or rho_slots.shape != (j, 1, s)):
        raise ValueError(
            f"admm_step operands disagree: v {tuple(v.shape)}, inv_den "
            f"{tuple(inv_den.shape)}, k {tuple(k.shape)}, b {tuple(b.shape)}, "
            f"g {tuple(g.shape)}, rho_slots {tuple(rho_slots.shape)}")
    if min(j, n, s) < 1:
        raise ValueError(f"empty admm_step operands: b {tuple(b.shape)}")
    if n > MAX_N:
        raise ValueError(f"the admm_step kernel holds 3N floats per node in "
                         f"shared memory and takes N <= {MAX_N}, got N={n}")
    lib = load_library()
    alpha = torch.empty((j, n, 1), dtype=torch.float32, device=dev)
    ka = torch.empty((j, n, 1), dtype=torch.float32, device=dev)
    b_new = torch.empty((j, n, s), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        rc = lib.kpca_admm_step(
            ptr(v), ptr(inv_den), ptr(k), ptr(b), ptr(g), ptr(rho_slots),
            ptr(alpha), ptr(b_new), ptr(ka), j, n, s, *b.stride(),
            *g.stride(), stream_of(dev))
    check_launch("admm_step", rc)
    admm_local_update.launches += 1
    return alpha, b_new, ka


admm_local_update.launches = 0

__all__ = ["MAX_N", "STAGED_MAX_N", "admm_local_update"]
