"""Public projection entries: the tensor's device picks the kernel or the
plain version.

  * ``project_op`` — single-device serving: fused scores with the centering
    epilogue (the ones column of A gathers the kernel row-sum);
    ``projector`` does its per-model part once, for a server.
  * ``project_partial_op`` — the same kernel with c = b = 0 and the caller's
    indicator column: raw (B, C+1) partials for sharded serving;
    ``partial_projector`` does its per-shard part once (what the sharded
    router's placement cache holds per shard and model version).

Query batches may be bf16 (the engine's bf16 slabs): the kernel widens them
on load, the plain version before its first product.

Matches ``repro.kernels.project.ops`` (tests/test_torch_kernels.py).
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from ...core.kernels_math import KernelSpec
from .._util import on_card
from ..gram.ops import gamma_operand
from .project import dispatch_slices, prepare_support, project_tiles
from .ref import project_partial_reference, project_reference


def projector(spec: KernelSpec, x_support: torch.Tensor, coefs: torch.Tensor,
              row_mean_coef: Optional[torch.Tensor] = None,
              bias: Optional[torch.Tensor] = None,
              gamma: Optional[torch.Tensor] = None,
              slices: Optional[int] = None
              ) -> Callable[[torch.Tensor], torch.Tensor]:
    """The per-model half of ``project_op``, done once: returns a function
    of a (B, M) query batch giving its (B, C) scores. On the card the
    support norms, gamma, the coefficients with their ones column and the
    feature slicing (``slices``, else the tile table's or the derived one)
    are formed here, with the support as the kernel reads it
    (``prepare_support``, one launch of the split pass), so each call is
    the kernel's one C call and nothing else; on the CPU each call is the
    plain version."""
    l, c = coefs.shape
    if x_support.shape[0] != l:
        raise ValueError(f"project shapes disagree: x_support "
                         f"{tuple(x_support.shape)}, coefs {tuple(coefs.shape)}")
    if not on_card(x_support, coefs):
        return lambda xq: project_reference(spec, xq, x_support, coefs,
                                            row_mean_coef, bias, gamma)
    dev = coefs.device
    zeros = torch.zeros((c,), dtype=torch.float32, device=dev)
    cvec = (zeros if row_mean_coef is None else
            row_mean_coef.to(torch.float32)).contiguous()
    bvec = (zeros if bias is None else bias.to(torch.float32)).contiguous()
    xs = x_support.contiguous()
    support = prepare_support(spec, xs)
    g = gamma_operand(spec, xs, gamma)
    a_ext = torch.cat([coefs.to(torch.float32),
                       torch.ones((l, 1), dtype=torch.float32, device=dev)],
                      dim=1)
    if slices is None:
        slices = dispatch_slices("project", l, xs.shape[1], dev)
    return lambda xq: project_tiles(spec, xq.contiguous(), support, a_ext, g,
                                    cvec=cvec, bvec=bvec, inv_l=1.0 / l,
                                    slices=slices)


def project_op(spec: KernelSpec, x_query: torch.Tensor,
               x_support: torch.Tensor, coefs: torch.Tensor,
               row_mean_coef: Optional[torch.Tensor] = None,
               bias: Optional[torch.Tensor] = None,
               gamma: Optional[torch.Tensor] = None) -> torch.Tensor:
    """scores = K(x_query, x_support) @ coefs + rowmean(K) * c + b, fused.

    x_query (B, M), x_support (L, M), coefs (L, C), row_mean_coef/bias (C,)
    (default zeros), gamma 0-d (default: median heuristic on the support).
    Returns (B, C) fp32.
    """
    if x_query.shape[1] != x_support.shape[1]:
        raise ValueError(f"project shapes disagree: x_query "
                         f"{tuple(x_query.shape)}, x_support "
                         f"{tuple(x_support.shape)}")
    on_card(x_query, x_support, coefs)       # one device for all, or raise
    return projector(spec, x_support, coefs, row_mean_coef, bias,
                     gamma)(x_query)


def partial_projector(spec: KernelSpec, x_support: torch.Tensor,
                      coefs_ext: torch.Tensor,
                      gamma: Optional[torch.Tensor] = None,
                      slices: Optional[int] = None
                      ) -> Callable[[torch.Tensor], torch.Tensor]:
    """The per-shard half of ``project_partial_op``, done once: returns a
    function of a (B, M) query batch giving its raw (B, C+1) partial. On the
    card the support as the kernel reads it (``prepare_support``, one launch
    of the split pass), gamma and the feature slicing (``slices``, else the
    tile table's or the derived one) are formed here, so each call is the
    kernel's one C call; on the CPU each call is the plain version."""
    if x_support.shape[0] != coefs_ext.shape[0]:
        raise ValueError(f"project shapes disagree: x_support "
                         f"{tuple(x_support.shape)}, coefs_ext "
                         f"{tuple(coefs_ext.shape)}")
    if not on_card(x_support, coefs_ext):
        return lambda xq: project_partial_reference(spec, xq, x_support,
                                                    coefs_ext, gamma)
    xs = x_support.contiguous()
    support = prepare_support(spec, xs)
    g = gamma_operand(spec, xs, gamma)
    a_ext = coefs_ext.to(torch.float32).contiguous()
    if slices is None:
        slices = dispatch_slices("project_partial", xs.shape[0], xs.shape[1],
                                 xs.device)
    return lambda xq: project_tiles(spec, xq.contiguous(), support, a_ext, g,
                                    slices=slices)


def project_partial_op(spec: KernelSpec, x_query: torch.Tensor,
                       x_support: torch.Tensor, coefs_ext: torch.Tensor,
                       gamma: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Raw per-shard partials K(x_query, x_support) @ coefs_ext, (B, C+1):
    the last column of ``coefs_ext`` is the valid-row indicator, so the last
    output column is the raw kernel row-sum over valid rows. No centering
    epilogue. On the card the support as the kernel reads it
    (``prepare_support``) is formed per call; a server holds a
    ``partial_projector`` instead."""
    if x_query.shape[1] != x_support.shape[1]:
        raise ValueError(f"project shapes disagree: x_query "
                         f"{tuple(x_query.shape)}, x_support "
                         f"{tuple(x_support.shape)}")
    on_card(x_query, x_support, coefs_ext)   # one device for all, or raise
    return partial_projector(spec, x_support, coefs_ext, gamma)(x_query)


__all__ = ["partial_projector", "project_op", "project_partial_op",
           "projector"]
