"""Central kernel PCA — the paper's ground-truth baseline (problem (2));
port of ``repro.core.central``.

Solves the eigenproblem of the (centered) global Gram matrix; the solution
``alpha_gt`` is normalized so that ||w*|| = 1 in feature space, i.e.
||alpha|| = 1/sqrt(lambda_1) (paper §1).
"""

from __future__ import annotations

from typing import Optional

import torch

from ..device import DeviceLike, as_f32, resolve_device
from .kernels_math import KernelSpec, center_gram, gram, topk_eigh


def central_kpca(x, spec: KernelSpec, n_components: int = 1,
                 center: bool = True, gamma: Optional[torch.Tensor] = None,
                 device: DeviceLike = "cuda"):
    """Central kPCA on the full dataset x: (N, M), on ``device``.

    Returns (alpha, lam, k): alpha (N, n_components) with columns normalized
    to 1/sqrt(lam_i); lam (n_components,) descending; k the (centered) Gram.
    """
    dev = resolve_device(device)
    x = as_f32(x, dev)
    if gamma is not None:
        gamma = torch.as_tensor(gamma, dtype=torch.float32, device=dev)
    k = gram(spec, x, gamma=gamma)
    if center:
        k = center_gram(k)
    lam, vec = topk_eigh(k, n_components)
    lam = torch.clamp(lam, min=1e-12)
    alpha = vec / torch.sqrt(lam)[None, :]
    return alpha, lam, k


def kpca_project(x_new: torch.Tensor, x_train: torch.Tensor,
                 alpha: torch.Tensor, spec: KernelSpec,
                 gamma: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Project new points onto learned components (paper §1), applying the
    training kernel-mean correction; runs on ``x_train``'s device. A
    stateless convenience: serving builds the artifact once
    (``oos.from_dual``) and calls ``oos.project``."""
    from . import oos
    squeeze = alpha.dim() == 1
    model = oos.from_dual(x_train, alpha, spec, gamma=gamma, center=True,
                          device=x_train.device)
    out = oos.project(model, x_new.to(x_train.device))
    return out[:, 0] if squeeze else out


__all__ = ["central_kpca", "kpca_project"]
