"""Similarity metric from the paper's §6.1 (port of ``repro.core.metrics``).

Similarity(w_j, w_gt) = w_j^T w_gt / (||w_j|| ||w_gt||)
  = alpha_j^T K(X_j, X) alpha_gt / sqrt((alpha_j^T K_j alpha_j)(alpha_gt^T K alpha_gt))

computed entirely in the dual. Eigenvector sign is arbitrary, so we report
|similarity|. Runs on the device of its inputs (Grams through the gram
kernel and their centering through the centering kernel on the card).
"""

from __future__ import annotations

from typing import Optional

import torch

from .kernels_math import KernelSpec, center_gram, center_gram_global, gram


def similarity(alpha_j: torch.Tensor, x_j: torch.Tensor,
               alpha_gt: torch.Tensor, x_gt: torch.Tensor,
               spec: KernelSpec, center: bool = True,
               gamma: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Cosine similarity of w_j = phi(X_j) alpha_j and w = phi(X) alpha_gt."""
    k_j = gram(spec, x_j, gamma=gamma)
    k_g = gram(spec, x_gt, gamma=gamma)
    k_cross = gram(spec, x_j, x_gt, gamma=gamma)
    if center:
        # Center every block consistently w.r.t. the global dataset so that
        # all vectors live in the same (centered) feature space.
        k_cross = center_gram_global(k_cross, k_cross, k_g, k_g)
        k_j = center_gram(k_j)
        k_g = center_gram(k_g)
    num = alpha_j @ k_cross @ alpha_gt
    den = torch.sqrt(torch.clamp((alpha_j @ k_j @ alpha_j)
                                 * (alpha_gt @ k_g @ alpha_gt), min=1e-24))
    return torch.clamp(torch.abs(num) / den, 0.0, 1.0)


def pairwise_direction_similarity(alpha_a, x_a, alpha_b, x_b, spec,
                                  gamma=None, center: bool = True):
    """Similarity between two dual-represented directions on different data."""
    return similarity(alpha_a, x_a, alpha_b, x_b, spec, center=center,
                      gamma=gamma)


def subspace_alignment(alphas_j: torch.Tensor, x_j: torch.Tensor,
                       alphas_gt: torch.Tensor, x_gt: torch.Tensor,
                       spec: KernelSpec,
                       gamma: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Mean principal angle cosine between two component subspaces (used
    by the beyond-paper top-k deflation). alphas: (N, k). Uncentered
    Grams, as in the JAX package."""
    k_cross = gram(spec, x_j, x_gt, gamma=gamma)
    k_j = gram(spec, x_j, gamma=gamma)
    k_g = gram(spec, x_gt, gamma=gamma)
    # Gram-normalize each side, then the SVD of the cross-correlation.
    aj = _orthonormalize(alphas_j, k_j)
    ag = _orthonormalize(alphas_gt, k_g)
    s = torch.linalg.svdvals(aj.T @ k_cross @ ag)
    return torch.mean(torch.clamp(s, 0.0, 1.0))


def _orthonormalize(alpha: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """Make columns of phi(X) alpha orthonormal: alpha^T K alpha = I."""
    lam, v = torch.linalg.eigh(alpha.T @ k @ alpha)
    lam = torch.clamp(lam, min=1e-12)
    return alpha @ v / torch.sqrt(lam)[None, :]


__all__ = ["pairwise_direction_similarity", "similarity",
           "subspace_alignment"]
