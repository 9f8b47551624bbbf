"""Beyond-paper: top-k decentralized kernel PCA via sequential deflation
(port of ``repro.core.deflation``).

The paper computes only the FIRST kernel principal component. Top-k
deflates each node's Gram blocks with the converged consensus direction
after each round and re-runs Alg. 1:

    K'(x, y) = K(x, y) - (phi(x)^T w)(w^T phi(y)) / ||w||^2

Every factor is evaluable at node j for all data it holds (w = phi(X_j)
alpha_j gives phi(x)^T w = K(x, X_j) alpha_j), so the deflation is fully
decentralized. Everything runs on the setup's device; each round's Alg. 1
goes through the fused local update kernel on the card.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

import torch

from .admm import DkpcaSetup, run_admm
from .kernels_math import psd_jitter_eigh
from .rho import RhoSchedule


def _deflate_setup(setup: DkpcaSetup, alpha: torch.Tensor) -> DkpcaSetup:
    """Deflate all Gram blocks with the converged component.

    kcross[j, a, b] -= proj_a proj_b^T / w2_j  where
    proj_a = K(X_src[j,a], X_j) alpha_j  (slot 0 is the node itself)."""
    # phi(X_src[j,a])^T w_j = kcross[j, a, 0] @ alpha_j     (N vectors)
    proj = torch.einsum("janm,jm->jan", setup.kcross[:, :, 0], alpha)
    w2 = torch.einsum("jn,jnm,jm->j", alpha, setup.k, alpha)   # ||w_j||^2
    w2 = torch.clamp(w2, min=1e-12)
    outer = torch.einsum("jan,jbm->jabnm", proj, proj) \
        / w2[:, None, None, None, None]
    kcross = setup.kcross - outer
    kj = kcross[:, 0, 0].contiguous()
    lam, vec = psd_jitter_eigh(kj)
    return dataclasses.replace(setup, kcross=kcross, k=kj, lam=lam, vec=vec)


def _local_gram_schmidt(k: torch.Tensor, alpha_new: torch.Tensor,
                        prev_alphas: List[torch.Tensor]) -> torch.Tensor:
    """Per-node Gram-Schmidt in feature space (local, no communication):
    alpha' = alpha - sum_p <w, w_p>/<w_p, w_p> alpha_p."""
    for ap in prev_alphas:
        num = torch.einsum("jn,jnm,jm->j", ap, k, alpha_new)
        den = torch.clamp(torch.einsum("jn,jnm,jm->j", ap, k, ap), min=1e-12)
        alpha_new = alpha_new - (num / den)[:, None] * ap
    return alpha_new


def run_admm_topk(setup: DkpcaSetup, k: int, n_iters: int = 30,
                  rho1: float = 100.0, rho2: Optional[RhoSchedule] = None,
                  seed: int = 0) -> List[torch.Tensor]:
    """Sequential-deflation top-k. Returns a list of k (J, N) alpha tensors.
    After each round, components are locally Gram-Schmidt-orthogonalized
    against the previous ones (deflation guarantees near-orthogonality only
    at exact consensus; the local projection removes the residual)."""
    alphas: List[torch.Tensor] = []
    cur = setup
    for c in range(k):
        res = run_admm(cur, n_iters=n_iters, rho1=rho1, rho2=rho2,
                       seed=seed + c)
        alpha = _local_gram_schmidt(setup.k, res.alpha, alphas)
        alphas.append(alpha)
        if c + 1 < k:
            cur = _deflate_setup(cur, alpha)
    return alphas


__all__ = ["run_admm_topk"]
