"""Kernel functions and Gram-matrix math for (decentralized) kernel PCA.

The port of ``repro.core.kernels_math``. ``gram`` and ``center_gram`` are
the entries every module calls: on a CUDA tensor they launch the
hand-written gram and centering kernels (``repro_torch.kernels.gram``,
``repro_torch.kernels.centering``), on a CPU tensor they run the plain
PyTorch versions. Inputs may carry a leading batch dimension (the JAX
package's ``vmap`` written out).

The paper (§3.1) requires the kernel to be *normalized*: K(x, x) = 1 for all
x. RBF satisfies this by construction; linear/polynomial kernels are
normalized via K(x,y)/sqrt(K(x,x) K(y,y)).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch


@dataclasses.dataclass(frozen=True)
class KernelSpec:
    """Positive-definite kernel specification.

    kind: "rbf" | "linear" | "poly"
    gamma: RBF bandwidth K(x,y)=exp(-gamma ||x-y||^2); None => median heuristic
           resolved at Gram time (see ``resolve_gamma``).
    degree/coef: polynomial kernel (x.y * scale + coef) ** degree.
    normalize: enforce K(x,x)=1 (paper §3.1). RBF is already normalized.
    """

    kind: str = "rbf"
    gamma: Optional[float] = None
    degree: int = 3
    coef: float = 1.0
    scale: float = 1.0
    normalize: bool = True

    def __post_init__(self):
        if self.kind not in ("rbf", "linear", "poly"):
            raise ValueError(f"unknown kernel kind: {self.kind}")


def pairwise_sqdist(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Squared euclidean distances. x: (..., n, m), y: (..., k, m) ->
    (..., n, k)."""
    sx = torch.sum(x * x, dim=-1)
    sy = torch.sum(y * y, dim=-1)
    d2 = sx[..., :, None] + sy[..., None, :] - 2.0 * (x @ y.transpose(-1, -2))
    return torch.clamp(d2, min=0.0)


def resolve_gamma(spec: KernelSpec, x: torch.Tensor) -> torch.Tensor:
    """Median heuristic: gamma = 1 / median(||x_i - x_j||^2) over a
    subsample. The median of an even count averages the two middle values
    (``jnp.median``'s convention, not ``torch.median``'s lower one)."""
    if spec.gamma is not None:
        return torch.tensor(spec.gamma, dtype=x.dtype, device=x.device)
    n = min(x.shape[0], 256)
    d2 = pairwise_sqdist(x[:n], x[:n])
    d2 = d2 + torch.eye(n, dtype=x.dtype, device=x.device) * torch.max(d2)
    med = torch.quantile(d2.reshape(-1), 0.5, interpolation="midpoint")
    return 1.0 / torch.clamp(med, min=1e-12)


def gram(spec: KernelSpec, x: torch.Tensor, y: Optional[torch.Tensor] = None,
         gamma: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Gram matrix K[..., i, j] = K(x_i, y_j): the gram kernel on a CUDA
    tensor, the plain version on a CPU tensor."""
    from ..kernels.gram.ops import gram_op   # kernels import this module
    return gram_op(spec, x, y, gamma=gamma)


def _self_k(spec: KernelSpec, x: torch.Tensor) -> torch.Tensor:
    s = torch.sum(x * x, dim=-1) * spec.scale
    if spec.kind == "poly":
        s = (s + spec.coef) ** spec.degree
    return s


def center_gram(k: torch.Tensor) -> torch.Tensor:
    """Center a Gram block per the paper's §6.1 formula (batched over any
    leading dims, strided views included): the centering kernel on a CUDA
    tensor, the plain version on a CPU tensor.

    K_c = K - 1_m K / m - K 1_n / n + 1_m K 1_n / (mn), for K in R^{m x n}.
    """
    from ..kernels.centering.ops import center_op   # kernels import this module
    return center_op(k)


def center_gram_global(k_xy: torch.Tensor, k_x_train: torch.Tensor,
                       k_train_y: torch.Tensor,
                       k_train: torch.Tensor) -> torch.Tensor:
    """Center a cross block consistently with a reference ("train") set.

    K_c(x,y) = K(x,y) - mean_t K(x,t) - mean_t K(t,y) + mean_tt' K(t,t').
    """
    return (k_xy
            - torch.mean(k_x_train, dim=1, keepdim=True)
            - torch.mean(k_train_y, dim=0, keepdim=True)
            + torch.mean(k_train))


def psd_jitter_eigh(k: torch.Tensor, rel_eps: float = 1e-6):
    """Eigendecomposition of a symmetric PSD Gram matrix (batched over any
    leading dims) with eigenvalue flooring: lam_i <- max(lam_i,
    rel_eps * lam_max). Returns (lam, v), lam ascending."""
    lam, v = torch.linalg.eigh(k)
    lam_max = torch.clamp(lam[..., -1:], min=1e-30)
    lam = torch.maximum(lam, rel_eps * lam_max)
    return lam, v


def topk_eigh(kmat: torch.Tensor, k: int = 1):
    """Top-k eigenpairs of a symmetric matrix (batched over any leading
    dims), descending: lam (..., k), v (..., N, k)."""
    lam, v = torch.linalg.eigh(kmat)
    return torch.flip(lam, (-1,))[..., :k], torch.flip(v, (-1,))[..., :k]


__all__ = ["KernelSpec", "center_gram", "center_gram_global", "gram",
           "pairwise_sqdist", "psd_jitter_eigh", "resolve_gamma",
           "topk_eigh"]
