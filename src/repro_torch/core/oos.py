"""Out-of-sample projection: the fitted-model artifact for serving kPCA
(port of ``repro.core.oos``, single-device artifact).

Every model — centered, uncentered, or landmark-compressed — serves through
ONE formula:

    score(x') = K(x', X_s) @ coefs + mean_l K(x', x_l) * row_mean_coef + bias

``project`` hands that to ``repro_torch.kernels.project.project_op``, where
the query tensor's device picks the path: the hand-written projection kernel
on the card, the plain PyTorch version on the CPU. (The JAX package's
``use_pallas``/``interpret`` flags have no counterpart: the device decides.)

Landmark compression (``compress``) projects each component w = Phi(X) a_eff
onto span{phi(z_l)} of L landmarks (Nystrom): beta = K_ZZ^+ K_ZX a_eff, with
the exact RKHS reconstruction error returned alongside.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple, Union

import numpy as np
import torch

from ..device import DeviceLike, as_f32, resolve_device
from .kernels_math import KernelSpec, gram, resolve_gamma


@dataclasses.dataclass(frozen=True)
class FittedKpca:
    """Servable kPCA model: support set + dual coefficients + centering.

    x_support:     (L, M) training samples or landmarks.
    coefs:         (L, C) dual coefficients, one column per component.
    row_mean_coef: (C,) weight of mean_l K(x', x_l) in the score.
    bias:          (C,) constant score offset.
    gamma:         0-d resolved RBF bandwidth actually used at fit time.
    k_row_mean:    optional (L,) cached kernel mean statistics
                   m_i = mean_t K(x_i, t) (for ``refresh_coefficients``).
    k_grand_mean:  optional 0-d cached grand mean mu_bar.
    spec:          kernel spec.
    """

    x_support: torch.Tensor
    coefs: torch.Tensor
    row_mean_coef: torch.Tensor
    bias: torch.Tensor
    gamma: torch.Tensor
    k_row_mean: Optional[torch.Tensor] = None
    k_grand_mean: Optional[torch.Tensor] = None
    spec: KernelSpec = KernelSpec()

    @property
    def n_support(self) -> int:
        return self.x_support.shape[0]

    @property
    def n_features(self) -> int:
        return self.x_support.shape[1]

    @property
    def n_components(self) -> int:
        return self.coefs.shape[1]

    @property
    def device(self) -> torch.device:
        return self.x_support.device

    def to(self, device: DeviceLike) -> "FittedKpca":
        """The same model with every tensor on ``device`` (no copy for
        tensors already there)."""
        dev = resolve_device(device)
        moved = {f.name: getattr(self, f.name).to(dev)
                 for f in dataclasses.fields(self)
                 if isinstance(getattr(self, f.name), torch.Tensor)}
        return dataclasses.replace(self, **moved)


def _as_2d(alpha: torch.Tensor) -> torch.Tensor:
    return alpha[:, None] if alpha.dim() == 1 else alpha


def from_dual(x_train, alpha, spec: KernelSpec,
              gamma: Optional[torch.Tensor] = None, center: bool = True,
              device: DeviceLike = "cuda") -> FittedKpca:
    """Build the serving artifact from any dual solution, on ``device``.

    x_train (N, M) becomes the support set; alpha (N,) or (N, C). With
    ``center=True`` the uncentered training Gram is formed once here (one
    gram launch on the card) for the kernel mean statistics the centered
    score needs.
    """
    dev = resolve_device(device)
    x_train = as_f32(x_train, dev)
    alpha = _as_2d(as_f32(alpha, dev))
    g = resolve_gamma(spec, x_train) if gamma is None \
        else torch.as_tensor(gamma, dtype=torch.float32, device=dev)
    c = alpha.shape[1]
    if center:
        k_raw = gram(spec, x_train, gamma=g)
        m = torch.mean(k_raw, dim=1)                      # (N,)
        mu_bar = torch.mean(k_raw)
        alpha_sum = torch.sum(alpha, dim=0)               # (C,)
        row_mean_coef = -alpha_sum
        bias = mu_bar * alpha_sum - m @ alpha
        stats = dict(k_row_mean=m, k_grand_mean=mu_bar)
    else:
        row_mean_coef = torch.zeros((c,), dtype=torch.float32, device=dev)
        bias = torch.zeros((c,), dtype=torch.float32, device=dev)
        stats = {}
    return FittedKpca(x_support=x_train, coefs=alpha,
                      row_mean_coef=row_mean_coef, bias=bias,
                      gamma=g.to(torch.float32), spec=spec, **stats)


def fit_central(x, spec: KernelSpec, n_components: int = 1,
                center: bool = True, gamma: Optional[torch.Tensor] = None,
                device: DeviceLike = "cuda") -> FittedKpca:
    """Fit central kPCA (paper problem (2)) and package it for serving."""
    from .central import central_kpca
    dev = resolve_device(device)
    x = as_f32(x, dev)
    g = resolve_gamma(spec, x) if gamma is None \
        else torch.as_tensor(gamma, dtype=torch.float32, device=dev)
    alpha, _, _ = central_kpca(x, spec, n_components, center=center,
                               gamma=g, device=dev)
    return from_dual(x, alpha, spec, gamma=g, center=center, device=dev)


def from_decentralized(x_nodes, alpha, spec: KernelSpec,
                       gamma: Optional[torch.Tensor] = None,
                       center: bool = True,
                       device: DeviceLike = "cuda") -> FittedKpca:
    """Package an Alg.-1 consensus solution for serving.

    x_nodes: (J, N, M); alpha: (J, N) from ``run_admm`` or a list of (J, N).
    The pooled dual vector concat_j(alpha_j) / J represents the nodes'
    average component on the pooled support set.
    """
    dev = resolve_device(device)
    x_nodes = as_f32(x_nodes, dev)
    j, n, m = x_nodes.shape
    if not isinstance(alpha, (list, tuple)):
        alpha = [alpha]
    pooled_alpha = torch.stack(
        [as_f32(a, dev).reshape(j * n) for a in alpha], dim=1) / j
    return from_dual(x_nodes.reshape(j * n, m), pooled_alpha, spec,
                     gamma=gamma, center=center, device=dev)


def _pool_alpha(alpha: Union[torch.Tensor, Sequence[torch.Tensor]],
                l_full: int, device: torch.device) -> torch.Tensor:
    """Normalize any live dual solution to pooled (L, C) float32: (L,) /
    (L, C) pooled coefficients, node-major (J, N[, C]) solver state, or a
    list of per-component (J, N); node-major input pools as concat / J."""
    if isinstance(alpha, (list, tuple)):
        first = as_f32(alpha[0], device)
        j = first.shape[0] if first.dim() == 2 else 1
        alpha = torch.stack([as_f32(a, device).reshape(-1) for a in alpha],
                            dim=1)
    else:
        alpha = as_f32(alpha, device)
        j = 1
        if alpha.dim() == 3 or (alpha.dim() == 2 and alpha.shape[0] != l_full):
            j = alpha.shape[0]
            alpha = alpha.reshape(j * alpha.shape[1], -1)
    if alpha.shape[0] != l_full:
        raise ValueError(
            f"alpha with leading dim {alpha.shape[0]} does not match "
            f"the support set ({l_full} rows); compressed models "
            f"cannot be refreshed — refit and re-compress instead")
    return _as_2d(alpha) / j


def refresh_coefficients(model: FittedKpca, alpha) -> FittedKpca:
    """Rebuild a fitted model around NEW dual coefficients, reusing the
    support set, bandwidth and the cached kernel mean statistics (an O(L*C)
    update, no Gram). Plain models only; compressed models are rejected."""
    if not isinstance(model, FittedKpca):
        raise TypeError(f"refresh_coefficients takes a FittedKpca, got "
                        f"{type(model).__name__}")
    alpha = _pool_alpha(alpha, model.n_support, model.device)
    c = alpha.shape[1]
    if model.k_row_mean is not None:
        alpha_sum = torch.sum(alpha, dim=0)
        row_mean_coef = -alpha_sum
        bias = model.k_grand_mean * alpha_sum - model.k_row_mean @ alpha
    else:
        if bool(torch.any(model.row_mean_coef != 0)) or \
                bool(torch.any(model.bias != 0)):
            raise ValueError(
                "model is centered but carries no kernel-mean cache "
                "(k_row_mean/k_grand_mean) — refit with "
                "from_dual(center=True) to enable refresh_coefficients")
        row_mean_coef = torch.zeros((c,), dtype=torch.float32,
                                    device=model.device)
        bias = torch.zeros_like(row_mean_coef)
    return dataclasses.replace(model, coefs=alpha,
                               row_mean_coef=row_mean_coef, bias=bias)


def project(model: FittedKpca, x_query: torch.Tensor) -> torch.Tensor:
    """Centered out-of-sample scores (B, C) for a (B, M) query batch:
    ``K(x_query, X_s) @ coefs + rowmean(K) * row_mean_coef + bias``. The
    projection kernel on the card, the plain version on the CPU."""
    from ..kernels.project.ops import project_op   # kernels import core
    return project_op(model.spec, x_query, model.x_support, model.coefs,
                      row_mean_coef=model.row_mean_coef, bias=model.bias,
                      gamma=model.gamma)


def projector(model: FittedKpca):
    """``project`` with its per-model work done once: returns a function of
    a (B, M) query batch giving its (B, C) scores (what the engine holds
    per model version)."""
    from ..kernels.project.ops import projector as make   # kernels import core
    return make(model.spec, model.x_support, model.coefs,
                row_mean_coef=model.row_mean_coef, bias=model.bias,
                gamma=model.gamma)


def effective_coefs(model: FittedKpca) -> torch.Tensor:
    """Fold the row-mean term into the dual coefficients:
    w = Phi(X_s) @ (coefs + row_mean_coef / L)."""
    return model.coefs + model.row_mean_coef[None, :] / model.n_support


def landmark_schedule(n_support: int, seed: int = 0) -> np.ndarray:
    """Fixed random permutation of support indices; prefixes give NESTED
    landmark sets (same as the JAX package for the same seed)."""
    return np.random.default_rng(seed).permutation(n_support)


def _nystrom_project(spec: KernelSpec, gamma: torch.Tensor, x: torch.Tensor,
                     a_eff: torch.Tensor, idx, rel_thresh: float
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Project w = Phi(x) a_eff onto span{phi(x[idx])} in the RKHS; returns
    (landmarks z, beta = K_ZZ^+ K_ZX a_eff, ||w_hat||_H^2 per component)."""
    z = x[torch.as_tensor(np.asarray(idx), device=x.device)]
    kzz = gram(spec, z, gamma=gamma)
    kzx = gram(spec, z, x, gamma=gamma)
    t = kzx @ a_eff                                      # (L, C)
    lam, v = torch.linalg.eigh(kzz)
    cut = rel_thresh * torch.clamp(lam[-1], min=1e-30)
    inv = torch.where(lam > cut, 1.0 / lam, torch.zeros_like(lam))
    beta = v @ (inv[:, None] * (v.T @ t))
    wh2 = torch.sum(beta * (kzz @ beta), dim=0)
    return z, beta, wh2


def compress(model: FittedKpca, n_landmarks: int, seed: int = 0,
             rel_thresh: float = 1e-7) -> Tuple[FittedKpca, torch.Tensor]:
    """Nystrom landmark compression of the support set, on the model's
    device. Returns (compressed model, rel_err (C,)) with the exact
    rel_err_c = ||w_c - w_hat_c||_H / ||w_c||_H."""
    l_full = model.n_support
    if not 0 < n_landmarks <= l_full:
        raise ValueError(f"n_landmarks={n_landmarks} not in [1, {l_full}]")
    idx = landmark_schedule(l_full, seed)[:n_landmarks]
    a_eff = effective_coefs(model)
    z, beta, wh2 = _nystrom_project(model.spec, model.gamma, model.x_support,
                                    a_eff, idx, rel_thresh)
    kxx = gram(model.spec, model.x_support, gamma=model.gamma)
    w2 = torch.sum(a_eff * (kxx @ a_eff), dim=0)
    rel_err = torch.sqrt(torch.clamp(w2 - wh2, min=0.0)
                         / torch.clamp(w2, min=1e-30))
    compressed = FittedKpca(
        x_support=z, coefs=beta,
        row_mean_coef=torch.zeros_like(model.row_mean_coef),
        bias=model.bias, gamma=model.gamma, spec=model.spec)
    return compressed, rel_err


# ---- persistence (checkpoint layout shared with the JAX package) ----------

def save_fitted(ckpt_dir: str, model: FittedKpca) -> str:
    """Write the artifact (step 0) in the JAX package's layout; returns the
    checkpoint path."""
    from ..checkpoint import save_checkpoint
    tree = {"x_support": model.x_support, "coefs": model.coefs,
            "row_mean_coef": model.row_mean_coef, "bias": model.bias,
            "gamma": model.gamma}
    if model.k_row_mean is not None:
        tree["k_row_mean"] = model.k_row_mean
        tree["k_grand_mean"] = model.k_grand_mean
    meta = {"kind": "fitted_kpca", "spec": dataclasses.asdict(model.spec)}
    return save_checkpoint(ckpt_dir, 0, tree, metadata=meta, keep_last=1)


def load_fitted(ckpt_dir: str, device: DeviceLike = "cuda") -> FittedKpca:
    """Restore a ``save_fitted`` checkpoint of either package onto
    ``device``; validates the artifact kind."""
    from ..checkpoint import restore_checkpoint
    from .convert import fitted_from_numpy
    tree, meta, _ = restore_checkpoint(ckpt_dir)
    if meta.get("kind") != "fitted_kpca":
        raise ValueError(f"{ckpt_dir} is not a FittedKpca checkpoint: {meta}")
    return fitted_from_numpy(tree, KernelSpec(**meta["spec"]),
                             resolve_device(device))


__all__ = [
    "FittedKpca", "compress", "effective_coefs", "fit_central", "from_dual",
    "from_decentralized", "landmark_schedule", "load_fitted", "project",
    "projector", "refresh_coefficients", "save_fitted",
]
