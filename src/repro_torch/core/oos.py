"""Out-of-sample projection: the fitted-model artifacts for serving kPCA
(port of ``repro.core.oos``: the single-device ``FittedKpca`` and the
support-sharded ``ShardedFittedKpca``).

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

A ``ShardedFittedKpca`` splits the support set into contiguous shards; each
shard's raw partial K(x', X_j) @ coefs_ext_j is summed over shards and the
global centering applied once (``finalize_partial_scores``).
``repro_torch.serve.sharded`` is its execution path. Checkpoints of both
artifacts use the JAX package's layout, so either package loads the other's.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple, Union

import numpy as np
import torch

from ..device import DeviceLike, as_f32, resolve_device
from ..obs import trace
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
    with trace.span("package.build"):
        return _from_dual(x_train, alpha, spec, gamma, center,
                          resolve_device(device))


def _from_dual(x_train, alpha, spec: KernelSpec, gamma, center: bool,
               dev: torch.device) -> FittedKpca:
    x_train = as_f32(x_train, dev)
    alpha = _as_2d(as_f32(alpha, dev))
    g = resolve_gamma(spec, x_train) if gamma is None \
        else torch.as_tensor(gamma, dtype=torch.float32, device=dev)
    c = alpha.shape[1]
    if center:
        with trace.span("package.mean_stats"):
            k_raw = gram(spec, x_train, gamma=g)
            m = torch.mean(k_raw, dim=1)                  # (N,)
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
    with trace.span("package.build"):
        x_nodes = as_f32(x_nodes, dev)
        j, n, m = x_nodes.shape
        if not isinstance(alpha, (list, tuple)):
            alpha = [alpha]
        pooled_alpha = torch.stack(
            [as_f32(a, dev).reshape(j * n) for a in alpha], dim=1) / j
        return _from_dual(x_nodes.reshape(j * n, m), pooled_alpha, spec,
                          gamma, center, dev)


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


def refresh_coefficients(model, alpha):
    """Rebuild a fitted model around NEW dual coefficients, reusing the
    support set, bandwidth and the cached kernel mean statistics (an O(L*C)
    update, no Gram). A ``ShardedFittedKpca`` refreshes per shard, its
    global centering rebuilt from the per-shard caches (alpha in shard
    concatenation order, which is the pooled order). Compressed models are
    rejected."""
    if isinstance(model, ShardedFittedKpca):
        return _refresh_sharded(model, alpha)
    if not isinstance(model, FittedKpca):
        raise TypeError(f"refresh_coefficients takes a FittedKpca or "
                        f"ShardedFittedKpca, got {type(model).__name__}")
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


# ---- sharded artifact (multi-device serving) ------------------------------

@dataclasses.dataclass(frozen=True)
class ShardedFittedKpca:
    """Support-sharded servable kPCA model (the JAX package's fields).

    x_support:     (S, Lp, M) per-shard support slices, zero-padded to the
                   common per-shard capacity Lp.
    coefs_ext:     (S, Lp, C+1) per-shard coefficient rows; column C is the
                   valid-row indicator (1.0 on real rows, 0.0 on padding),
                   so each shard's raw kernel row-sum is one more column of
                   the same product.
    row_mean_coef: (C,) global centering weight (zeros for models built
                   with per-shard landmark compression).
    bias:          (C,) global score offset, applied once after the sum.
    gamma:         0-d fit-time RBF bandwidth, shared by all shards.
    n_support:     total TRUE support rows across shards.
    shard_sizes:   per-shard true row counts.
    k_row_mean:    optional (S, Lp) per-shard slices of the cached kernel
                   means (zero on padding rows), for per-shard refresh.
    k_grand_mean:  optional 0-d cached grand mean.
    spec:          kernel spec.
    """

    x_support: torch.Tensor
    coefs_ext: torch.Tensor
    row_mean_coef: torch.Tensor
    bias: torch.Tensor
    gamma: torch.Tensor
    n_support: int
    shard_sizes: Tuple[int, ...]
    k_row_mean: Optional[torch.Tensor] = None
    k_grand_mean: Optional[torch.Tensor] = None
    spec: KernelSpec = KernelSpec()

    @property
    def n_shards(self) -> int:
        return self.x_support.shape[0]

    @property
    def shard_capacity(self) -> int:
        return self.x_support.shape[1]

    @property
    def n_features(self) -> int:
        return self.x_support.shape[2]

    @property
    def n_components(self) -> int:
        return self.coefs_ext.shape[2] - 1

    @property
    def device(self) -> torch.device:
        return self.x_support.device

    def to(self, device: DeviceLike) -> "ShardedFittedKpca":
        """The same model with every tensor on ``device``."""
        dev = resolve_device(device)
        moved = {f.name: getattr(self, f.name).to(dev)
                 for f in dataclasses.fields(self)
                 if isinstance(getattr(self, f.name), torch.Tensor)}
        return dataclasses.replace(self, **moved)


def finalize_partial_scores(partials: torch.Tensor,
                            row_mean_coef: torch.Tensor, bias: torch.Tensor,
                            n_support: int) -> torch.Tensor:
    """Global centering epilogue for summed per-shard partials (B, C+1):
    columns :C the raw scores, column C the raw kernel row-sum over all
    true support rows. Returns (B, C) scores, ``project`` of the gathered
    model."""
    c = partials.shape[-1] - 1
    kmean = partials[:, c] / n_support
    return (partials[:, :c] + kmean[:, None] * row_mean_coef[None, :]
            + bias[None, :])


def shard_fitted(model: FittedKpca, n_shards: int,
                 landmarks_per_shard: Optional[int] = None, seed: int = 0,
                 rel_thresh: float = 1e-7
                 ) -> Tuple[ShardedFittedKpca, torch.Tensor]:
    """Partition a ``FittedKpca`` into ``n_shards`` contiguous support
    slices, on the model's device (as ``repro.core.oos.shard_fitted``).

    Uneven L is zero-padded to the largest slice, with the indicator column
    zero on padding rows. With ``landmarks_per_shard`` each shard's slice of
    the effective coefficients is Nystrom-compressed onto min(budget, shard
    size) landmarks of a per-shard fixed-seed schedule (``seed + 7919 j``),
    through ``gram``: on the card, the gram kernel.

    Returns (sharded model, rel_err_bound (C,)): the aggregate relative RKHS
    error sum_j ||w_j - w_hat_j||_H / ||w||_H; zeros without compression.
    """
    l_full, c = model.n_support, model.n_components
    if not 0 < n_shards <= l_full:
        raise ValueError(f"n_shards={n_shards} not in [1, {l_full}]")
    dev = model.device
    splits = [torch.as_tensor(ix, device=dev)
              for ix in np.array_split(np.arange(l_full), n_shards)]
    if landmarks_per_shard is None:
        parts = [(model.x_support[ix], model.coefs[ix]) for ix in splits]
        row_mean_coef, bias = model.row_mean_coef, model.bias
        rel_err = torch.zeros((c,), dtype=torch.float32, device=dev)
    else:
        if landmarks_per_shard < 1:
            raise ValueError(f"landmarks_per_shard={landmarks_per_shard} < 1")
        a_eff = effective_coefs(model)
        kxx = gram(model.spec, model.x_support, gamma=model.gamma)
        w2 = torch.sum(a_eff * (kxx @ a_eff), dim=0)      # ||w||_H^2, global
        parts = []
        err_abs = torch.zeros((c,), dtype=torch.float32, device=dev)
        for j, ix in enumerate(splits):
            xj, aj = model.x_support[ix], a_eff[ix]
            order = landmark_schedule(len(ix), seed=seed + 7919 * j)
            z, beta, wh2 = _nystrom_project(
                model.spec, model.gamma, xj, aj,
                order[:min(landmarks_per_shard, len(ix))], rel_thresh)
            kjj = kxx[ix][:, ix]
            wj2 = torch.sum(aj * (kjj @ aj), dim=0)       # ||w_j||_H^2
            err_abs = err_abs + torch.sqrt(torch.clamp(wj2 - wh2, min=0.0))
            parts.append((z, beta))
        row_mean_coef = torch.zeros_like(model.row_mean_coef)
        bias = model.bias
        rel_err = err_abs / torch.sqrt(torch.clamp(w2, min=1e-30))

    sizes = tuple(int(x.shape[0]) for x, _ in parts)
    lp, m = max(sizes), model.n_features
    xs = torch.zeros((n_shards, lp, m), dtype=torch.float32, device=dev)
    ae = torch.zeros((n_shards, lp, c + 1), dtype=torch.float32, device=dev)
    for j, (xj, aj) in enumerate(parts):
        xs[j, :sizes[j]] = xj
        ae[j, :sizes[j], :c] = aj
        ae[j, :sizes[j], c] = 1.0                         # indicator column
    stats = {}
    if landmarks_per_shard is None and model.k_row_mean is not None:
        kr = torch.zeros((n_shards, lp), dtype=torch.float32, device=dev)
        for j, ix in enumerate(splits):
            kr[j, :sizes[j]] = model.k_row_mean[ix]
        stats = dict(k_row_mean=kr, k_grand_mean=model.k_grand_mean)
    return ShardedFittedKpca(
        x_support=xs, coefs_ext=ae,
        row_mean_coef=row_mean_coef.to(torch.float32),
        bias=bias.to(torch.float32), gamma=model.gamma,
        n_support=int(sum(sizes)), shard_sizes=sizes, spec=model.spec,
        **stats), rel_err


def _sharded_centering(model: ShardedFittedKpca, coefs_pad: torch.Tensor
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Global (row_mean_coef, bias) for per-shard padded (S, Lp, C)
    coefficients, from the per-shard cached kernel means (padding rows are
    zero in both, so sums over (S, Lp) are the true-row sums)."""
    alpha_sum = torch.sum(coefs_pad, dim=(0, 1))          # (C,)
    m_dot = torch.einsum("sl,slc->c", model.k_row_mean, coefs_pad)
    return -alpha_sum, model.k_grand_mean * alpha_sum - m_dot


def _require_sharded_cache(model: ShardedFittedKpca, c: int):
    """(row_mean_coef, bias, centered): with no cache only an UNCENTERED
    model (all-zero centering terms) may refresh, and its terms stay zero."""
    if model.k_row_mean is not None:
        return None, None, True
    if bool(torch.any(model.row_mean_coef != 0)) or \
            bool(torch.any(model.bias != 0)):
        raise ValueError(
            "sharded model carries centering terms but no per-shard "
            "kernel-mean cache (k_row_mean/k_grand_mean) — re-shard an "
            "uncompressed centered fit to enable coefficient refresh")
    zeros = torch.zeros((c,), dtype=torch.float32, device=model.device)
    return zeros, zeros.clone(), False


def _refresh_sharded(model: ShardedFittedKpca, alpha) -> ShardedFittedKpca:
    """All-shard coefficient swap (see ``refresh_coefficients``)."""
    alpha = _pool_alpha(alpha, model.n_support, model.device)   # (L, C)
    c, lp = alpha.shape[1], model.shard_capacity
    coefs_pad = torch.zeros((model.n_shards, lp, c), dtype=torch.float32,
                            device=model.device)
    off = 0
    for j, n in enumerate(model.shard_sizes):
        coefs_pad[j, :n] = alpha[off:off + n]
        off += n
    row_mean_coef, bias, centered = _require_sharded_cache(model, c)
    if centered:
        row_mean_coef, bias = _sharded_centering(model, coefs_pad)
    coefs_ext = torch.cat([coefs_pad, model.coefs_ext[..., -1:]], dim=-1)
    return dataclasses.replace(model, coefs_ext=coefs_ext,
                               row_mean_coef=row_mean_coef, bias=bias)


def refresh_shard_coefficients(model: ShardedFittedKpca, shard: int,
                               alpha) -> ShardedFittedKpca:
    """Swap ONE shard's dual-coefficient rows ((n_j,) or (n_j, C) for its
    true rows); the other shards keep theirs, and the global centering is
    rebuilt from the per-shard caches. Returns a new model."""
    if not isinstance(model, ShardedFittedKpca):
        raise TypeError(f"refresh_shard_coefficients takes a "
                        f"ShardedFittedKpca, got {type(model).__name__}")
    if not 0 <= shard < model.n_shards:
        raise ValueError(f"shard {shard} not in [0, {model.n_shards})")
    n_j, c = model.shard_sizes[shard], model.n_components
    alpha = _as_2d(as_f32(alpha, model.device))
    if tuple(alpha.shape) != (n_j, c):
        raise ValueError(f"shard {shard} takes ({n_j}, {c}) coefficients, "
                         f"got {tuple(alpha.shape)}")
    coefs_ext = model.coefs_ext.clone()
    coefs_ext[shard, :, :c] = 0.0
    coefs_ext[shard, :n_j, :c] = alpha
    row_mean_coef, bias, centered = _require_sharded_cache(model, c)
    if centered:
        row_mean_coef, bias = _sharded_centering(model, coefs_ext[..., :c])
    return dataclasses.replace(model, coefs_ext=coefs_ext,
                               row_mean_coef=row_mean_coef, bias=bias)


def drop_shard(model: ShardedFittedKpca, shard: int) -> ShardedFittedKpca:
    """Shard-loss re-balance: the lost shard becomes an empty participant
    (support, coefficients and indicator zeroed, ``shard_sizes[shard]`` 0),
    ``n_support`` shrinks, and with the per-shard cache the centering is
    rebuilt for the survivors. Idempotent on an empty shard."""
    if not isinstance(model, ShardedFittedKpca):
        raise TypeError(f"drop_shard takes a ShardedFittedKpca, got "
                        f"{type(model).__name__}")
    if not 0 <= shard < model.n_shards:
        raise ValueError(f"shard {shard} not in [0, {model.n_shards})")
    if model.shard_sizes[shard] == 0:
        return model
    sizes = tuple(0 if j == shard else n
                  for j, n in enumerate(model.shard_sizes))
    n_support = int(sum(sizes))
    if n_support == 0:
        raise ValueError("cannot drop the last non-empty shard")
    c = model.n_components
    x_support = model.x_support.clone()
    x_support[shard] = 0.0
    coefs_ext = model.coefs_ext.clone()
    coefs_ext[shard] = 0.0
    k_row_mean = model.k_row_mean
    row_mean_coef, bias = model.row_mean_coef, model.bias
    if k_row_mean is not None:
        k_row_mean = k_row_mean.clone()
        k_row_mean[shard] = 0.0
        survivor = dataclasses.replace(model, k_row_mean=k_row_mean)
        row_mean_coef, bias = _sharded_centering(survivor,
                                                 coefs_ext[..., :c])
    return dataclasses.replace(
        model, x_support=x_support, coefs_ext=coefs_ext,
        row_mean_coef=row_mean_coef, bias=bias, n_support=n_support,
        shard_sizes=sizes, k_row_mean=k_row_mean)


def gather_fitted(sharded: ShardedFittedKpca) -> FittedKpca:
    """Reassemble a single-device ``FittedKpca``: the true support slices
    and coefficient rows concatenated, padding dropped."""
    xs = torch.cat([sharded.x_support[j, :n]
                    for j, n in enumerate(sharded.shard_sizes)], dim=0)
    coefs = torch.cat([sharded.coefs_ext[j, :n, :-1]
                       for j, n in enumerate(sharded.shard_sizes)], dim=0)
    stats = {}
    if sharded.k_row_mean is not None:
        stats = dict(
            k_row_mean=torch.cat([sharded.k_row_mean[j, :n]
                                  for j, n in enumerate(sharded.shard_sizes)]),
            k_grand_mean=sharded.k_grand_mean)
    return FittedKpca(x_support=xs, coefs=coefs,
                      row_mean_coef=sharded.row_mean_coef, bias=sharded.bias,
                      gamma=sharded.gamma, spec=sharded.spec, **stats)


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


def save_sharded(ckpt_dir: str, model: ShardedFittedKpca) -> str:
    """Write a sharded artifact in the JAX package's layout (the partition
    metadata rides in the manifest); returns the checkpoint path."""
    from ..checkpoint import save_checkpoint
    tree = {"x_support": model.x_support, "coefs_ext": model.coefs_ext,
            "row_mean_coef": model.row_mean_coef, "bias": model.bias,
            "gamma": model.gamma}
    if model.k_row_mean is not None:
        tree["k_row_mean"] = model.k_row_mean
        tree["k_grand_mean"] = model.k_grand_mean
    meta = {"kind": "sharded_fitted_kpca",
            "spec": dataclasses.asdict(model.spec),
            "n_support": model.n_support,
            "shard_sizes": list(model.shard_sizes)}
    return save_checkpoint(ckpt_dir, 0, tree, metadata=meta, keep_last=1)


def load_sharded(ckpt_dir: str,
                 device: DeviceLike = "cuda") -> ShardedFittedKpca:
    """Restore a ``save_sharded`` checkpoint of either package onto
    ``device``; validates the artifact kind."""
    from ..checkpoint import restore_checkpoint
    from .convert import sharded_from_numpy
    tree, meta, _ = restore_checkpoint(ckpt_dir)
    if meta.get("kind") != "sharded_fitted_kpca":
        raise ValueError(
            f"{ckpt_dir} is not a ShardedFittedKpca checkpoint: {meta}")
    return sharded_from_numpy(
        tree, KernelSpec(**meta["spec"]), int(meta["n_support"]),
        tuple(int(n) for n in meta["shard_sizes"]), resolve_device(device))


__all__ = [
    "FittedKpca", "ShardedFittedKpca", "compress", "drop_shard",
    "effective_coefs", "finalize_partial_scores", "fit_central", "from_dual",
    "from_decentralized", "gather_fitted", "landmark_schedule",
    "load_fitted", "load_sharded", "project", "projector",
    "refresh_coefficients", "refresh_shard_coefficients", "save_fitted",
    "save_sharded", "shard_fitted",
]
