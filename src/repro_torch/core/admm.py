"""Paper Alg. 1 — ADMM-based decentralized kernel PCA, all J nodes on one
device (port of ``repro.core.admm``).

The setup phase forms every Gram block a node needs — for all J nodes in ONE
launch of the gram kernel on the card — centers them with global kernel
mean statistics and eigendecomposes each node's own Gram; the iteration body
is ``repro_torch.core.solver.admm_step``. Layouts match the JAX package at
every public function: ``kcross`` is (J, S, S, N, N), slot 0 is the self
slot, slots 1..D the neighbors in graph order.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from ..device import DeviceLike, as_f32, resolve_device
from .kernels_math import (KernelSpec, center_gram, gram, psd_jitter_eigh,
                           resolve_gamma)
from .rho import RhoSchedule, auto_rho
from .solver import (admm_step, dense_parts, init_state, lagrangian,
                     run_steps, slot_rho)
from .topology import Graph


@dataclasses.dataclass(frozen=True)
class DkpcaSetup:
    """Static per-run tensors, all on one device.

    Slot layout: S = D + 1 where D = max degree. Slot 0 is the self slot
    (masked out when include_self=False), slots 1..D are neighbors in graph
    order. src[j, s] = data-owner node of slot s of node j;
    rsl[j, s] = the slot index of node j inside node src[j,s]'s slot list.
    """

    x: torch.Tensor          # (J, N, M) node data
    k: torch.Tensor          # (J, N, N) (centered) local Gram K_j
    lam: torch.Tensor        # (J, N) floored eigenvalues of K_j (ascending)
    vec: torch.Tensor        # (J, N, N) eigenvectors of K_j
    kcross: torch.Tensor     # (J, S, S, N, N)
    src: torch.Tensor        # (J, S) int64
    rsl: torch.Tensor        # (J, S) int64
    mask: torch.Tensor       # (J, S) bool — valid slots
    gamma: torch.Tensor      # 0-d RBF bandwidth actually used
    include_self: bool = True

    @property
    def n_nodes(self):
        return self.x.shape[0]

    @property
    def n_local(self):
        return self.x.shape[1]

    @property
    def n_slots(self):
        return self.mask.shape[1]

    @property
    def device(self) -> torch.device:
        return self.x.device


@dataclasses.dataclass
class DkpcaResult:
    alpha: torch.Tensor            # (J, N) final local solutions
    alpha_hist: torch.Tensor       # (T, J, N)
    lagrangian: torch.Tensor       # (T,) augmented Lagrangian value
    primal_residual: torch.Tensor  # (T,) ||K alpha 1 - G||_F total
    rho_hist: torch.Tensor         # (T,) rho2 used per iteration


def _masked_center(kfull: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """Center square Grams over their valid rows/cols only (then zero the
    invalid ones). kfull: (..., P, P); valid: (..., P) bool."""
    v = valid.to(kfull.dtype)
    nv = torch.clamp(torch.sum(v, dim=-1), min=1.0)[..., None]
    row = (kfull @ v[..., None])[..., 0] / nv          # mean over valid cols
    col = (v[..., None, :] @ kfull)[..., 0, :] / nv
    tot = (torch.sum(row * v, dim=-1, keepdim=True)) / nv
    kc = kfull - row[..., :, None] - col[..., None, :] + tot[..., None]
    return kc * v[..., :, None] * v[..., None, :]


def kernel_mean_stats(x_nodes: torch.Tensor, spec: KernelSpec, gamma):
    """Global kernel mean statistics for consistent centering.

    Returns (m, mu_bar): m[j, i] = mean_t K(x_i^(j), t) over ALL samples t in
    the network, mu_bar = mean over all pairs. One Gram of the pooled data
    (one kernel launch on the card) summed per row: the JAX package sums
    node blocks in scan order, so the two agree to fp32 summation-order
    tolerance.
    """
    j, n, m_feat = x_nodes.shape
    pooled = x_nodes.reshape(j * n, m_feat)
    m = torch.sum(gram(spec, pooled, gamma=gamma), dim=1) / (j * n)
    m = m.reshape(j, n)
    return m, torch.mean(m)


def build_setup(x_nodes, graph: Graph, spec: KernelSpec,
                center: str | bool = "global", include_self: bool = True,
                rel_eps: float = 1e-6, gamma: float | None = None,
                device: DeviceLike = "cuda") -> DkpcaSetup:
    """Precompute Gram blocks / factorizations on ``device`` (the card by
    default): the paper's setup phase, where raw data is exchanged with
    neighbors and all K(X_p, X_q), p,q in Omega_j, are formed once.

    center: "global" (default, shared global kernel-mean statistics),
    "neighborhood", "block" (the paper's per-block §6.1 formula) or
    "none"/False — see ``repro.core.admm.build_setup`` for what each does to
    the consensus fixed point.
    """
    if center is True:
        center = "global"
    if center is False:
        center = "none"
    if center not in ("global", "neighborhood", "block", "none"):
        raise ValueError(f"unknown center mode {center!r}")
    dev = resolve_device(device)
    x_nodes = as_f32(x_nodes, dev)
    j, n, m_feat = x_nodes.shape
    if j != graph.n_nodes:
        raise ValueError(f"{j} nodes of data for a {graph.n_nodes}-node graph")
    ids, rev, nmask = graph.neighbor_array()
    s = ids.shape[1] + 1
    src = np.concatenate([np.arange(j, dtype=np.int64)[:, None], ids], axis=1)
    rsl = np.concatenate([np.zeros((j, 1), np.int64), rev + 1], axis=1)
    mask = np.concatenate([np.full((j, 1), include_self), nmask], axis=1)
    # slot-0 blocks (K_j) are always needed even when the self *constraint*
    # is disabled, so Gram validity masking uses a mask with slot 0 on.
    gmask = np.concatenate([np.full((j, 1), True), nmask], axis=1)
    src_t = torch.as_tensor(src, device=dev)
    rsl_t = torch.as_tensor(rsl.astype(np.int64), device=dev)

    # A caller that REBUILDS a setup mid-run pins the original gamma so the
    # kernel — and the warm-started iterate — stays the same operator.
    if gamma is None:
        gamma = resolve_gamma(spec, x_nodes.reshape(j * n, -1))
    gamma = torch.as_tensor(gamma, dtype=torch.float32, device=dev)

    # Every node's slot data stacked: (J, S*N, M), then all J Grams in ONE
    # batched gram launch.
    xs = x_nodes[src_t].reshape(j, s * n, m_feat)
    kfull = gram(spec, xs, gamma=gamma)                      # (J, SN, SN)
    valid = torch.as_tensor(np.repeat(gmask, n, axis=1), device=dev)
    if center == "neighborhood":
        kfull = _masked_center(kfull, valid)
    elif center == "global":
        m_glob, mu_bar = kernel_mean_stats(x_nodes, spec, gamma)
        mf = m_glob[src_t].reshape(j, s * n)
        v = valid.to(kfull.dtype)
        kfull = (kfull - mf[:, :, None] - mf[:, None, :] + mu_bar) \
            * v[:, :, None] * v[:, None, :]
    kcross = kfull.reshape(j, s, n, s, n).permute(0, 1, 3, 2, 4)
    if center == "block":
        kcross = center_gram(kcross)
    kcross = kcross.contiguous()                             # (J, S, S, N, N)

    kj = kcross[:, 0, 0].contiguous()                        # (J, N, N)
    lam, vec = psd_jitter_eigh(kj, rel_eps)
    return DkpcaSetup(x=x_nodes, k=kj, lam=lam, vec=vec, kcross=kcross,
                      src=src_t, rsl=rsl_t,
                      mask=torch.as_tensor(mask, device=dev), gamma=gamma,
                      include_self=include_self)


def _slot_rho(setup: DkpcaSetup, rho1: float, rho2: float) -> torch.Tensor:
    """(J, S) per-slot rho (0 on invalid slots)."""
    return slot_rho(setup.mask.to(setup.k.dtype), rho1, rho2)


def initial_alpha(setup: DkpcaSetup, init: str = "local", seed: int = 0):
    """alpha^(0).

    "paper": entrywise standard normal, *unnormalized* (||alpha0|| ~
      sqrt(N) puts ||z_hat|| above 1 so the ball projection engages from
      step one). Drawn with a seeded ``torch.Generator`` on the CPU: the
      numbers differ from ``jax.random``'s for the same seed.
    "local": warm start at each node's local kPCA solution v1/sqrt(lam1).
    """
    if init == "paper":
        gen = torch.Generator().manual_seed(seed)
        return torch.randn(tuple(setup.x.shape[:2]), generator=gen,
                           dtype=setup.k.dtype).to(setup.device)
    if init == "local":
        return local_solution_alpha(setup.lam, setup.vec)
    raise ValueError(init)


def local_solution_alpha(lam: torch.Tensor, vec: torch.Tensor) -> torch.Tensor:
    """Each node's local kPCA solution v1/sqrt(lam1) (so ||w_j|| = 1).
    lam: (..., N) ascending; vec: (..., N, N).

    The eigenvector sign is whatever eigh returns. Do NOT canonicalize it
    per node: a node-local sign rule de-correlates the signs ACROSS nodes,
    which makes neighbors' warm starts partially cancel in the z-update
    (see ``repro.core.admm.local_solution_alpha``)."""
    return vec[..., :, -1] / torch.sqrt(torch.clamp(lam[..., -1:], min=1e-12))


def run_admm(setup: DkpcaSetup, n_iters: int = 30, rho1: float = 100.0,
             rho2: Optional[RhoSchedule] = None, seed: int = 0,
             alpha0: Optional[torch.Tensor] = None, init: str = "local",
             project: str = "ball") -> DkpcaResult:
    """Run Alg. 1 for ``n_iters`` iterations on the setup's device (see
    ``repro_torch.core.solver.run_chunked`` for the resumable driver).

    rho2 defaults to the paper's warm-up schedule (10 -> 50 -> 100);
    ``init`` defaults to the local-solution warm start."""
    if rho2 is None:
        rho2 = RhoSchedule()
    if alpha0 is None:
        alpha0 = initial_alpha(setup, init, seed)
    alpha0 = as_f32(alpha0, setup.device)
    rho2s = [rho2.at(t) for t in range(n_iters)]
    rho1s = [float(rho1) if setup.include_self else 0.0] * n_iters
    ops, comm = dense_parts(setup)
    state, ahist, lhist, rhist = run_steps(
        ops, comm, init_state(alpha0, setup.n_slots), rho1s, rho2s, project)
    return DkpcaResult(alpha=state.alpha, alpha_hist=ahist, lagrangian=lhist,
                       primal_residual=rhist,
                       rho_hist=torch.tensor(rho2s, dtype=torch.float32))


def admm_iteration(setup: DkpcaSetup, alpha: torch.Tensor, b: torch.Tensor,
                   rho1: float, rho2: float, project: str = "ball"):
    """One ADMM iteration (eq. 10-13, per-slot-rho generalization) through
    the shared step body (``repro_torch.core.solver.admm_step``) over the
    dense transport, on the setup's device.

    alpha: (J, N); b: (J, N, S). Returns (alpha', b', g, znorm2).
    """
    ops, comm = dense_parts(setup)
    state = dataclasses.replace(
        init_state(as_f32(alpha, setup.device), setup.n_slots),
        b=as_f32(b, setup.device))
    new, _ = admm_step(ops, comm, state, _slot_rho(setup, rho1, rho2),
                       project)
    return new.alpha, new.b, new.g, new.znorm2


def augmented_lagrangian(setup: DkpcaSetup, alpha: torch.Tensor,
                         b: torch.Tensor, g: torch.Tensor, rho1: float,
                         rho2: float) -> torch.Tensor:
    """Dual-space evaluation of eq. (8):
    L = sum_j [ -a^T K^2 a + sum_s B_s^T C_s + sum_s rho_s/2 C_s^T K C_s ],
    C_s = alpha - K^{-1} G_s (constraint residual coefficients)."""
    ops, _ = dense_parts(setup)
    return lagrangian(ops, alpha, b, g, _slot_rho(setup, rho1, rho2))


def theorem2_rho(setup: DkpcaSetup, safety: float = 1.05) -> float:
    """Assumption-2-satisfying constant rho for this setup."""
    degrees = torch.sum(setup.mask, dim=1)
    return auto_rho(setup.lam, degrees, safety)


__all__ = ["DkpcaResult", "DkpcaSetup", "admm_iteration",
           "augmented_lagrangian", "build_setup", "initial_alpha",
           "kernel_mean_stats", "local_solution_alpha", "run_admm",
           "theorem2_rho"]
