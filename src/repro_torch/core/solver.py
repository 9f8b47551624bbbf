"""Shared ADMM solver layer (port of ``repro.core.solver``, dense transport).

  * ``AdmmState`` — the full iterate (alpha, dual B, last z projections G,
    per-node ||z_hat||^2, iteration counter, per-slot rho), checkpointable
    via ``save_state``/``load_state`` in the JAX package's layout;
  * ``admm_step`` — ONE iteration (paper eq. 10-13 in the per-slot-rho
    generalization, with ``slot_mask`` censoring and hold-when-isolated),
    written against a communicator (``DenseComm``: all J nodes on one
    device, exchange by (src, rsl) indexing). The node axis J is a written-
    out batch dimension where the JAX package ``vmap``s. Its eq. 12-13
    block is the fused local update (``repro_torch.kernels.admm_step``):
    one kernel launch for all J nodes on the card;
  * ``run_chunked`` — the resumable driver: a Python loop over iterations
    (the JAX package's jitted ``scan``) that yields the live state every
    ``chunk`` iterations, with residual-based early stopping and
    checkpointing.

Everything stays on the setup's device; the host reads a value only for the
early-stop test.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Iterator, List, Optional, Union

import torch

from ..device import DeviceLike, resolve_device
from .rho import RhoSchedule


# ---- state ----------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class AdmmState:
    """Full ADMM iterate over J nodes (leading axis on every tensor).

    alpha:  (J, N) primal dual-space coefficients.
    b:      (J, N, S) dual variables B_j = phi(X_j)^T eta_j, slot-major.
    g:      (J, N, S) last z projections G_j = phi(X_j)^T Z xi_j.
    znorm2: (J,) last ||z_hat||^2 per node.
    t:      iterations completed (a host int).
    rho:    (J, S) per-slot rho applied at the last step (0 before it).
    """

    alpha: torch.Tensor
    b: torch.Tensor
    g: torch.Tensor
    znorm2: torch.Tensor
    t: int
    rho: torch.Tensor


def init_state(alpha0: torch.Tensor, n_slots: int, t0: int = 0) -> AdmmState:
    """Fresh state at iteration ``t0`` with zero duals/projections."""
    b = alpha0.new_zeros(alpha0.shape + (n_slots,))
    return AdmmState(alpha=alpha0, b=b, g=torch.zeros_like(b),
                     znorm2=alpha0.new_zeros(alpha0.shape[:-1]), t=int(t0),
                     rho=alpha0.new_zeros(alpha0.shape[:-1] + (n_slots,)))


@dataclasses.dataclass(frozen=True)
class SolverOps:
    """Per-node constants the step needs (leading node axis J).

    kcross: (J, S, S, N, N) Gram blocks between slot owners' data.
    k:      (J, N, N) own (centered) Gram K_j == kcross[:, 0, 0].
    lam:    (J, N) floored eigenvalues of K_j, ascending.
    vec:    (J, N, N) eigenvectors of K_j.
    mask:   (J, S) float 1/0 — valid constraint slots.
    """

    kcross: torch.Tensor
    k: torch.Tensor
    lam: torch.Tensor
    vec: torch.Tensor
    mask: torch.Tensor


# ---- communicator ---------------------------------------------------------

class DenseComm:
    """All nodes on one device: exchange == advanced indexing by the
    (src, rsl) slot routing tables."""

    def __init__(self, src: torch.Tensor, rsl: torch.Tensor):
        self.src, self.rsl = src, rsl

    def exchange(self, cols: torch.Tensor) -> torch.Tensor:
        """cols: (J, S, N) per-out-slot columns -> (J, S, N) where in-slot s
        of node j receives cols[src[j,s], rsl[j,s]]."""
        return cols[self.src, self.rsl]

    def all_sum(self, x: torch.Tensor) -> torch.Tensor:
        return torch.sum(x)

    def all_max(self, x: torch.Tensor) -> torch.Tensor:
        return torch.max(x)


def dense_parts(setup) -> tuple:
    """(SolverOps, DenseComm) for a ``repro_torch.core.admm.DkpcaSetup``.
    K and V are made contiguous here, once per run, because the fused
    update kernel reads them row-major (eigh returns V column-major)."""
    ops = SolverOps(kcross=setup.kcross, k=setup.k.contiguous(),
                    lam=setup.lam, vec=setup.vec.contiguous(),
                    mask=setup.mask.to(setup.k.dtype))
    return ops, DenseComm(setup.src, setup.rsl)


# ---- the shared step ------------------------------------------------------

def _pinv_lam(lam: torch.Tensor, rel_thresh: float = 1e-5) -> torch.Tensor:
    """Pseudo-inverse eigenvalues of K_j (drop the null space)."""
    keep = lam > rel_thresh * lam[..., -1:]
    return torch.where(keep, 1.0 / lam, torch.zeros_like(lam))


def _sym_apply(vec: torch.Tensor, scale: torch.Tensor,
               x: torch.Tensor) -> torch.Tensor:
    """V diag(scale) V^T x per node: vec (J, N, N), scale (J, N),
    x (J, N, S)."""
    return vec @ ((vec.transpose(1, 2) @ x) * scale[..., None])


def inverse_denominators(lam: torch.Tensor,
                         rho_sum: torch.Tensor) -> torch.Tensor:
    """The eq. 12 solve's diag(inv_den) per node: 1 / (rho_sum lam - 2 lam^2)
    on K_j's eigen-directions. lam (J, N) ascending, rho_sum (J,)."""
    den = rho_sum[:, None] * lam - 2.0 * lam * lam
    # drop (don't invert) directions where the alpha-Hessian is not PD —
    # during rho warm-up large-N kernels can violate Assumption 2 for a
    # few iterations; clamping would amplify those modes into divergence.
    return torch.where((lam > 1e-5 * lam[:, -1:]) & (den > 0), 1.0 / den,
                       torch.zeros_like(den))


def admm_step(ops: SolverOps, comm: DenseComm, state: AdmmState,
              rho_slots: torch.Tensor, project: str = "ball",
              slot_mask: Optional[torch.Tensor] = None):
    """One ADMM iteration (paper eq. 10-13, per-slot-rho generalization).

    Args:
      ops: per-node constants.
      comm: transport (``DenseComm``).
      state: incoming iterate; only (alpha, b, t) drive the update.
      rho_slots: (J, S) per-node per-slot rho for THIS iteration; zero on
        invalid slots.
      project: "ball" (paper eq. 11), "sphere" (always renormalize), or
        "rescale" (ball + global gauge renormalization).
      slot_mask: optional (J, S) {0,1} mask censoring links for THIS
        iteration: rho_bar renormalizes over the slots heard, censored
        constraints leave the z/alpha updates and the residual, their duals
        freeze, and a node that heard nobody holds its (alpha, B).

    Returns:
      (state', primal_residual) with the global ||K alpha 1 - G||_F over
      valid slots as a 0-d tensor.
    """
    faulty = slot_mask is not None
    if faulty:
        ops = dataclasses.replace(ops, mask=ops.mask * slot_mask)
        rho_slots = rho_slots * slot_mask
    alpha, b = state.alpha, state.b
    mask = ops.mask                                          # (J, S)
    n_slots = b.shape[2]

    # ---- message round 1: K^-1 B columns + alpha --------------------------
    m1 = _sym_apply(ops.vec, _pinv_lam(ops.lam), b)          # (J, N, S)
    recv_m1 = comm.exchange(m1.transpose(1, 2))              # (J, S, N)
    recv_a = comm.exchange(alpha[:, None, :].expand(-1, n_slots, -1))

    # ---- Z-update (eq. 10-11) --------------------------------------------
    rho_bar = torch.sum(rho_slots, dim=-1)                   # (J,)
    if faulty:
        # fully-censored node: avoid 0/0 (its update is discarded below)
        rho_bar = torch.clamp(rho_bar, min=1e-30)
    c = ((recv_m1 + rho_slots[..., None] * recv_a)
         / rho_bar[:, None, None]) * mask[..., None]         # (J, S, N)
    kc = torch.einsum("jabnm,jbm->jan", ops.kcross, c)
    znorm2 = torch.einsum("jan,jan->j", c, kc)
    rs = torch.rsqrt(torch.clamp(znorm2, min=1e-30))
    if project == "sphere":
        scale = rs
    else:
        scale = torch.where(znorm2 > 1.0, rs, torch.ones_like(rs))
    p = scale[:, None, None] * kc                            # (J, S, N)

    # ---- message round 2: z projections ----------------------------------
    g = comm.exchange(p).transpose(1, 2) * mask[:, None, :]  # (J, N, S)

    # ---- alpha-update (eq. 12) + eta-update (eq. 13) ---------------------
    from ..kernels.admm_step.ops import admm_local_update_op  # kernels import core
    rho_sum = torch.sum(rho_slots, dim=-1)
    inv = inverse_denominators(ops.lam, rho_sum)
    # The fused update (one kernel launch on the card). With B masked, G
    # masked and rho zero on invalid slots, its B + rho (ka - G) equals
    # (B + rho (ka - G)) * mask on every slot, censored ones included.
    alpha_n, b_n, ka = admm_local_update_op(
        ops.vec, inv[..., None], ops.k, b * mask[:, None, :], g,
        (rho_slots * mask)[:, None, :])
    alpha_n = alpha_n[..., 0]
    diff = ka - g                                            # (J, N, S)
    res_part = torch.sum(mask[:, None, :] * diff * diff, dim=(1, 2))
    if faulty:
        # A node that heard nobody this iteration has no consensus
        # information: den <= 0 zeroes every direction and the naive update
        # would collapse alpha to 0. Hold its state instead.
        live = rho_sum > 0.0
        alpha_n = torch.where(live[:, None], alpha_n, alpha)
        b_n = torch.where(live[:, None, None], b_n, b)
    res = torch.sqrt(comm.all_sum(res_part))

    if project == "rescale":
        # Beyond-paper gauge renormalization (see repro.core.solver).
        zmax = torch.sqrt(torch.clamp(comm.all_max(znorm2), min=1e-30))
        gain = torch.where(zmax < 1.0, 1.0 / zmax, torch.ones_like(zmax))
        alpha_n = alpha_n * gain
        b_n = b_n * gain

    return AdmmState(alpha=alpha_n, b=b_n, g=g, znorm2=znorm2,
                     t=state.t + 1, rho=rho_slots), res


def lagrangian(ops: SolverOps, alpha, b, g, rho_slots) -> torch.Tensor:
    """Dual-space augmented Lagrangian eq. (8), summed over nodes:
    L = sum_j [ -a^T K^2 a + sum_s B_s^T C_s + sum_s rho_s/2 C_s^T K C_s ],
    C_s = alpha - K^{-1} G_s."""
    ka = (ops.k @ alpha[..., None])[..., 0]
    kinv_g = _sym_apply(ops.vec, _pinv_lam(ops.lam), g)
    cres = (alpha[..., None] - kinv_g) * ops.mask[:, None, :]
    per_node = (-torch.sum(ka * ka, dim=1) + torch.sum(b * cres, dim=(1, 2))
                + 0.5 * torch.sum(rho_slots[:, None, :] * cres
                                  * (ops.k @ cres), dim=(1, 2)))
    return torch.sum(per_node)


def slot_rho(mask: torch.Tensor, rho1: float, rho2: float) -> torch.Tensor:
    """(J, S) per-slot rho (slot 0 = self at rho1, neighbors at rho2) from
    a (J, S) float mask; 0 on invalid slots."""
    r = torch.full_like(mask, rho2)
    r[:, 0] = rho1
    return r * mask


def run_steps(ops: SolverOps, comm: DenseComm, state: AdmmState,
              rho1s: List[float], rho2s: List[float], project: str):
    """``len(rho2s)`` iterations from ``state`` (the JAX package's scan
    body as a Python loop). Returns (state, alpha_hist (T, J, N),
    lagrangian (T,), primal_residual (T,))."""
    ahist, lhist, rhist = [], [], []
    for rho1, rho2 in zip(rho1s, rho2s):
        rho_slots = slot_rho(ops.mask, rho1, rho2)
        new, res = admm_step(ops, comm, state, rho_slots, project)
        # Theorem-2 pairing: L(alpha^t, Z^t, eta^t) with Z^t generated from
        # the incoming (alpha^t, eta^t) — i.e. this step's g.
        lhist.append(lagrangian(ops, state.alpha, state.b, new.g, rho_slots))
        ahist.append(new.alpha)
        rhist.append(res)
        state = new
    return (state, torch.stack(ahist), torch.stack(lhist),
            torch.stack(rhist))


# ---- chunked, resumable driver -------------------------------------------

@dataclasses.dataclass
class ChunkResult:
    """One driver chunk: the live state plus this chunk's per-iteration
    histories (alpha (c, J, N), Lagrangian/residual/rho2 (c,) each)."""

    state: AdmmState
    alpha_hist: torch.Tensor
    lagrangian: torch.Tensor
    primal_residual: torch.Tensor
    rho_hist: torch.Tensor
    ckpt_path: Optional[str] = None
    stopped: bool = False          # residual-based early stop fired here


class EveryK:
    """Refresh cadence: fire on every k-th chunk."""

    def __init__(self, k: int = 1):
        if k < 1:
            raise ValueError(f"k must be >= 1, got {k}")
        self.k = k
        self._n = 0

    def should_refresh(self, chunk: ChunkResult) -> bool:
        self._n += 1
        return self._n % self.k == 0


class ResidualImprovement:
    """Refresh cadence: fire only when the primal residual has improved by
    at least ``rel_drop`` (fractional) since the last firing; the first
    chunk always fires."""

    def __init__(self, rel_drop: float = 0.1):
        if not 0.0 <= rel_drop < 1.0:
            raise ValueError(f"rel_drop must be in [0, 1), got {rel_drop}")
        self.rel_drop = rel_drop
        self._last: Optional[float] = None

    def should_refresh(self, chunk: ChunkResult) -> bool:
        res = float(chunk.primal_residual[-1])
        if self._last is None or res <= (1.0 - self.rel_drop) * self._last:
            self._last = res
            return True
        return False


def resolve_rho2(rho2, setup) -> Callable[[int], float]:
    """Normalize a rho2 policy to a host-side ``t -> float``: a
    ``RhoSchedule``, "theorem2", a number, or a callable ``t -> rho``."""
    if rho2 is None:
        rho2 = RhoSchedule()
    if isinstance(rho2, str):
        if rho2 != "theorem2":
            raise ValueError(f"unknown rho2 policy {rho2!r}")
        from .admm import theorem2_rho   # admm imports this module
        r = theorem2_rho(setup)
        return lambda t: r
    if isinstance(rho2, RhoSchedule):
        return rho2.at
    if callable(rho2):
        return rho2
    r = float(rho2)
    return lambda t: r


def run_chunked(setup, n_iters: int = 30, chunk: int = 10,
                rho1: float = 100.0,
                rho2: Union[RhoSchedule, str, float, Callable, None] = None,
                project: str = "ball", init: str = "local", seed: int = 0,
                alpha0: Optional[torch.Tensor] = None,
                state: Optional[AdmmState] = None, tol: float = 0.0,
                ckpt_dir: Optional[str] = None, ckpt_every: int = 1
                ) -> Iterator[ChunkResult]:
    """Resumable chunked driver for Alg. 1 over the dense transport.

    Runs ``chunk`` iterations per step of the generator and yields a
    ``ChunkResult`` after each, so callers can observe, checkpoint, re-tune
    or publish mid-run. Arguments as in ``repro.core.solver.run_chunked``
    (the ledger and link-mask options are not ported yet). Advance it from
    one thread.
    """
    from .admm import initial_alpha   # admm imports this module
    if chunk < 1:
        raise ValueError(f"chunk must be >= 1, got {chunk}")
    if ckpt_every < 1:
        raise ValueError(f"ckpt_every must be >= 1, got {ckpt_every}")
    rho2_fn = resolve_rho2(rho2, setup)
    if state is None:
        if alpha0 is None:
            alpha0 = initial_alpha(setup, init, seed)
        state = init_state(alpha0, setup.n_slots)
    ops, comm = dense_parts(setup)
    rho1_eff = float(rho1) if setup.include_self else 0.0

    t = state.t
    chunk_idx = 0
    while t < n_iters:
        c = min(chunk, n_iters - t)
        rho2s = [float(rho2_fn(tt)) for tt in range(t, t + c)]
        state, ahist, lhist, rhist = run_steps(
            ops, comm, state, [rho1_eff] * c, rho2s, project)
        t += c
        chunk_idx += 1
        stopped = tol > 0.0 and float(rhist[-1]) < tol
        ckpt_path = None
        if ckpt_dir and (chunk_idx % ckpt_every == 0 or t >= n_iters
                         or stopped):
            ckpt_path = save_state(ckpt_dir, state)
        yield ChunkResult(
            state=state, alpha_hist=ahist, lagrangian=lhist,
            primal_residual=rhist,
            rho_hist=torch.tensor(rho2s, dtype=torch.float32),
            ckpt_path=ckpt_path, stopped=stopped)
        if stopped:
            return


# ---- persistence (checkpoint layout shared with the JAX package) ----------

def save_state(ckpt_dir: str, state: AdmmState, keep_last: int = 3) -> str:
    """Checkpoint a live ``AdmmState`` (step number == iteration count)."""
    from ..checkpoint import save_checkpoint
    tree = {"alpha": state.alpha, "b": state.b, "g": state.g,
            "znorm2": state.znorm2, "rho": state.rho}
    return save_checkpoint(ckpt_dir, state.t, tree,
                           metadata={"kind": "admm_state", "t": state.t},
                           keep_last=keep_last)


def load_state(ckpt_dir: str, step: Optional[int] = None,
               device: DeviceLike = "cuda") -> AdmmState:
    """Restore an ``AdmmState`` checkpoint (latest step by default) onto
    ``device``; reads checkpoints of either package."""
    from ..checkpoint import restore_checkpoint
    from .convert import state_from_numpy
    tree, meta, step = restore_checkpoint(ckpt_dir, step)
    if meta.get("kind") != "admm_state":
        raise ValueError(f"{ckpt_dir} is not an AdmmState checkpoint: {meta}")
    return state_from_numpy(dict(tree, t=int(meta.get("t", step))),
                            resolve_device(device))


__all__ = [
    "AdmmState", "ChunkResult", "DenseComm", "EveryK", "ResidualImprovement",
    "SolverOps", "admm_step", "dense_parts", "init_state",
    "inverse_denominators", "lagrangian",
    "load_state", "resolve_rho2", "run_chunked", "run_steps", "save_state",
    "slot_rho",
]
