"""Decentralized kernel PCA over ``torch.distributed`` — paper Alg. 1 with
the ring's nodes spread over the ranks of a process group (port of
``repro.core.dkpca``).

Mapping: the J nodes of ``ring(J, hops)`` split into contiguous blocks, rank
r holding nodes r*L .. r*L+L-1 (L = J / world). One program runs on every
rank, batched over its L nodes:

  setup:  raw X_j crosses the 2*hops ring shifts (the paper's setup phase);
          the global-centring statistics take one ring sweep (J single-hop
          rotations of X, one cross-Gram launch each) and one all-reduce;
          the slot Grams of the rank's nodes are ONE batched gram launch;
  iterate: ``n_iters`` steps of the shared ``repro_torch.core.solver.
          admm_step`` over ``RingComm`` — 3 exchanges of N-vectors per
          iteration, each one ``batch_isend_irecv`` of everything that
          crosses ranks, and one all-reduce for the residual.

On one rank (world 1, L = J) the whole ring runs in one process and every
shift is indexing; with world = J it is the JAX package's one node per
device. Per-node per-iteration traffic is O(|Omega_j| N) numbers (§4.2),
independent of J, and the ledger records it per node.

Resume a run through ``alpha0``/``b0``/``t0`` (``DistDkpcaResult.alpha`` and
``.b`` are the full restart state); recover from node loss by re-launching
on the survivors with the shrunk state (``repro_torch.faults``).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.distributed as dist

from ..device import DeviceLike, as_f32, resolve_device
from ..obs.comm import CommLedger
from .admm import local_solution_alpha
from .kernels_math import KernelSpec, gram, psd_jitter_eigh, resolve_gamma
from .rho import RhoSchedule
from .solver import AdmmState, RingComm, SolverOps, admm_step, slot_rho
from .topology import ring_shifts


@dataclasses.dataclass
class DistDkpcaResult:
    """The run gathered on every rank, in the JAX package's shapes."""

    alpha: torch.Tensor            # (J, N)
    alpha_hist: torch.Tensor       # (T, J, N)
    primal_residual: torch.Tensor  # (T,)
    znorm2_hist: torch.Tensor      # (T, J)
    b: Optional[torch.Tensor] = None  # (J, N, S) final duals (restart state)


def _gather(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """Every rank's block of x concatenated along ``dim``, in rank order."""
    parts = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, x.contiguous(), group=group)
    return torch.cat(parts, dim=dim)


def dkpca_distributed(
    x_nodes,
    group=None,
    hops: int = 2,
    spec: KernelSpec = KernelSpec(),
    center: str = "global",
    include_self: bool = True,
    rho1: float = 100.0,
    rho2: Optional[RhoSchedule] = None,
    n_iters: int = 30,
    seed: int = 0,
    init: str = "local",
    alpha0=None,
    b0=None,
    t0: int = 0,
    project: str = "ball",
    gamma: Optional[float] = None,
    message_dtype=None,
    ledger: Optional[CommLedger] = None,
    link_mask=None,
    device: DeviceLike = "cuda",
) -> DistDkpcaResult:
    """Run decentralized kPCA on a ring spread over the ranks of ``group``
    (None: the default group), on ``device`` (the card unless the caller
    asks for the CPU; a NCCL group carries CUDA tensors, a gloo group CPU
    ones). Every rank calls it with the same arguments.

    x_nodes: the full (J, N, M) data on every rank, as the JAX caller
      passes a global array; J must split evenly over the ranks. A rank
      takes its own block; other ranks' raw data reaches it only through
      the ring's messages.
    gamma: the RBF bandwidth; None resolves it on every rank alike (the
      median heuristic on the pooled rows).
    init (when alpha0 is None): "local" starts each node at its own local
      kPCA solution, computed inside the node program from the setup's
      eigendecomposition; "paper" draws the paper's unnormalized Gaussian
      from a ``torch.Generator`` seeded with ``seed`` (the port's dense
      ``initial_alpha`` numbers, not ``jax.random``'s).
    alpha0 (J, N), b0 (J, N, S), t0: resume from iteration ``t0``; the rho2
      schedule is evaluated at [t0, t0 + n_iters).
    message_dtype (e.g. torch.bfloat16): cast each iteration's neighbour
      payloads for the wire; accumulation stays fp32.
    ledger: a ``repro_torch.obs.CommLedger`` recording ONE node's traffic
      (setup exchanges in ``ledger.setup``, an iteration's in
      ``ledger.per_iter``).
    link_mask: optional (n_iters, J, S) {0,1} censoring mask in the ring
      slot layout (``repro_torch.faults.plan.ring_slot_tables``): zeroed
      at the transport and dropped from the consensus weights, as in the
      dense driver.

    The JAX signature's ``mesh``/``axis_names`` are the group here. Its
    ``use_pallas`` has no counterpart: the Grams always go through
    ``gram_op``, which launches the gram kernel for a CUDA tensor and runs
    the plain version for a CPU one. Nor has ``unroll_iters``, a
    ``lax.scan`` unroll: the iterations are a Python loop.
    """
    dev = resolve_device(device)
    if center not in ("global", "none"):
        raise ValueError(f"unknown center mode {center!r}")
    if init not in ("local", "paper"):
        raise ValueError(f"unknown init {init!r}")
    x_all = torch.as_tensor(x_nodes, dtype=torch.float32)
    jj, n, m = x_all.shape
    offsets = ring_shifts(hops)                 # [-r..-1, 1..r]
    s_slots = len(offsets) + 1                  # slot 0 = self
    # rev[d]: for in-slot d+1 (offset o), the sender's out-slot pointing
    # back at the receiver, the slot of offset -o
    slot_of = {o: i + 1 for i, o in enumerate(offsets)}
    comm = RingComm(jj, offsets, [slot_of[-o] for o in offsets], group=group,
                    device=dev, message_dtype=message_dtype, ledger=ledger)
    lo, ln = comm.first_node, comm.n_local
    mine = slice(lo, lo + ln)
    x = x_all[mine].to(dev)                                  # (L, N, M)
    if gamma is None:
        g = resolve_gamma(spec, x_all.reshape(jj * n, m)[:256].to(dev))
    else:
        g = torch.as_tensor(gamma, dtype=torch.float32, device=dev)
    g = g.reshape(())
    if rho2 is None:
        rho2 = RhoSchedule()
    rho_self = float(rho1) if include_self else 0.0

    # ---- setup: raw X with the 2*hops ring neighbours ---------------------
    d = len(offsets)
    xs = torch.cat([x[:, None], comm.shift(
        x.expand(d, -1, -1, -1), offsets).transpose(0, 1)], dim=1)

    # ---- global-centring statistics: one ring sweep + one all-reduce -----
    if center == "global":
        rot = x
        macc = torch.zeros((ln, n), device=dev)
        for _ in range(jj):
            kb = gram(spec, x, rot, gamma=g)                 # (L, N, N)
            macc = macc + torch.sum(kb, dim=2)
            rot = comm.shift(rot[None], (1,))[0]
        m_own = macc / (jj * n)
        mu_bar = comm.all_sum(torch.sum(m_own, dim=1) / n) / jj
        m_slots = torch.cat([m_own[:, None], comm.shift(
            m_own.expand(d, -1, -1), offsets).transpose(0, 1)], dim=1)

    # ---- slot Grams: one batched launch over the rank's nodes ------------
    kfull = gram(spec, xs.reshape(ln, s_slots * n, m), gamma=g)
    if center == "global":
        mf = m_slots.reshape(ln, s_slots * n)
        kfull = kfull - mf[:, :, None] - mf[:, None, :] + mu_bar
    kcross = kfull.reshape(ln, s_slots, n, s_slots, n) \
        .permute(0, 1, 3, 2, 4).contiguous()                 # (L, S, S, N, N)
    k_loc = kcross[:, 0, 0].contiguous()
    lam, vec = psd_jitter_eigh(k_loc)

    if alpha0 is not None:
        alpha = as_f32(alpha0, dev)[mine]
    elif init == "local":
        alpha = local_solution_alpha(lam, vec)
    else:
        gen = torch.Generator().manual_seed(seed)
        alpha = torch.randn((jj, n), generator=gen)[mine].to(dev)
    b = torch.zeros((ln, n, s_slots), device=dev) if b0 is None \
        else as_f32(b0, dev)[mine]
    if b.shape != (ln, n, s_slots):
        raise ValueError(f"b0 block {tuple(b.shape)} != {(ln, n, s_slots)}")
    lm = None
    if link_mask is not None:
        lm = as_f32(link_mask, dev)
        if lm.shape != (n_iters, jj, s_slots):
            raise ValueError(f"link_mask shape {tuple(lm.shape)} != "
                             f"{(n_iters, jj, s_slots)}")
        lm = lm[:, mine]
        from ..faults.comm import FaultyComm   # faults import core

    mask = torch.ones((ln, s_slots), device=dev)
    mask[:, 0] = 1.0 if include_self else 0.0
    ops = SolverOps(kcross=kcross, k=k_loc, lam=lam, vec=vec.contiguous(),
                    mask=mask)
    state = AdmmState(alpha=alpha, b=b, g=torch.zeros_like(b),
                      znorm2=torch.zeros((ln,), device=dev), t=int(t0),
                      rho=torch.zeros((ln, s_slots), device=dev))
    ahist, rhist, zhist = [], [], []
    for t in range(n_iters):
        rho_slots = slot_rho(mask, rho_self, rho2.at(t0 + t))
        if lm is None:
            state, res = admm_step(ops, comm, state, rho_slots, project)
        else:
            state, res = admm_step(ops, FaultyComm(comm, lm[t]), state,
                                   rho_slots, project, slot_mask=lm[t])
        ahist.append(state.alpha)
        rhist.append(res)
        zhist.append(state.znorm2)
    if ledger is not None:
        ledger.add_iterations(n_iters)
    return DistDkpcaResult(
        alpha=_gather(state.alpha, 0, group),
        alpha_hist=_gather(torch.stack(ahist), 1, group),
        primal_residual=torch.stack(rhist),
        znorm2_hist=_gather(torch.stack(zhist), 1, group),
        b=_gather(state.b, 0, group))


__all__ = ["DistDkpcaResult", "dkpca_distributed"]
