"""Shared ADMM solver layer (port of ``repro.core.solver``): one step body,
two transports.

  * ``AdmmState`` — the full iterate (alpha, dual B, last z projections G,
    per-node ||z_hat||^2, iteration counter, per-slot rho), checkpointable
    via ``save_state``/``load_state`` in the JAX package's layout;
  * ``admm_step`` — ONE iteration (paper eq. 10-13 in the per-slot-rho
    generalization, with ``slot_mask`` censoring and hold-when-isolated),
    written against a communicator: ``DenseComm`` (all J nodes on one
    device, exchange by (src, rsl) indexing) or ``RingComm`` (the ring's
    nodes split in blocks over the ranks of a ``torch.distributed`` group,
    exchange by neighbour shifts; ``repro_torch.core.dkpca``). The node
    axis is a written-out batch dimension where the JAX package ``vmap``s.
    Its eq. 12-13 block is the fused local update
    (``repro_torch.kernels.admm_step``): one kernel launch for all of a
    device's nodes on the card;
  * ``run_chunked`` — the resumable driver: a Python loop over iterations
    (the JAX package's jitted ``scan``) that yields the live state every
    ``chunk`` iterations, with residual-based early stopping,
    checkpointing, communication accounting (``repro_torch.obs.CommLedger``)
    and per-iteration link masks (compiled from a
    ``repro_torch.faults.FaultPlan``).

Everything stays on the setup's device; the host reads a value only for the
early-stop test.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Callable, Iterator, List, Optional, Sequence, Union

import numpy as np
import torch
import torch.distributed as dist

from ..device import DeviceLike, resolve_device
from ..obs import metrics, trace
from ..obs.comm import CommLedger
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
    (src, rsl) slot routing tables.

    Communication accounting (``repro_torch.obs.comm``): the driver counts
    the off-node routing entries (the directed edges an exchange moves data
    over) on the host and passes them in as ``wire_entries``; each
    ``exchange`` then reports NETWORK-WIDE payload bytes into the ledger.
    """

    def __init__(self, src: torch.Tensor, rsl: torch.Tensor,
                 ledger: Optional[CommLedger] = None,
                 wire_entries: int = 0):
        self.src, self.rsl = src, rsl
        self.ledger = ledger
        self.wire_entries = wire_entries

    def local(self, fn: Callable) -> Callable:
        """Per-node math: written batched over the leading node axis here
        (the JAX package ``vmap``s it), so ``fn`` applies as it is."""
        return fn

    def exchange(self, cols: torch.Tensor) -> torch.Tensor:
        """cols: (J, S, N) per-out-slot columns -> (J, S, N) where in-slot s
        of node j receives cols[src[j,s], rsl[j,s]]."""
        if self.ledger is not None:
            payload = cols.shape[-1] * cols.element_size()
            self.ledger.record_exchange(self.wire_entries * payload,
                                        self.wire_entries)
        return cols[self.src, self.rsl]

    def all_sum(self, x: torch.Tensor) -> torch.Tensor:
        return torch.sum(x)

    def all_max(self, x: torch.Tensor) -> torch.Tensor:
        return torch.max(x)


def check_backend(backend: str, device: torch.device) -> None:
    """A ring's process group must suit its tensors: NCCL for CUDA
    tensors, gloo for CPU ones. Anything else raises."""
    want = "nccl" if device.type == "cuda" else "gloo"
    if str(backend).lower() != want:
        raise ValueError(f"a {backend!r} process group cannot carry "
                         f"{device.type} tensors: the ring needs {want!r}")


class RingComm:
    """The ring transport over ``torch.distributed``: the J nodes of a ring
    split into contiguous blocks, rank r holding nodes r*L .. r*L+L-1 (the
    leading axis of every per-node tensor), and exchange == one shift per
    neighbour offset. On one rank (L == J) the whole ring is indexing; with
    one node a rank it is the JAX package's one node per device.

    Each exchange moves everything that crosses ranks in ONE
    ``batch_isend_irecv`` (all offsets together, one contiguous buffer per
    peer and direction); every rank posts its sends and receives in that
    batch, so NCCL's first batched call has the whole group. The columns
    that stay on the rank are indexed.

    message_dtype (e.g. torch.bfloat16) casts neighbour payloads before the
    wire and widens them to fp32 after; columns that stay on the rank take
    the same round trip, so a result does not depend on the layout. The
    self slot and all accumulation stay fp32.

    Communication accounting (``repro_torch.obs.comm``): the ledger
    records ONE node's logical egress, as the JAX package's ``RingComm``
    does inside ``shard_map``: each neighbour shift N * itemsize(wire) bytes
    and one message, each ``all_sum``/``all_max`` one collective of a
    scalar; whatever the layout (8 x 1 and 4 x 2 give the same ledger).
    ``all_sum`` is an all-gather of the nodes' values and one sum in global
    node order (the same bits at every layout); it counts as the one
    collective the JAX package's ``psum`` is.
    Multiply by J for network totals.
    """

    def __init__(self, n_nodes: int, offsets: Sequence[int],
                 rev_slots: Sequence[int], group=None,
                 device: DeviceLike = "cuda", message_dtype=None,
                 ledger: Optional[CommLedger] = None):
        self.device = resolve_device(device)
        check_backend(dist.get_backend(group), self.device)
        self.group = group
        self.world = dist.get_world_size(group)
        self.rank = dist.get_rank(group)
        if n_nodes % self.world:
            raise ValueError(f"{n_nodes} nodes do not split evenly over "
                             f"{self.world} ranks")
        self.n_nodes = n_nodes
        self.n_local = n_nodes // self.world
        self.offsets = tuple(offsets)
        self.rev_slots = tuple(rev_slots)
        self.message_dtype = message_dtype
        self.ledger = ledger
        self._routes = {}

    @property
    def first_node(self) -> int:
        """Global index of this rank's first node."""
        return self.rank * self.n_local

    def local(self, fn: Callable) -> Callable:
        """Per-node math, batched over the rank's L nodes, in its
        batch-invariant form (``rows=True``): its products summed along
        contiguous rows, so a node's result has the same bits whatever the
        number of nodes its rank holds (see ``_rowdot``)."""
        return functools.partial(fn, rows=True)

    def _route(self, offsets: tuple):
        """Index tensors for shifting values by ``offsets``: (offset, node)
        pairs that stay on the rank (receiver and sender), and per peer
        rank the pairs sent to it and received from it, in one order both
        ends agree on (offset, then the receiver's local index)."""
        if offsets in self._routes:
            return self._routes[offsets]
        j, ln, r0 = self.n_nodes, self.n_local, self.first_node
        stay_to, stay_from = [], []
        sends, recvs = {}, {}
        for d, o in enumerate(offsets):
            for l in range(ln):
                src = (r0 + l + o) % j              # receiver l hears src
                if src // ln == self.rank:
                    stay_to.append((d, l))
                    stay_from.append((d, src % ln))
                else:
                    recvs.setdefault(src // ln, []).append((d, l))
                dst = (r0 + l - o) % j              # l is heard by dst
                if dst // ln != self.rank:
                    sends.setdefault(dst // ln, []).append(
                        ((d, dst % ln), (d, l)))

        def idx(pairs):
            t = torch.as_tensor(pairs, dtype=torch.long,
                                device=self.device).reshape(-1, 2)
            return t[:, 0], t[:, 1]

        peers = [(p, idx([s for _, s in sorted(sends.get(p, []))]),
                  idx(recvs.get(p, []))) for p in sorted({*sends, *recvs})]
        route = (idx(stay_to), idx(stay_from), peers)
        self._routes[offsets] = route
        return route

    def shift(self, v: torch.Tensor, offsets: Sequence[int],
              wire_dtype=None) -> torch.Tensor:
        """v: (D, L, ...) — row d the value each of this rank's nodes sends
        at offset d — -> (D, L, ...) with out[d, l] = v[d] of global node
        (first_node + l + offsets[d]) % J, in fp32 (cast to ``wire_dtype``
        for the trip when one is given). Records one message of one node's
        row per offset."""
        offsets = tuple(offsets)
        if self.ledger is not None:
            per_node = v[0, 0].numel() * (
                v.element_size() if wire_dtype is None
                else torch.empty((), dtype=wire_dtype).element_size())
            for _ in offsets:
                self.ledger.record_exchange(per_node)
        wire = v if wire_dtype is None else v.to(wire_dtype)
        (to_d, to_l), (from_d, from_l), peers = self._route(offsets)
        out = torch.empty(v.shape, dtype=torch.float32, device=v.device)
        out[to_d, to_l] = wire[from_d, from_l].float()
        if not peers:
            return out
        ops, landing = [], []
        for peer, (sd, sl), (rd, rl) in peers:
            to = peer if self.group is None else \
                dist.get_global_rank(self.group, peer)
            if sd.numel():
                ops.append(dist.P2POp(dist.isend, wire[sd, sl].contiguous(),
                                      to, self.group))
            if rd.numel():
                buf = torch.empty((rd.numel(),) + tuple(v.shape[2:]),
                                  dtype=wire.dtype, device=v.device)
                ops.append(dist.P2POp(dist.irecv, buf, to, self.group))
                landing.append((rd, rl, buf))
        for req in dist.batch_isend_irecv(ops):
            req.wait()
        for rd, rl, buf in landing:
            out[rd, rl] = buf.float()
        return out

    def exchange(self, cols: torch.Tensor) -> torch.Tensor:
        """cols: (L, S, N) per-out-slot columns -> (L, S, N): in-slot 0 is
        self; in-slot d+1 (offset o) of global node m receives column
        rev_slots[d] of node (m + o) % J (its out-slot pointing back)."""
        sent = cols[:, list(self.rev_slots)].transpose(0, 1)    # (D, L, N)
        recv = self.shift(sent, self.offsets, self.message_dtype)
        return torch.cat([cols[:, :1], recv.transpose(0, 1)], dim=1)

    def _reduce(self, x: torch.Tensor, local, op) -> torch.Tensor:
        if self.ledger is not None:
            self.ledger.record_collective(x.element_size())
        out = local(x).reshape(1)
        dist.all_reduce(out, op=op, group=self.group)
        return out[0]

    def all_sum(self, x: torch.Tensor) -> torch.Tensor:
        """Sum of every node's value in x (L,) over the ring: the J values
        all-gathered in global node order into one buffer (copied into it
        at world 1) and summed by one ``torch.sum``, the same kernel on the
        same J values at every layout, so the same bits; an all-reduce
        would add the ranks' partial sums in its own order."""
        if self.ledger is not None:
            self.ledger.record_collective(x.element_size())
        x = x.reshape(-1).contiguous()
        parts = x.new_empty((self.world * x.numel(),))
        if self.world > 1:
            dist.all_gather_into_tensor(parts, x, group=self.group)
        else:
            parts.copy_(x)
        return torch.sum(parts)

    def all_max(self, x: torch.Tensor) -> torch.Tensor:
        """Max of every node's value in x (L,) over the ring."""
        return self._reduce(x, torch.max, dist.ReduceOp.MAX)


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


def _row_sum(x: torch.Tensor) -> torch.Tensor:
    """Sum over the last dim in an order set by its length alone: rows of
    32 (zero-padded) summed, then those sums in rows of 32, and so on. A
    ``torch.sum`` over contiguous rows of K picks its threads per row by
    K and by the number of rows; with rows of 32 or fewer it takes the
    row's length whatever the number of rows."""
    while x.shape[-1] > 32:
        x = torch.nn.functional.pad(x, (0, -x.shape[-1] % 32))
        x = torch.sum(x.reshape(*x.shape[:-1], -1, 32), dim=-1)
    return torch.sum(x, dim=-1)


def _rowdot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(J, P, K) x (J, Q, K) -> (J, P, Q): sum over k of a[j, p, k]
    b[j, q, k], as products summed by ``_row_sum``. A node's sums then have
    the same bits whatever J is, where cuBLAS picks a batched product's
    kernel, and with it the order of each sum, by the batch count (checked
    on the card at the probe ring's and the ring fit's shapes:
    ``scripts/ring_batch_bits.py``). The products take a (J, P, Q, K)
    temporary."""
    return _row_sum(a.contiguous()[:, :, None] * b.contiguous()[:, None])


def _sym_apply(vec: torch.Tensor, scale: torch.Tensor, x: torch.Tensor,
               rows: bool = False) -> torch.Tensor:
    """V diag(scale) V^T x per node: vec (J, N, N), scale (J, N),
    x (J, N, S); ``rows``: through ``_rowdot``."""
    if not rows:
        return vec @ ((vec.transpose(1, 2) @ x) * scale[..., None])
    y = _rowdot(vec.transpose(1, 2), x.transpose(1, 2)) * scale[..., None]
    return _rowdot(vec, y.transpose(1, 2))


def _kcross_apply(kcross: torch.Tensor, c: torch.Tensor,
                  rows: bool = False) -> torch.Tensor:
    """(J, S, N): sum over in-slots b of K(a, b) c_b per node; ``rows``:
    through ``_rowdot`` on the (J, S*N, S*N) slot Gram."""
    if not rows:
        return torch.einsum("jabnm,jbm->jan", kcross, c)
    j, s, _, n, _ = kcross.shape
    k2 = kcross.permute(0, 1, 3, 2, 4).reshape(j, s * n, s * n)
    return _rowdot(k2, c.reshape(j, 1, s * n)).reshape(j, s, n)


def _znorm2(c: torch.Tensor, kc: torch.Tensor,
            rows: bool = False) -> torch.Tensor:
    """(J,): c^T K c per node; ``rows``: through ``_rowdot``."""
    if not rows:
        return torch.einsum("jan,jan->j", c, kc)
    j = c.shape[0]
    return _rowdot(c.reshape(j, 1, -1), kc.reshape(j, 1, -1))[:, 0, 0]


def _res_part(mask: torch.Tensor, diff: torch.Tensor,
              rows: bool = False) -> torch.Tensor:
    """(J,): each node's masked squared consensus residual; ``rows``:
    through ``_row_sum``."""
    sq = mask[:, None, :] * diff * diff
    if not rows:
        return torch.sum(sq, dim=(1, 2))
    return _row_sum(sq.reshape(sq.shape[0], -1))


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


def admm_step(ops: SolverOps, comm, state: AdmmState,
              rho_slots: torch.Tensor, project: str = "ball",
              slot_mask: Optional[torch.Tensor] = None):
    """One ADMM iteration (paper eq. 10-13, per-slot-rho generalization).

    Args:
      ops: per-node constants.
      comm: transport (``DenseComm``, or a ``FaultyComm`` around one); a
        ledger on it records this iteration's traffic between
        ``begin_iteration`` and ``end_iteration``.
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
    ledger = getattr(comm, "ledger", None)
    if ledger is not None:
        ledger.begin_iteration()
    faulty = slot_mask is not None
    if faulty:
        ops = dataclasses.replace(ops, mask=ops.mask * slot_mask)
        rho_slots = rho_slots * slot_mask
    alpha, b = state.alpha, state.b
    mask = ops.mask                                          # (J, S)
    n_slots = b.shape[2]

    # ---- message round 1: K^-1 B columns + alpha --------------------------
    # (comm.local: the products in their batch-invariant form on the ring,
    # as batched products on the dense transport)
    m1 = comm.local(_sym_apply)(ops.vec, _pinv_lam(ops.lam), b)  # (J, N, S)
    recv_m1 = comm.exchange(m1.transpose(1, 2))              # (J, S, N)
    recv_a = comm.exchange(alpha[:, None, :].expand(-1, n_slots, -1))

    # ---- Z-update (eq. 10-11) --------------------------------------------
    rho_bar = torch.sum(rho_slots, dim=-1)                   # (J,)
    if faulty:
        # fully-censored node: avoid 0/0 (its update is discarded below)
        rho_bar = torch.clamp(rho_bar, min=1e-30)
    c = ((recv_m1 + rho_slots[..., None] * recv_a)
         / rho_bar[:, None, None]) * mask[..., None]         # (J, S, N)
    kc = comm.local(_kcross_apply)(ops.kcross, c)
    znorm2 = comm.local(_znorm2)(c, kc)
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
    res_part = comm.local(_res_part)(mask, diff)
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

    new_state = AdmmState(alpha=alpha_n, b=b_n, g=g, znorm2=znorm2,
                          t=state.t + 1, rho=rho_slots)
    if ledger is not None:
        ledger.end_iteration()
    return new_state, res


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
              rho1s: List[float], rho2s: List[float], project: str,
              link_mask: Optional[torch.Tensor] = None):
    """``len(rho2s)`` iterations from ``state`` (the JAX package's scan
    body as a Python loop). ``link_mask`` (T, J, S) {0,1}, or None:
    row i censors iteration i's links, at the transport (``FaultyComm``)
    and in the consensus (``admm_step(slot_mask=...)``). Returns (state,
    alpha_hist (T, J, N), lagrangian (T,), primal_residual (T,))."""
    if link_mask is not None:
        from ..faults.comm import FaultyComm
    ahist, lhist, rhist = [], [], []
    for i, (rho1, rho2) in enumerate(zip(rho1s, rho2s)):
        rho_slots = slot_rho(ops.mask, rho1, rho2)
        with trace.span("solver.iter"):
            if link_mask is None:
                new, res = admm_step(ops, comm, state, rho_slots, project)
            else:
                sm = link_mask[i]
                new, res = admm_step(ops, FaultyComm(comm, sm), state,
                                     rho_slots, project, slot_mask=sm)
        # Theorem-2 pairing: L(alpha^t, Z^t, eta^t) with Z^t generated from
        # the incoming (alpha^t, eta^t) — i.e. this step's g.
        with trace.span("solver.lagrangian"):
            lhist.append(lagrangian(ops, state.alpha, state.b, new.g,
                                    rho_slots))
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
    # communication accounting for THIS chunk (0 without a ledger):
    # point-to-point payload bytes / messages moved by its iterations
    comm_bytes: int = 0
    comm_messages: int = 0


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


def resolve_refresh_policy(policy) -> object:
    """Normalize a refresh-cadence spec to a policy object: an int (every k
    chunks), the string "residual" (``ResidualImprovement`` defaults), any
    object already exposing ``should_refresh``, a bare ``ChunkResult ->
    bool`` callable, or None (every chunk)."""
    if policy is None:
        return EveryK(1)
    if isinstance(policy, int):
        return EveryK(policy)
    if isinstance(policy, str):
        if policy != "residual":
            raise ValueError(f"unknown refresh policy {policy!r}")
        return ResidualImprovement()
    if hasattr(policy, "should_refresh"):
        return policy
    if callable(policy):
        class _Fn:
            def should_refresh(self, chunk, _fn=policy):
                return bool(_fn(chunk))
        return _Fn()
    raise TypeError(f"cannot interpret refresh policy {policy!r}")


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
                ckpt_dir: Optional[str] = None, ckpt_every: int = 1,
                ledger: Optional[CommLedger] = None,
                link_mask: Optional[np.ndarray] = None
                ) -> Iterator[ChunkResult]:
    """Resumable chunked driver for Alg. 1 over the dense transport.

    Runs ``chunk`` iterations per step of the generator and yields a
    ``ChunkResult`` after each, so callers can observe, checkpoint, re-tune
    or publish mid-run. Arguments as in ``repro.core.solver.run_chunked``:

      ledger: a ``repro_torch.obs.CommLedger`` to account each iteration's
        communication into (network-wide bytes for this dense transport);
        each yielded chunk then carries ``comm_bytes``/``comm_messages``.
      link_mask: optional ``(n_iters, J, S)`` {0,1} array censoring links
        per ABSOLUTE iteration index (``FaultPlan.link_mask``); row t is
        applied at iteration t through ``admm_step(slot_mask=...)`` and a
        transport-level ``FaultyComm``.

    Iterations run one at a time, so the trajectory does not depend on
    ``chunk``. Advance it from one thread.
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
    if link_mask is not None:
        link_mask = np.asarray(link_mask, np.float32)
        j, s = setup.src.shape
        if link_mask.shape != (n_iters, j, s):
            raise ValueError(
                f"link_mask shape {link_mask.shape} != {(n_iters, j, s)}")
    if ledger is not None:
        # Off-node routing entries = directed edges one exchange moves data
        # over: slot s of node j is remote iff its source is another node
        # AND the slot is valid. Counted on the host from the setup tables.
        src_np = setup.src.cpu().numpy()
        own = np.arange(src_np.shape[0], dtype=src_np.dtype)[:, None]
        wire = int(np.sum((src_np != own) & setup.mask.cpu().numpy()))
        comm = DenseComm(setup.src, setup.rsl, ledger, wire)

    m_iters = metrics.counter(
        "solver_iterations_total", "ADMM iterations executed",
        transport="dense")
    m_chunks = metrics.counter(
        "solver_chunks_total", "driver chunks yielded", transport="dense")
    m_bytes = metrics.counter(
        "comm_bytes_total", "point-to-point ADMM payload bytes",
        transport="dense")
    m_res = metrics.gauge(
        "solver_primal_residual", "last observed primal residual")

    t = state.t
    chunk_idx = 0
    while t < n_iters:
        c = min(chunk, n_iters - t)
        with trace.span("solver.rho2", t=t, steps=c):
            rho2s = [float(rho2_fn(tt)) for tt in range(t, t + c)]
        lm_chunk = None
        if link_mask is not None:
            lm_chunk = torch.as_tensor(link_mask[t:t + c],
                                       device=setup.device)
        # The span times the launches; the card runs them asynchronously
        # (it is awaited where a host value is read, e.g. the residual).
        with trace.span("solver.step", t=t, steps=c):
            state, ahist, lhist, rhist = run_steps(
                ops, comm, state, [rho1_eff] * c, rho2s, project,
                link_mask=lm_chunk)
        t += c
        chunk_idx += 1
        comm_bytes = comm_msgs = 0
        if ledger is not None:
            ledger.add_iterations(c)
            per = ledger.per_iter
            comm_bytes, comm_msgs = per.bytes * c, per.messages * c
            m_bytes.inc(comm_bytes)
        m_iters.inc(c)
        m_chunks.inc()
        stopped = False
        if tol > 0.0:
            with trace.span("solver.residual", t=t):
                res_last = float(rhist[-1])
            m_res.set(res_last)
            stopped = res_last < tol
        ckpt_path = None
        if ckpt_dir and (chunk_idx % ckpt_every == 0 or t >= n_iters
                         or stopped):
            with trace.span("solver.checkpoint", t=t):
                ckpt_path = save_state(ckpt_dir, state)
        yield ChunkResult(
            state=state, alpha_hist=ahist, lagrangian=lhist,
            primal_residual=rhist,
            rho_hist=torch.tensor(rho2s, dtype=torch.float32),
            ckpt_path=ckpt_path, stopped=stopped, comm_bytes=comm_bytes,
            comm_messages=comm_msgs)
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
    "RingComm", "SolverOps", "admm_step", "check_backend", "dense_parts",
    "init_state",
    "inverse_denominators", "lagrangian",
    "load_state", "resolve_refresh_policy", "resolve_rho2", "run_chunked",
    "run_steps", "save_state", "slot_rho",
]
