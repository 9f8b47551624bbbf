"""Fault-tolerant ADMM driver: survive what the plan injects (port of the
JAX package's ``faults.driver``).

Wraps the chunked driver (``repro_torch.core.solver.run_chunked``) in fault
semantics read off a :class:`~repro_torch.faults.plan.FaultPlan`:

- **Link loss / delay / straggler stalls** compile to a per-iteration link
  mask (``plan.link_mask``) that ``run_chunked`` threads into every
  ``admm_step`` — the COKE-style censored update: received columns are
  zeroed at the transport (``FaultyComm``), ``rho_bar`` renormalizes over
  the slots actually heard, and censored duals freeze. No restart, no
  topology change.

- **Node dropout at iteration t** is detected at a chunk boundary: the
  driver clamps the running segment at t, re-knits the topology
  (``core.topology.reknit``), shrinks the live ``AdmmState`` to the
  survivors (:func:`shrink_state` — the carried (alpha, B) IS the warm
  z-start; ``t`` keeps counting), rebuilds the Gram setup on survivor data
  with the ORIGINAL gamma pinned, and continues.

Everything runs on ``device`` (the card unless the caller passes
``device="cpu"``); the host holds only the topology and the plan. Single-
threaded (the same concurrency contract as ``run_chunked``); fault
accounting — ``fault.injected`` instants, ``faults_injected_total`` /
``reknit_total`` counters, ``fault.recovery`` spans — happens here.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Iterator, List, Optional, Tuple

import numpy as np
import torch

from ..core import topology
from ..core.admm import build_setup, initial_alpha
from ..core.solver import AdmmState, ChunkResult, init_state, run_chunked
from ..device import DeviceLike, as_f32, resolve_device
from ..obs import metrics, trace
from .plan import FaultPlan

# module-level cached handles: the loop must not allocate new metric
# identities per call (same contract as serve/kpca_engine.py)
_M_INJECTED_DROPOUT = metrics.counter(
    "faults_injected_total", "fault events activated", kind="dropout")
_M_INJECTED_LINK = metrics.counter(
    "faults_injected_total", "fault events activated", kind="link")
_M_INJECTED_STRAGGLER = metrics.counter(
    "faults_injected_total", "fault events activated", kind="straggler")
_M_REKNIT = metrics.counter(
    "reknit_total", "topology re-knits after node dropout")


@dataclasses.dataclass(frozen=True)
class FaultEventRecord:
    """Host-side record of one applied fault (for tests/reports)."""
    kind: str
    t: int
    detail: dict


def shrink_state(state: AdmmState, old_graph: topology.Graph,
                 new_graph: topology.Graph,
                 survivors: np.ndarray) -> AdmmState:
    """Map a live ``AdmmState`` onto the re-knit survivor topology, on the
    state's device.

    ``survivors[new_row] = old_row`` (``reknit``'s second return). The
    warm content carries over exactly where the constraint survived:

    - ``alpha``/``znorm2``: survivor rows, unchanged.
    - ``b``/``g`` slot columns: survivor self slot 0 copies over; a
      neighbor slot copies iff that edge existed before the re-knit
      (matched by ORIGINAL node id); edges the re-knit invented start with
      zero dual/projection, exactly like iteration 0 of a fresh constraint.
    - ``rho``: zeroed — the driver refreshes per-slot rho every iteration.
    - ``t``: preserved. This is a continuation, not a restart.

    The slot map is worked out on the host from the two graphs; the state
    is gathered on its device, bit for bit.
    """
    surv = [int(v) for v in survivors]
    old_ids, _, old_mask = old_graph.neighbor_array()
    new_ids, _, new_mask = new_graph.neighbor_array()
    j2, d2 = new_ids.shape
    # old slot feeding each new slot, -1 where the new slot starts cold
    from_slot = np.full((j2, d2 + 1), -1, np.int64)
    from_slot[:, 0] = 0
    for nj, o in enumerate(surv):
        old_slot = {int(old_ids[o, d]): d + 1
                    for d in range(old_ids.shape[1]) if old_mask[o, d]}
        for d in range(d2):
            if new_mask[nj, d]:
                from_slot[nj, d + 1] = old_slot.get(
                    surv[int(new_ids[nj, d])], -1)
    dev = state.alpha.device
    rows = torch.as_tensor(surv, device=dev)
    n = state.alpha.shape[1]
    slots = torch.as_tensor(np.maximum(from_slot, 0), device=dev)
    slots = slots[:, None, :].expand(j2, n, d2 + 1)
    warm = torch.as_tensor(from_slot >= 0, device=dev)[:, None, :]

    def carry(x: torch.Tensor) -> torch.Tensor:
        got = torch.gather(x[rows], 2, slots)
        return torch.where(warm, got, torch.zeros_like(got))

    return AdmmState(alpha=state.alpha[rows], b=carry(state.b),
                     g=carry(state.g), znorm2=state.znorm2[rows], t=state.t,
                     rho=state.alpha.new_zeros((j2, d2 + 1)))


class FaultTolerantRun:
    """Chunked ADMM run that survives a :class:`FaultPlan`, on ``device``.

    Iterate :meth:`chunks` exactly like ``run_chunked``; between the
    yielded chunks the driver applies dropout recovery. Inspect after (or
    during) the run:

    - ``node_ids``: original id of each current row (survivor mapping).
    - ``graph`` / ``setup`` / ``state``: the live topology and iterate.
    - ``events``: ordered :class:`FaultEventRecord` list.
    - ``n_reknits``: recovery count (== number of dropout instants).
    """

    def __init__(self, x_nodes, graph: topology.Graph, spec, plan: FaultPlan,
                 n_iters: int = 30, chunk: int = 10,
                 center: str = "global", include_self: bool = True,
                 rho1: float = 100.0, rho2=None, project: str = "ball",
                 init: str = "local", seed: int = 0, tol: float = 0.0,
                 ckpt_dir: Optional[str] = None, ckpt_every: int = 1,
                 ledger=None, device: DeviceLike = "cuda"):
        self.device = resolve_device(device)
        self.x_nodes = as_f32(x_nodes, self.device)
        self.graph = graph
        self.spec = spec
        self.plan = plan
        self.n_iters = int(n_iters)
        self.chunk = int(chunk)
        self.kw = dict(rho1=rho1, rho2=rho2, project=project, tol=tol,
                       ckpt_dir=ckpt_dir, ckpt_every=ckpt_every,
                       ledger=ledger)
        self.center = center
        self.include_self = include_self
        self.init = init
        self.seed = int(seed)
        self.node_ids = np.arange(graph.n_nodes, dtype=np.int64)
        self.events: List[FaultEventRecord] = []
        self.n_reknits = 0
        self.setup = build_setup(self.x_nodes, graph, spec, center=center,
                                 include_self=include_self,
                                 device=self.device)
        self.gamma = float(self.setup.gamma)
        self.state: Optional[AdmmState] = None
        sched = plan.dropout_schedule()
        bad = [t for t, _ in sched if not 0 < t < self.n_iters]
        if bad:
            raise ValueError(f"dropout instants {bad} outside (0, n_iters)")

    # -- internals ---------------------------------------------------------

    def _segments(self) -> List[Tuple[int, Tuple[int, ...]]]:
        """``[(stop, nodes-dropping-at-stop), ...]`` covering [0, n_iters]."""
        segs = [(t, nodes) for t, nodes in self.plan.dropout_schedule()]
        segs.append((self.n_iters, ()))
        return segs

    def _segment_mask(self, stop: int) -> Optional[np.ndarray]:
        if not self.plan.has_link_faults(0, stop):
            return None
        return self.plan.link_mask(
            self.setup.src.cpu().numpy(), self.setup.mask.cpu().numpy(),
            0, stop, node_ids=self.node_ids)

    def _record(self, kind: str, t: int, counter, **detail) -> None:
        self.events.append(FaultEventRecord(kind=kind, t=t, detail=detail))
        counter.inc()
        if trace.is_enabled():
            trace.instant("fault.injected", kind=kind, t=t, **detail)

    def _recover(self, t: int, dead_ids: Tuple[int, ...]) -> None:
        """Re-knit + state shrink + setup rebuild — one recovery span."""
        t0 = time.perf_counter()
        dead_rows = [int(np.nonzero(self.node_ids == d)[0][0])
                     for d in dead_ids]
        old_graph = self.graph
        new_graph, surv_rows = topology.reknit(old_graph, dead_rows)
        self.state = shrink_state(self.state, old_graph, new_graph,
                                  surv_rows)
        self.node_ids = self.node_ids[np.asarray(surv_rows)]
        self.x_nodes = self.x_nodes[torch.as_tensor(
            np.asarray(surv_rows, np.int64), device=self.device)]
        self.graph = new_graph
        # Same gamma ⇒ same kernel operator on the survivor data; the
        # shrunk (alpha, B) is a warm z-start for the survivor consensus.
        self.setup = build_setup(self.x_nodes, new_graph, self.spec,
                                 center=self.center,
                                 include_self=self.include_self,
                                 gamma=self.gamma, device=self.device)
        self.n_reknits += 1
        _M_REKNIT.inc()
        if trace.is_enabled():
            trace.complete("fault.recovery", time.perf_counter() - t0,
                           kind="dropout", t=t, dead=list(dead_ids),
                           survivors=len(surv_rows))

    # -- the run -----------------------------------------------------------

    def chunks(self) -> Iterator[ChunkResult]:
        for lf in self.plan.links:
            self._record("link", lf.t0, _M_INJECTED_LINK, u=lf.u, v=lf.v,
                         t1=lf.t1, directed=lf.directed)
        for st_ev in self.plan.stragglers:
            self._record("straggler", st_ev.t0, _M_INJECTED_STRAGGLER,
                         node=st_ev.node, t1=st_ev.t1)
        if self.state is None:
            alpha0 = initial_alpha(self.setup, self.init, self.seed)
            self.state = init_state(alpha0, self.setup.n_slots)
        for stop, dead in self._segments():
            if self.state.t < stop:
                for res in run_chunked(
                        self.setup, n_iters=stop, chunk=self.chunk,
                        state=self.state,
                        link_mask=self._segment_mask(stop), **self.kw):
                    self.state = res.state
                    yield res
                    if res.stopped:
                        return
            if dead:
                self._record("dropout", stop, _M_INJECTED_DROPOUT,
                             nodes=list(dead))
                self._recover(stop, dead)

    def __iter__(self) -> Iterator[ChunkResult]:
        return self.chunks()


def run_chunked_with_faults(x_nodes, graph, spec, plan,
                            **kw) -> FaultTolerantRun:
    """Convenience constructor mirroring ``run_chunked``'s shape."""
    return FaultTolerantRun(x_nodes, graph, spec, plan, **kw)


__all__ = ["FaultEventRecord", "FaultTolerantRun", "run_chunked_with_faults",
           "shrink_state"]
