"""Seeded fault plans: WHAT fails, WHEN, deterministically (a copy of the
JAX package's ``faults.plan``, numpy only, so the port imports nothing of
``repro``).

A :class:`FaultPlan` is an immutable schedule of fault events, fixed before
the run starts (same seed ⇒ same faults ⇒ same trajectory, so a chaos test
can assert bitwise determinism). The plan is pure data — injection happens
in ``faults.comm`` (link-level), ``faults.driver`` (node dropout) and
``faults.serving`` (shard loss / publisher crash), all reading the same
plan.

Event vocabulary (see docs/FAULT_TOLERANCE.md for the schema):

- :class:`NodeDropout` — node ``node`` permanently leaves at iteration
  ``t``. The ADMM driver detects it at the next chunk boundary, re-knits
  the topology and shrinks the solver state to survivors.
- :class:`LinkFault` — messages on edge ``(u, v)`` are LOST for iterations
  ``t0 <= t < t1``. ``directed=True`` drops only ``u <- v`` (u stops
  hearing v); undirected drops both directions. A *delay* of ``d``
  iterations is modeled as loss over ``[t0, t0 + d)`` — the stale payload
  is censored rather than applied late, matching COKE-style censored
  communication (the receiver renormalizes over slots actually heard).
- :class:`StragglerStall` — node ``node`` is unresponsive for
  ``t0 <= t < t1``: loss on every incident edge, both directions, for the
  window. The stalled node itself keeps iterating on its own data.
- :class:`ShardLoss` — serving-side: shard ``shard`` becomes unreachable
  at the ``at_dispatch``-th engine dispatch (0-based: ``at_dispatch=0``
  fails the first batch).
- :class:`PublisherCrash` — the ``at_job``-th publish/refresh job raises
  :class:`~repro_torch.faults.errors.InjectedCrashError`.

Iteration-level events compile to a dense per-iteration *link mask* via
:meth:`FaultPlan.link_mask` — shape ``(n_iters, J, S)`` float32 in
{0, 1}, aligned with the solver's slot tables (slot 0 = self, slots
1.. = neighbors). Slot 0 is never masked: a node that cannot talk to
itself is a dropout, not a link fault.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np


@dataclasses.dataclass(frozen=True)
class NodeDropout:
    t: int
    node: int


@dataclasses.dataclass(frozen=True)
class LinkFault:
    t0: int
    t1: int
    u: int
    v: int
    directed: bool = False


@dataclasses.dataclass(frozen=True)
class StragglerStall:
    t0: int
    t1: int
    node: int


@dataclasses.dataclass(frozen=True)
class ShardLoss:
    at_dispatch: int
    shard: int


@dataclasses.dataclass(frozen=True)
class PublisherCrash:
    at_job: int


_EVENT_TYPES = {
    "dropouts": NodeDropout,
    "links": LinkFault,
    "stragglers": StragglerStall,
    "shard_losses": ShardLoss,
    "publisher_crashes": PublisherCrash,
}


def link_delay(t0: int, delay: int, u: int, v: int,
               directed: bool = False) -> LinkFault:
    """A link delay of ``delay`` iterations == censoring for that window."""
    return LinkFault(t0=t0, t1=t0 + delay, u=u, v=v, directed=directed)


def ring_slot_tables(j_nodes: int, hops: int):
    """(src, mask) routing tables in the SPMD ring slot layout.

    The JAX package's ``core.dkpca`` orders neighbor slots by
    ``ring_shifts(hops)`` (offsets [-r..-1, 1..r]), which differs from the
    dense setup's ``graph.nbr`` ordering — compile a mask with THESE tables
    for a ring transport.
    """
    from ..core.topology import ring_shifts
    offsets = ring_shifts(hops)
    src = np.empty((j_nodes, len(offsets) + 1), np.int32)
    src[:, 0] = np.arange(j_nodes)
    for i, o in enumerate(offsets):
        src[:, i + 1] = (np.arange(j_nodes) + o) % j_nodes
    return src, np.ones_like(src, np.float32)


@dataclasses.dataclass(frozen=True)
class FaultPlan:
    """Immutable, seed-stamped schedule of faults for one run."""

    seed: int = 0
    dropouts: Tuple[NodeDropout, ...] = ()
    links: Tuple[LinkFault, ...] = ()
    stragglers: Tuple[StragglerStall, ...] = ()
    shard_losses: Tuple[ShardLoss, ...] = ()
    publisher_crashes: Tuple[PublisherCrash, ...] = ()

    # -- schedule views ---------------------------------------------------

    def dropout_schedule(self) -> List[Tuple[int, Tuple[int, ...]]]:
        """Sorted ``[(t, (nodes dropping at t, ...)), ...]``."""
        by_t: Dict[int, List[int]] = {}
        for d in self.dropouts:
            by_t.setdefault(int(d.t), []).append(int(d.node))
        return [(t, tuple(sorted(ns))) for t, ns in sorted(by_t.items())]

    def dead_after(self, t: int) -> Tuple[int, ...]:
        """Original node ids dead strictly before iteration ``t`` runs."""
        return tuple(sorted(int(d.node) for d in self.dropouts
                            if int(d.t) <= t))

    # -- link-mask compilation --------------------------------------------

    def link_mask(self, src: np.ndarray, mask: np.ndarray,
                  t0: int, t1: int,
                  node_ids: Optional[Sequence[int]] = None) -> np.ndarray:
        """Compile link events into a per-iteration slot mask.

        ``src``/``mask`` are the solver's ``(J, S)`` routing tables
        (``src[j, s]`` = node index whose columns land in node j's slot s;
        ``mask[j, s]`` = structural slot validity). ``node_ids`` maps the
        current row index to the ORIGINAL node id (after a re-knit the
        survivor table is re-indexed but the plan still speaks original
        ids); ``None`` means identity.

        Returns ``(t1 - t0, J, S)`` float32 with 0 where a message is
        censored at iteration ``t0 + i``. Slot 0 (self) is never censored,
        and structurally-invalid slots stay 0-masked upstream so their
        value here is irrelevant.
        """
        src = np.asarray(src)
        j, s = src.shape
        ids = (np.arange(j) if node_ids is None
               else np.asarray(node_ids, dtype=np.int64))
        if len(ids) != j:
            raise ValueError(f"node_ids has {len(ids)} entries for {j} rows")
        id_of_row = ids                       # row -> original id
        row_of_id = {int(v): r for r, v in enumerate(ids)}
        out = np.ones((t1 - t0, j, s), np.float32)

        def censor(t_a: int, t_b: int, u: int, v: int) -> None:
            """Drop u <- v (receiver u stops hearing sender v)."""
            ru = row_of_id.get(int(u))
            rv = row_of_id.get(int(v))
            if ru is None or rv is None:
                return                        # endpoint already dropped out
            lo, hi = max(t_a, t0), min(t_b, t1)
            if lo >= hi:
                return
            slots = np.nonzero(src[ru, 1:] == rv)[0] + 1
            out[lo - t0:hi - t0, ru, slots] = 0.0

        for lf in self.links:
            censor(lf.t0, lf.t1, lf.u, lf.v)
            if not lf.directed:
                censor(lf.t0, lf.t1, lf.v, lf.u)
        for st in self.stragglers:
            for other in id_of_row:
                if int(other) == int(st.node):
                    continue
                censor(st.t0, st.t1, int(other), int(st.node))
                censor(st.t0, st.t1, int(st.node), int(other))
        out *= np.asarray(mask, np.float32)[None, :, :]
        out[:, :, 0] = 1.0                    # self slot is never censored
        return out

    def has_link_faults(self, t0: int, t1: int) -> bool:
        win = [(e.t0, e.t1) for e in self.links]
        win += [(e.t0, e.t1) for e in self.stragglers]
        return any(a < t1 and b > t0 for a, b in win)

    # -- (de)serialization -------------------------------------------------

    def to_dict(self) -> dict:
        d: dict = {"seed": int(self.seed)}
        for key in _EVENT_TYPES:
            events = getattr(self, key)
            if events:
                d[key] = [dataclasses.asdict(e) for e in events]
        return d

    @classmethod
    def from_dict(cls, d: dict) -> "FaultPlan":
        kw: dict = {"seed": int(d.get("seed", 0))}
        for key, typ in _EVENT_TYPES.items():
            kw[key] = tuple(typ(**e) for e in d.get(key, ()))
        return cls(**kw)

    # -- seeded generation -------------------------------------------------

    @classmethod
    def random(cls, seed: int, n_nodes: int, n_iters: int, *,
               n_dropouts: int = 0, n_link_faults: int = 0,
               n_stragglers: int = 0, max_window: int = 5,
               protect: Iterable[int] = (),
               t_min: int = 1) -> "FaultPlan":
        """Deterministic plan from a seed (same args ⇒ identical plan).

        Dropout times land in ``[t_min, n_iters)`` and dropped nodes are
        distinct, never in ``protect``, and never a majority — at least
        ``n_nodes - n_dropouts >= 2`` nodes must survive.
        """
        if n_nodes - n_dropouts < 2:
            raise ValueError("a fault plan must leave >= 2 survivors")
        rng = np.random.default_rng(seed)
        protected = set(int(p) for p in protect)
        pool = [n for n in range(n_nodes) if n not in protected]
        victims = rng.choice(pool, size=n_dropouts, replace=False) \
            if n_dropouts else np.empty(0, np.int64)
        dropouts = tuple(
            NodeDropout(t=int(rng.integers(t_min, max(n_iters, t_min + 1))),
                        node=int(v))
            for v in sorted(int(v) for v in victims))
        live = [n for n in range(n_nodes)
                if n not in {d.node for d in dropouts}]
        links = []
        for _ in range(n_link_faults):
            u, v = rng.choice(live, size=2, replace=False)
            t_a = int(rng.integers(t_min, max(n_iters, t_min + 1)))
            links.append(LinkFault(
                t0=t_a, t1=t_a + int(rng.integers(1, max_window + 1)),
                u=int(u), v=int(v),
                directed=bool(rng.integers(0, 2))))
        stragglers = []
        for _ in range(n_stragglers):
            t_a = int(rng.integers(t_min, max(n_iters, t_min + 1)))
            stragglers.append(StragglerStall(
                t0=t_a, t1=t_a + int(rng.integers(1, max_window + 1)),
                node=int(rng.choice(live))))
        return cls(seed=int(seed), dropouts=dropouts,
                   links=tuple(links), stragglers=tuple(stragglers))


__all__ = [
    "FaultPlan", "NodeDropout", "LinkFault", "StragglerStall",
    "ShardLoss", "PublisherCrash", "link_delay",
]
