"""Network topologies for the decentralized consensus graph (pure numpy) —
a copy of ``repro.core.topology``.

The paper assumes a symmetric, undirected, connected graph G = (V, E)
(Assumption 1); its experiments use a ring where each node talks to the k
nearest nodes (k/2 on each side).
"""

from __future__ import annotations

import dataclasses
from typing import List, Sequence

import numpy as np


@dataclasses.dataclass(frozen=True)
class Graph:
    """Undirected graph with per-node ordered neighbor lists.

    nbr[j]  : ordered list of neighbor ids of node j (Omega_j).
    rev[j][d]: index of j within nbr[l] where l = nbr[j][d] (the "reverse
               slot"), needed to pick the right column of B_l = phi(X_l)^T eta_l.
    """

    n_nodes: int
    nbr: tuple  # tuple of tuples
    rev: tuple

    @property
    def degrees(self) -> np.ndarray:
        return np.array([len(o) for o in self.nbr], dtype=np.int32)

    @property
    def max_degree(self) -> int:
        return int(self.degrees.max())

    @property
    def is_regular(self) -> bool:
        d = self.degrees
        return bool((d == d[0]).all())

    def validate(self):
        for j, om in enumerate(self.nbr):
            if len(om) == 0:
                raise ValueError(f"node {j} has no neighbors (paper requires |Omega_j| >= 1)")
            if j in om:
                raise ValueError(f"node {j} lists itself as neighbor")
            for d, l in enumerate(om):
                if self.nbr[l][self.rev[j][d]] != j:
                    raise ValueError(f"rev-slot inconsistency at ({j},{l})")
        if not self.connected():
            raise ValueError("graph is not connected (Assumption 1 violated)")

    def connected(self) -> bool:
        seen = {0}
        stack = [0]
        while stack:
            u = stack.pop()
            for v in self.nbr[u]:
                if v not in seen:
                    seen.add(v)
                    stack.append(v)
        return len(seen) == self.n_nodes

    def neighbor_array(self, pad_to: int | None = None):
        """(J, D) int32 neighbor ids + (J, D) int32 reverse slots + (J, D)
        bool mask, padded with 0."""
        d_max = pad_to or self.max_degree
        j = self.n_nodes
        ids = np.zeros((j, d_max), np.int32)
        rev = np.zeros((j, d_max), np.int32)
        mask = np.zeros((j, d_max), bool)
        for u, om in enumerate(self.nbr):
            ids[u, : len(om)] = om
            rev[u, : len(om)] = self.rev[u]
            mask[u, : len(om)] = True
        return ids, rev, mask


def _build(n_nodes: int, nbr: List[List[int]]) -> Graph:
    rev = []
    for j, om in enumerate(nbr):
        rev.append(tuple(nbr[l].index(j) for l in om))
    g = Graph(n_nodes, tuple(tuple(o) for o in nbr), tuple(rev))
    g.validate()
    return g


def ring(n_nodes: int, hops: int = 1) -> Graph:
    """Ring where each node connects to ``hops`` nodes on each side
    (|Omega_j| = 2*hops). The paper's "4 closest neighbors" = ring(J, 2).
    Neighbor slot order is [-hops, ..., -1, +1, ..., +hops] (offsets mod J)."""
    if n_nodes < 2 * hops + 1:
        raise ValueError(f"ring({n_nodes}, hops={hops}) would double-connect")
    offs = list(range(-hops, 0)) + list(range(1, hops + 1))
    nbr = [[(j + o) % n_nodes for o in offs] for j in range(n_nodes)]
    return _build(n_nodes, nbr)


def ring_shifts(hops: int) -> List[int]:
    """Slot-ordered ring offsets matching ``ring`` neighbor order."""
    return list(range(-hops, 0)) + list(range(1, hops + 1))


def complete(n_nodes: int) -> Graph:
    nbr = [[q for q in range(n_nodes) if q != j] for j in range(n_nodes)]
    return _build(n_nodes, nbr)


def random_connected(n_nodes: int, extra_edge_prob: float = 0.2,
                     seed: int = 0) -> Graph:
    """Random connected graph: a ring(J,1) backbone + random chords."""
    rng = np.random.default_rng(seed)
    adj = np.zeros((n_nodes, n_nodes), bool)
    for j in range(n_nodes):
        adj[j, (j + 1) % n_nodes] = adj[(j + 1) % n_nodes, j] = True
    chords = rng.random((n_nodes, n_nodes)) < extra_edge_prob
    chords = np.triu(chords, 2)
    adj |= chords | chords.T
    np.fill_diagonal(adj, False)
    nbr = [sorted(np.nonzero(adj[j])[0].tolist()) for j in range(n_nodes)]
    return _build(n_nodes, nbr)


def from_adjacency(adj: np.ndarray) -> Graph:
    adj = np.asarray(adj, bool)
    if not (adj == adj.T).all():
        raise ValueError("adjacency must be symmetric (undirected graph)")
    nbr = [sorted(np.nonzero(adj[j])[0].tolist()) for j in range(adj.shape[0])]
    return _build(adj.shape[0], nbr)


def reknit(graph: Graph, dead: Sequence[int]) -> tuple:
    """Fault tolerance: remove dead nodes and re-knit the survivors.

    Survivors keep their surviving edges; any survivor left isolated (all its
    neighbors died) is reconnected to the nearest surviving node ids on each
    side (ring semantics). Returns (new_graph, survivor_ids) where
    survivor_ids maps new node index -> original node index.
    """
    dead_set = set(int(d) for d in dead)
    survivors = [j for j in range(graph.n_nodes) if j not in dead_set]
    if len(survivors) < 2:
        raise ValueError("fewer than 2 survivors")
    old2new = {o: n for n, o in enumerate(survivors)}
    nbr = []
    for o in survivors:
        kept = [old2new[l] for l in graph.nbr[o] if l not in dead_set]
        nbr.append(kept)
    # reconnect isolated survivors to ring-adjacent survivors
    s = len(survivors)
    for n in range(s):
        if not nbr[n]:
            left, right = (n - 1) % s, (n + 1) % s
            for other in (left, right):
                if other != n and other not in nbr[n]:
                    nbr[n].append(other)
                    nbr[other].append(n)
    # if disconnection remains (a dead node was a cut vertex), add ring edges
    g = _try_build(len(survivors), nbr)
    if g is None:
        for n in range(s):
            nxt = (n + 1) % s
            if nxt not in nbr[n]:
                nbr[n].append(nxt)
                nbr[nxt].append(n)
        g = _try_build(len(survivors), nbr)
        assert g is not None
    return g, np.array(survivors, np.int32)


def _try_build(n_nodes, nbr):
    try:
        return _build(n_nodes, [sorted(o) for o in nbr])
    except ValueError:
        return None


__all__ = ["Graph", "complete", "from_adjacency", "random_connected",
           "reknit", "ring", "ring_shifts"]
