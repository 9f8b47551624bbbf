"""The fused local ADMM update's work (eq. 12-13), per call over J nodes:
alpha = V diag(inv) V^T rhs, ka = K alpha, B' = B + rho (ka - G)."""

from __future__ import annotations

F32 = 4


def call(nodes: int, n: int, slots: int) -> tuple:
    """(operations, bytes) of one call: three N x N products a node;
    V and K read once, inv, B, G, rho read once, alpha, B', K alpha
    written once."""
    ops = 6.0 * nodes * n * n
    reads = 2 * nodes * n * n + nodes * n + 2 * nodes * n * slots \
        + nodes * slots
    writes = 2 * nodes * n + nodes * n * slots
    return ops, F32 * (reads + writes)


def fit(cfg: dict) -> tuple:
    """(operations, bytes) of one fit's calls: one an iteration."""
    ops, nbytes = call(cfg["nodes"], cfg["samples_per_node"],
                       2 * cfg["hops"] + 1)
    return ops * cfg["iterations"], nbytes * cfg["iterations"]
