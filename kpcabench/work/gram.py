"""The Gram op's work: K[i, j] = k(x_i, y_j) for x (n, m), y (k, m)."""

from __future__ import annotations

F32 = 4


def block(n: int, k: int, m: int, same: bool = False) -> tuple:
    """(operations, bytes) of one Gram block: the n x k x m product; x and
    y read once (y is x for a self-Gram), the block written once."""
    ops = 2.0 * n * k * m
    nbytes = F32 * (n * m + (0 if same else k * m) + n * k)
    return ops, nbytes


def fit(cfg: dict) -> tuple:
    """(operations, bytes) of the Grams one fit needs. The global centring
    statistics need k(x_p, x_q) for every pair of the J*N pooled rows, and
    every pair that a node's slot graph needs is among them, so the math
    needs the pooled self-Gram once; what the program computes beyond it
    (the slot blocks again, the packaging's statistics again) is not
    counted."""
    rows = cfg["nodes"] * cfg["samples_per_node"]
    return block(rows, rows, cfg["features"], same=True)
