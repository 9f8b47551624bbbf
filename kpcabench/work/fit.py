"""A whole fit's products, for its share of the card's peak: the Grams it
needs (``work.gram.fit``) and the ADMM iterations' products. The
eigendecompositions are not counted (no product count is defined for an
iterative eigensolver)."""

from __future__ import annotations

from . import gram


def ops(cfg: dict) -> float:
    """Operations of one fit's products. Per iteration and node: K^+ B
    (two N x N x S products), the slot Grams applied to the z
    coefficients ((S N)^2), c^T K c (S N), and the local update (three
    N x N products)."""
    j, n = cfg["nodes"], cfg["samples_per_node"]
    s = 2 * cfg["hops"] + 1
    per_node = 4.0 * n * n * s + 2.0 * (s * n) ** 2 + 2.0 * s * n \
        + 6.0 * n * n
    return gram.fit(cfg)[0] + cfg["iterations"] * j * per_node
