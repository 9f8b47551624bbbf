"""The projection op's work: scores = K(x', X) a + mean_l K(x', x_l) c + b
for query rows x' against a support X (L, M) with C components."""

from __future__ import annotations

F32 = 4


def rows(n_rows: int, support: int, features: int, components: int = 1
         ) -> tuple:
    """(operations, bytes) of scoring ``n_rows`` query rows, the rows the
    clients sent (never the slabs or their padding): a row's distances to
    the support (2 L M) and its kernel row against the coefficients and
    the ones column (2 L (C + 1)); each query row read once and its scores
    written once, the support and coefficients read once."""
    ops = 2.0 * n_rows * support * (features + components + 1)
    nbytes = F32 * (n_rows * (features + components)
                    + support * (features + components))
    return ops, nbytes
