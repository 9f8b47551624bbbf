"""Synthetic datasets (numpy, seeded) — a copy of ``repro.data.synthetic``
kept here so the port never imports the JAX package.

MNIST (paper §6.1) is replaced by a generated "digits-like" dataset with
matched regime: M=784 features, a few nonlinear class manifolds, values in
[0, 1], randomly and evenly distributed to nodes. Generators take an
explicit seed and give the same data as the JAX package's for that seed.
"""

from __future__ import annotations

import numpy as np


def kpca_dataset(n: int, m: int = 784, n_classes: int = 4, seed: int = 0,
                 noise: float = 0.05, dominant: float = 3.0) -> np.ndarray:
    """Nonlinear data with a *dominant* first kernel principal component.

    Structure: one strong shared nonlinear factor (amplitude ``dominant``)
    + per-class offsets + weak secondary factors + isotropic noise, embedded
    into R^m by a frozen random map and squashed to [0, 1].
    Returns (n, m) float32.
    """
    rng = np.random.default_rng(seed)
    latent_dim = 6
    # frozen embedding maps
    w_dom = rng.normal(0, 1.0, size=(2, m)) / np.sqrt(2)
    w_sec = rng.normal(0, 1.0, size=(latent_dim, m)) / np.sqrt(latent_dim)
    offs = rng.normal(0, 0.6, size=(n_classes, m))
    labels = np.arange(n) % n_classes
    # dominant shared 1-D nonlinear factor (a curve, not a line); the
    # asymmetric harmonic amplitudes give the global kernel a clear
    # top-eigenvalue gap, so the top-1 similarity metric is well posed.
    t = rng.uniform(0, 2 * np.pi, size=(n,))
    dom = np.stack([(4.0 / 3.0) * dominant * np.cos(t),
                    0.5 * dominant * np.sin(2 * t)], axis=1)        # (n, 2)
    # weak secondary factors
    sec = np.tanh(rng.normal(0, 1.0, size=(n, latent_dim))) * 0.4
    x = dom @ w_dom + sec @ w_sec + offs[labels]
    x = x + rng.normal(0, noise * np.sqrt(m) / 4, size=(n, m))
    x = 1.0 / (1.0 + np.exp(-x / np.sqrt(m) * 8.0))                 # [0, 1]
    perm = rng.permutation(n)
    return x[perm].astype(np.float32)


def distribute(x: np.ndarray, n_nodes: int, seed: int = 0) -> np.ndarray:
    """Randomly, evenly distribute samples to nodes: (J, N_j, M).
    Truncates the remainder (paper uses exactly even splits)."""
    rng = np.random.default_rng(seed)
    n = (x.shape[0] // n_nodes) * n_nodes
    perm = rng.permutation(x.shape[0])[:n]
    return x[perm].reshape(n_nodes, n // n_nodes, *x.shape[1:])


def node_dataset(n_nodes: int, n_per_node: int, m: int = 784,
                 n_classes: int = 4, seed: int = 0):
    """Convenience: (J, N, M) node-distributed data + the pooled (J*N, M)."""
    x = kpca_dataset(n_nodes * n_per_node, m, n_classes, seed)
    nodes = distribute(x, n_nodes, seed=seed + 1)
    return nodes, nodes.reshape(n_nodes * n_per_node, m)


__all__ = ["distribute", "kpca_dataset", "node_dataset"]
