"""Local baselines from the paper's experiments (§6.2); port of
``repro.core.local``.

- (alpha_j)_local : kPCA on the node's own data only (Fig 4 baseline).
- (alpha_j)_Nei   : kPCA on the union of the node's and its neighbors' data
                    (Fig 5 black line), evaluated on the node's own samples.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import torch

from ..device import DeviceLike, as_f32, resolve_device
from .central import central_kpca
from .kernels_math import KernelSpec, center_gram, gram, topk_eigh
from .topology import Graph


def local_kpca(x_nodes, spec: KernelSpec, n_components: int = 1,
               gamma: Optional[torch.Tensor] = None,
               device: DeviceLike = "cuda") -> torch.Tensor:
    """x_nodes: (J, N, M) -> per-node local solutions alpha (J, N, C), each
    column normalized to 1/sqrt(lam) as in ``central_kpca``.

    The JAX package's ``vmap`` of ``central_kpca`` written out: with a given
    ``gamma``, ONE batched gram launch, ONE batched centering launch and one
    batched eigh for all J nodes. With ``gamma=None`` each node takes the
    median bandwidth of its own samples, as under ``vmap``, so the Grams are
    formed one node at a time.
    """
    dev = resolve_device(device)
    x = as_f32(x_nodes, dev)
    if gamma is None:
        k = torch.stack([gram(spec, xj) for xj in x])
    else:
        k = gram(spec, x, gamma=torch.as_tensor(gamma, dtype=torch.float32,
                                                device=dev))
    lam, vec = topk_eigh(center_gram(k), n_components)
    lam = torch.clamp(lam, min=1e-12)
    return vec / torch.sqrt(lam)[:, None, :]


def neighborhood_kpca(x_nodes, graph: Graph, spec: KernelSpec,
                      n_components: int = 1,
                      gamma: Optional[torch.Tensor] = None,
                      device: DeviceLike = "cuda"
                      ) -> List[Tuple[torch.Tensor, torch.Tensor]]:
    """(alpha_j)_Nei: for each node, kPCA on [X_j, X_{Omega_j}] (own data
    first, then the neighbors' in graph order). Returns one (alpha
    (|Omega_j|+1)N x C, stacked data) pair per node: the direction is
    phi(stacked) alpha, which the similarity metric evaluates exactly."""
    dev = resolve_device(device)
    x = as_f32(x_nodes, dev)
    out = []
    for j in range(graph.n_nodes):
        xcat = torch.cat([x[i] for i in [j] + list(graph.nbr[j])], dim=0)
        alpha, _, _ = central_kpca(xcat, spec, n_components, gamma=gamma,
                                   device=dev)
        out.append((alpha, xcat))
    return out


__all__ = ["local_kpca", "neighborhood_kpca"]
