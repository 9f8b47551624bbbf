"""Decentralized activation spectroscopy: the paper's DKPCA as a training
probe (counterpart of ``repro.train.probes``).

Each node of a ring treats a slice of the pooled activation minibatch as
its local dataset X_j; the probe runs a few ADMM iterations of
decentralized kernel PCA and reports, per node, the kernel-PCA
participation of its batch. On one device this is the single-device
branch of the JAX package (``build_setup`` + ``run_admm`` over all nodes
at once), on the tensors' device: on the card that launches the gram
kernel (global mean statistics and the node Grams) and the admm_step
kernel (one launch an iteration). The ring branch over a mesh
(``dkpca_distributed``) is ROADMAP queue A: a ``mesh`` raises.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..core import KernelSpec, RhoSchedule, build_setup, ring, run_admm
from .loop import MESH_NOT_PORTED


def pooled_activations(params, tokens: torch.Tensor) -> torch.Tensor:
    """Cheap representation proxy: mean-pooled token embeddings (B, E) in
    fp32. (For full residual-stream probes, tap model internals instead.)"""
    emb = params["embed"]
    return torch.mean(emb[tokens.long()].to(torch.float32), dim=1)


@torch.no_grad()
def activation_probe(params, batch, mesh=None, axis_names=("data",),
                     hops: int = 1, n_iters: int = 8,
                     samples_per_node: int = 32,
                     spec: Optional[KernelSpec] = None):
    """Returns a dict of probe metrics (computed decentralized)."""
    if mesh is not None:
        raise NotImplementedError(MESH_NOT_PORTED)
    spec = spec or KernelSpec(kind="rbf")
    acts = pooled_activations(params, batch["tokens"])    # (B, E)
    b = acts.shape[0]
    j = max(b // samples_per_node, 3)
    n = min(samples_per_node, b // j)
    if n < 4 or j < 3:
        return {"skipped": True}
    x_nodes = acts[: j * n].reshape(j, n, -1)
    graph = ring(j, hops=min(hops, (j - 1) // 2) or 1)
    setup = build_setup(x_nodes, graph, spec, device=x_nodes.device)
    res = run_admm(setup, n_iters=n_iters, rho2=RhoSchedule())
    # participation: per-node projection energy of the consensus component
    energy = torch.linalg.norm(res.alpha, dim=1)
    mean = torch.mean(energy)
    return {
        "skipped": False,
        "consensus_residual": float(res.primal_residual[-1]),
        "participation_mean": float(mean),
        "participation_cv": float(torch.std(energy, unbiased=False)
                                  / torch.clamp(mean, min=1e-9)),
    }


__all__ = ["activation_probe", "pooled_activations"]
