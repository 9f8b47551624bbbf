"""Decentralized activation spectroscopy: the paper's DKPCA as a training
probe (counterpart of ``repro.train.probes``).

Each node of a ring treats a slice of the pooled activation minibatch as
its local dataset X_j; the probe runs a few ADMM iterations of
decentralized kernel PCA and reports, per node, the kernel-PCA
participation of its batch. On one device this is the single-device
branch of the JAX package (``build_setup`` + ``run_admm`` over all nodes
at once), on the tensors' device: on the card that launches the gram
kernel (global mean statistics and the node Grams) and the admm_step
kernel (one launch an iteration).

Over a mesh (``mesh``, with ``shards`` the params' layout) it is the JAX
package's ring branch: node j is rank j of the ``axis_names`` sub-group
(J = their size, N = min(samples_per_node, B // J)), and the nodes'
datasets are the global batch's rows, x_nodes = acts[:J*N].reshape(J, N,
E). A node's rows are not always its own rank's rows of the batch, so each
rank pools its own rows (through the FSDP-gathered, vocab-split table) and
the pooled B x E activations are all-gathered over the batch axes first;
then ``dkpca_distributed`` runs the ring over the sub-group (each "model"
column its own ring), launching on the card the gram kernel (the sweep's
cross-Grams and the slot Grams) and the admm_step kernel (once an
iteration) on every rank. Where J < 2*hops + 1 the nodes run the
single-device branch instead, as in the JAX package.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..core import KernelSpec, RhoSchedule, build_setup, ring, run_admm
from ..core.dkpca import dkpca_distributed
from ..distributed import collectives as coll
from ..models.common import local_batch
from ..models.lm import embed_rows


def pooled_activations(params, tokens: torch.Tensor,
                       shards=None) -> torch.Tensor:
    """Cheap representation proxy: mean-pooled token embeddings (B, E) in
    fp32. (For full residual-stream probes, tap model internals instead.)
    ``shards``: the table's layout on a mesh (it is gathered over its FSDP
    axes, and looked up vocab-parallel where the vocab is split)."""
    emb = params["embed"]
    if shards is not None:
        emb = shards.gather({"embed": emb})["embed"]
    return torch.mean(embed_rows(emb, tokens, shards).to(torch.float32),
                      dim=1)


@torch.no_grad()
def activation_probe(params, batch, mesh=None, axis_names=("data",),
                     hops: int = 1, n_iters: int = 8,
                     samples_per_node: int = 32,
                     spec: Optional[KernelSpec] = None, shards=None):
    """Returns a dict of probe metrics (computed decentralized). Over
    ``mesh`` every rank calls it with the global batch; ``shards`` is the
    params' layout (``Model.shards()``; None: every leaf whole on every
    rank)."""
    spec = spec or KernelSpec(kind="rbf")
    tokens = batch["tokens"]
    if mesh is None:
        acts = pooled_activations(params, tokens)          # (B, E)
    else:
        rows, shared = local_batch({"tokens": tokens}, mesh)
        acts = pooled_activations(params, rows["tokens"], shards)
        if not shared:
            acts = coll.all_gather(acts, 0, mesh, coll.batch_axes_of(mesh))
    b = acts.shape[0]
    if mesh is not None:
        j = mesh.size(tuple(axis_names))
    else:
        j = max(b // samples_per_node, 3)
    n = min(samples_per_node, b // j)
    if n < 4 or j < 3:
        return {"skipped": True}
    x_nodes = acts[: j * n].reshape(j, n, -1)
    if mesh is not None and j >= 2 * hops + 1:
        res = dkpca_distributed(x_nodes, group=mesh.group(tuple(axis_names)),
                                hops=hops, spec=spec, n_iters=n_iters,
                                device=mesh.device)
    else:
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
