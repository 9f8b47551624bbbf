"""Decode and prefill over a device mesh: what the families share.

Over a mesh (``distributed.Mesh``) a decode cache is this rank's shards
of every leaf under ``sharding.cache_specs`` (the JAX dry-run's layout:
the batch dim over the batch axes, the longest other dim over "model"),
and ``MeshCache`` carries them with their specs; the parameters are the
rank's shards in the training layout (``Model.shards()``). A step takes
the global tokens and runs this rank's rows of them (``common.
local_batch``: the rows the cache's batch shards hold), and returns the
logits of every row, whole over the vocabulary, on every rank.

Each family splits some dims of its cache natively: the decoder families
and the shared and self-attention blocks their KV cache's (and MLA's
latent cache's) slots over "model" (context-parallel attention,
``models.attention``), mamba1 its states' d_inner over "model"
(column-parallel, ``models.mamba``). ``MeshStep.working`` all-gathers a
leaf's other split dims once a step (mamba2's states, seamless's
``enc_out``, a KV cache whose slots are not its longest dim), and
``MeshStep.finish`` cuts the new leaf back to the rank's shard.

On a mesh of one device (``one_device``) the families run their
no-mesh code, op for op, and issue no collective.
"""

from __future__ import annotations

from typing import Any, Dict, NamedTuple

import torch

from ..distributed.collectives import MODEL, all_gather, batch_axes_of
from ..distributed.sharding import axes_of, local_shard, shard_shape
from .common import local_batch


class MeshCache(NamedTuple):
    """A decode cache over a mesh: this rank's shards (the family's cache
    structure) and their specs (``sharding.cache_specs``)."""
    shards: Any
    specs: Any


def one_device(mesh) -> bool:
    """No mesh, or a mesh of one device."""
    return mesh is None or mesh.size(mesh.axis_names) == 1


def local_zeros(meta_cache, specs, mesh, device):
    """This rank's zero shards of a cache given on the meta device, in its
    structure."""
    leaves = [torch.zeros(shard_shape(t.shape, sp, mesh), dtype=t.dtype,
                          device=device)
              for t, sp in zip(meta_cache, specs)]
    return type(meta_cache)(*leaves) if hasattr(meta_cache, "_fields") \
        else type(meta_cache)(leaves)


class MeshStep:
    """One decode step's view of the mesh: ``shards`` the parameters'
    layout, ``specs`` the cache's (``sharding.cache_specs``)."""

    def __init__(self, mesh, shards, specs):
        if shards is None or specs is None:
            raise ValueError("decode over a mesh needs the params' layout "
                             "(shards=) and the cache's specs "
                             "(cache_specs=)")
        self.mesh = mesh
        self.batch = axes_of(batch_axes_of(mesh))
        self.shared = False

    def rows(self, batch: Dict[str, torch.Tensor]):
        """This rank's rows of the global ``batch`` (``local_batch``)."""
        rows, self.shared = local_batch(batch, self.mesh)
        return rows

    def split(self, spec, dim: int) -> bool:
        """Is ``dim`` of a leaf under ``spec`` split over "model"?"""
        return MODEL in axes_of(spec[dim])

    def back(self, spec, keep: Dict[int, Any]):
        """The spec of a leaf's split dims that ``keep`` does not keep
        split (dim -> "model" or "batch"), None elsewhere."""
        back = []
        for d, e in enumerate(spec):
            axes = axes_of(e)
            want = keep.get(d)
            kept = (want == "batch" and axes == self.batch) or (
                want == MODEL and axes == (MODEL,))
            back.append(e if axes and not kept else None)
        return tuple(back)

    def working(self, leaf, spec, keep: Dict[int, Any]):
        """(the leaf with every split dim all-gathered but those ``keep``
        keeps split, the spec that cuts the gathered dims back)."""
        back = self.back(spec, keep)
        for d, e in enumerate(back):
            if e is not None:
                leaf = all_gather(leaf, d, self.mesh, e)
        return leaf, back

    def finish(self, leaf, back):
        """A new leaf cut back to the rank's shard along the dims
        ``working`` gathered."""
        if all(e is None for e in back):
            return leaf
        return local_shard(leaf, back, self.mesh).contiguous()

    def whole_rows(self, t: torch.Tensor) -> torch.Tensor:
        """This rank's rows of a tensor whole over its leading (batch)
        dim."""
        return self.rows({"tokens": t})["tokens"]

    def logits(self, logits: torch.Tensor, vocab_split: bool):
        """(B_rank, V or V / tp) -> (B, V): the vocabulary gathered over
        "model" where it is split, the rows over the batch axes where
        they are."""
        if vocab_split:
            logits = all_gather(logits, logits.dim() - 1, self.mesh, MODEL)
        if not self.shared and self.mesh.size(self.batch) > 1:
            logits = all_gather(logits, 0, self.mesh, self.batch)
        return logits


__all__ = ["MeshCache", "MeshStep", "local_zeros", "one_device"]
