"""Logical-axis sharding rules with divisibility fallbacks (port of
``repro.distributed.sharding``).

Every parameter is created with a tuple of *logical* axis names
(``repro_torch.models.common.ParamCollector``); a per-config rule table
maps logical axes to mesh axes. ``spec_for`` resolves the spec for a
concrete shape, skipping any mapping whose mesh-axis size does not divide
the dimension and never using one mesh axis twice within a tensor. A spec
is a tuple with one entry per dim: None (replicated), a mesh-axis name, or
a tuple of them, standing in for the JAX package's ``PartitionSpec``.

The functions read only the mesh's axis sizes (``mesh.shape``, a dict of
axis name to size, as on a JAX mesh), so a stub with that dict resolves
the same specs as a live ``collectives.Mesh``.

Conventions:
  batch   -> ("pod", "data") on the multi-pod mesh, ("data",) per pod
  heads / kv_heads / mlp / expert / vocab -> "model"   (tensor parallelism)
  embed -> "data" [+"pod"]                             (FSDP weight shard)
  cache_seq -> "model"
  layers / stack / conv / state -> None

``cache_specs`` lays out a decode cache as the JAX dry-run's
``_cache_sharded`` does (context-parallel decode: the KV cache's
sequence dim on "model").
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Sequence, Tuple, Union

import torch

MeshAxes = Union[None, str, Tuple[str, ...]]
Rules = Dict[str, MeshAxes]
Spec = Tuple[MeshAxes, ...]


def default_rules(multi_pod: bool) -> Rules:
    batch = ("pod", "data") if multi_pod else ("data",)
    fsdp = ("pod", "data") if multi_pod else ("data",)
    return {
        "batch": batch,
        "seq": None,
        "embed": fsdp,          # FSDP: weights gathered per layer on use
        "embed_nofsdp": None,
        "heads": "model",
        "kv_heads": "model",
        "head_dim": None,
        "mlp": "model",
        "expert": "model",
        "expert_mlp": None,
        "vocab": "model",
        "layers": None,
        "stack": None,
        "kv_lora": None,
        "q_lora": None,
        "rope": None,
        "conv": None,
        "state": None,
        "inner": "model",       # mamba d_inner
        "cache_batch": batch,
        "cache_seq": "model",
        "cache_heads": None,
        "act_embed": None,      # activations replicated over model by default
    }


def axes_of(entry: MeshAxes) -> Tuple[str, ...]:
    """The mesh axes of one spec entry, as a tuple (() for None)."""
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def axis_size(mesh, axes: MeshAxes) -> int:
    return int(math.prod(mesh.shape[a] for a in axes_of(axes)))


def spec_for(shape: Sequence[int], logical: Sequence[Optional[str]],
             rules: Rules, mesh) -> Spec:
    """Resolve a spec; drop mappings that don't divide or reuse."""
    if len(shape) != len(logical):
        raise ValueError(f"shape {tuple(shape)} vs axes {tuple(logical)}")
    used: set = set()
    out = []
    for dim, name in zip(shape, logical):
        axes = rules.get(name) if name is not None else None
        if axes is None:
            out.append(None)
            continue
        ax_tuple = axes_of(axes)
        if any(a in used for a in ax_tuple):
            out.append(None)
            continue
        if dim % axis_size(mesh, ax_tuple) != 0:
            out.append(None)  # divisibility fallback: replicate
            continue
        used.update(ax_tuple)
        out.append(axes)
    return tuple(out)


def tree_specs(axes: Dict[str, Tuple[Optional[str], ...]],
               shapes: Dict[str, Sequence[int]], rules: Rules,
               mesh) -> Dict[str, Spec]:
    """Per-key specs (the counterpart of ``tree_shardings``); ``shapes``
    maps each key to a shape or to anything with a ``.shape``."""
    return {k: spec_for(tuple(getattr(shapes[k], "shape", shapes[k])),
                        axes[k], rules, mesh) for k in axes}


def shard_shape(shape: Sequence[int], spec: Spec, mesh) -> Tuple[int, ...]:
    """The shape of one device's shard of a tensor of ``shape``."""
    return tuple(d // axis_size(mesh, e) for d, e in zip(shape, spec))


def shard_index(entry: MeshAxes, mesh, coords=None) -> int:
    """This device's index along a dim split over ``entry``'s axes: the
    row-major index of its coordinates on those axes, in the order given
    (a ("pod", "data") dim is split pod-major, as the JAX package's)."""
    coords = mesh.coords if coords is None else coords
    idx = 0
    for a in axes_of(entry):
        idx = idx * mesh.shape[a] + coords[a]
    return idx


def local_shard(full: torch.Tensor, spec: Spec, mesh,
                coords=None) -> torch.Tensor:
    """The shard of ``full`` that the device at ``coords`` (default: this
    process's, ``mesh.coords``) holds under ``spec``: a view."""
    if full.dim() != len(spec):
        raise ValueError(f"{full.dim()}-d tensor vs spec {spec}")
    out = full
    for d, entry in enumerate(spec):
        n = axis_size(mesh, entry)
        if n > 1:
            size = full.shape[d] // n
            out = out.narrow(d, shard_index(entry, mesh, coords) * size,
                             size)
    return out


def cache_specs(cache, mesh, rules: Rules):
    """The specs of a decode cache's leaves (tensors, or anything with a
    ``.shape``), in the cache's own structure: a copy of the JAX dry-run's
    heuristic (``repro.launch.dryrun._cache_sharded``). The batch dim (1
    for a stacked cache, else 0) goes to the batch axes when they divide
    it; the longest remaining dim goes to "model" when "model" divides it
    (the KV cache's and MLA latents' sequence, mamba1's d_inner). As
    written there, any 3-d leaf takes dim 1 as its batch: seamless's
    ``enc_out`` (B, enc_seq, d_model) gets enc_seq on the batch axes and
    d_model on "model"."""
    batch_axes = rules["batch"]
    bsz = axis_size(mesh, batch_axes)
    model = mesh.shape.get("model", 1)

    def one(t) -> Spec:
        shape = tuple(int(d) for d in getattr(t, "shape", t))
        spec = [None] * len(shape)
        bdim = 1 if len(shape) >= 3 else 0
        if shape[bdim] % bsz == 0:
            spec[bdim] = batch_axes
        rest = [(d, i) for i, d in enumerate(shape) if i != bdim]
        if rest:
            d, i = max(rest)
            if d % model == 0 and d >= model:
                spec[i] = "model"
        return tuple(spec)

    specs = [one(t) for t in cache]
    return type(cache)(*specs) if hasattr(cache, "_fields") \
        else type(cache)(specs)


__all__ = ["MeshAxes", "Rules", "Spec", "axes_of", "axis_size",
           "cache_specs", "default_rules", "local_shard", "shard_index", "shard_shape",
           "spec_for", "tree_specs"]
