"""The port's device mesh and the collectives that data-, tensor- and
expert-parallel training runs on.

The JAX package shards its training step with GSPMD: parameters carry
``NamedSharding``s and XLA inserts the communication. Here every parameter,
first and second moment is a plain local tensor, the process's shard under
``sharding.spec_for``, and the communication is explicit, written as a few
``torch.autograd.Function``s over the named sub-groups of a
``torch.distributed`` device mesh (one process per device):

  * ``gather`` (FSDP over the batch axes): all-gather a weight's
    "data"-sharded dim on use; backward: reduce-scatter (sum), so each
    rank keeps its shard's gradient;
  * ``gather_replica``: all-gather over "model" for a layer that every
    "model" rank computes whole; backward: the rank's slice of the
    gradient, unsummed (each rank's is already the whole one). Only a
    mamba layer whose widths the "model" size does not divide runs so
    (the divisibility fallback, ``Shards.gather_whole``); the others run
    split, on the rank's d_inner columns or heads;
  * ``copy_to`` (Megatron's "f"): identity forward, all-reduce (sum)
    backward; it goes where a tensor replicated over "model" enters
    per-shard work: before the column-parallel products (q/k/v heads,
    w_gate/w_up, the vocab-parallel logits, the expert dispatch) and on a
    weight replicated over "model" that each shard uses only part of;
  * ``reduce_from`` (Megatron's "g"): all-reduce (sum) forward, identity
    backward; it goes after the row-parallel products (wo, w_down, the
    expert combine). ``torch.distributed.nn.functional.all_reduce`` is not
    used for it: its backward all-reduces the incoming gradient, which
    downstream of "g" is already the same on every rank, so the gradient
    would come back multiplied by the group's size;
  * ``reduce_sum``: all-reduce (sum) forward and backward, for a sum that
    each rank then uses only through its own shard of the work (mamba1's
    ``w_x`` product, which feeds the rank's d_inner columns of the scan;
    mamba2's sum of squares for its gated RMSNorm over the whole
    d_inner): downstream of it the ranks' gradients differ, each the part
    through its own columns, so the backward must sum them where "g"'s
    passes them on;
  * ``grad_on_first``: identity forward; backward the gradient on the
    first rank of the axes, zeros on the others: for a value every rank
    computes whole, with the same whole gradient, ahead of a sum over
    the ranks (mamba2's B and C channels over "model"), which then counts
    it once;
  * ``mean_all`` (the JAX package's ``pmean`` over every axis): forward
    the mean over all ranks, backward the gradient over the rank count;
  * ``scale_grad``: identity forward, backward the gradient times a
    constant.

A group of one rank makes every collective the identity, and then none is
issued: on a (1, 1) mesh the step is the single-device step's code, op for
op. ``Mesh.counts`` counts the collectives issued (calls, and the bytes
of each one's output as the JAX dry-run counts them, by kind), forward
and backward.
"""

from __future__ import annotations

import collections
import math
from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from .sharding import MeshAxes, Spec, axes_of, shard_index

MODEL = "model"


class Mesh:
    """A ``torch.distributed`` device mesh with named axes, one process per
    device: ``shape`` maps each axis to its size (as a JAX mesh's does),
    ``coords`` this process's index on each, ``device`` its device.
    Built by ``repro_torch.launch.make_mesh``."""

    def __init__(self, device_mesh, device: torch.device):
        self.device_mesh = device_mesh
        self.axis_names: Tuple[str, ...] = tuple(device_mesh.mesh_dim_names)
        self.shape: Dict[str, int] = dict(zip(self.axis_names,
                                              device_mesh.shape))
        self.coords: Dict[str, int] = dict(zip(
            self.axis_names, device_mesh.get_coordinate()))
        self.device = device
        self.counts = collections.Counter()
        self._groups = {}

    def size(self, axes: MeshAxes) -> int:
        return int(math.prod(self.shape[a] for a in axes_of(axes)))

    def index(self, axes: MeshAxes) -> int:
        """This process's row-major index over ``axes``: its rank in
        ``group(axes)``."""
        return shard_index(axes, self)

    def group(self, axes: MeshAxes):
        """The process group of the ranks that differ only on ``axes``
        (one axis: the device mesh's own sub-group; several: one made with
        every rank of the world, so call it at the same point on every
        rank)."""
        axes = axes_of(axes)
        if axes not in self._groups:
            if len(axes) == 1:
                self._groups[axes] = self.device_mesh.get_group(axes[0])
            elif axes == self.axis_names:
                self._groups[axes] = dist.group.WORLD
            else:
                self._groups[axes] = self._new_group(axes)
        return self._groups[axes]

    def _new_group(self, axes: Tuple[str, ...]):
        order = [self.axis_names.index(a) for a in axes]
        if order != sorted(order):
            raise ValueError(f"axes {axes} out of the mesh's order "
                             f"{self.axis_names}")
        ranks = np.arange(math.prod(self.shape.values())).reshape(
            tuple(self.shape.values()))
        rest = [i for i in range(ranks.ndim) if i not in order]
        lists = ranks.transpose(rest + order).reshape(
            -1, self.size(axes)).tolist()
        mine, _ = dist.new_subgroups_by_enumeration(lists)
        return mine

    def count(self, kind: str, t: torch.Tensor) -> None:
        self.counts[kind] += 1
        self.counts[kind + "_bytes"] += t.numel() * t.element_size()

    def __repr__(self):
        return f"Mesh({self.shape}, coords={self.coords}, {self.device})"


# ---------------------------------------------------------------------------
# plain collectives (no autograd)


def all_gather(x: torch.Tensor, dim: int, mesh: Mesh,
               axes: MeshAxes) -> torch.Tensor:
    """Every rank's ``x`` over ``axes`` concatenated along ``dim``, in
    rank order (the full tensor of a dim sharded over ``axes``)."""
    n = mesh.size(axes)
    if n == 1:
        return x
    xt = x.movedim(dim, 0).contiguous()
    out = xt.new_empty((n * xt.shape[0],) + tuple(xt.shape[1:]))
    mesh.count("all_gather", out)
    dist.all_gather_into_tensor(out, xt, group=mesh.group(axes))
    return out.movedim(0, dim)


def reduce_scatter(x: torch.Tensor, dim: int, mesh: Mesh,
                   axes: MeshAxes) -> torch.Tensor:
    """The sum of every rank's ``x`` over ``axes``, each rank keeping its
    slice of ``dim``."""
    n = mesh.size(axes)
    if n == 1:
        return x
    xt = x.movedim(dim, 0).contiguous()
    out = xt.new_empty((xt.shape[0] // n,) + tuple(xt.shape[1:]))
    mesh.count("reduce_scatter", out)
    dist.reduce_scatter_tensor(out, xt, op=dist.ReduceOp.SUM,
                               group=mesh.group(axes))
    return out.movedim(0, dim)


def all_reduce_(x: torch.Tensor, mesh: Mesh, axes: MeshAxes,
                op=dist.ReduceOp.SUM) -> torch.Tensor:
    """``x`` reduced in place over ``axes``; returns it."""
    if mesh.size(axes) > 1:
        mesh.count("all_reduce", x)
        dist.all_reduce(x, op=op, group=mesh.group(axes))
    return x


def gather_full(x: torch.Tensor, spec: Spec, mesh: Mesh) -> torch.Tensor:
    """The whole tensor of which ``x`` is this rank's shard under
    ``spec``, on every rank (one all-gather per sharded dim)."""
    for d, entry in enumerate(spec):
        x = all_gather(x, d, mesh, entry)
    return x


# ---------------------------------------------------------------------------
# autograd Functions


class _Gather(torch.autograd.Function):
    """Forward: all-gather dim ``dim`` over ``axes``. Backward:
    reduce-scatter (sum) of the gradient along it."""

    @staticmethod
    def forward(ctx, x, dim, mesh, axes):
        ctx.dim, ctx.mesh, ctx.axes = dim, mesh, axes
        return all_gather(x, dim, mesh, axes)

    @staticmethod
    def backward(ctx, g):
        return reduce_scatter(g, ctx.dim, ctx.mesh, ctx.axes), None, None, \
            None


class _GatherSlice(torch.autograd.Function):
    """Forward: all-gather dim ``dim`` over ``axes``. Backward: this rank's
    slice of the gradient along it, unsummed. For a weight whose layer
    every rank on ``axes`` computes whole from the same inputs: each rank's
    gradient of the gathered weight is then the whole one, so a summing
    backward (``_Gather``'s) would multiply it by the axes' size."""

    @staticmethod
    def forward(ctx, x, dim, mesh, axes):
        ctx.dim, ctx.size, ctx.index = dim, x.shape[dim], mesh.index(axes)
        return all_gather(x, dim, mesh, axes)

    @staticmethod
    def backward(ctx, g):
        return g.narrow(ctx.dim, ctx.index * ctx.size, ctx.size), None, \
            None, None


class _CopyTo(torch.autograd.Function):
    """Megatron's "f". Forward: identity. Backward: all-reduce (sum) of the
    gradient over ``axes``."""

    @staticmethod
    def forward(ctx, x, mesh, axes):
        ctx.mesh, ctx.axes = mesh, axes
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce_(g.clone(), ctx.mesh, ctx.axes), None, None


class _ReduceFrom(torch.autograd.Function):
    """Megatron's "g". Forward: all-reduce (sum) over ``axes``. Backward:
    identity."""

    @staticmethod
    def forward(ctx, x, mesh, axes):
        return all_reduce_(x.clone(), mesh, axes)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


class _ReduceSum(torch.autograd.Function):
    """Forward: all-reduce (sum) over ``axes``. Backward: all-reduce (sum)
    of the gradient. Each rank's output is used only through its own shard
    of the work that follows, so each rank's gradient of it is partial and
    the whole one is their sum ("g" would keep the rank's part alone)."""

    @staticmethod
    def forward(ctx, x, mesh, axes):
        ctx.mesh, ctx.axes = mesh, axes
        return all_reduce_(x.clone(), mesh, axes)

    @staticmethod
    def backward(ctx, g):
        return all_reduce_(g.clone(), ctx.mesh, ctx.axes), None, None


class _GradOnFirst(torch.autograd.Function):
    """Forward: identity. Backward: the gradient on the first rank of
    ``axes``, zeros on the others. For a value that every rank on ``axes``
    computes whole from the same inputs, with the same whole gradient,
    before a sum over them (a reduce-scatter's, a replicated leaf's): the
    sum then counts it once, exactly."""

    @staticmethod
    def forward(ctx, x, mesh, axes):
        ctx.first = mesh.index(axes) == 0
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return (g if ctx.first else torch.zeros_like(g)), None, None


class _MeanAll(torch.autograd.Function):
    """``pmean`` over every rank. Forward: the sum over the world divided by
    its size. Backward: the gradient divided by the world size."""

    @staticmethod
    def forward(ctx, x, mesh):
        n = mesh.size(mesh.axis_names)
        ctx.n = n
        return all_reduce_(x.clone(), mesh, mesh.axis_names) / n

    @staticmethod
    def backward(ctx, g):
        return g / ctx.n, None


class _ScaleGrad(torch.autograd.Function):
    """Forward: identity. Backward: the gradient times ``s``."""

    @staticmethod
    def forward(ctx, x, s):
        ctx.s = s
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g * ctx.s, None


def gather(x, dim: int, mesh: Mesh, axes: MeshAxes):
    return x if mesh.size(axes) == 1 else _Gather.apply(x, dim, mesh, axes)


def gather_replica(x, dim: int, mesh: Mesh, axes: MeshAxes):
    """``x`` all-gathered along ``dim`` over ``axes`` for work that every
    rank on them repeats whole (backward: the rank's slice, unsummed)."""
    return x if mesh.size(axes) == 1 else _GatherSlice.apply(x, dim, mesh,
                                                             axes)


def copy_to(x, mesh: Mesh, axes: MeshAxes = MODEL):
    return x if mesh.size(axes) == 1 else _CopyTo.apply(x, mesh, axes)


def reduce_from(x, mesh: Mesh, axes: MeshAxes = MODEL):
    return x if mesh.size(axes) == 1 else _ReduceFrom.apply(x, mesh, axes)


def reduce_sum(x, mesh: Mesh, axes: MeshAxes = MODEL):
    return x if mesh.size(axes) == 1 else _ReduceSum.apply(x, mesh, axes)


def grad_on_first(x, mesh: Mesh, axes: MeshAxes = MODEL):
    return x if mesh.size(axes) == 1 else _GradOnFirst.apply(x, mesh, axes)


def mean_all(x, mesh: Mesh):
    return x if mesh.size(mesh.axis_names) == 1 else _MeanAll.apply(x, mesh)


def scale_grad(x, s: float):
    return x if s == 1 else _ScaleGrad.apply(x, s)


# ---------------------------------------------------------------------------
# the model's view of a sharded parameter tree


def batch_axes_of(mesh) -> Optional[Tuple[str, ...]]:
    """The mesh axes the batch is split over (None without a mesh)."""
    if mesh is None:
        return None
    return ("pod", "data") if "pod" in mesh.axis_names else ("data",)


class Shards:
    """The layout of a parameter sub-dict on a mesh: ``specs`` by key
    (relative to the sub-dict), with the collectives the model code needs.
    ``tp`` and ``mi`` are the "model" axis's size and this rank's index on
    it; ``dp`` the batch axes' size. ``partial``: the keys of the leaves
    replicated over "model" of which each "model" rank's work uses only
    its part, so that its gradient of them is partial and the step sums
    them over "model" (``train.loop.sum_replicated_grads``); set by
    ``Model.shards`` for the whole tree, empty in a ``sub``."""

    def __init__(self, mesh: Mesh, specs: Dict[str, Spec]):
        self.mesh = mesh
        self.specs = specs
        self.partial: Tuple[str, ...] = ()
        self.batch_axes = batch_axes_of(mesh)
        self.dp = mesh.size(self.batch_axes)
        self.tp = mesh.shape.get(MODEL, 1)
        self.mi = mesh.coords.get(MODEL, 0)

    def sub(self, prefix: str, stacked: bool = False) -> "Shards":
        """The sub-dict under ``prefix/``; ``stacked``: its leaves lose
        their leading "layers" dim (one layer's slice)."""
        plen = len(prefix) + 1
        return Shards(self.mesh, {
            k[plen:]: (s[1:] if stacked else s)
            for k, s in self.specs.items() if k.startswith(prefix + "/")})

    def model_dim(self, key: str) -> Optional[int]:
        """The dim of ``key`` split over "model", or None (replicated, or
        a "model" axis of one rank: nothing is split)."""
        if self.tp == 1:
            return None
        for d, e in enumerate(self.specs[key]):
            if MODEL in axes_of(e):
                return d
        return None

    def gather(self, params: Dict[str, torch.Tensor]):
        """Every leaf with its non-"model" sharded dims all-gathered (FSDP:
        the weights as the model code uses them, still split over
        "model")."""
        out = {}
        for k, v in params.items():
            for d, e in enumerate(self.specs[k]):
                axes = axes_of(e)
                if axes and MODEL not in axes:
                    v = gather(v, d, self.mesh, e)
            out[k] = v
        return out

    def gather_whole(self, params: Dict[str, torch.Tensor]):
        """Every leaf whole on every rank: ``gather``'s FSDP gathers, and
        the dims split over "model" gathered too, with the unsummed
        backward of ``gather_replica`` (for a mamba layer whose widths the
        "model" size does not divide, which every "model" rank then
        computes whole)."""
        out = {}
        for k, v in params.items():
            for d, e in enumerate(self.specs[k]):
                axes = axes_of(e)
                if MODEL in axes:
                    v = gather_replica(v, d, self.mesh, e)
                elif axes:
                    v = gather(v, d, self.mesh, e)
            out[k] = v
        return out

    def gather_layer(self, params: Dict[str, torch.Tensor], split: bool):
        """A layer's leaves as it runs: their FSDP dims gathered when it
        runs ``split`` over "model" (``gather``), else whole
        (``gather_whole``)."""
        return self.gather(params) if split else self.gather_whole(params)

    def f(self, x):
        return copy_to(x, self.mesh)

    def g(self, x):
        return reduce_from(x, self.mesh)

    def split(self, keys, *widths) -> bool:
        """Can a layer run split over "model": an axis of more than one
        rank, every leaf of ``keys`` split over it, and its size dividing
        each of ``widths``."""
        return self.tp > 1 and all(w % self.tp == 0 for w in widths) and \
            all(self.model_dim(k) is not None for k in keys)

    def f_replicated(self, p: Dict[str, torch.Tensor], key: str):
        """``p[key]``, through "f" when it is replicated over "model" (each
        shard then uses part of it, so its gradient is partial)."""
        v = p[key]
        return self.f(v) if self.model_dim(key) is None else v


__all__ = ["MODEL", "Mesh", "Shards", "all_gather", "all_reduce_",
           "batch_axes_of", "copy_to", "gather", "gather_full",
           "gather_replica", "grad_on_first", "mean_all", "reduce_from",
           "reduce_scatter", "reduce_sum", "scale_grad"]
