"""Device layouts for the port (port of ``repro.launch.mesh``): the
serving mesh, the ring's process group, and the training meshes.

A serving mesh is a plain list of ``torch.device``: the sharded router
(``repro_torch.serve.sharded``) places each device's shards and runs its
work on that device's own CUDA stream; ``mesh_shardings`` and
``replicate_on_mesh`` are the JAX package's two placements over such a
list. The ring fit (``repro_torch.core.dkpca``) runs one process per rank
of a ``torch.distributed`` group instead: ``make_process_group`` joins the
calling process to it. Training runs one process per device too:
``make_mesh`` lays the world out as a named device mesh
(``repro_torch.distributed.Mesh``, over
``torch.distributed.device_mesh.init_device_mesh``) and
``make_production_mesh`` is the JAX package's (16, 16) and (2, 16, 16)
layout.
"""

from __future__ import annotations

import math
import os
from typing import Dict, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from ..core.solver import check_backend
from ..device import DeviceLike, resolve_device
from ..distributed.collectives import Mesh


def make_serving_mesh(n_shards: int) -> Optional[List[torch.device]]:
    """The first ``n_shards`` CUDA devices of this host, or None when it has
    fewer (or none): the caller then serves with the same-math
    single-device reduction (routing "single"), as the JAX package does
    when it has fewer devices than shards. None is that policy, not a CPU
    fallback: the single reduction still runs on the engine's device."""
    if n_shards < 1:
        raise ValueError(f"n_shards must be >= 1, got {n_shards}")
    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if n < n_shards:
        return None
    return [torch.device("cuda", i) for i in range(n_shards)]


def make_process_group(device: DeviceLike = "cuda",
                       rank: Optional[int] = None,
                       world_size: Optional[int] = None,
                       local_rank: Optional[int] = None,
                       init_method: str = "env://"
                       ) -> Tuple[object, torch.device]:
    """Join the calling process to the default process group; returns
    (group, device) for ``dkpca_distributed(group=..., device=...)``.

    rank, world_size and local_rank default to ``RANK``, ``WORLD_SIZE``
    and ``LOCAL_RANK`` as ``torchrun`` sets them (and 0, 1, 0 without
    them); ``init_method`` is where the ranks meet (``env://`` reads
    ``MASTER_ADDR``/``MASTER_PORT``; ``tcp://host:port`` or
    ``file:///path`` name it). A CUDA device gives a NCCL group on
    ``cuda:local_rank``, the CPU a gloo group; a CUDA request without a
    card raises. A process already in a group keeps it, if its backend
    suits the device."""
    dev = resolve_device(device)
    env = os.environ
    rank = int(env.get("RANK", 0)) if rank is None else rank
    world_size = int(env.get("WORLD_SIZE", 1)) if world_size is None \
        else world_size
    local_rank = int(env.get("LOCAL_RANK", 0)) if local_rank is None \
        else local_rank
    if dev.type == "cuda":
        dev = torch.device("cuda", local_rank)
        torch.cuda.set_device(dev)
    if not dist.is_initialized():
        dist.init_process_group("nccl" if dev.type == "cuda" else "gloo",
                                init_method=init_method, rank=rank,
                                world_size=world_size)
    check_backend(dist.get_backend(), dev)
    return dist.group.WORLD, dev


def make_mesh(shape: Sequence[int], axes: Sequence[str],
              device: DeviceLike = "cuda", **group_kw) -> Mesh:
    """The world laid out as a device mesh of ``shape`` with axis names
    ``axes``, one process per device (row-major: rank r sits at
    ``np.unravel_index(r, shape)``). The calling process joins the default
    group through ``make_process_group(device, **group_kw)`` (on the card
    ``cuda:LOCAL_RANK``; a process already in a group of the right size
    keeps it). Raises ``ValueError`` when ``prod(shape)`` differs from the
    world size."""
    from torch.distributed.device_mesh import init_device_mesh
    shape, axes = tuple(int(n) for n in shape), tuple(axes)
    if len(shape) != len(axes):
        raise ValueError(f"mesh shape {shape} vs axes {axes}")
    need = math.prod(shape)
    world = dist.get_world_size() if dist.is_initialized() else \
        group_kw.get("world_size") or int(os.environ.get("WORLD_SIZE", 1))
    if world != need:
        raise ValueError(f"a mesh of shape {shape} needs {need} processes, "
                         f"the world has {world}")
    _, dev = make_process_group(device, **group_kw)
    dm = init_device_mesh(dev.type, shape, mesh_dim_names=axes)
    return Mesh(dm, dev)


def make_production_mesh(*, multi_pod: bool = False,
                         device: DeviceLike = "cuda", **group_kw) -> Mesh:
    """The JAX package's production layout: (16, 16) over ("data",
    "model"), or (2, 16, 16) over ("pod", "data", "model")."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes, device=device, **group_kw)


def mesh_shardings(devices: Sequence[torch.device]):
    """(row_sharded, replicated) placements over a serving mesh (a list of
    devices): ``row_sharded(t)`` splits t's leading axis one slice per
    device, ``replicated(t)`` puts a full copy on every device; each
    returns the per-device tensors in mesh order."""
    devices = list(devices)

    def row_sharded(t: torch.Tensor) -> List[torch.Tensor]:
        if t.shape[0] % len(devices):
            raise ValueError(f"{t.shape[0]} rows over {len(devices)} "
                             f"devices")
        return [part.to(d) for part, d in zip(
            t.chunk(len(devices)), devices)]

    def replicated(t: torch.Tensor) -> List[torch.Tensor]:
        return [t.to(d) for d in devices]

    return row_sharded, replicated


def replicate_on_mesh(tree: Dict[str, torch.Tensor],
                      devices: Sequence[torch.device]
                      ) -> Dict[str, List[torch.Tensor]]:
    """Every leaf of ``tree`` copied onto every device of the serving mesh
    (the data-parallel serving layout): key -> per-device copies."""
    _, replicated = mesh_shardings(devices)
    return {k: replicated(v) for k, v in tree.items()}


__all__ = ["make_mesh", "make_process_group", "make_production_mesh",
           "make_serving_mesh", "mesh_shardings", "replicate_on_mesh"]
