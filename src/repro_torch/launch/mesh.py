"""Device layouts for the port: the serving mesh and the ring's process
group (port of ``repro.launch.mesh``'s ``make_serving_mesh`` and, for the
decentralized fit, ``make_mesh``; the production and LM meshes are not
ported yet).

A serving mesh is a plain list of ``torch.device``: the sharded router
(``repro_torch.serve.sharded``) places each device's shards and runs its
work on that device's own CUDA stream. The ring fit
(``repro_torch.core.dkpca``) runs one process per rank of a
``torch.distributed`` group instead: ``make_process_group`` joins the
calling process to it.
"""

from __future__ import annotations

import os
from typing import List, Optional, Tuple

import torch
import torch.distributed as dist

from ..core.solver import check_backend
from ..device import DeviceLike, resolve_device


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


__all__ = ["make_process_group", "make_serving_mesh"]
