"""The serving mesh: the devices a sharded model is served over (port of
``repro.launch.mesh.make_serving_mesh``; the production and LM meshes are
not ported yet).

A mesh here is a plain list of ``torch.device``: the sharded router
(``repro_torch.serve.sharded``) places each device's shards and runs its
work on that device's own CUDA stream. Nothing is read from the
environment: a multi-process launcher passes its device list explicitly.
"""

from __future__ import annotations

from typing import List, Optional

import torch


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


__all__ = ["make_serving_mesh"]
