"""Distributed substrate of the port (counterpart of ``repro.distributed``):
the logical-axis sharding rules (``sharding``) and the device mesh with the
collectives that data-, tensor- and expert-parallel training runs on
(``collectives``)."""

from .collectives import Mesh, Shards, batch_axes_of
from .sharding import (cache_specs, default_rules, local_shard, shard_shape, spec_for,
                       tree_specs)

__all__ = ["Mesh", "Shards", "batch_axes_of", "cache_specs", "default_rules",
           "local_shard", "shard_shape", "spec_for", "tree_specs"]
