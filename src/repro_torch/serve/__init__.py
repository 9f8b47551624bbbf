from .batching import (EngineStats, RequestQueue, RequestStats,
                       SlotFuture, bucket_for, iter_slabs,
                       pack_slabs, pow2_buckets)
from .kpca_engine import KpcaEngine, KpcaServeConfig
from .publisher import ModelHandle

__all__ = ["EngineStats", "KpcaEngine", "KpcaServeConfig", "ModelHandle",
           "RequestQueue", "RequestStats", "SlotFuture",
           "bucket_for", "iter_slabs", "pack_slabs", "pow2_buckets"]
