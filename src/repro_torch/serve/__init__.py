from .batching import (EngineStats, FlushSlots, QueueFullError, Request,
                       RequestFuture, RequestQueue, RequestStats, ShedError,
                       SlabArena, SlotFuture, bucket_for, format_latency,
                       iter_slabs, left_pad_pack, pack_slabs, pow2_buckets)
from .engine import DecodeEngine, ServeConfig
from .kpca_engine import KpcaEngine, KpcaServeConfig
from .publisher import BackgroundPublisher, ModelHandle, stream_chunks
from .sharded import (POLICIES, CrossoverTable, ShardedRouter, ShardedScores,
                      measure_crossover, place_sharded_model, project_sharded)

__all__ = ["BackgroundPublisher", "CrossoverTable", "DecodeEngine",
           "EngineStats",
           "FlushSlots", "KpcaEngine", "KpcaServeConfig", "ModelHandle",
           "POLICIES", "QueueFullError", "Request", "RequestFuture",
           "RequestQueue", "RequestStats", "ShardedRouter", "ShardedScores",
           "ShedError", "SlabArena", "SlotFuture", "bucket_for",
           "format_latency", "iter_slabs", "left_pad_pack",
           "measure_crossover",
           "pack_slabs", "place_sharded_model", "pow2_buckets",
           "project_sharded", "ServeConfig", "stream_chunks"]
