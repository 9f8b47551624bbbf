"""Optimizer substrate of the port (counterpart of ``repro.optim``): AdamW
with global-norm clipping (functional, and in place for the training
loop), the cosine schedule, and PowerSGD-style gradient compression over a
``torch.distributed`` group."""

from .adamw import (AdamWConfig, adamw_init, adamw_update, adamw_update_,
                    global_norm)
from .compression import (compress_local, compressed_psum_grads,
                          compression_ratio, init_compression_state)
from .schedule import cosine_with_warmup

__all__ = ["AdamWConfig", "adamw_init", "adamw_update", "compress_local",
           "compressed_psum_grads", "compression_ratio",
           "cosine_with_warmup", "global_norm", "init_compression_state"]
