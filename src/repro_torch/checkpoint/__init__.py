from .checkpoint import (latest_step, restore_checkpoint, save_checkpoint,
                         save_checkpoint_async)

__all__ = ["latest_step", "restore_checkpoint", "save_checkpoint",
           "save_checkpoint_async"]
