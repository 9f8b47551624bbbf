from .admm_step import admm_local_update
from .ops import admm_local_update_op
from .ref import admm_local_update_reference

__all__ = ["admm_local_update", "admm_local_update_op",
           "admm_local_update_reference"]
