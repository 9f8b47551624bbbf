from .centering import center_tiles
from .ops import center_op
from .ref import center_reference

__all__ = ["center_op", "center_reference", "center_tiles"]
