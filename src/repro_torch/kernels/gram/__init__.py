from .gram import gram_tiles
from .ops import gram_op
from .ref import gram_reference

__all__ = ["gram_op", "gram_reference", "gram_tiles"]
