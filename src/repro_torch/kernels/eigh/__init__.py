from .eigh import MAX_N, MAX_SWEEPS, sym_eigh
from .ops import eigh_op
from .ref import sym_eigh_reference

__all__ = ["MAX_N", "MAX_SWEEPS", "eigh_op", "sym_eigh",
           "sym_eigh_reference"]
