from .ops import project_op, project_partial_op, projector
from .project import project_tiles
from .ref import project_partial_reference, project_reference

__all__ = ["project_op", "project_partial_op", "project_partial_reference",
           "project_reference", "project_tiles", "projector"]
