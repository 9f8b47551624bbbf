from .ops import partial_projector, project_op, project_partial_op, projector
from .project import prepare_support, project_tiles
from .ref import project_partial_reference, project_reference

__all__ = ["partial_projector", "prepare_support", "project_op",
           "project_partial_op", "project_partial_reference",
           "project_reference", "project_tiles", "projector"]
