"""Hand-written Hopper kernels of the port, one package per TPU kernel.

Each package has the launch wrapper (``gram.py``, ``project.py``,
``centering.py``, ``admm_step.py``, with its ``launches`` count), the public
op that picks kernel or plain version by the tensor's device (``ops.py``),
and the plain PyTorch version (``ref.py``). The CUDA sources live in
``csrc/`` and are built at first use (``_build.load_library``).
"""

from .admm_step import (admm_local_update, admm_local_update_op,
                        admm_local_update_reference)
from .centering import center_op, center_reference, center_tiles
from .gram import gram_op, gram_reference, gram_tiles
from .project import (project_op, project_partial_op,
                      project_partial_reference, project_reference,
                      project_tiles, projector)

__all__ = ["admm_local_update", "admm_local_update_op",
           "admm_local_update_reference", "center_op", "center_reference",
           "center_tiles", "gram_op", "gram_reference", "gram_tiles",
           "project_op", "project_partial_op", "project_partial_reference",
           "project_reference", "project_tiles", "projector"]
