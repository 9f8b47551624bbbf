"""The port's launchers and what they share: device layouts (``mesh``: the
serving mesh, the ring's process group, the training meshes), the process
environment
(``env``), the launchers (``python -m repro_torch.launch.serve_kpca``,
``python -m repro_torch.launch.serve``, ``python -m
repro_torch.launch.train``) and the dry-run and its roofline (``python -m
repro_torch.launch.dryrun``, ``python -m repro_torch.launch.roofline``)."""

from .mesh import (make_mesh, make_process_group, make_production_mesh,
                   make_serving_mesh, mesh_shardings, replicate_on_mesh)

__all__ = ["make_mesh", "make_process_group", "make_production_mesh",
           "make_serving_mesh", "mesh_shardings", "replicate_on_mesh"]
