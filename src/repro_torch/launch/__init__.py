"""The port's launchers and what they share: device layouts (``mesh``: the
serving mesh, the ring's process group), the process environment
(``env``) and the serving launchers (``python -m
repro_torch.launch.serve_kpca``, ``python -m repro_torch.launch.serve``)."""

from .mesh import make_process_group, make_serving_mesh

__all__ = ["make_process_group", "make_serving_mesh"]
