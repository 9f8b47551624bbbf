"""Device layouts for the port's launchers (``mesh``)."""

from .mesh import make_serving_mesh

__all__ = ["make_serving_mesh"]
