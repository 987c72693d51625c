"""Process launch and device meshes of the port (``torch.distributed``)."""

from .mesh import launch, make_host_mesh, make_production_mesh

__all__ = ["launch", "make_host_mesh", "make_production_mesh"]
