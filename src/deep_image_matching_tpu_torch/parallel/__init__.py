from .mesh import MeshRunner, get_default_mesh, mesh_devices  # noqa: F401
