from .mesh import Mesh, ShardDevice, make_mesh, replicated

__all__ = ["Mesh", "ShardDevice", "make_mesh", "replicated"]
