from . import mesh, multihost
from .mesh import Mesh, make_mesh, pad_batch_to_devices, replicate, shard_batch

__all__ = [
    "mesh",
    "multihost",
    "Mesh",
    "make_mesh",
    "pad_batch_to_devices",
    "replicate",
    "shard_batch",
]
