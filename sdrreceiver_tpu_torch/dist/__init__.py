"""Sharded execution over device meshes and processes (port of
``sdrreceiver_tpu.dist``)."""

from . import halo, mesh, multihost, sharded
from .mesh import CHAN_AXIS, TIME_AXIS, Mesh, local_devices, make_mesh
from .sharded import ShardedReceiver

__all__ = [
    "halo",
    "mesh",
    "multihost",
    "sharded",
    "Mesh",
    "make_mesh",
    "local_devices",
    "ShardedReceiver",
    "TIME_AXIS",
    "CHAN_AXIS",
]
