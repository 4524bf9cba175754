"""Multi-device and multi-process evaluation of the port.

``sharded`` is the ring: one process drives a ("frames", "points") mesh of
torch devices, frame groups over its rows and each cloud's points over a
row's slots (``make_mesh``, the ring searches, ``sharded_pair_stats``).
``multihost`` splits a sweep's frames over processes that coordinate
through ``torch.distributed``; each writes its own journal shard.
"""
from . import multihost
from .sharded import (
    make_mesh,
    ring_nn,
    ring_nn_pruned,
    ring_knn_coords,
    ring_knn_coords_pruned,
    ring_normals,
    sharded_pair_stats,
)

__all__ = [
    "make_mesh",
    "ring_nn",
    "ring_nn_pruned",
    "ring_knn_coords",
    "ring_knn_coords_pruned",
    "ring_normals",
    "sharded_pair_stats",
    "multihost",
]
