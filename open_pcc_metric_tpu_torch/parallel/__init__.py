"""Multi-process helpers of the port.

``multihost`` splits a sweep's frames over processes that coordinate
through ``torch.distributed``; each writes its own journal shard.
"""
from . import multihost

__all__ = ["multihost"]
