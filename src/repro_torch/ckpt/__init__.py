"""Checkpoint/restart of the port (``checkpoint``), in the reference's
file format, and elastic restore (``elastic``): a host-side tree placed
onto any mesh by the logical-axis rules of ``dist.sharding``."""
from .elastic import reshard_tree  # noqa: F401
