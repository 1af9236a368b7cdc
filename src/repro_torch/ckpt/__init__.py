"""Checkpoint/restart of the port (``checkpoint``), in the reference's
file format; elastic restore waits for the port's sharding."""
