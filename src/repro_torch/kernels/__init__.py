"""Hand-written Hopper kernels of the port and their plain versions.

``counts`` holds one launch counter per kernel: each wrapper calls
``launched(name)`` where it launches its CUDA kernel and nowhere else
(the plain versions the CPU path runs are not counted).  Under ``tally()``
the launches go to the tally instead: a CUDA graph's capture records its
launches there, and each replay adds them with ``add_counts``, so that
``counts`` still counts the kernel's launches on the card.
``reset_counts()`` zeroes them.  ``KERNELS`` names the CUDA sources
(``csrc/<name>.cu``).  A wrapper's card path takes plain tensors:
``reject_dtensor`` raises, naming the entry, where a DTensor reaches it
(the CPU path's plain versions take DTensors: the dry run's).
"""
import contextlib

from ..dist.sharding import is_dtensor

KERNELS = ("cloudlet_finish", "tropical", "link_share", "flash_attention",
           "ssd_chunk", "flash_attention_bwd", "ssd_chunk_bwd")
counts = {"cloudlet_finish": 0, "tropical_matmul": 0, "tropical_closure": 0,
          "link_share": 0, "flash_attention": 0, "ssd_chunk": 0,
          "flash_attention_bwd": 0, "ssd_chunk_bwd": 0}
_TALLIES: list = []


def launched(name: str) -> None:
    """Count one launch of kernel ``name`` (in the innermost open tally,
    if any)."""
    (_TALLIES[-1] if _TALLIES else counts)[name] += 1


@contextlib.contextmanager
def tally():
    """Collect the launches made inside the block in a dict of their own,
    apart from ``counts``."""
    t = dict.fromkeys(counts, 0)
    _TALLIES.append(t)
    try:
        yield t
    finally:
        _TALLIES.pop()


def add_counts(t: dict) -> None:
    for k, v in t.items():
        counts[k] += v


def reset_counts() -> None:
    for k in counts:
        counts[k] = 0


def reject_dtensor(entry: str, *ts) -> None:
    """Raise if a DTensor reaches ``entry``'s kernel: nothing unwraps one
    to its local shard on the card."""
    if any(is_dtensor(t) for t in ts):
        raise TypeError(f"{entry} launches its kernel on plain tensors; "
                        "it was given a DTensor")
