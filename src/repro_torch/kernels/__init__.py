"""Hand-written Hopper kernels of the port and their plain versions.

``counts`` holds one launch counter per kernel: each wrapper adds one
where it launches its CUDA kernel and nowhere else (the plain versions
the CPU path runs are not counted).  ``reset_counts()`` zeroes them.
``KERNELS`` names the CUDA sources (``csrc/<name>.cu``).
"""
KERNELS = ("cloudlet_finish", "tropical", "link_share", "flash_attention",
           "ssd_chunk")
counts = {"cloudlet_finish": 0, "tropical_matmul": 0, "tropical_closure": 0,
          "link_share": 0, "flash_attention": 0, "ssd_chunk": 0}


def reset_counts() -> None:
    for k in counts:
        counts[k] = 0
