"""repro_torch — the PyTorch/CUDA port of the CloudNativeSim engine.

The JAX package ``repro`` is the reference; this package runs the same
simulation in PyTorch, on an NVIDIA GPU by default, with hand-written
Hopper kernels (``csrc/``) where the reference had Pallas TPU kernels.
It imports neither ``jax`` nor ``repro``.
"""
