"""PyTorch/CUDA port of specforge_tpu (EAGLE3 offline TTT forward slice).

The JAX package ``specforge_tpu`` is the reference; this package imports
nothing of it, nor JAX. Hand-written Hopper kernels live in ``csrc/``.
"""
