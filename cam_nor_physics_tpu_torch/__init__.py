"""PyTorch/CUDA port of cam_nor_physics_tpu for NVIDIA Hopper.

The JAX package `cam_nor_physics_tpu` is the reference; this package mirrors
its layout (utils/, ops/, models/fv/) and imports nothing of it. Its first
slice is the Held-Suarez FV dycore large step (entry.build_step), whose four
hand-written CUDA kernels live in csrc/ and are built at first use.
"""
