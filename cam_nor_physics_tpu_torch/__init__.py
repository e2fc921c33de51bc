"""PyTorch/CUDA port of cam_nor_physics_tpu for NVIDIA Hopper.

The JAX package `cam_nor_physics_tpu` is the reference; this package mirrors
its layout (utils/, ops/, models/fv/, models/physics/) and imports nothing
of it. It runs bench.py's main path: the Held-Suarez FV dycore large step
(entry.build_step) and one ZM deep-convection step (entry.build_zm_step),
whose hand-written CUDA kernels live in csrc/ and are built at first use;
and the coupled atm_step (models/atm_comp.py, entry.build_coupled).
`python -m cam_nor_physics_tpu_torch.bench` times them as bench.py does.
"""
