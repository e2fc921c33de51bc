"""Multi-device runs of the port: meshes of ranks, latitude strips and the
strip stencils (twin of `cam_nor_physics_tpu.parallel`)."""
