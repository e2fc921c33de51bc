"""Oslo aerosol interface shims: oslo_aero_{microp,ocean,share}.

Twin of `cam_nor_physics_tpu.models.physics.oslo_aero`. The reference
ships these as deliberately empty stubs "to replace the need for
OSLO_AERO ifdef in NorESM physics" (oslo_aero_microp.F90:3): the real
OSLO_AERO package lives in a separate NorESM repository, and the physics
driver branches on `use_oslo_aero` (physpkg.F90:1801-1809, 2914-2920).
This module keeps that contract: the interfaces exist with the CAM
signatures, `use_oslo_aero` defaults to False, and the calls do nothing.
Neither package's physics driver calls them.
"""

from __future__ import annotations

# oslo_aero_share (oslo_aero_share.F90:8-9)
USE_OSLO_AERO: bool = False
NBMODES: int = 0


def oslo_aero_microp_run(state, ptend_all, dt, pbuf):
    """No-op with the CAM microp_aero_run interface
    (oslo_aero_microp.F90:16-25): returns its inputs unchanged. The
    `use_oslo_aero` branch of tphysac selects it instead of
    `microp_aero_run` (physpkg.F90:1801-1809)."""
    return state, ptend_all, pbuf


def oslo_aero_ocean_adv(state, pbuf):
    """No-op (oslo_aero_ocean.F90): the ocean DMS/aerosol advance hook."""
    return pbuf
