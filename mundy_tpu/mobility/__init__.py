"""Mobility operators: force -> velocity maps for Stokes suspensions.

Replacement for the reference's mobility layer
(`scrap/parameter_interface/alens/src/mundy_alens/compute_mobility/` with
LocalDragNonOrientableSpheres and RPYSpheres techniques, and the team-based
RPY kernel of `scrap/lcp_spheres/StkNgpLCP.cpp:296-390`). All operators are
matrix-free `apply(forces) -> velocities` functions suitable for use inside
the BBPGD collision solver and as drift terms.
"""

from mundy_tpu.mobility.local_drag import (
    local_drag_mobility,
    local_drag_angular_mobility,
)
from mundy_tpu.mobility.rpy import (
    rpy_apply_dense,
    rpy_apply_neighbors,
    rpy_flow_at,
    rpy_self_mobility,
)
from mundy_tpu.mobility.ewald import (
    EwaldRPY,
    build_ewald_rpy,
    ewald_rpy_apply,
)
from mundy_tpu.mobility.spectral import (
    SpectralEwaldRPY,
    build_spectral_ewald,
    se_rpy_apply,
    se_wave_apply,
)
from mundy_tpu.mobility.periphery import (
    Periphery,
    build_sphere_periphery,
    double_layer_flow,
    no_slip_correction,
    surface_densities,
)

__all__ = [
    "Periphery",
    "build_sphere_periphery",
    "double_layer_flow",
    "no_slip_correction",
    "surface_densities",
    "SpectralEwaldRPY",
    "build_spectral_ewald",
    "se_rpy_apply",
    "se_wave_apply",
    "local_drag_mobility",
    "local_drag_angular_mobility",
    "rpy_apply_dense",
    "rpy_apply_neighbors",
    "rpy_flow_at",
    "rpy_self_mobility",
    "EwaldRPY",
    "build_ewald_rpy",
    "ewald_rpy_apply",
]
