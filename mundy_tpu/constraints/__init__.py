"""Constrained dynamics: LCP-based non-penetration collision resolution.

Replacement for the reference's matrix-free BBPGD collision path
(`scrap/lcp_spheres/StkNgpLCP.cpp:705-875`) and the archived NonSmoothLCP
(`scrap/motion/`).
"""

from mundy_tpu.constraints.collision import (
    CollisionSetup,
    collision_setup_spheres,
    resolve_collisions,
    collision_forces,
    remap_gamma,
)

__all__ = [
    "CollisionSetup",
    "collision_setup_spheres",
    "resolve_collisions",
    "collision_forces",
    "remap_gamma",
]
