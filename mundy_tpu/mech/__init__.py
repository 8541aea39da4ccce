"""Mechanical elements: rods, joints.

Replacement for MundyMech (reference `mundy/mech/`, SURVEY.md
§2.4). The reference's owning/view spring-joint primitives (HookeanSpring,
FeneSpring, TorsionalSpring, BallJoint) become parameter arrays +
connectivity index arrays evaluated by `mundy_tpu.forces.springs`; the
centerline-twist Kirchhoff rod (archived `scrap/Sperm.cpp:23-175`) lives in
`mech.rod`.
"""

from mundy_tpu.mech.rod import (
    RodState,
    init_rod_edges,
    update_rod_edges,
    rod_curvature,
    rod_internal_forces,
)
from mundy_tpu.mech.joints import ball_joint_forces

__all__ = [
    "RodState",
    "init_rod_edges",
    "update_rod_edges",
    "rod_curvature",
    "rod_internal_forces",
    "ball_joint_forces",
]
