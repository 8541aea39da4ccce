"""Time integration + Brownian motion.

Replacement for the reference's node-Euler integration
(`integrate_positions_node_euler`, HP1 driver `:1523`;
`scrap/motion/include/mundy_motion/` NodeEuler) and ComputeBrownianVelocity
(`scrap/parameter_interface/alens/src/mundy_alens/compute_brownian_velocity/
kernels/SpheresKernel.cpp:104-129`).
"""

from mundy_tpu.dynamics.integrators import euler_step, euler_step_rigid
from mundy_tpu.dynamics.brownian import (
    brownian_velocity,
    brownian_velocity_keyed,
    brownian_angular_velocity,
)

__all__ = [
    "euler_step",
    "euler_step_rigid",
    "brownian_velocity",
    "brownian_velocity_keyed",
    "brownian_angular_velocity",
]
