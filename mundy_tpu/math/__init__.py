"""Math layer: small-vector algebra, quaternions, SFC keys, solvers.

Replacement for MundyMath (reference `mundy/math/`, SURVEY.md
§2.2). The reference's accessor/ownership-templated `AVector`/`Matrix`/
`Quaternion` views collapse to plain jnp arrays with trailing-dim conventions
(`(..., 3)` vectors, `(..., 3, 3)` matrices, `(..., 4)` wxyz quaternions) —
"views over mesh fields" are just slices of the state pytree, and every op is
batched by construction.
"""

from mundy_tpu.math import linalg, quaternion, spacefill, convex, lbfgs
from mundy_tpu.math.tolerance import get_relative_tolerance, get_zero_tolerance
from mundy_tpu.math.linalg import (
    dot,
    cross,
    norm,
    norm_sq,
    normalize,
    outer,
)
from mundy_tpu.math.quaternion import (
    quat_identity,
    quat_multiply,
    quat_conjugate,
    quat_normalize,
    quat_rotate,
    quat_inverse_rotate,
    quat_from_axis_angle,
    quat_to_matrix,
    quat_from_matrix,
    quat_slerp,
    quat_from_omega_dt,
    quat_integrate,
)
from mundy_tpu.math.spacefill import (
    morton_key_3d,
    cell_linear_index,
    hilbert_key_3d,
    hilbert_positions_and_directors,
)
from mundy_tpu.math.convex import (
    Space,
    unconstrained,
    lower_bound,
    upper_bound,
    bounded,
    PGDConfig,
    SolveResult,
    solve_cqpp,
    solve_lcp,
)
from mundy_tpu.math.lbfgs import minimize_lbfgs

__all__ = [
    "linalg", "quaternion", "spacefill", "convex", "lbfgs",
    "dot", "cross", "norm", "norm_sq", "normalize", "outer",
    "quat_identity", "quat_multiply", "quat_conjugate", "quat_normalize",
    "quat_rotate", "quat_inverse_rotate", "quat_from_axis_angle",
    "quat_to_matrix", "quat_from_matrix", "quat_slerp", "quat_from_omega_dt",
    "quat_integrate",
    "morton_key_3d", "cell_linear_index", "hilbert_key_3d",
    "hilbert_positions_and_directors",
    "Space", "unconstrained", "lower_bound", "upper_bound", "bounded",
    "PGDConfig", "SolveResult", "solve_cqpp", "solve_lcp",
    "minimize_lbfgs",
]
