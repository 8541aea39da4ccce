"""Per-dtype zero tolerances.

Replaces the reference's `mundy/math/src/mundy_math/Tolerance.hpp`
(`get_zero_tolerance` per scalar type): one table of "treat as zero"
thresholds used by distance kernels, solvers, and tests. The values follow
the reference's convention of a few orders of magnitude above machine
epsilon (room for accumulated rounding in compound kernels), extended with
a bfloat16 entry.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np

_TABLE = {
    np.dtype(np.float64): 1e-12,
    np.dtype(np.float32): 1e-5,
    np.dtype(np.float16): 1e-2,
    np.dtype(jnp.bfloat16): 1e-1,
}


def get_zero_tolerance(dtype) -> float:
    """The "effectively zero" threshold for `dtype` (ref Tolerance.hpp)."""
    dt = np.dtype(dtype)
    if dt in _TABLE:
        return _TABLE[dt]
    if np.issubdtype(dt, np.integer):
        return 0.0
    raise TypeError(f"no zero tolerance for dtype {dt}")


def get_relative_tolerance(dtype) -> float:
    """~100 ulp relative comparison tolerance for `dtype`."""
    dt = np.dtype(dtype)
    if dt == np.dtype(jnp.bfloat16):
        return 100 * 2.0 ** -8
    return float(100 * np.finfo(dt).eps)
