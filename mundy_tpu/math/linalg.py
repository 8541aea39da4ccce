"""Batched small-vector algebra over trailing axes.

Replaces the reference's `AVector`/`Matrix3` operator machinery
(`mundy/math/src/mundy_math/Vector.hpp:112`, `Matrix.hpp`): here a "Vector3"
is any array of shape `(..., 3)` and every operation broadcasts over leading
batch axes, so the zero-copy Shifted/Strided/Masked accessor views of the
reference are simply array slices.
"""

from __future__ import annotations

import jax.numpy as jnp
from jax import Array


def dot(a: Array, b: Array) -> Array:
    """Batched inner product over the trailing axis: (..., d) x (..., d) -> (...)."""
    return jnp.sum(a * b, axis=-1)


def norm_sq(a: Array) -> Array:
    return jnp.sum(a * a, axis=-1)


def norm(a: Array) -> Array:
    return jnp.sqrt(norm_sq(a))


def normalize(a: Array, eps: float = 0.0) -> Array:
    """Unit vector along `a`; if eps > 0 guards the zero vector (returns 0)."""
    n = norm(a)
    if eps > 0.0:
        safe = jnp.maximum(n, eps)
        return jnp.where(n[..., None] > eps, a / safe[..., None], jnp.zeros_like(a))
    return a / n[..., None]


def cross(a: Array, b: Array) -> Array:
    """Batched 3-vector cross product."""
    return jnp.stack(
        [
            a[..., 1] * b[..., 2] - a[..., 2] * b[..., 1],
            a[..., 2] * b[..., 0] - a[..., 0] * b[..., 2],
            a[..., 0] * b[..., 1] - a[..., 1] * b[..., 0],
        ],
        axis=-1,
    )


def outer(a: Array, b: Array) -> Array:
    """Batched outer product: (..., n) x (..., m) -> (..., n, m)."""
    return a[..., :, None] * b[..., None, :]
