"""Rigid transforms of points and primitives.

Replaces the reference's per-primitive `transform.hpp:1-420` overload
family: here a rigid transform is (unit quaternion q, translation t)
applied to the arrays of a primitive pytree — positions map as
x' = R(q) x + t, directions/normals rotate, orientations compose, scalars
(radii/lengths) are invariant. One dispatcher covers all 11 primitives
(batched: every function maps over leading axes for free).
"""

from __future__ import annotations

import jax.numpy as jnp
from jax import Array

from mundy_tpu.geom import primitives as prim
from mundy_tpu.math.quaternion import (
    quat_inverse_rotate,
    quat_multiply,
    quat_rotate,
)


def transform_points(q: Array, t: Array, p: Array) -> Array:
    """x' = R(q) x + t."""
    return quat_rotate(q, p) + t


def inverse_transform_points(q: Array, t: Array, p: Array) -> Array:
    """x' = R(q)^T (x - t)."""
    return quat_inverse_rotate(q, p - t)


def _aabb_corners(box: prim.AABB) -> Array:
    """(..., 8, 3) corner points."""
    lo, hi = box.min, box.max
    corners = []
    for sx in (0, 1):
        for sy in (0, 1):
            for sz in (0, 1):
                sel = jnp.asarray([sx, sy, sz], lo.dtype)
                corners.append(lo + sel * (hi - lo))
    return jnp.stack(corners, axis=-2)


def transform_primitive(q: Array, t: Array, obj):
    """Rigidly transform any geom primitive (or a bare (..., 3) point
    array). ref: the transform() overloads of `transform.hpp:1-420`.

    AABBs transform to the AABB OF the rotated box (axis alignment is not
    rotation-invariant), matching the reference's conservative behavior.
    """
    if isinstance(obj, prim.Sphere):
        return prim.Sphere(center=transform_points(q, t, obj.center),
                           radius=obj.radius)
    if isinstance(obj, prim.Line):
        return prim.Line(point=transform_points(q, t, obj.point),
                         direction=quat_rotate(q, obj.direction))
    if isinstance(obj, prim.LineSegment):
        return prim.LineSegment(start=transform_points(q, t, obj.start),
                                end=transform_points(q, t, obj.end))
    if isinstance(obj, prim.VSegment):
        return prim.VSegment(start=transform_points(q, t, obj.start),
                             middle=transform_points(q, t, obj.middle),
                             end=transform_points(q, t, obj.end))
    if isinstance(obj, prim.Plane):
        return prim.Plane(point=transform_points(q, t, obj.point),
                          normal=quat_rotate(q, obj.normal))
    if isinstance(obj, prim.Circle3D):
        return prim.Circle3D(center=transform_points(q, t, obj.center),
                             orientation=quat_multiply(q, obj.orientation),
                             radius=obj.radius)
    if isinstance(obj, prim.Ring):
        return prim.Ring(center=transform_points(q, t, obj.center),
                         orientation=quat_multiply(q, obj.orientation),
                         major_radius=obj.major_radius,
                         minor_radius=obj.minor_radius)
    if isinstance(obj, prim.Spherocylinder):
        return prim.Spherocylinder(
            center=transform_points(q, t, obj.center),
            orientation=quat_multiply(q, obj.orientation),
            radius=obj.radius, length=obj.length)
    if isinstance(obj, prim.SpherocylinderSegment):
        return prim.SpherocylinderSegment(
            start=transform_points(q, t, obj.start),
            end=transform_points(q, t, obj.end), radius=obj.radius)
    if isinstance(obj, prim.Ellipsoid):
        return prim.Ellipsoid(center=transform_points(q, t, obj.center),
                              orientation=quat_multiply(q, obj.orientation),
                              radii=obj.radii)
    if isinstance(obj, prim.AABB):
        corners = transform_points(q[..., None, :] if q.ndim > 1 else q,
                                   t[..., None, :] if t.ndim > 1 else t,
                                   _aabb_corners(obj))
        return prim.AABB(min=jnp.min(corners, axis=-2),
                         max=jnp.max(corners, axis=-2))
    if isinstance(obj, jnp.ndarray) or hasattr(obj, "shape"):
        return transform_points(q, t, obj)
    raise TypeError(f"cannot transform {type(obj).__name__}")


def inverse_transform_primitive(q: Array, t: Array, obj):
    """Inverse rigid transform: the body frame of (q, t)."""
    from mundy_tpu.math.quaternion import quat_conjugate

    qi = quat_conjugate(q)
    ti = -quat_inverse_rotate(q, t)
    return transform_primitive(qi, ti, obj)
