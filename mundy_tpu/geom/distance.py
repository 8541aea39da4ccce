"""Batched distance kernels for all shape pairs.

Replaces the reference's overloaded `distance()` family
(`mundy/geom/src/mundy_geom/distance.hpp:26-53` + per-pair headers in
`distance/`). Tag dispatch (`SharedNormalSigned` vs `Euclidean`,
`distance/Types.hpp:37-39`) becomes explicit function names; every function
is branch-free (where-selects instead of if/else) so it vmaps/jits over
millions of pairs, and takes an optional periodic `Metric` that shifts body 2
to its minimum image before the free-space computation (valid while bodies
are smaller than half the box, the usual MD contract).

Return convention: `SepResult(dist, point1, point2, normal)` where
- dist is the shared-normal SIGNED separation (negative = overlap) for pairs
  with surfaces (sphere/capsule/ellipsoid/plane), Euclidean otherwise;
- point1/point2 are the closest (foot) points on each object's surface or
  skeleton (for point/line/segment pairs: the closest points themselves);
- normal is the unit shared normal pointing from object 1 toward object 2
  (matches the reference's linker contact-normal convention,
  `StkNgpLCP.cpp:504-508`).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp
from jax import Array

from mundy_tpu.geom.primitives import (
    Circle3D,
    Ellipsoid,
    LineSegment,
    Plane,
    Sphere,
    Spherocylinder,
    SpherocylinderSegment,
    VSegment,
    spherocylinder_endpoints,
)
from mundy_tpu.geom.periodicity import Metric
from mundy_tpu.math.linalg import cross, dot, norm, normalize
from mundy_tpu.math.quaternion import quat_inverse_rotate, quat_rotate


class SepResult(NamedTuple):
    dist: Array  # (...) signed separation (or euclidean distance)
    point1: Array  # (..., 3) closest/foot point on object 1
    point2: Array  # (..., 3) closest/foot point on object 2
    normal: Array  # (..., 3) unit normal from 1 to 2


_EPS = 1e-12


def _image_shift(anchor1: Array, anchor2: Array, metric: Optional[Metric]) -> Array:
    """Translation that moves object 2 to its minimum image w.r.t. object 1."""
    if metric is None:
        return jnp.zeros_like(anchor1)
    return metric.sep(anchor1, anchor2) - (anchor2 - anchor1)


def _safe_normal(sep_vec: Array) -> Array:
    return normalize(sep_vec, eps=_EPS)


# --------------------------------------------------------------------------
# point family
# --------------------------------------------------------------------------
def distance_point_point(p1: Array, p2: Array, metric: Optional[Metric] = None) -> SepResult:
    """ref: distance/PointPoint.hpp"""
    sep = p2 - p1 if metric is None else metric.sep(p1, p2)
    d = norm(sep)
    n = _safe_normal(sep)
    return SepResult(d, p1, p1 + sep, n)


def distance_point_line(p: Array, line_point: Array, line_dir: Array,
                        metric: Optional[Metric] = None) -> SepResult:
    """ref: distance/PointLine.hpp. line_dir must be unit."""
    lp = line_point + _image_shift(p, line_point, metric)
    w = p - lp
    t = dot(w, line_dir)
    foot = lp + t[..., None] * line_dir
    sep = foot - p
    return SepResult(norm(sep), p, foot, _safe_normal(sep))


def _closest_param_on_segment(p: Array, a: Array, b: Array) -> Array:
    u = b - a
    uu = jnp.maximum(dot(u, u), _EPS)
    return jnp.clip(dot(p - a, u) / uu, 0.0, 1.0)


def distance_point_segment(p: Array, seg: LineSegment,
                           metric: Optional[Metric] = None) -> SepResult:
    """ref: distance/PointLineSegment.hpp"""
    shift = _image_shift(p, 0.5 * (seg.start + seg.end), metric)
    a, b = seg.start + shift, seg.end + shift
    t = _closest_param_on_segment(p, a, b)
    foot = a + t[..., None] * (b - a)
    sep = foot - p
    return SepResult(norm(sep), p, foot, _safe_normal(sep))


def distance_point_plane(p: Array, plane: Plane,
                         metric: Optional[Metric] = None) -> SepResult:
    """Signed by plane normal. ref: distance/PointPlane.hpp"""
    pp = plane.point + _image_shift(p, plane.point, metric)
    s = dot(p - pp, plane.normal)
    foot = p - s[..., None] * plane.normal
    return SepResult(s, p, foot, -plane.normal)


def distance_point_sphere(p: Array, sph: Sphere,
                          metric: Optional[Metric] = None) -> SepResult:
    """Signed (negative inside). ref: distance/PointSphere.hpp"""
    c = sph.center + _image_shift(p, sph.center, metric)
    sep = c - p
    d = norm(sep)
    n = _safe_normal(sep)
    surf = c - n * sph.radius[..., None]
    return SepResult(d - sph.radius, p, surf, n)


def _point_ellipsoid_body(p: Array, radii: Array, newton_iters: int = 64) -> tuple:
    """Closest point on an axis-aligned ellipsoid (body frame) to p.

    Eberly's secular-equation approach, done with bisection (robust and
    branch-free; fixed iteration count for jit). Solves for t in
        sum_i (r_i^2 p_i / (t + r_i^2))^2 / r_i^2 = 1
    with closest point x_i = r_i^2 p_i / (t + r_i^2). This is the batched
    replacement for the reference's in-kernel minimization in
    distance/PointEllipsoid.hpp.
    """
    dtype = p.dtype
    r2 = radii * radii
    # perturb exact-zero components to avoid the degenerate axis case
    p_safe = jnp.where(jnp.abs(p) < 1e-14, 1e-14, p)

    def f(t):
        x = r2 * p_safe / (t[..., None] + r2)
        return jnp.sum((x / radii) ** 2, axis=-1) - 1.0

    r2_min = jnp.min(r2, axis=-1)
    batch = jnp.broadcast_shapes(p.shape[:-1], radii.shape[:-1])
    # t > -r2_min; f is strictly decreasing on that interval.
    lo = jnp.broadcast_to(-r2_min + jnp.asarray(1e-12, dtype), batch)
    hi = jnp.broadcast_to(norm(radii * p_safe) + jnp.max(r2, axis=-1), batch)  # f(hi) < 0

    def body(_, lohi):
        lo, hi = lohi
        mid = 0.5 * (lo + hi)
        fm = f(mid)
        lo = jnp.where(fm > 0, mid, lo)
        hi = jnp.where(fm > 0, hi, mid)
        return lo, hi

    lo, hi = jax.lax.fori_loop(0, newton_iters, body, (lo, hi))
    t = 0.5 * (lo + hi)
    x = r2 * p_safe / (t[..., None] + r2)
    inside = jnp.sum((p_safe / radii) ** 2, axis=-1) < 1.0
    d = norm(p - x) * jnp.where(inside, -1.0, 1.0)
    return x, d


def distance_point_ellipsoid(p: Array, ell: Ellipsoid,
                             metric: Optional[Metric] = None) -> SepResult:
    """Signed (negative inside). ref: distance/PointEllipsoid.hpp"""
    c = ell.center + _image_shift(p, ell.center, metric)
    pb = quat_inverse_rotate(ell.orientation, p - c)
    xb, d = _point_ellipsoid_body(pb, ell.radii)
    foot = quat_rotate(ell.orientation, xb) + c
    n = _safe_normal(foot - p) * jnp.where(d < 0, -1.0, 1.0)[..., None]
    return SepResult(d, p, foot, n)


def distance_point_vsegment(p: Array, v: VSegment,
                            metric: Optional[Metric] = None) -> SepResult:
    """Min over the two legs. ref: primitives/VSegment.hpp usage"""
    r1 = distance_point_segment(p, LineSegment(v.start, v.middle), metric)
    r2 = distance_point_segment(p, LineSegment(v.middle, v.end), metric)
    take1 = (r1.dist <= r2.dist)[..., None]
    return SepResult(
        jnp.minimum(r1.dist, r2.dist),
        p,
        jnp.where(take1, r1.point2, r2.point2),
        jnp.where(take1, r1.normal, r2.normal),
    )


# --------------------------------------------------------------------------
# line family
# --------------------------------------------------------------------------
def distance_line_line(p1: Array, d1: Array, p2: Array, d2: Array,
                       metric: Optional[Metric] = None) -> SepResult:
    """Closest approach of two infinite lines (unit dirs). ref: distance/LineLine.hpp"""
    p2 = p2 + _image_shift(p1, p2, metric)
    w = p1 - p2
    b = dot(d1, d2)
    d_ = dot(d1, w)
    e = dot(d2, w)
    denom = 1.0 - b * b
    parallel = denom < 1e-12
    safe = jnp.where(parallel, 1.0, denom)
    s = jnp.where(parallel, 0.0, (b * e - d_) / safe)
    t = jnp.where(parallel, e, (e - b * d_) / safe)
    c1 = p1 + s[..., None] * d1
    c2 = p2 + t[..., None] * d2
    sep = c2 - c1
    return SepResult(norm(sep), c1, c2, _safe_normal(sep))


def distance_line_sphere(lp: Array, ld: Array, sph: Sphere,
                         metric: Optional[Metric] = None) -> SepResult:
    """Signed to surface. ref: distance/LineSphere.hpp"""
    r = distance_point_line(sph.center, lp, ld, metric)
    # point1 of r is the center; point2 the foot on the line
    n = -r.normal  # from line toward center
    surf = sph.center - n * sph.radius[..., None]
    return SepResult(r.dist - sph.radius, r.point2, surf, n)


def distance_line_plane(lp: Array, ld: Array, plane: Plane,
                        metric: Optional[Metric] = None) -> SepResult:
    """0 unless parallel; then plane-offset. ref: distance/LinePlane.hpp"""
    pp = plane.point + _image_shift(lp, plane.point, metric)
    denom = dot(ld, plane.normal)
    parallel = jnp.abs(denom) < 1e-12
    t = jnp.where(parallel, 0.0, -dot(lp - pp, plane.normal) / jnp.where(parallel, 1.0, denom))
    hit = lp + t[..., None] * ld
    s = dot(lp - pp, plane.normal)
    d = jnp.where(parallel, s, 0.0)
    foot = jnp.where(parallel[..., None], lp - s[..., None] * plane.normal, hit)
    p_on_line = jnp.where(parallel[..., None], lp, hit)
    return SepResult(d, p_on_line, foot, -plane.normal)


# --------------------------------------------------------------------------
# segment family
# --------------------------------------------------------------------------
def segment_segment_closest(a0: Array, a1: Array, b0: Array, b1: Array):
    """Clamped closest points between segments [a0,a1], [b0,b1].

    Branch-free port of the classic algorithm used by the reference
    (distance/LineSegmentLineSegment.hpp:51-200, adapted from VTK /
    GeometryAlgorithms.com), including the near-parallel fallback that takes
    the best of the four endpoint projections.
    Returns (s, t, c1, c2): arc parameters and closest points.
    """
    u = a1 - a0
    v = b1 - b0
    w = a0 - b0
    a = dot(u, u)
    b = dot(u, v)
    c = dot(v, v)
    d = dot(u, w)
    e = dot(v, w)
    D = a * c - b * b

    # General (non-parallel) case with edge clamping.
    sN = b * e - c * d
    tN = a * e - b * d
    sD = jnp.where(D > 0, D, 1.0)
    tD = sD

    # clamp s to [0, sD]
    s_lo = sN < 0.0
    s_hi = sN > sD
    tN = jnp.where(s_lo, e, jnp.where(s_hi, e + b, tN))
    tD = jnp.where(s_lo | s_hi, c, tD)
    sN = jnp.clip(sN, 0.0, sD)

    # clamp t to [0, tD], recompute s on those edges
    t_lo = tN < 0.0
    t_hi = tN > tD
    sN_t_lo = jnp.clip(-d, 0.0, a)
    sN_t_hi = jnp.clip(-d + b, 0.0, a)
    sN = jnp.where(t_lo, sN_t_lo, jnp.where(t_hi, sN_t_hi, sN))
    sD = jnp.where(t_lo | t_hi, jnp.maximum(a, _EPS), sD)
    tN = jnp.clip(tN, 0.0, tD)

    s = sN / jnp.maximum(sD, _EPS)
    t = tN / jnp.maximum(tD, _EPS)

    # Near-parallel / degenerate fallback: best of 4 endpoint projections.
    ta0 = _closest_param_on_segment(a0, b0, b1)
    ta1 = _closest_param_on_segment(a1, b0, b1)
    sb0 = _closest_param_on_segment(b0, a0, a1)
    sb1 = _closest_param_on_segment(b1, a0, a1)
    cands_s = jnp.stack([jnp.zeros_like(s), jnp.ones_like(s), sb0, sb1], axis=-1)
    cands_t = jnp.stack([ta0, ta1, jnp.zeros_like(t), jnp.ones_like(t)], axis=-1)

    def seg_pts(ss, tt):
        c1 = a0[..., None, :] + ss[..., :, None] * u[..., None, :]
        c2 = b0[..., None, :] + tt[..., :, None] * v[..., None, :]
        return c1, c2

    c1s, c2s = seg_pts(cands_s, cands_t)
    d2s = jnp.sum((c2s - c1s) ** 2, axis=-1)
    best = jnp.argmin(d2s, axis=-1)
    s_par = jnp.take_along_axis(cands_s, best[..., None], axis=-1)[..., 0]
    t_par = jnp.take_along_axis(cands_t, best[..., None], axis=-1)[..., 0]

    parallel = D < 1e-9 * jnp.maximum(a * c, _EPS)
    s = jnp.where(parallel, s_par, s)
    t = jnp.where(parallel, t_par, t)

    c1 = a0 + s[..., None] * u
    c2 = b0 + t[..., None] * v
    return s, t, c1, c2


def distance_segment_segment(s1: LineSegment, s2: LineSegment,
                             metric: Optional[Metric] = None) -> SepResult:
    """ref: distance/LineSegmentLineSegment.hpp:51-200"""
    mid1 = 0.5 * (s1.start + s1.end)
    mid2 = 0.5 * (s2.start + s2.end)
    shift = _image_shift(mid1, mid2, metric)
    s, t, c1, c2 = segment_segment_closest(s1.start, s1.end, s2.start + shift, s2.end + shift)
    sep = c2 - c1
    return SepResult(norm(sep), c1, c2, _safe_normal(sep))


def distance_segment_sphere(seg: LineSegment, sph: Sphere,
                            metric: Optional[Metric] = None) -> SepResult:
    """ref: distance/LineSegmentSphere.hpp"""
    r = distance_point_segment(sph.center, seg, metric)
    # r.point2 = foot on segment, r.normal from center toward segment
    n = -r.normal
    surf = sph.center + _image_shift(r.point2, sph.center, metric) - n * 0.0  # center image
    surf = sph.center - n * sph.radius[..., None]
    return SepResult(r.dist - sph.radius, r.point2, surf, n)


def distance_segment_plane(seg: LineSegment, plane: Plane,
                           metric: Optional[Metric] = None) -> SepResult:
    """Signed; 0 if the segment crosses the plane. ref: distance/LineSegmentPlane.hpp"""
    pp = plane.point + _image_shift(0.5 * (seg.start + seg.end), plane.point, metric)
    s0 = dot(seg.start - pp, plane.normal)
    s1 = dot(seg.end - pp, plane.normal)
    crosses = s0 * s1 < 0.0
    pick0 = jnp.abs(s0) <= jnp.abs(s1)
    s = jnp.where(crosses, 0.0, jnp.where(pick0, s0, s1))
    p_on = jnp.where(pick0[..., None], seg.start, seg.end)
    foot = p_on - jnp.where(pick0, s0, s1)[..., None] * plane.normal
    return SepResult(s, p_on, foot, -plane.normal)


# --------------------------------------------------------------------------
# sphere / plane / ellipsoid families
# --------------------------------------------------------------------------
def distance_sphere_sphere(s1: Sphere, s2: Sphere,
                           metric: Optional[Metric] = None) -> SepResult:
    """Signed surface separation. ref: distance/SphereSphere.hpp:45-72"""
    sep = (s2.center - s1.center) if metric is None else metric.sep(s1.center, s2.center)
    d = norm(sep)
    n = _safe_normal(sep)
    p1 = s1.center + n * s1.radius[..., None]
    p2 = s1.center + sep - n * s2.radius[..., None]
    return SepResult(d - s1.radius - s2.radius, p1, p2, n)


def distance_sphere_ellipsoid(sph: Sphere, ell: Ellipsoid,
                              metric: Optional[Metric] = None) -> SepResult:
    """ref: distance/SphereEllipsoid.hpp"""
    r = distance_point_ellipsoid(sph.center, ell, metric)
    n = r.normal
    p1 = sph.center + n * sph.radius[..., None]
    return SepResult(r.dist - sph.radius, p1, r.point2, n)


def distance_plane_sphere(plane: Plane, sph: Sphere,
                          metric: Optional[Metric] = None) -> SepResult:
    """Signed surface-to-plane (sign of the center's side). ref: distance/PlaneSphere.hpp"""
    c = sph.center + _image_shift(plane.point, sph.center, metric)
    s = dot(c - plane.point, plane.normal)
    side = jnp.sign(jnp.where(s == 0, 1.0, s))
    d = jnp.abs(s) - sph.radius
    n = plane.normal * side[..., None]  # from plane toward sphere
    p2 = c - n * sph.radius[..., None]
    p1 = c - s[..., None] * plane.normal
    return SepResult(d * side, p1, p2, n)


def distance_plane_plane(p1: Plane, p2: Plane,
                         metric: Optional[Metric] = None) -> SepResult:
    """0 unless parallel. ref: distance/PlanePlane.hpp"""
    q2 = p2.point + _image_shift(p1.point, p2.point, metric)
    parallel = norm(cross(p1.normal, p2.normal)) < 1e-9
    s = dot(q2 - p1.point, p1.normal)
    d = jnp.where(parallel, s, 0.0)
    foot2 = jnp.where(parallel[..., None], p1.point + s[..., None] * p1.normal, p1.point)
    return SepResult(d, p1.point, foot2, p1.normal)


def distance_plane_ellipsoid(plane: Plane, ell: Ellipsoid,
                             metric: Optional[Metric] = None) -> SepResult:
    """Support-function form: separation = |h| - support(n). ref: distance/PlaneEllipsoid.hpp"""
    c = ell.center + _image_shift(plane.point, ell.center, metric)
    h = dot(c - plane.point, plane.normal)
    side = jnp.sign(jnp.where(h == 0, 1.0, h))
    # support radius along n: sqrt(n^T R diag(r^2) R^T n)
    nb = quat_inverse_rotate(ell.orientation, plane.normal)
    supp = jnp.sqrt(jnp.sum((ell.radii * nb) ** 2, axis=-1))
    d = jnp.abs(h) - supp
    n_to_ell = plane.normal * side[..., None]
    # foot point on ellipsoid surface: the support point opposing the plane
    grad_dir = -(side[..., None]) * nb  # direction minimizing h
    xb = (ell.radii**2) * grad_dir / jnp.maximum(
        jnp.sqrt(jnp.sum((ell.radii * grad_dir) ** 2, axis=-1))[..., None], _EPS
    )
    p2 = quat_rotate(ell.orientation, xb) + c
    p1 = p2 - dot(p2 - plane.point, plane.normal)[..., None] * plane.normal
    return SepResult(d * side, p1, p2, n_to_ell)


# --------------------------------------------------------------------------
# spherocylinders (capsules) — the rod/filament workhorses
# --------------------------------------------------------------------------
def distance_sphere_scsegment(sph: Sphere, sc: SpherocylinderSegment,
                              metric: Optional[Metric] = None) -> SepResult:
    """ref: linkers SphereSpherocylinderSegment narrow-phase kernels"""
    r = distance_point_segment(sph.center, LineSegment(sc.start, sc.end), metric)
    n = r.normal  # from sphere center toward segment axis
    d = r.dist - sph.radius - sc.radius
    p1 = sph.center + n * sph.radius[..., None]
    p2 = r.point2 - n * sc.radius[..., None]
    return SepResult(d, p1, p2, n)


def distance_scsegment_scsegment(sc1: SpherocylinderSegment, sc2: SpherocylinderSegment,
                                 metric: Optional[Metric] = None) -> SepResult:
    """ref: linkers SpherocylinderSegmentSpherocylinderSegment kernels"""
    r = distance_segment_segment(
        LineSegment(sc1.start, sc1.end), LineSegment(sc2.start, sc2.end), metric
    )
    d = r.dist - sc1.radius - sc2.radius
    p1 = r.point1 + r.normal * sc1.radius[..., None]
    p2 = r.point2 - r.normal * sc2.radius[..., None]
    return SepResult(d, p1, p2, r.normal)


def distance_sphere_spherocylinder(sph: Sphere, sc: Spherocylinder,
                                   metric: Optional[Metric] = None) -> SepResult:
    """ref: linkers SphereSpherocylinder kernels"""
    return distance_sphere_scsegment(sph, spherocylinder_endpoints(sc), metric)


def distance_spherocylinder_spherocylinder(sc1: Spherocylinder, sc2: Spherocylinder,
                                           metric: Optional[Metric] = None) -> SepResult:
    """ref: linkers SpherocylinderSpherocylinder kernels"""
    return distance_scsegment_scsegment(
        spherocylinder_endpoints(sc1), spherocylinder_endpoints(sc2), metric
    )


# --------------------------------------------------------------------------
# ellipsoid-ellipsoid (in-kernel minimization) and line/segment-ellipsoid
# --------------------------------------------------------------------------
def _foot_point_from_normal(nhat_lab: Array, ell: Ellipsoid) -> Array:
    """Lab-frame surface point of `ell` whose outward normal is nhat_lab.

    ref: map_surface_normal_to_foot_point_on_ellipsoid
    (primitives/Ellipsoid.hpp:420-468). For outward normal n (body frame),
    the surface point is x_i = r_i^2 n_i / sqrt(sum_j r_j^2 n_j^2).
    """
    nb = quat_inverse_rotate(ell.orientation, nhat_lab)
    scale = jnp.sqrt(jnp.sum((ell.radii * nb) ** 2, axis=-1))
    xb = (ell.radii**2) * nb / jnp.maximum(scale, _EPS)[..., None]
    return quat_rotate(ell.orientation, xb) + ell.center


def distance_ellipsoid_ellipsoid(e1: Ellipsoid, e2: Ellipsoid,
                                 metric: Optional[Metric] = None,
                                 newton_iters: int = 48,
                                 refine: str = "none",
                                 refine_iters: int = 12,
                                 n0: Optional[Array] = None) -> SepResult:
    """Shared-normal signed separation between two ellipsoids.

    Mirrors the reference's in-kernel minimization
    (distance/EllipsoidEllipsoid.hpp:45-152): parameterize a trial shared
    normal n(θ,φ), map it to foot points on both ellipsoids (outward n on
    e1, -n on e2), and minimize the foot-point distance. The reference runs
    dlib-style L-BFGS from a 3x3 multistart grid; here we use projected
    gradient descent directly on the unit-sphere of normals (autodiff
    gradient, fixed iterations) from the same multistart budget — no angle
    chart, no gimbal issues, fully vmappable.

    `n0` (optional, (..., 3)): TEMPORAL WARM START — seed the minimization
    from a previous step's converged shared normal and SKIP the 7-point
    multistart entirely (contact normals are strongly step-coherent at dt
    where contacts persist; callers keep per-pair-slot normals between
    neighbor rebuilds and re-seed cold at rebuilds). Pair with a reduced
    `newton_iters` (~6): the polish supplies the superlinear tail.

    `refine="lbfgs"` then polishes the winning normal with the batched
    no-alloc L-BFGS (math/lbfgs.py — the reference's own minimize.hpp
    pairing) on a LOCAL 2-parameter chart n(t) ∝ best_n + t0 u + t1 v
    (u, v orthonormal ⊥ best_n; gimbal-free around the optimum, unlike a
    global angle chart). Superlinear tail convergence: sharpens the PGD
    answer by ~2-3 digits on strongly anisotropic pairs for a handful of
    curvature-aware iterations (`refine_iters`).
    """
    c2 = e2.center + _image_shift(e1.center, e2.center, metric)
    e2 = e2.replace(center=c2)

    def objective(n):
        f1 = _foot_point_from_normal(n, e1)
        f2 = _foot_point_from_normal(-n, e2)
        return jnp.sum((f2 - f1) ** 2, axis=-1)

    grad = jax.grad(lambda n: jnp.sum(objective(n)))

    if n0 is not None:
        # temporal warm start: one seed, no multistart sweep. Rows whose
        # seed is ~zero (masked/padded slots with no stored normal) fall
        # back to the center-line direction, the cold path's primary
        # start. Callers refresh seeds EVERY step from the previous
        # converged normals (rooted in a rebuild-time full multistart),
        # so live slots never carry stale frozen seeds.
        n0b = jnp.broadcast_to(
            n0, jnp.broadcast_shapes(n0.shape, e1.center.shape))
        cdir = _safe_normal(e2.center - e1.center)
        ok = (jnp.sum(n0b * n0b, axis=-1) > 0.25)[..., None]
        starts = [normalize(jnp.where(ok, n0b, cdir), eps=_EPS)]
    else:
        # Multistart: center-line direction plus 6 axis directions.
        center_dir = _safe_normal(e2.center - e1.center)
        eye = jnp.eye(3, dtype=center_dir.dtype)
        starts = [center_dir]
        for i in range(3):
            axis = jnp.broadcast_to(eye[i], center_dir.shape)
            starts.append(axis)
            starts.append(-axis)

    def minimize_from(n0):
        lr0 = jnp.asarray(0.5, n0.dtype)

        def body(k, n):
            g = grad(n)
            # project gradient onto tangent space of the unit sphere
            g = g - dot(g, n)[..., None] * n
            lr = lr0 / (1.0 + 0.1 * k)
            n_new = normalize(n - lr * g, eps=_EPS)
            return n_new

        n = jax.lax.fori_loop(0, newton_iters, body, n0)
        return n, objective(n)

    best_n, best_f = minimize_from(starts[0])
    for s in starts[1:]:
        n_c, f_c = minimize_from(s)
        take = (f_c < best_f)[..., None]
        best_n = normalize(jnp.where(take, n_c, best_n), eps=_EPS)
        best_f = jnp.minimum(best_f, f_c)

    if refine == "lbfgs":
        from mundy_tpu.math.lbfgs import minimize_lbfgs

        # orthonormal tangent frame (u, v) at best_n: pick the seed axis
        # least aligned with best_n, Gram-Schmidt the pair
        seed = jnp.where((jnp.abs(best_n[..., :1]) < 0.9),
                         jnp.broadcast_to(jnp.asarray([1.0, 0.0, 0.0],
                                                      best_n.dtype),
                                          best_n.shape),
                         jnp.broadcast_to(jnp.asarray([0.0, 1.0, 0.0],
                                                      best_n.dtype),
                                          best_n.shape))
        u = normalize(seed - dot(seed, best_n)[..., None] * best_n, eps=_EPS)
        v = jnp.cross(best_n, u)

        batch = best_n.shape[:-1]

        def chart_obj(t, n0, uu, vv, p1, p2):
            n = normalize(n0 + t[..., 0, None] * uu + t[..., 1, None] * vv,
                          eps=_EPS)
            g1 = _foot_point_from_normal(n, p1)
            g2 = _foot_point_from_normal(-n, p2)
            return jnp.sum((g2 - g1) ** 2, axis=-1)

        t0 = jnp.zeros(batch + (2,), best_n.dtype)
        if batch:
            import math as _m
            flat = _m.prod(batch)
            tt0 = t0.reshape(flat, 2)
            nn0 = best_n.reshape(flat, 3)
            uu0 = u.reshape(flat, 3)
            vv0 = v.reshape(flat, 3)
            # Every Ellipsoid leaf carries exactly ONE trailing component
            # axis (center/radii (..., 3), orientation (..., 4)); broadcast
            # against that known trailing shape rather than inferring the
            # batch split from rank — an unbatched leaf such as radii of
            # shape (3,) under a 2-D batch would otherwise raise (or, worse,
            # silently misbroadcast when trailing dims coincide with batch
            # dims). The PGD path accepts such inputs via plain numpy
            # broadcasting, so the refine path must too.
            def canon(p):
                return jax.tree_util.tree_map(
                    lambda x: jnp.broadcast_to(x, batch + x.shape[-1:])
                    .reshape((flat,) + x.shape[-1:]), p)
            p1f = canon(e1)
            p2f = canon(e2)
            res = jax.vmap(
                lambda t, n0, uu, vv, q1, q2: minimize_lbfgs(
                    lambda tv: chart_obj(tv, n0, uu, vv, q1, q2), t,
                    max_iters=refine_iters, memory=4))(
                tt0, nn0, uu0, vv0, p1f, p2f)
            t_ref = res.x.reshape(batch + (2,))
            f_ref = res.f.reshape(batch)
        else:
            res = minimize_lbfgs(
                lambda tv: chart_obj(tv, best_n, u, v, e1, e2), t0,
                max_iters=refine_iters, memory=4)
            t_ref, f_ref = res.x, res.f
        n_ref = normalize(best_n + t_ref[..., 0, None] * u
                          + t_ref[..., 1, None] * v, eps=_EPS)
        take = (f_ref < best_f)[..., None]
        best_n = normalize(jnp.where(take, n_ref, best_n), eps=_EPS)

    f1 = _foot_point_from_normal(best_n, e1)
    f2 = _foot_point_from_normal(-best_n, e2)
    # signed separation along the shared normal (ref returns dot(p2-p1, n))
    d = dot(f2 - f1, best_n)
    return SepResult(d, f1, f2, best_n)


def distance_segment_ellipsoid(seg: LineSegment, ell: Ellipsoid,
                               metric: Optional[Metric] = None,
                               iters: int = 48) -> SepResult:
    """Golden-section search over the segment parameter (the distance to a
    convex body is convex along a line). ref: distance/LineSegmentEllipsoid.hpp"""
    mid = 0.5 * (seg.start + seg.end)
    c = ell.center + _image_shift(mid, ell.center, metric)
    ell0 = ell.replace(center=c)

    def dist_at(t):
        p = seg.start + t[..., None] * (seg.end - seg.start)
        pb = quat_inverse_rotate(ell0.orientation, p - ell0.center)
        _, d = _point_ellipsoid_body(pb, ell0.radii, newton_iters=48)
        return d

    phi = 0.6180339887498949
    lo = jnp.zeros(seg.start.shape[:-1], seg.start.dtype)
    hi = jnp.ones_like(lo)

    def body(_, lohi):
        lo, hi = lohi
        m1 = hi - phi * (hi - lo)
        m2 = lo + phi * (hi - lo)
        take_left = dist_at(m1) < dist_at(m2)
        return jnp.where(take_left, lo, m1), jnp.where(take_left, m2, hi)

    lo, hi = jax.lax.fori_loop(0, iters, body, (lo, hi))
    t = 0.5 * (lo + hi)
    p = seg.start + t[..., None] * (seg.end - seg.start)
    r = distance_point_ellipsoid(p, ell0)
    return SepResult(r.dist, p, r.point2, r.normal)


def distance_line_ellipsoid(lp: Array, ld: Array, ell: Ellipsoid,
                            metric: Optional[Metric] = None,
                            iters: int = 48) -> SepResult:
    """Bracket by projecting the center onto the line, then golden-section.
    ref: distance/LineEllipsoid.hpp"""
    c = ell.center + _image_shift(lp, ell.center, metric)
    t0 = dot(c - lp, ld)
    span = jnp.max(ell.radii, axis=-1) + norm(c - lp)
    a = lp + (t0 - span)[..., None] * ld
    b = lp + (t0 + span)[..., None] * ld
    return distance_segment_ellipsoid(LineSegment(a, b), ell.replace(center=c))


def distance_circle3d_circle3d(c1: Circle3D, c2: Circle3D,
                               metric: Optional[Metric] = None,
                               iters: int = 64) -> SepResult:
    """Closest points between two circle rims in 3D via alternating
    projection (no closed form exists). ref: distance/Circle3DCircle3D.hpp"""
    cc2 = c2.center + _image_shift(c1.center, c2.center, metric)
    c2 = c2.replace(center=cc2)

    def project_to_rim(p, circ: Circle3D):
        pb = quat_inverse_rotate(circ.orientation, p - circ.center)
        inplane = pb.at[..., 2].set(0.0)
        rim_b = normalize(inplane, eps=_EPS) * circ.radius[..., None]
        # degenerate: p on the axis -> pick body x direction
        degen = (norm(inplane) < _EPS)[..., None]
        fallback = jnp.zeros_like(rim_b).at[..., 0].set(1.0) * circ.radius[..., None]
        rim_b = jnp.where(degen, fallback, rim_b)
        return quat_rotate(circ.orientation, rim_b) + circ.center

    p = project_to_rim(c2.center, c1)

    def body(_, p):
        q = project_to_rim(p, c2)
        return project_to_rim(q, c1)

    p = jax.lax.fori_loop(0, iters, body, p)
    q = project_to_rim(p, c2)
    sep = q - p
    return SepResult(norm(sep), p, q, _safe_normal(sep))


def segment_closest_planes(SX, SY, SZ, oex, oey, oez, cex, cey, cez,
                           eps=None):
    """Clamped segment-segment closest points on COMPONENT PLANES — the
    layout for batched narrow phases (no (..., 3) minor axis, so arbitrary
    plane shapes vectorize directly).

    Inputs are broadcast-compatible planes: S = (cand midpoint - own
    midpoint, minimum image already applied), own half-edges oe*, candidate
    half-edges ce* (endpoints = mid -/+ e). Same arithmetic as
    neighbor/rows._segment_pair_chunk
    (edge-clamped Lumelsky with a continuous min-of-5-candidates selection
    instead of the near-parallel threshold switch; reference algorithm
    distance/LineSegmentLineSegment.hpp:51-200).

    Returns (s, t, DX, DY, DZ, d2): clamped arc parameters in [0, 1], the
    closest vector own -> cand (EXACT zero below the reconstruction noise
    floor, so 1/dist force laws see a true zero for coincident segments),
    and its squared norm.
    """
    dt = jnp.result_type(SX, oex)
    if eps is None:
        eps = jnp.asarray(1e-12 if dt == jnp.float64 else 1e-8, dt)
    WX = cex - oex - SX
    WY = cey - oey - SY
    WZ = cez - oez - SZ
    a = 4.0 * (oex * oex + oey * oey + oez * oez)
    c = 4.0 * (cex * cex + cey * cey + cez * cez)
    b = 4.0 * (oex * cex + oey * cey + oez * cez)
    d = 2.0 * (oex * WX + oey * WY + oez * WZ)
    e = 2.0 * (cex * WX + cey * WY + cez * WZ)
    D = a * c - b * b

    sN = b * e - c * d
    tN = a * e - b * d
    sD = jnp.where(D > 0, D, 1.0)
    tD = sD
    s_lo = sN < 0.0
    s_hi = sN > sD
    tN = jnp.where(s_lo, e, jnp.where(s_hi, e + b, tN))
    tD = jnp.where(s_lo | s_hi, c, tD)
    sN = jnp.clip(sN, 0.0, sD)
    t_lo = tN < 0.0
    t_hi = tN > tD
    sN = jnp.where(t_lo, jnp.clip(-d, 0.0, a),
                   jnp.where(t_hi, jnp.clip(b - d, 0.0, a), sN))
    sD = jnp.where(t_lo | t_hi, jnp.maximum(a, eps), sD)
    tN = jnp.clip(tN, 0.0, tD)
    s = sN / jnp.maximum(sD, eps)
    t = tN / jnp.maximum(tD, eps)

    w2 = WX * WX + WY * WY + WZ * WZ
    inv_a = 1.0 / jnp.maximum(a, eps)
    inv_c = 1.0 / jnp.maximum(c, eps)
    zero = jnp.zeros_like(s)
    one = jnp.ones_like(s)
    cands = (
        (zero, jnp.clip(e * inv_c, 0.0, 1.0)),
        (one, jnp.clip((e + b) * inv_c, 0.0, 1.0)),
        (jnp.clip(-d * inv_a, 0.0, 1.0), zero),
        (jnp.clip((b - d) * inv_a, 0.0, 1.0), one),
    )

    def q(ss, tt):
        return (w2 + ss * ss * a + tt * tt * c + 2.0 * ss * d
                - 2.0 * tt * e - 2.0 * ss * tt * b)

    d2_best = q(s, t)
    for ss, tt in cands:
        d2c = q(ss, tt)
        take = d2c < d2_best
        s = jnp.where(take, ss, s)
        t = jnp.where(take, tt, t)
        d2_best = jnp.where(take, d2c, d2_best)

    DX = 2.0 * (t * cex - s * oex) - WX
    DY = 2.0 * (t * cey - s * oey) - WY
    DZ = 2.0 * (t * cez - s * oez) - WZ
    d2 = DX * DX + DY * DY + DZ * DZ
    m_eps = jnp.asarray(float(jnp.finfo(dt).eps), dt)
    noise2 = (32.0 * m_eps) ** 2 * (a + c + w2)
    clean = d2 > noise2
    DX = jnp.where(clean, DX, 0.0)
    DY = jnp.where(clean, DY, 0.0)
    DZ = jnp.where(clean, DZ, 0.0)
    d2 = jnp.where(clean, d2, 0.0)
    return s, t, DX, DY, DZ, d2
