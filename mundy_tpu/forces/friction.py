"""Frictional Hertzian contact (granular DEM, history-dependent).

Replaces the reference's FrictionalHertzianContact kernels
(`SpherocylinderSegmentSpherocylinderSegmentFrictionalHertzianContact.cpp:
440-520`, LAMMPS granular hertz/history convention): spring-dashpot normal
force, tangential spring on the accumulated (projected) tangential
displacement, Coulomb cap |Ft| <= mu |Fn| with the reference's history
rescaling.

The per-contact tangential displacement is the history variable; it lives in
the pair-list slot (capacity-padded) and is carried across steps by the
caller. On neighbor rebuild the slot mapping changes and history restarts —
same practical behavior as a DEM rebuild without history matching; pass the
old state through `match_history` if slot-stable warm starts are needed.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp
from jax import Array

from mundy_tpu.geom.periodicity import Metric
from mundy_tpu.neighbor.cell_list import PairList

_EPS = 1e-12


class FrictionalContactResult(NamedTuple):
    forces: Array  # (N, 3) per body
    torques: Array  # (N, 3) per body (from tangential forces at contact)
    tang_disp: Array  # (C, 3) updated history
    normal_force_mag: Array  # (C,) diagnostics


def frictional_hertzian_contact(
    pos: Array,  # (N, 3) body centers (spheres; capsules via contact points)
    vel: Array,  # (N, 3) body velocities (for dashpots)
    radius: Array,  # scalar or (N,)
    pairs: PairList,
    tang_disp: Array,  # (C, 3) tangential history per pair slot
    dt,
    normal_spring: float,
    normal_damping: float,
    tang_spring: float,
    tang_damping: float,
    friction_coeff: float,
    density: float = 1.0,
    metric: Optional[Metric] = None,
) -> FrictionalContactResult:
    """Sphere-sphere frictional Hertzian over a pair list.

    Force on the LEFT body i (reference convention): normal spring-dashpot
    hertz_poly * (k_n * sep * n + m_eff * c_n * v_n) plus tangential
    hertz_poly * (k_t * xi + m_eff * c_t * v_t), Coulomb-capped; equal and
    opposite on j; torques from the tangential component at the contact
    point.
    """
    n = pos.shape[0]
    radius = jnp.broadcast_to(jnp.asarray(radius, pos.dtype), (n,))
    i, j = pairs.i, pairs.j
    pi, pj = pos[i], pos[j]
    sepv = (pj - pi) if metric is None else metric.sep(pi, pj)
    r2 = jnp.maximum(jnp.sum(sepv * sepv, axis=-1), _EPS)
    rinv = jax.lax.rsqrt(r2)
    dist = r2 * rinv
    nhat = sepv * rinv[:, None]  # from i toward j (the left contact normal)
    ri, rj = radius[i], radius[j]
    signed_sep = dist - ri - rj
    in_contact = pairs.mask & (signed_sep < 0.0)

    # contact-point velocities (spheres: center velocity + 0 spin here)
    rel = vel[j] - vel[i]
    rel_n = jnp.sum(rel * nhat, axis=-1)[:, None] * nhat
    rel_t = rel - rel_n

    # history update: accumulate and project to the tangent plane; reset
    # out-of-contact slots (ref `:432-434` reset on separation)
    xi = tang_disp + rel_t * dt
    xi = xi - jnp.sum(xi * nhat, axis=-1)[:, None] * nhat
    xi = jnp.where(in_contact[:, None], xi, 0.0)

    m = (4.0 / 3.0) * jnp.pi * density * radius**3
    m_eff = (m[i] * m[j]) / (m[i] + m[j])
    r_eff = (ri * rj) / (ri + rj)
    hertz_poly = jnp.sqrt(jnp.maximum(-r_eff * signed_sep, 0.0))

    f_n = hertz_poly[:, None] * (
        normal_spring * signed_sep[:, None] * nhat
        + (m_eff * normal_damping)[:, None] * rel_n
    )
    f_t = hertz_poly[:, None] * (
        tang_spring * xi + (m_eff * tang_damping)[:, None] * rel_t
    )

    # Coulomb cap with history rescale (ref `:497-513`)
    fn_mag = jnp.linalg.norm(f_n, axis=-1)
    ft_mag = jnp.linalg.norm(f_t, axis=-1)
    cap = friction_coeff * fn_mag
    over = ft_mag > cap
    scale = cap / jnp.maximum(ft_mag, _EPS)
    damp_term = (m_eff * tang_damping)[:, None] * rel_t / jnp.maximum(tang_spring, _EPS)
    xi_rescaled = scale[:, None] * (xi + damp_term) - damp_term
    xi = jnp.where(over[:, None], xi_rescaled, xi)
    f_t = jnp.where(over[:, None], f_t * scale[:, None], f_t)

    f_on_i = jnp.where(in_contact[:, None], f_n + f_t, 0.0)
    forces = jnp.zeros_like(pos)
    forces = forces.at[i].add(f_on_i)
    forces = forces.at[j].add(-f_on_i)

    # torques: tangential force acts at the contact point on each surface
    arm_i = (ri * jnp.ones_like(ri))[:, None] * nhat
    arm_j = -(rj)[:, None] * nhat
    ti = jnp.cross(arm_i, f_on_i)
    tj = jnp.cross(arm_j, -f_on_i)
    torques = jnp.zeros_like(pos)
    torques = torques.at[i].add(ti)
    torques = torques.at[j].add(tj)
    return FrictionalContactResult(
        forces=forces, torques=torques, tang_disp=xi,
        normal_force_mag=jnp.where(in_contact, jnp.linalg.norm(f_n, axis=-1), 0.0),
    )


class SegmentFrictionResult(NamedTuple):
    forces: Array  # (N, 3) per body
    torques: Array  # (N, 3) per body
    tang_disp: Array  # (N, K, 3) updated per-slot history
    normal_mag: Array  # (N, K) Hertzian normal magnitudes (diagnostics)


def frictional_segment_contact_rows(
    pos: Array,  # (N, 3) segment midpoints
    hedge: Array,  # (N, 3) half-edge vectors (axis * length/2)
    vel: Array,  # (N, 3) body translational velocities (lagged one step)
    omega: Array,  # (N, 3) body angular velocities (lagged one step)
    nmat_idx: Array,  # (N, K) neighbor rows
    nmat_mask: Array,  # (N, K)
    tang_disp: Array,  # (N, K, 3) tangential history per slot
    dt,
    radius: float,
    youngs: float,
    poisson: float,
    tang_spring: float,
    friction_coeff: float,
    tang_damping: float = 0.0,
    metric: Optional[Metric] = None,
) -> SegmentFrictionResult:
    """Frictional Hertzian contact between spherocylinder SEGMENTS.

    The reference's spherocylinder-segment frictional kernel
    (`SpherocylinderSegmentSpherocylinderSegmentFrictionalHertzianContact
    .cpp:440-520`, the CollidingFrictionalSperm capability): narrow phase =
    clamped segment-segment closest points (geom/distance.
    segment_closest_planes), Hertz normal force, tangential spring on the
    accumulated contact-point slip with the LAMMPS hertz/history Coulomb
    cap and history rescale. Relative slip velocity is evaluated at the
    CONTACT POINTS from the (lagged) rigid-body velocities v + w x r — the
    standard explicit friction closure for overdamped Stokesian dynamics,
    where current-step velocities are only known after the mobility solve.

    Each contact appears on BOTH bodies' rows with mirrored normals, so the
    two history copies evolve as exact negatives and action-reaction holds
    from symmetric one-sided accumulation (same scheme as the rods contact
    path and the sharded granular engine).
    """
    n = pos.shape[0]
    idx = jnp.minimum(nmat_idx, n - 1)
    payload = jnp.concatenate([pos, hedge, vel, omega], axis=1)  # (N, 12)
    cand = payload[idx]  # (N, K, 12) — one gather
    cmid, chedge = cand[..., 0:3], cand[..., 3:6]
    cvel, comega = cand[..., 6:9], cand[..., 9:12]

    if metric is None:
        S = cmid - pos[:, None, :]
    else:
        S = metric.sep(pos[:, None, :], cmid)

    from mundy_tpu.forces.contact import (effective_youngs,
                                          hertzian_pair_force)
    from mundy_tpu.geom.distance import segment_closest_planes

    s, t, DX, DY, DZ, d2 = segment_closest_planes(
        S[..., 0], S[..., 1], S[..., 2],
        hedge[:, None, 0], hedge[:, None, 1], hedge[:, None, 2],
        chedge[..., 0], chedge[..., 1], chedge[..., 2])
    d2c = jnp.maximum(d2, _EPS)
    rinv = jax.lax.rsqrt(d2c)
    dist = d2c * rinv
    nhat = jnp.stack([DX, DY, DZ], axis=-1) * rinv[..., None]  # own -> cand
    sep0 = dist - 2.0 * radius
    in_contact = nmat_mask & (sep0 < 0.0)

    e_eff = effective_youngs(youngs, youngs, poisson, poisson)
    fn_mag = hertzian_pair_force(sep0, jnp.asarray(0.5 * radius, pos.dtype),
                                 jnp.asarray(e_eff, pos.dtype))

    # contact arms from each body's center (closest point + radius * n)
    arm_i = (2.0 * s - 1.0)[..., None] * hedge[:, None, :] + radius * nhat
    arm_j = (2.0 * t - 1.0)[..., None] * chedge - radius * nhat
    v_i = vel[:, None, :] + jnp.cross(omega[:, None, :], arm_i)
    v_j = cvel + jnp.cross(comega, arm_j)
    rel = v_j - v_i
    rel_n = jnp.sum(rel * nhat, axis=-1)[..., None] * nhat
    rel_t = rel - rel_n

    xi = tang_disp + rel_t * dt
    xi = xi - jnp.sum(xi * nhat, axis=-1)[..., None] * nhat
    xi = jnp.where(in_contact[..., None], xi, 0.0)

    # hertz/history scaling: tangential stiffness grows with the contact
    # patch, sqrt(R* delta) (ref `:470-497`)
    hertz_poly = jnp.sqrt(jnp.maximum(-0.5 * radius * sep0, 0.0))
    f_t = hertz_poly[..., None] * (tang_spring * xi + tang_damping * rel_t)
    ft_mag = jnp.linalg.norm(f_t, axis=-1)
    cap = friction_coeff * fn_mag
    over = ft_mag > cap
    scale = cap / jnp.maximum(ft_mag, _EPS)
    damp = tang_damping * rel_t / jnp.maximum(tang_spring, _EPS)
    xi = jnp.where(over[..., None], scale[..., None] * (xi + damp) - damp,
                   xi)
    f_t = jnp.where(over[..., None], f_t * scale[..., None], f_t)

    f_pair = jnp.where(in_contact[..., None],
                       -fn_mag[..., None] * nhat + f_t, 0.0)
    forces = jnp.sum(f_pair, axis=1)
    torques = jnp.sum(jnp.cross(arm_i, f_pair), axis=1)
    return SegmentFrictionResult(
        forces=forces, torques=torques, tang_disp=xi,
        normal_mag=jnp.where(in_contact, fn_mag, 0.0))


def remap_row_history(old_idx: Array, old_mask: Array, old_vals: Array,
                      new_idx: Array, new_mask: Array) -> Array:
    """Carry (N, K, ...) per-slot history across a neighbor rebuild BY PAIR
    IDENTITY: new slot (i, q) inherits old slot (i, p) where the neighbor
    ids match (K x K probe per row — the row-layout form of
    constraints.remap_gamma; ref: persistent linker entities)."""
    hit = ((old_idx[:, None, :] == new_idx[:, :, None])
           & old_mask[:, None, :] & new_mask[:, :, None])
    # HIGHEST: a one-hot product must carry the history exactly (no TF32)
    return jnp.einsum("npq,nq...->np...", hit.astype(old_vals.dtype),
                      old_vals, precision=jax.lax.Precision.HIGHEST)
