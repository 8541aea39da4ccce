"""Pairwise contact forces over the dense neighbor matrix.

Replaces the reference's per-shape-pair EvaluateLinkerPotentials kernels
(Hertzian: `SphereSphereHertzianContact.cpp:188-215`, WCA and frictional
variants in the same directory) and the LinkerPotentialForceReduction
scatter: each particle accumulates its own force over its neighbor row
(one-sided sum), so no atomics and bitwise-deterministic results.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import jax
import jax.numpy as jnp
from jax import Array

from mundy_tpu.geom.periodicity import Metric
from mundy_tpu.neighbor.cell_list import NeighborMatrix

_EPS = 1e-12


def hertzian_pair_force(
    sep: Array, r_eff: Array, e_eff: Array
) -> Array:
    """Hertz normal force magnitude F = 4/3 E* sqrt(R*) delta^{3/2}.

    `sep` is the signed surface separation (negative = overlap, delta = -sep).
    ref: SphereSphereHertzianContact.cpp:205-210.
    """
    delta = jnp.maximum(-sep, 0.0)
    return (4.0 / 3.0) * e_eff * jnp.sqrt(r_eff) * delta * jnp.sqrt(delta)


def wca_pair_force(r: Array, sigma: Array, epsilon: Array) -> Array:
    """WCA (shifted-truncated LJ) force magnitude along the center line,
    positive = repulsive; zero beyond the 2^(1/6) sigma cutoff.

    ref: the WCA kernels in evaluate_linker_potentials (FENEWCASprings.hpp).
    """
    cutoff = (2.0 ** (1.0 / 6.0)) * sigma
    r_safe = jnp.maximum(r, 1e-6 * sigma)
    sr6 = (sigma / r_safe) ** 6
    f = 24.0 * epsilon * (2.0 * sr6 * sr6 - sr6) / r_safe
    return jnp.where(r < cutoff, f, 0.0)


def effective_radius(r1: Array, r2: Array) -> Array:
    return (r1 * r2) / (r1 + r2)


def effective_youngs(e1: Array, e2: Array, nu1: Array, nu2: Array) -> Array:
    """ref: SphereSphereHertzianContact.cpp:199-202."""
    return (e1 * e2) / (e2 - e2 * nu1 * nu1 + e1 - e1 * nu2 * nu2)


def _is_uniform(x) -> bool:
    """True for python/0-d scalars (per-particle gathers can be skipped)."""
    return jnp.ndim(x) == 0


def _pair_scalar(x: Array, idx: Array):
    """(value_i (N,1), value_j (N,K)) for a per-particle scalar field.

    Gather note: gather cost is mostly per row, so callers needing several
    per-particle
    parameters must pack them into one (N, D) array and gather once.
    """
    return x[:, None], x[idx]


def contact_forces(
    pos: Array,
    radius: Array,
    nmat: NeighborMatrix,
    pair_force_mag: Callable[[Array, Array, Array], Array],
    metric: Optional[Metric] = None,
) -> Array:
    """Generic central-force accumulation over the neighbor matrix.

    pair_force_mag(signed_sep, idx_i, idx_j) -> magnitude (positive =
    repulsive along the i->j normal). Returns (N, 3) forces.
    """
    n = pos.shape[0]
    idx = jnp.minimum(nmat.idx, n - 1)  # clamp padding
    pj = pos[idx]  # (N, K, 3) — one vector gather
    if metric is None:
        sepv = pj - pos[:, None, :]
    else:
        sepv = metric.sep(pos[:, None, :], pj)
    r2 = jnp.maximum(jnp.sum(sepv * sepv, axis=-1), _EPS * _EPS)
    rinv = jax.lax.rsqrt(r2)
    d = r2 * rinv
    if _is_uniform(radius):
        signed_sep = d - 2.0 * radius
    else:
        r_i, r_j = _pair_scalar(radius, idx)
        signed_sep = d - r_i - r_j
    mag = pair_force_mag(signed_sep, jnp.arange(n)[:, None], idx)
    mag = jnp.where(nmat.mask, mag, 0.0)
    # repulsive: force on i points away from j (fold rinv into the weight
    # so nhat is never materialized)
    return -jnp.sum((mag * rinv)[..., None] * sepv, axis=1)


def hertzian_contact_forces(
    pos: Array,
    radius: Array,
    youngs: Array,
    poisson: Array,
    nmat: NeighborMatrix,
    metric: Optional[Metric] = None,
) -> Array:
    """Hertzian sphere-sphere contact over the neighbor matrix. (N,3).

    Uniform (scalar) radius/youngs/poisson take a gather-free fast path;
    per-particle arrays are packed into one (N, 3) parameter block so a
    single vector gather serves all three (see _pair_scalar).
    """
    uniform = all(_is_uniform(v) for v in (radius, youngs, poisson))
    if uniform:
        r_eff = 0.5 * radius
        e_eff = effective_youngs(youngs, youngs, poisson, poisson)

        def mag(signed_sep, i, j):
            return hertzian_pair_force(signed_sep, r_eff, e_eff)

        return contact_forces(pos, radius, nmat, mag, metric)

    n = pos.shape[0]
    radius = jnp.broadcast_to(radius, (n,))
    youngs = jnp.broadcast_to(youngs, (n,))
    poisson = jnp.broadcast_to(poisson, (n,))
    # pack: one vector gather instead of three scalar-column gathers.
    # E* = E1 E2 / (E2(1-nu1^2) + E1(1-nu2^2)) == m1 m2 / (m1 + m2) with the
    # plane-strain modulus m = E / (1 - nu^2), so pack m per particle.
    m = youngs / (1.0 - poisson * poisson)
    params = jnp.stack([radius, m], axis=1)

    def mag(signed_sep, i, j):
        pi = params[i[:, 0]]  # (N, 2)
        pj = params[jnp.minimum(j, n - 1)]  # (N, K, 2)
        r_eff = effective_radius(pi[:, None, 0], pj[..., 0])
        m_i = pi[:, None, 1]
        m_j = pj[..., 1]
        e_eff = (m_i * m_j) / jnp.maximum(m_i + m_j, _EPS)
        return hertzian_pair_force(signed_sep, r_eff, e_eff)

    return contact_forces(pos, radius, nmat, mag, metric)


def wca_contact_forces(
    pos: Array,
    radius: Array,
    epsilon: Array,
    nmat: NeighborMatrix,
    metric: Optional[Metric] = None,
) -> Array:
    """WCA contact with sigma = r_i + r_j (contact at center distance sigma)."""
    n = pos.shape[0]
    if _is_uniform(radius) and _is_uniform(epsilon):

        def mag(signed_sep, i, j):
            sigma = 2.0 * radius
            return wca_pair_force(signed_sep + sigma, sigma, epsilon)

        return contact_forces(pos, radius, nmat, mag, metric)

    radius = jnp.broadcast_to(radius, (n,))
    epsilon = jnp.broadcast_to(epsilon, (n,))
    params = jnp.stack([radius, epsilon], axis=1)

    def mag(signed_sep, i, j):
        pi = params[i[:, 0]]
        pj = params[jnp.minimum(j, n - 1)]
        sigma = pi[:, None, 0] + pj[..., 0]
        eps_pair = jnp.sqrt(pi[:, None, 1] * pj[..., 1])
        return wca_pair_force(signed_sep + sigma, sigma, eps_pair)

    return contact_forces(pos, radius, nmat, mag, metric)
