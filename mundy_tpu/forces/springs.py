"""Spring-network forces over connectivity index arrays.

Replaces the reference's compute_constraint_forcing kernels
(`scrap/parameter_interface/constraints/src/mundy_constraints/
compute_constraint_forcing/kernels/`): Hookean
(`HookeanSpringsKernel.cpp:137-166`), FENE (`FENESpringsKernel.cpp:135-175`),
FENE-WCA (`FENEWCASpringsKernel.cpp`), angular
(`AngularSpringsKernel.cpp:120-185`, HOOMD force convention). Atomic
adds become `segment_sum`-style index-add scatters — deterministic on XLA.

Connectivity is (E,) int32 node-index arrays + a bool mask (capacity-padded
springs contribute zero force).
"""

from __future__ import annotations

from typing import Optional

import jax.numpy as jnp
from jax import Array

from mundy_tpu.forces.contact import wca_pair_force
from mundy_tpu.geom.periodicity import Metric
from mundy_tpu.math.linalg import dot, norm

_EPS = 1e-12


def _edge(pos, i, j, metric: Optional[Metric]):
    if metric is None:
        t = pos[j] - pos[i]
    else:
        t = metric.sep(pos[i], pos[j])
    L = jnp.maximum(norm(t), _EPS)
    return t / L[..., None], L


def _scatter_pair(n: int, i: Array, j: Array, f_on_j: Array) -> Array:
    out = jnp.zeros((n, 3), f_on_j.dtype)
    out = out.at[j].add(f_on_j)
    out = out.at[i].add(-f_on_j)
    return out


def hookean_spring_forces(
    pos: Array, i: Array, j: Array, k: Array, rest_length: Array,
    mask: Optional[Array] = None, metric: Optional[Metric] = None,
) -> Array:
    """F_on_j = -k (L - L0) t_hat(i->j). ref: HookeanSpringsKernel.cpp:146-166."""
    that, L = _edge(pos, i, j, metric)
    fmag = k * (L - rest_length)
    if mask is not None:
        fmag = jnp.where(mask, fmag, 0.0)
    return _scatter_pair(pos.shape[0], i, j, -fmag[..., None] * that)


def fene_spring_forces(
    pos: Array, i: Array, j: Array, k: Array, r_max: Array,
    mask: Optional[Array] = None, metric: Optional[Metric] = None,
    epsilon_reg: float = 1e-4,
) -> Array:
    """FENE attraction F = k L / (1 - (L/rmax)^2), clamped below rmax.

    ref: FENESpringsKernel.cpp:148-162 (same epsilon_reg clamp).
    """
    that, L = _edge(pos, i, j, metric)
    L_adj = jnp.minimum(L, r_max - epsilon_reg)
    fmag = k * L_adj / (1.0 - (L_adj / r_max) ** 2)
    if mask is not None:
        fmag = jnp.where(mask, fmag, 0.0)
    return _scatter_pair(pos.shape[0], i, j, -fmag[..., None] * that)


def fenewca_spring_forces(
    pos: Array, i: Array, j: Array, k: Array, r_max: Array,
    sigma: Array, epsilon: Array,
    mask: Optional[Array] = None, metric: Optional[Metric] = None,
) -> Array:
    """FENE bond + WCA excluded volume on the same edge (Kremer-Grest bond).

    ref: FENEWCASpringsKernel.cpp — FENE attraction with WCA repulsion.
    """
    that, L = _edge(pos, i, j, metric)
    L_adj = jnp.minimum(L, r_max - 1e-4)
    fene = k * L_adj / (1.0 - (L_adj / r_max) ** 2)
    wca = wca_pair_force(L, sigma, epsilon)  # positive = repulsive
    fmag = fene - wca
    if mask is not None:
        fmag = jnp.where(mask, fmag, 0.0)
    return _scatter_pair(pos.shape[0], i, j, -fmag[..., None] * that)


def fenewca_chain_forces(
    pos: Array, beads_per_chain: int, k: Array, r_max: Array,
    sigma: Array, epsilon: Array, metric: Optional[Metric] = None,
) -> Array:
    """FENE-WCA backbone forces for CONTIGUOUS chains (bead n bonds bead
    n+1 except at chain ends) — the chromatin/filament layout.

    Scatter-free: bond vectors are shifted slices and the per-bead
    accumulation is two shifted adds, vs the generic kernel's (nb,)
    scatter-add. Arithmetic is identical per bond, so results match
    fenewca_spring_forces on the equivalent bond list bit-for-bit.
    """
    n = pos.shape[0]
    per = int(beads_per_chain)
    if metric is None:
        t = pos[1:] - pos[:-1]
    else:
        t = metric.sep(pos[:-1], pos[1:])
    L = jnp.maximum(norm(t), _EPS)
    that = t / L[..., None]
    L_adj = jnp.minimum(L, r_max - 1e-4)
    fene = k * L_adj / (1.0 - (L_adj / r_max) ** 2)
    wca = wca_pair_force(L, sigma, epsilon)
    fmag = fene - wca
    valid = (jnp.arange(n - 1, dtype=jnp.int32) + 1) % per != 0
    f_on_j = jnp.where(valid[:, None], -fmag[..., None] * that, 0.0)
    zero = jnp.zeros((1, 3), pos.dtype)
    return (jnp.concatenate([zero, f_on_j], axis=0)
            - jnp.concatenate([f_on_j, zero], axis=0))


def angular_spring_forces(
    pos: Array, i: Array, j: Array, apex: Array, k: Array, rest_angle: Array,
    mask: Optional[Array] = None, metric: Optional[Metric] = None,
) -> Array:
    """Three-body angular spring about `apex` (nodes i -- apex -- j).

    Cosine-harmonic torque tau = k (cos(theta) - cos(theta0)) with HOOMD's
    force distribution. ref: AngularSpringsKernel.cpp:144-170.
    """
    if metric is None:
        v1 = pos[i] - pos[apex]
        v2 = pos[j] - pos[apex]
    else:
        v1 = metric.sep(pos[apex], pos[i])
        v2 = metric.sep(pos[apex], pos[j])
    d1sq = jnp.maximum(dot(v1, v1), _EPS)
    d2sq = jnp.maximum(dot(v2, v2), _EPS)
    d1 = jnp.sqrt(d1sq)
    d2 = jnp.sqrt(d2sq)
    cos_t = dot(v1, v2) / (d1 * d2)
    tau = k * (cos_t - jnp.cos(rest_angle))
    if mask is not None:
        tau = jnp.where(mask, tau, 0.0)

    a11 = tau * cos_t / d1sq
    a13 = -tau / (d1 * d2)
    a33 = tau * cos_t / d2sq
    f1 = a11[..., None] * v1 + a13[..., None] * v2
    f2 = a33[..., None] * v2 + a13[..., None] * v1

    n = pos.shape[0]
    out = jnp.zeros((n, 3), pos.dtype)
    out = out.at[i].add(f1)
    out = out.at[j].add(f2)
    out = out.at[apex].add(-(f1 + f2))
    return out
