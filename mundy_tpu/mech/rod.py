"""Centerline-twist Kirchhoff rod (discrete, batched over chains).

Port of the *physics* of the reference's sperm-flagellum rod model
(`scrap/Sperm.cpp`), re-shaped for SoA batching. A rod is a chain of N
nodes with N-1 edges; state per edge is a material-frame quaternion evolved
by parallel transport + twist. Formulas (all from Sperm.cpp, cited inline):

- edge info (`compute_edge_information`, `:630-678`):
      t_i = (x_{i+1} - x_i)/l_i
      b_i = 2 (t_i_old x t_i) / (1 + t_i_old . t_i)       (PT rotation vector)
- curvature at interior node i (`compute_node_curvature...`, `:679-724`):
      g_i = conj(q_{i-1}) q_i   (Lagrangian rotation gradient)
      kappa_i = 2 vec(g_i)
- internal force/twist-torque (`compute_internal_force_and_twist_torque`,
  `:725-860`): T = B (kappa - kappa_rest) rotated to the lab frame through
  q_{i-1} and g_i, distributed to nodes by the discrete derivative of the
  curvature w.r.t. node positions; stretching F = k (l - l0) t per edge.

Arrays are (..., N, 3) node positions and (..., N-1, ...) edge quantities;
everything vmaps over leading chain axes.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import jax.numpy as jnp
from jax import Array

from mundy_tpu.math.linalg import cross, dot, norm
from mundy_tpu.math.quaternion import (
    quat_from_omega_dt,
    quat_multiply,
    quat_conjugate,
    quat_normalize,
)

_EPS = 1e-12


class RodState(NamedTuple):
    """Per-edge frame state of a discretized rod."""

    edge_q: Array  # (..., E, 4) material-frame quaternions
    tangent: Array  # (..., E, 3) unit tangents
    length: Array  # (..., E)


def _edge_vectors(pos: Array):
    t = pos[..., 1:, :] - pos[..., :-1, :]
    l = jnp.maximum(norm(t), _EPS)
    return t / l[..., None], l


def _pt_quaternion(t_old: Array, t_new: Array) -> Array:
    """Geodesic rotation taking t_old to t_new, as a unit quaternion.

    Half-way-vector form q ∝ [1 + t_old.t_new, t_old x t_new]: smooth (and
    autodiff-safe) at parallel tangents, singular only at the antipode —
    this is exactly the Rodrigues form of the reference's binormal
    b = 2 (t_old x t_new)/(1 + t_old.t_new) (Sperm.cpp:674-676).
    """
    w = 1.0 + dot(t_old, t_new)
    v = cross(t_old, t_new)
    q = jnp.concatenate([w[..., None], v], axis=-1)
    return quat_normalize(q, eps=_EPS)


def init_rod_edges(pos: Array, ref_normal=(0.0, 0.0, 1.0)) -> RodState:
    """Initial edge frames: body z-axis along the tangent, x-axis from the
    projected reference normal (a standard frame seeding; the reference
    initializes EDGE_ORIENTATION equivalently at declaration)."""
    t, l = _edge_vectors(pos)
    ref = jnp.broadcast_to(jnp.asarray(ref_normal, pos.dtype), t.shape)
    # d1 = normalized (ref - (ref.t) t); fall back to any perpendicular
    d1 = ref - dot(ref, t)[..., None] * t
    bad = norm(d1) < 1e-6
    alt = jnp.stack(
        [jnp.ones_like(t[..., 0]), jnp.zeros_like(t[..., 0]), jnp.zeros_like(t[..., 0])],
        axis=-1,
    )
    alt = alt - dot(alt, t)[..., None] * t
    d1 = jnp.where(bad[..., None], alt, d1)
    d1 = d1 / jnp.maximum(norm(d1), _EPS)[..., None]
    d2 = cross(t, d1)
    # rotation matrix columns (d1, d2, t) -> quaternion
    m = jnp.stack([d1, d2, t], axis=-1)  # (..., 3, 3)
    from mundy_tpu.math.quaternion import quat_from_matrix

    return RodState(edge_q=quat_from_matrix(m), tangent=t, length=l)


def update_rod_edges(state: RodState, pos: Array, twist_rate: Optional[Array] = None,
                     dt=0.0) -> RodState:
    """Advance edge frames to the new positions: parallel transport each
    frame from the old tangent to the new, then (optionally) twist about the
    new tangent by the nodal twist rate.

    The PT rotation uses the binormal form of Sperm.cpp `:674-676`:
    rotation vector b = 2 (t_old x t_new)/(1 + t_old.t_new), which is the
    tangent-aligning rotation in Rodrigues form.
    """
    t_new, l_new = _edge_vectors(pos)
    pt_q = _pt_quaternion(state.tangent, t_new)
    q = quat_multiply(pt_q, state.edge_q)
    if twist_rate is not None:
        # edge twist rate = mean of its node twist rates (midpoint rule)
        omega = 0.5 * (twist_rate[..., :-1] + twist_rate[..., 1:])
        tw_q = quat_from_omega_dt(omega[..., None] * t_new, dt)
        q = quat_multiply(tw_q, q)
    return RodState(edge_q=quat_normalize(q), tangent=t_new, length=l_new)


def rod_curvature(state: RodState):
    """(rotation gradient g (..., E-1, 4), curvature kappa (..., E-1, 3)) at
    interior nodes. Sperm.cpp `:691-724`: g_i = conj(q_{i-1}) q_i,
    kappa = 2 vec(g)."""
    q_prev = state.edge_q[..., :-1, :]
    q_next = state.edge_q[..., 1:, :]
    g = quat_multiply(quat_conjugate(q_prev), q_next)
    kappa = 2.0 * g[..., 1:4]
    return g, kappa


def _transported_frames(state: RodState, pos: Array, phi: Array) -> Array:
    """Edge frames at the configuration (pos, node-twist increments phi):
    parallel transport old frames to the new tangents, then rotate about the
    new tangent by the edge twist angle (midpoint of its node phis).

    Differentiable in (pos, phi): this is the map whose gradient defines the
    discrete forces/twist torques.
    """
    t_new, _ = _edge_vectors(pos)
    t_old = state.tangent
    pt_q = _pt_quaternion(t_old, t_new)
    q = quat_multiply(pt_q, state.edge_q)
    edge_phi = 0.5 * (phi[..., :-1] + phi[..., 1:])
    half = 0.5 * edge_phi
    tw_q = jnp.concatenate(
        [jnp.cos(half)[..., None], jnp.sin(half)[..., None] * t_new], axis=-1
    )
    return quat_multiply(tw_q, q)


def rod_energy(
    state: RodState,
    pos: Array,
    phi: Array,  # (..., N) node twist increments (0 at current config)
    rest_curvature: Array,
    bend_modulus,
    stretch_stiffness,
    rest_length,
) -> Array:
    """Discrete Kirchhoff energy at (pos, phi), same discretization as the
    reference (Sperm.cpp `:725-860`): E = 1/2 sum (kappa - kappa0)^T B
    (kappa - kappa0) + 1/2 k sum (l - l0)^2, with kappa = 2 vec(conj(q_{i-1})
    q_i) and edge frames parallel-transported from the previous step."""
    q = _transported_frames(state, pos, phi)
    g = quat_multiply(quat_conjugate(q[..., :-1, :]), q[..., 1:, :])
    kappa = 2.0 * g[..., 1:4]
    dk = kappa - rest_curvature
    B = jnp.asarray(bend_modulus, pos.dtype)
    e_bend = 0.5 * jnp.sum(dk * dk * B, axis=(-2, -1))
    _, l = _edge_vectors(pos)
    dl = l - rest_length
    e_stretch = 0.5 * jnp.sum(stretch_stiffness * dl * dl, axis=-1)
    return jnp.sum(e_bend + e_stretch)


def rod_internal_forces(
    state: RodState,
    pos: Array,
    rest_curvature: Array,  # (..., E-1, 3) or broadcastable
    bend_modulus,  # scalar or (3,) diagonal of B
    stretch_stiffness,  # scalar k
    rest_length,  # scalar or (..., E)
):
    """(node_forces (..., N, 3), node_twist_torque (..., N)).

    Exact negative gradients of the discrete energy via autodiff — the
    Replacement for the reference's hand-derived distribution
    (compute_internal_force_and_twist_torque, Sperm.cpp `:725-860`), whose
    sign conventions are tied to its reversed quaternion convention
    (REDESIGN.md:10 "Our quaternion is backwards"). The energy discretization
    is identical; autodiff guarantees the forces are energy-consistent
    (dissipative under overdamped flow) by construction.
    """
    import jax

    phi0 = jnp.zeros(pos.shape[:-1], pos.dtype)

    def energy(p, phi):
        return rod_energy(state, p, phi, rest_curvature, bend_modulus,
                          stretch_stiffness, rest_length)

    fpos, fphi = jax.grad(energy, argnums=(0, 1))(pos, phi0)
    return -fpos, -fphi
