"""No-slip periphery confinement via a dense boundary-integral method.

Replacement for the reference periphery
(`scrap/parameter_interface/alens/src/mundy_alens/periphery/Periphery.hpp`):
a closed surface (sphere/ellipsoid shell) discretized by quadrature nodes
enforces no-slip on the enclosed suspension. Pipeline (FastDirectPeriphery,
`:1155-2140`):

1. quadrature generation (`gen_sphere_quadrature:90-150`): Gauss-Legendre in
   cos(theta) x uniform phi ring grid;
2. the second-kind Fredholm matrix M = 1/2 I + T + N (`fill_skfie_matrix:
   1693-1742`), with T the Stokes double-layer operator
   T_ij = -3/(4 pi) r_i r_j (r . n_s) / r^5 * w_s, singularity subtraction on
   the diagonal, and the null-space correction N = n n^T w;
3. dense inverse M^{-1} precomputed once in float64 on host
   (`build_inverse_self_interaction_matrix:2094`, cached to disk like
   `write_matrix_to_file:217`);
4. per step: surface densities q = -M^{-1} u_slip
   (`compute_surface_forces:2125-2140`), then the correction flow at any
   interior point via the double-layer evaluation (one (3N_t x 3N_q)
   matmul).
"""

from __future__ import annotations

import os
from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp
import numpy as np
from jax import Array


def gen_sphere_quadrature(order: int, radius: float, center=(0.0, 0.0, 0.0)):
    """Spherical quadrature: Gauss-Legendre in cos(theta), uniform in phi.

    Mirrors `gen_sphere_quadrature` (`Periphery.hpp:90-150`). Returns
    (points (Q,3), weights (Q,), inward_normals (Q,3)) as float64 numpy.
    """
    if order < 1:
        raise ValueError("order must be >= 1")
    nodes, wts = np.polynomial.legendre.leggauss(order + 1)
    n_phi = 2 * (order + 1)
    phi = 2 * np.pi * np.arange(n_phi) / n_phi
    cos_t = nodes  # = cos(theta)
    sin_t = np.sqrt(np.maximum(1 - cos_t**2, 0.0))

    pts, weights = [], []
    for ct, st, w in zip(cos_t, sin_t, wts):
        for p in phi:
            pts.append([st * np.cos(p), st * np.sin(p), ct])
            # area element: R^2 dcos(theta) dphi
            weights.append(w * (2 * np.pi / n_phi) * radius**2)
    pts = np.asarray(pts)
    weights = np.asarray(weights)
    normals = -pts  # inward (confinement encloses the suspension)
    points = np.asarray(center) + radius * pts
    return points, weights, normals


def stokes_double_layer_matrix(src_pos, src_normals, weights, tgt_pos, viscosity,
                               self_surface: bool) -> np.ndarray:
    """(3T, 3S) double-layer matrix
    T[3t+i, 3s+j] = -3/(4 pi) r_i r_j (r.n_s) w_s / r^5,  r = x_t - x_s.

    Mirrors fill_stokes_double_layer_matrix; for the self-surface case the
    s == t entries are zeroed (handled by singularity subtraction).
    Note: the kernel is viscosity-independent here (density q has units of
    velocity); the reference carries the same scale.
    """
    src_pos = np.asarray(src_pos, np.float64)
    tgt_pos = np.asarray(tgt_pos, np.float64)
    src_normals = np.asarray(src_normals, np.float64)
    weights = np.asarray(weights, np.float64)
    T = tgt_pos.shape[0]
    S = src_pos.shape[0]
    r = tgt_pos[:, None, :] - src_pos[None, :, :]  # (T, S, 3)
    r2 = np.sum(r * r, axis=-1)
    with np.errstate(divide="ignore", invalid="ignore"):
        rinv5 = np.where(r2 > 1e-24, r2 ** (-2.5), 0.0)
    rdotn = np.sum(r * src_normals[None, :, :], axis=-1)  # (T, S)
    coeff = -(3.0 / (4.0 * np.pi)) * rdotn * rinv5 * weights[None, :]  # (T, S)
    blocks = coeff[:, :, None, None] * r[:, :, :, None] * r[:, :, None, :]  # (T,S,3,3)
    if self_surface and T == S:
        idx = np.arange(T)
        blocks[idx, idx] = 0.0
    return blocks.transpose(0, 2, 1, 3).reshape(3 * T, 3 * S)


def skfie_matrix(src_pos, src_normals, weights) -> np.ndarray:
    """Second-kind Fredholm matrix M = T_PV - 1/2 I + N.

    Role mirrors `fill_skfie_matrix` (`Periphery.hpp:1693-1742`) — double
    layer + singularity subtraction + null-space completion — but the jump
    conventions are pinned NUMERICALLY for our kernel/normal orientation
    (inward normals, r = target - source):

        D[c](x inside)  = -c        D[c](x outside) = 0

    hence the inside limit is D = T_PV + sigma with sigma = -1/2 and
    T_PV[const] = -1/2 const. The singularity subtraction exactifies the
    diagonal against that identity: diag block = -1/2 I - (off-diag row
    sum), so constants are treated exactly. N = n_t n_s^T w_s annihilates
    constants (closed surface: integral of n dS = 0) and completes the
    rigid-motion null space. For constants M[c] = -c, and the BIE
    M q = -u_ambient|surface yields the correct interior extension
    (validated against the uniform/shear no-slip analytic solutions).
    """
    S = np.asarray(src_pos).shape[0]
    T = stokes_double_layer_matrix(src_pos, src_normals, weights, src_pos,
                                   viscosity=1.0, self_surface=True)
    # exactify the diagonal: T_PV[const] = -1/2 const
    Tb = T.reshape(S, 3, S, 3)
    row_sum = Tb.sum(axis=2)  # (S, 3, 3)
    idx = np.arange(S)
    Tb[idx, :, idx, :] += -0.5 * np.eye(3)[None, :, :] - row_sum
    T = Tb.reshape(3 * S, 3 * S)

    n = np.asarray(src_normals, np.float64)
    w = np.asarray(weights, np.float64)
    N = (n[:, :, None, None] * n[None, None, :, :] * w[None, None, :, None])
    N = N.reshape(S, 3, S, 3).reshape(3 * S, 3 * S)
    return T - 0.5 * np.eye(3 * S) + N


class Periphery(NamedTuple):
    """Precomputed confinement operator (device arrays)."""

    points: Array  # (Q, 3)
    normals: Array  # (Q, 3) inward
    weights: Array  # (Q,)
    m_inv: Array  # (3Q, 3Q)


def build_sphere_periphery(order: int, radius: float, center=(0.0, 0.0, 0.0),
                           cache_path: Optional[str] = None,
                           dtype=jnp.float32) -> Periphery:
    """Generate quadrature + precompute M^{-1} (float64 on host, cached).

    Mirrors build_inverse_self_interaction_matrix + the disk cache
    (`Periphery.hpp:217,2094-2119`).
    """
    pts, wts, nrm = gen_sphere_quadrature(order, radius, center)
    m_inv = None
    if cache_path is not None and os.path.exists(cache_path):
        m_inv = np.load(cache_path)
        if m_inv.shape != (3 * len(pts), 3 * len(pts)):
            m_inv = None
    if m_inv is None:
        M = skfie_matrix(pts, nrm, wts)
        m_inv = np.linalg.inv(M)
        if cache_path is not None:
            tmp = cache_path + ".tmp"
            np.save(tmp, m_inv)
            os.replace(tmp + ".npy" if not tmp.endswith(".npy") else tmp, cache_path)
    return Periphery(
        points=jnp.asarray(pts, dtype),
        normals=jnp.asarray(nrm, dtype),
        weights=jnp.asarray(wts, dtype),
        m_inv=jnp.asarray(m_inv, dtype),
    )


def surface_densities(periphery: Periphery, u_slip: Array) -> Array:
    """q = -M^{-1} u_slip (no-slip balance; `compute_surface_forces:2137`).

    u_slip (Q, 3): ambient velocity evaluated at the surface nodes.
    """
    # HIGHEST precision: a reduced-precision product (bf16 or TF32) would
    # inject ~1e-3..1e-2 relative error into the no-slip balance.
    q = -jnp.dot(periphery.m_inv, u_slip.reshape(-1),
                 precision=jax.lax.Precision.HIGHEST)
    return q.reshape(-1, 3)


def double_layer_flow(periphery: Periphery, q: Array, targets: Array) -> Array:
    """Correction flow at interior targets from surface densities q.

    u_i(x_t) = -3/(4 pi) sum_s w_s (r.n_s)(r.q_s) r_i / r^5 — evaluated as
    dense batched contractions.
    """
    r = targets[:, None, :] - periphery.points[None, :, :]  # (T, Q, 3)
    r2 = jnp.sum(r * r, axis=-1)
    rinv5 = jnp.where(r2 > 1e-24, r2 ** (-2.5), 0.0)
    rdotn = jnp.sum(r * periphery.normals[None, :, :], axis=-1)
    rdotq = jnp.sum(r * q[None, :, :], axis=-1)
    coeff = -(3.0 / (4.0 * jnp.pi)) * periphery.weights[None, :] * rdotn * rdotq * rinv5
    return jnp.sum(coeff[:, :, None] * r, axis=1)


def no_slip_correction(periphery: Periphery, ambient_at_surface: Array,
                       targets: Array) -> Array:
    """Full periphery correction: densities from the ambient slip, evaluated
    at the target points. Total velocity = ambient + correction."""
    q = surface_densities(periphery, ambient_at_surface)
    return double_layer_flow(periphery, q, targets)
