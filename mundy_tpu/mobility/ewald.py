"""Ewald-split periodic RPY mobility (the long-range Stokes path).

The reference plans PVFMM/STKFMM for long-range Stokes sums
(`TPLsList.cmake:29-30`, marked experimental); the equivalent here is
an Ewald decomposition whose wave-space sum is dense matmuls over k-modes,
per SURVEY.md §5.

Split (Hasimoto screening):
    M(k) = (I - k_hat k_hat) sinc^2(k a) / (eta k^2)        [exact RPY in k]
    H(k) = (1 + k^2/(4 xi^2)) exp(-k^2/(4 xi^2))            [splitting window]
    wave part  = lattice sum over k != 0 of M(k) H(k)       [converges ~ exp]
    real part  = RPY(r) - W(r),  W = continuum FT^-1[M H]   [decays ~ exp]

The real-space correction scalars are tabulated once in float64 by radial
quadrature (Gaussian-damped integrands -> plain trapezoid is accurate) and
interpolated per pair; the self term replaces W(0) by the true 1/(6 pi eta a).
The k = 0 mode is excluded (neutralizing mean-force background, the standard
periodic Stokes convention).

Validation (tests): xi-independence of the total, agreement with free-space
RPY as L -> inf, and Hasimoto's sedimentation constant for a simple cubic
array: mu(L) = 1/(6 pi eta a) - 2.83730 / (6 pi eta L) + O((a/L)^3).
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp
import numpy as np
from jax import Array

from mundy_tpu.neighbor.cell_list import NeighborMatrix


class EwaldRPY(NamedTuple):
    """Precomputed periodic RPY operator pieces."""

    box: float
    radius: float
    viscosity: float
    xi: float
    r_cut: float
    # real-space correction tables R(r) = RPY(r) - W(r): iso + rr scalars
    table_r: Array  # (T,) radii
    table_f: Array  # (T,) isotropic scalar
    table_g: Array  # (T,) r_hat r_hat scalar
    # wave-space modes
    kvecs: Array  # (K, 3)
    kcoeff: Array  # (K,) M(k) H(k) / V   (tensor applied as (I - khat khat))
    self_coeff: float  # 1/(6 pi eta a) - W(0)
    # Chebyshev coefficients (python float tuples -> baked as scalars, no
    # table gathers) of the SMOOTH window scalars fw/gw on [0, r_cut]; the
    # kinked RPY branches are evaluated analytically at apply time
    cheb_fw: tuple = ()
    cheb_gw: tuple = ()


def _rpy_scalars(r, a, eta):
    """Exact free-space RPY scalars: M = f I + g rr_hat (r > 0), with the
    overlap-corrected branch for r < 2a (matches mobility.rpy)."""
    r = np.asarray(r, np.float64)
    c = 1.0 / (8 * np.pi * eta * r)
    far_f = c * (1 + (2 * a * a) / (3 * r * r))
    far_g = c * (1 - (2 * a * a) / (r * r))
    c6 = 1.0 / (6 * np.pi * eta * a)
    near_f = c6 * (1 - 9 * r / (32 * a))
    near_g = c6 * (3 * r / (32 * a))
    f = np.where(r < 2 * a, near_f, far_f)
    g = np.where(r < 2 * a, near_g, far_g)
    return f, g


def _window_scalars(r_grid, a, eta, xi, kmax=None, nk=20000):
    """W(r) = continuum FT^-1 of M(k) H(k): W = fw(r) I + gw(r) rr_hat.

    Angular reduction of (I - khat khat) e^{ik.r}:
        fw(r) = (1/2 pi^2) int dk k^2 K(k) (j0(x) - j1(x)/x)
        gw(r) = (1/2 pi^2) int dk k^2 K(k) (3 j1(x)/x - j0(x)),  x = k r
    with K(k) = sinc^2(ka) H(k) / (eta k^2). The H window makes the
    integrand Gaussian-damped, so trapezoid quadrature converges fast.
    Also returns W(0) (isotropic: fw(0); gw(0) = 0).
    """
    if kmax is None:
        kmax = 14.0 * xi  # e^{-(kmax/2xi)^2} ~ 3e-22
    k = np.linspace(1e-8, kmax, nk)
    sinc_ka = np.sinc(k * a / np.pi)  # np.sinc(x) = sin(pi x)/(pi x)
    H = (1 + k**2 / (4 * xi**2)) * np.exp(-(k**2) / (4 * xi**2))
    K = sinc_ka**2 * H / (eta * k**2)
    pref = 1.0 / (2 * np.pi**2)

    fw = np.empty_like(r_grid)
    gw = np.empty_like(r_grid)
    for i, r in enumerate(r_grid):
        if r < 1e-12:
            # j0 -> 1, j1/x -> 1/3: fw(0) = pref * int k^2 K * (2/3)
            fw[i] = pref * np.trapezoid(k**2 * K * (2.0 / 3.0), k)
            gw[i] = 0.0
            continue
        x = k * r
        j0 = np.sin(x) / x
        j1_over_x = (np.sin(x) / x - np.cos(x)) / (x * x)
        fw[i] = pref * np.trapezoid(k**2 * K * (j0 - j1_over_x), k)
        gw[i] = pref * np.trapezoid(k**2 * K * (3 * j1_over_x - j0), k)
    return fw, gw


def build_ewald_rpy(
    box: float,
    radius: float,
    viscosity: float,
    xi: Optional[float] = None,
    r_cut: Optional[float] = None,
    tol: float = 1e-6,
    table_points: int = 2048,
    dtype=jnp.float32,
) -> EwaldRPY:
    """Precompute tables and k-mode coefficients (host, float64).

    Defaults: r_cut from tol (erfc-type decay: xi * r_cut ~ sqrt(ln 1/tol)),
    xi balanced so both sums are modest. The real-space correction R(r)
    must be paired at apply time with a neighbor structure whose cutoff
    >= r_cut.
    """
    if xi is None:
        # balance: k-modes ~ (kmax L / 2 pi)^3 with kmax = 2 xi s,
        # real pairs ~ rho r_cut^3 with r_cut = s / xi, s = sqrt(ln 1/tol)
        xi = 3.0 / (0.25 * box)  # r_cut ~ box/4 by default
    s = math.sqrt(max(math.log(1.0 / tol), 1.0))
    if r_cut is None:
        r_cut = s / xi
    r_cut = min(r_cut, 0.49 * box)

    # real-space tables
    r_grid = np.linspace(0.0, r_cut, table_points)
    f_rpy = np.empty_like(r_grid)
    g_rpy = np.empty_like(r_grid)
    f_rpy[0] = 1.0 / (6 * np.pi * viscosity * radius)
    g_rpy[0] = 0.0
    f_rpy[1:], g_rpy[1:] = _rpy_scalars(r_grid[1:], radius, viscosity)
    fw, gw = _window_scalars(r_grid, radius, viscosity, xi)
    table_f = f_rpy - fw
    table_g = g_rpy - gw

    # wave-space modes: |k| <= kmax = 2 xi s
    kmax = 2.0 * xi * s
    mmax = int(np.ceil(kmax * box / (2 * np.pi)))
    rng = np.arange(-mmax, mmax + 1)
    mx, my, mz = np.meshgrid(rng, rng, rng, indexing="ij")
    m = np.stack([mx.ravel(), my.ravel(), mz.ravel()], axis=1).astype(np.float64)
    kv = (2 * np.pi / box) * m
    k2 = np.sum(kv * kv, axis=1)
    keep = (k2 > 0) & (k2 <= kmax * kmax)
    kv = kv[keep]
    k2 = k2[keep]
    kn = np.sqrt(k2)
    sinc_ka = np.sinc(kn * radius / np.pi)
    H = (1 + k2 / (4 * xi**2)) * np.exp(-k2 / (4 * xi**2))
    vol = box**3
    kcoeff = sinc_ka**2 * H / (viscosity * k2) / vol

    self_coeff = 1.0 / (6 * np.pi * viscosity * radius) - fw[0]

    # Chebyshev interpolants of the SMOOTH window scalars from values at
    # Chebyshev nodes (fine quadrature: more accurate than the 20k-point
    # tables). The kinked RPY branch split happens analytically at apply
    # time, so only C-infinity functions are fitted — spectral convergence.
    D = 16
    xk = np.cos(np.pi * (np.arange(D + 1) + 0.5) / (D + 1))
    rk = 0.5 * (xk + 1) * r_cut
    fwk, gwk = _window_scalars(rk, radius, viscosity, xi, nk=200000)
    from numpy.polynomial import chebyshev as _C
    cheb_fw = tuple(float(c) for c in _C.chebfit(xk, fwk, D))
    cheb_gw = tuple(float(c) for c in _C.chebfit(xk, gwk, D))

    return EwaldRPY(
        box=float(box), radius=float(radius), viscosity=float(viscosity),
        xi=float(xi), r_cut=float(r_cut),
        table_r=jnp.asarray(r_grid, dtype),
        table_f=jnp.asarray(table_f, dtype),
        table_g=jnp.asarray(table_g, dtype),
        kvecs=jnp.asarray(kv, dtype),
        kcoeff=jnp.asarray(kcoeff, dtype),
        self_coeff=float(self_coeff),
        cheb_fw=cheb_fw,
        cheb_gw=cheb_gw,
    )


def _clenshaw(coeffs: tuple, x: Array) -> Array:
    """Chebyshev series evaluation; coeffs are python floats (baked as
    program scalars — zero memory traffic, no gathers)."""
    b1 = jnp.zeros_like(x)
    b2 = jnp.zeros_like(x)
    for k in range(len(coeffs) - 1, 0, -1):
        b1, b2 = 2.0 * x * b1 - b2 + coeffs[k], b1
    return x * b1 - b2 + coeffs[0]


def real_scalars(op: EwaldRPY, r: Array, rinv: Array):
    """Real-space correction scalars R(r) = RPY(r) - W(r), gather-free.

    The RPY branches (kink at r = 2a) are analytic; the smooth window W
    comes from the Chebyshev interpolants. Replaces _interp_tables' two
    per-pair table gathers (at 1M bodies x 216 hydro neighbors, 2e8
    gathered elements per mobility apply)."""
    a = op.radius
    eta = op.viscosity
    c8 = rinv / (8 * math.pi * eta)
    a2 = a * a
    far_f = c8 * (1 + (2.0 / 3.0) * a2 * rinv * rinv)
    far_g = c8 * (1 - 2.0 * a2 * rinv * rinv)
    c6 = 1.0 / (6 * math.pi * eta * a)
    near_f = c6 * (1 - 9.0 * r / (32.0 * a))
    near_g = c6 * (3.0 * r / (32.0 * a))
    near = r < 2 * a
    f_rpy = jnp.where(near, near_f, far_f)
    g_rpy = jnp.where(near, near_g, far_g)
    x = 2.0 * r / op.r_cut - 1.0
    fw = _clenshaw(op.cheb_fw, x)
    gw = _clenshaw(op.cheb_gw, x)
    inside = r < op.r_cut
    return (jnp.where(inside, f_rpy - fw, 0.0),
            jnp.where(inside, g_rpy - gw, 0.0))


def _interp_tables(op: EwaldRPY, r: Array):
    """Linear interpolation of the real-space correction scalars."""
    t = r / op.r_cut * (op.table_r.shape[0] - 1)
    i0 = jnp.clip(t.astype(jnp.int32), 0, op.table_r.shape[0] - 2)
    w = t - i0
    f = op.table_f[i0] * (1 - w) + op.table_f[i0 + 1] * w
    g = op.table_g[i0] * (1 - w) + op.table_g[i0 + 1] * w
    inside = r < op.r_cut
    return jnp.where(inside, f, 0.0), jnp.where(inside, g, 0.0)


def ewald_real_apply_cells(op: EwaldRPY, cells, forces: Array,
                           box_lengths) -> Array:
    """Real-space correction via the dense 3D-cell engine — INCLUDING the
    self term (the self-pair's sep = 0 contribution is exactly
    self_coeff * F_i, so callers must NOT add op.self_coeff again).

    `cells` from neighbor.cells3d.build_cells3d with cell edge >= r_cut.
    Gather-free: no neighbor matrix, no per-pair table lookups (the
    Chebyshev window scalars evaluate inline). Replaces the (N, K) path
    whose K-pass neighbor build alone cost 20 s at 262k bodies with wide
    hydro cutoffs.
    """
    from mundy_tpu.neighbor.cells3d import (
        gather_from_flat,
        pair_apply_cells3d,
        scatter_to_flat,
    )

    if not op.cheb_fw:
        raise ValueError("ewald_real_apply_cells needs the Chebyshev window "
                         "coefficients (rebuild the operator)")
    n = forces.shape[0]
    payload = gather_from_flat(cells, forces)
    u = pair_apply_cells3d(cells, box_lengths, payload,
                           rpy_real_cells_kernel(op), 3)
    return scatter_to_flat(cells, u, n)


def rpy_real_cells_kernel(op: EwaldRPY):
    """The real-space RPY pair kernel in pair_apply_cells3d's contract
    (factored so sharded evaluators can drive x-slab slices of the grid)."""
    if not op.cheb_fw:
        raise ValueError("rpy_real_cells_kernel needs the Chebyshev window "
                         "coefficients (rebuild the operator)")

    def kernel(DX, DY, DZ, r2, pj):
        r2c = jnp.maximum(r2, 1e-24)
        rinv = jax.lax.rsqrt(r2c)
        r = r2c * rinv
        f, g = real_scalars(op, r, rinv)
        fx = pj[..., None, :, 0]
        fy = pj[..., None, :, 1]
        fz = pj[..., None, :, 2]
        rdotf = (DX * fx + DY * fy + DZ * fz) * (rinv * rinv)
        grf = g * rdotf
        ux = jnp.sum(f * fx + grf * DX, axis=-1)
        uy = jnp.sum(f * fy + grf * DY, axis=-1)
        uz = jnp.sum(f * fz + grf * DZ, axis=-1)
        return jnp.stack([ux, uy, uz], axis=-1)

    return kernel


def ewald_wave_apply(op: EwaldRPY, pos: Array, forces: Array,
                     chunk_k: int = 4096) -> Array:
    """Wave-space sum as dense matmuls over k-mode chunks.

    u_i = sum_k c(k) (I - khat khat) [cos(k.x_i) Sc(k) + sin(k.x_i) Ss(k)]
    with Sc = sum_j cos(k.x_j) f_j, Ss = sum_j sin(k.x_j) f_j.
    """
    K = op.kvecs.shape[0]
    n = pos.shape[0]
    u = jnp.zeros_like(forces)
    n_chunks = -(-K // chunk_k)
    # pad modes to a chunk multiple (zero coeff -> no contribution)
    pad = n_chunks * chunk_k - K
    kv = jnp.concatenate([op.kvecs, jnp.zeros((pad, 3), op.kvecs.dtype)])
    kc = jnp.concatenate([op.kcoeff, jnp.zeros((pad,), op.kcoeff.dtype)])

    def body(c, u):
        kvc = jax.lax.dynamic_slice_in_dim(kv, c * chunk_k, chunk_k)
        kcc = jax.lax.dynamic_slice_in_dim(kc, c * chunk_k, chunk_k)
        k2 = jnp.maximum(jnp.sum(kvc * kvc, axis=1), 1e-30)
        hi = jax.lax.Precision.HIGHEST
        phase = jnp.dot(pos, kvc.T, precision=hi)  # (n, Kc)
        cosp = jnp.cos(phase)
        sinp = jnp.sin(phase)
        # project forces transverse per mode: P f = f - khat (khat . f).
        # All matmuls pinned HIGHEST: a bf16 or TF32 product quantizes the
        # O(1) structure factors to ~0.1-0.4%.
        fk_c = jnp.dot(cosp.T, forces, precision=hi)  # (Kc, 3)
        fk_s = jnp.dot(sinp.T, forces, precision=hi)
        kdotc = jnp.sum(kvc * fk_c, axis=1) / k2
        kdots = jnp.sum(kvc * fk_s, axis=1) / k2
        tc = (fk_c - kdotc[:, None] * kvc) * kcc[:, None]
        ts = (fk_s - kdots[:, None] * kvc) * kcc[:, None]
        u = u + jnp.dot(cosp, tc, precision=hi) + jnp.dot(sinp, ts, precision=hi)
        return u

    return jax.lax.fori_loop(0, n_chunks, body, u)


def ewald_real_apply(op: EwaldRPY, pos: Array, forces: Array,
                     nmat: NeighborMatrix, metric,
                     hbm_budget_bytes: float = 1.0e9) -> Array:
    """Real-space correction over the neighbor matrix (cutoff >= r_cut).

    Chunked over particles: at 1M bodies x 216 hydro neighbors the (N, K, 3)
    pair temporaries are ~2.5 GB EACH and several stay live; chunks bound
    them by hbm_budget_bytes."""
    n, k = nmat.idx.shape
    itemsize = jnp.dtype(pos.dtype).itemsize
    # pack positions + forces: ONE (rows, K) gather instead of two (gather
    # cost is mostly per row, not per element)
    pf = jnp.concatenate([pos, forces], axis=1)  # (N, 6)
    use_cheb = len(op.cheb_fw) > 0

    def apply_rows(idx_c, mask_c, pos_c):
        idx_c = jnp.minimum(idx_c, n - 1)
        pfj = pf[idx_c]  # (chunk, K, 6)
        rvec = metric.sep(pfj[..., :3], pos_c[:, None, :])  # from j toward i
        fj = pfj[..., 3:]
        r2 = jnp.maximum(jnp.sum(rvec * rvec, axis=-1), 1e-24)
        rinv = jax.lax.rsqrt(r2)
        r = r2 * rinv
        if use_cheb:
            f, g = real_scalars(op, r, rinv)
        else:
            f, g = _interp_tables(op, r)
        rdotf = jnp.sum(rvec * fj, axis=-1) * rinv * rinv
        u = f[..., None] * fj + (g * rdotf)[..., None] * rvec
        u = jnp.where(mask_c[..., None], u, 0.0)
        return jnp.sum(u, axis=1)

    # ~8 live (chunk, K, 3)-class temporaries
    chunk = int(hbm_budget_bytes // max(8 * k * 3 * itemsize, 1))
    if chunk >= n:
        return apply_rows(nmat.idx, nmat.mask, pos)
    chunk = max(1024, (chunk // 1024) * 1024)
    n_pad = -(-n // chunk) * chunk

    def pad(a, fill=0):
        cfg = [(0, n_pad - n)] + [(0, 0)] * (a.ndim - 1)
        return jnp.pad(a, cfg, constant_values=fill)

    idx_p = pad(nmat.idx, n - 1)
    mask_p = pad(nmat.mask, False)
    pos_p = pad(pos)

    def one(c):
        sl = lambda a: jax.lax.dynamic_slice_in_dim(a, c * chunk, chunk, 0)  # noqa: E731
        return apply_rows(sl(idx_p), sl(mask_p), sl(pos_p))

    u = jax.lax.map(one, jnp.arange(n_pad // chunk, dtype=jnp.int32))
    return u.reshape(n_pad, 3)[:n]


def ewald_rpy_apply(op: EwaldRPY, pos: Array, forces: Array,
                    nmat: NeighborMatrix, metric, chunk_k: int = 4096) -> Array:
    """Full periodic RPY product: real + wave + self. (N, 3)."""
    u = ewald_real_apply(op, pos, forces, nmat, metric)
    u = u + ewald_wave_apply(op, pos, forces, chunk_k=chunk_k)
    return u + op.self_coeff * forces
