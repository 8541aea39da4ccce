"""Free-space spectral Stokes: O(N log N) RPY mobility WITHOUT periodicity.

The confined-domain completion of the PVFMM/STKFMM role (`TPLsList.cmake:
29-30`, `dep/install_pvfmm.sh`): the reference's production HP1 geometry is
a periphery-confined sphere (`alens/src/mundy_alens/periphery/Periphery.hpp
:1155`), where periodic spectral Ewald (mobility/spectral.py) does not
apply and dense/neighbor RPY is O(N^2)/truncated.

Method (Vico-Greengard kernel truncation / af Klinteberg-Tornberg free-
space Ewald): keep the standard Ewald screen split — short-range screened
kernel summed over neighbors, smooth remainder G_l evaluated on a grid —
but run the grid convolution on a ZERO-PADDED box with the TRUNCATED
remainder kernel K = G_l * 1_{|r| < L}. Every source-target distance is
<= the domain extent E <= L, so truncation changes nothing physical, and
with padded period P >= E + L the circular convolution never wraps images
into range: free-space sums from FFTs.

The kernel spectrum is the DISCRETE transform of the SAMPLED kernel,
precomputed once at build (host float64: radial window-scalar table ->
grid sampling -> 6 rfftns of the symmetric tensor, real because K(-r) =
K(r)). The ANALYTIC truncated transform — closed form via the truncated
biharmonic, Psi(k) = [2H - (2-x^2)cos x - 2x sin x]/(2k^2), x = kL — is
NOT usable directly: its shell terms give a non-decaying L^2 cos(kL) tail
whose aliasing into the resolved modes costs ~15% error at any resolution
(measured); the discrete spectrum IS the alias-summed object and makes the
on-grid convolution machine-exact (1e-15 against the pair sum on snapped
positions).

Everything else — ES-window gridding, FFTs, deconvolution, real-space
tables, self term — is shared with the periodic spectral operator
unchanged. Cost: the padded grid is ~(2-2.7)^3 x the periodic volume (the
textbook price of free space), still O(N log N); kernel storage is
6 real (G, G, G/2+1) planes.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp
import numpy as np
from jax import Array

from mundy_tpu.mobility.spectral import (SpectralEwaldRPY,
                                         build_spectral_ewald,
                                         make_se_geometry, se_interpolate,
                                         se_spread)


class FreeSpaceStokes(NamedTuple):
    se: SpectralEwaldRPY  # spectral operator on the PADDED box
    khat: Array  # (6, G, G, G//2+1) real discrete kernel spectrum
    #              (xx, yy, zz, xy, xz, yz)
    trunc_L: float  # kernel truncation radius (>= max pair distance)
    origin: tuple  # domain min corner (shift into the padded grid)
    extent: float  # domain extent fed to the builder (diagnostics)


def build_freespace_stokes(
    domain: float,
    radius: float,
    viscosity: float,
    origin=(0.0, 0.0, 0.0),
    extent: Optional[float] = None,
    xi: Optional[float] = None,
    r_cut: Optional[float] = None,
    tol: float = 1e-4,
    n_particles: Optional[int] = None,
    dtype=jnp.float32,
) -> FreeSpaceStokes:
    """Precompute the free-space operator for sources in
    [origin, origin + domain)^3.

    `extent` = max source-target distance (default sqrt(3) * domain, the
    cube diagonal; pass the sphere diameter for a periphery-confined cloud
    — it shrinks the padded grid from 2.73x to 2x per axis).
    """
    from mundy_tpu.mobility.ewald import _window_scalars

    E = float(extent) if extent is not None else math.sqrt(3.0) * domain
    # smooth roll-off over [E, L]: a HARD cutoff at E has a jump of size
    # G_l(E) ~ 1/(8 pi eta E) whose Gibbs ringing floors the operator error
    # at ~3e-3 regardless of tol (measured); pairs only sample r <= E, so a
    # cos^2 taper to zero over the extra 15% margin is still exact and
    # kills the discontinuity
    L = 1.3 * E
    # P >= E + L prevents image wrap (kernel support <= L); the 1% margin
    # keeps the taper edge strictly clear of the farthest image
    pad = (domain + L) * 1.01
    # the e^{-(xi r_cut)^2} truncation estimate is ~40x optimistic in the
    # measured aggregate (many pairs just beyond r_cut) — size the split
    # for tol/50 so the dropped screened tail lands at ~tol
    tol_split = tol / 50.0
    if xi is None and r_cut is None and n_particles is not None:
        spacing = domain / max(n_particles, 1) ** (1.0 / 3.0)
        r_cut = min(0.25 * domain, 3.5 * spacing)
        xi = math.sqrt(max(math.log(1.0 / tol_split), 1.0)) / r_cut
    elif xi is None:
        r_cut = r_cut if r_cut is not None else 0.25 * domain
        xi = math.sqrt(max(math.log(1.0 / tol_split), 1.0)) / r_cut
    # window support: the ES default assumes the field is band-limited to
    # k_N / sigma (true for the H-decaying periodic kernel); the sampled
    # free-space kernel keeps taper-tail content near Nyquist, so the
    # interpolation needs a wider window (measured at tol 1e-5: P 7 -> 11
    # cuts the floor 6.5e-4 -> 9e-5)
    s2 = max(math.log(1.0 / tol), 1.0)
    p_es = max(int(math.ceil(s2 / (math.pi * math.sqrt(1.0 - 1.0 / 1.5)))), 4)
    se = build_spectral_ewald(pad, radius, viscosity, xi=xi, r_cut=r_cut,
                              tol=tol, dtype=dtype, window="es",
                              support=p_es + 4)

    # ---- discrete kernel spectrum (host float64, once) ----
    G = se.grid_n
    P = se.base.box
    h = P / G
    rt = np.linspace(0.0, math.sqrt(3.0) * P / 2 + h, 4000)
    # fine quadrature: the nk=20000 default's trapezoid error on the
    # oscillatory Bessel integrand is ~1e-4 relative at r ~ 10 — it would
    # bake straight into the kernel spectrum
    fwt, gwt = _window_scalars(rt, radius, viscosity, se.base.xi, nk=200000)
    coord = np.arange(G) * h
    coord = np.where(coord > P / 2, coord - P, coord)
    X, Y, Z = np.meshgrid(coord, coord, coord, indexing="ij")
    R = np.sqrt(X * X + Y * Y + Z * Z)
    t = np.clip((R - E) / max(L - E, 1e-12), 0.0, 1.0)
    taper = np.cos(0.5 * np.pi * t) ** 2  # C^1 roll-off, 1 on r <= E
    fw = taper * np.interp(R, rt, fwt)
    gw = taper * np.interp(R, rt, gwt)
    Rs = np.maximum(R, 1e-300)
    comps = []
    pairs = [(0, 0), (1, 1), (2, 2), (0, 1), (0, 2), (1, 2)]
    axes_ = (X, Y, Z)
    for a, b in pairs:
        Kab = gw * (axes_[a] / Rs) * (axes_[b] / Rs)
        if a == b:
            Kab = Kab + fw
        Kab[0, 0, 0] = fwt[0] if a == b else 0.0
        comps.append(np.fft.rfftn(Kab).real)
    khat = jnp.asarray(np.stack(comps, axis=0), dtype)
    return FreeSpaceStokes(se=se, khat=khat, trunc_L=float(L),
                           origin=tuple(float(o) for o in origin),
                           extent=E)


def _k_apply_free(op: FreeSpaceStokes, grid: Array) -> Array:
    """FFT -> multiply the discrete kernel spectrum (with PME window
    deconvolution) -> iFFT.

    Normalization: mirrors spectral._k_apply with c_ab = khat_ab / (G^3
    whatk^2) — in the continuum limit khat ~= Mhat/h^3 and the periodic
    coefficient is Mhat/V = khat h^3/V = khat/G^3."""
    se = op.se
    G = se.grid_n
    # keep f64 grids f64 (CPU validation); f32 otherwise
    ft = grid.dtype if grid.dtype == jnp.float64 else jnp.float32
    fhat = jnp.fft.rfftn(grid.astype(ft), axes=(0, 1, 2))
    assert se.window == "es"
    wkx, wkz = se.wk
    wprod = (wkx[:, None, None] * wkx[None, :, None] * wkz[None, None, :])
    scale = 1.0 / (float(G) ** 3 * jnp.maximum(wprod * wprod, 1e-300))
    k = op.khat
    uhat = jnp.stack([
        scale * (k[0] * fhat[..., 0] + k[3] * fhat[..., 1]
                 + k[4] * fhat[..., 2]),
        scale * (k[3] * fhat[..., 0] + k[1] * fhat[..., 1]
                 + k[5] * fhat[..., 2]),
        scale * (k[4] * fhat[..., 0] + k[5] * fhat[..., 1]
                 + k[2] * fhat[..., 2]),
    ], axis=-1)
    ugrid = jnp.fft.irfftn(uhat, s=(G, G, G), axes=(0, 1, 2))
    return ugrid * (se.base.box ** 3)


def _shift(op: FreeSpaceStokes, pos: Array) -> Array:
    return pos - jnp.asarray(op.origin, pos.dtype)[None, :]


def freespace_wave_apply(op: FreeSpaceStokes, pos: Array,
                         forces: Array) -> Array:
    """Smooth-remainder sum on the padded grid (scatter gridding; the
    dense gridding path applies identically at scale)."""
    p = _shift(op, pos)
    grid = se_spread(op.se, p, forces)
    ugrid = _k_apply_free(op, grid)
    return se_interpolate(op.se, p, ugrid.astype(forces.dtype))


def freespace_wave_apply_dense(op: FreeSpaceStokes, geom, pos: Array,
                               forces: Array, pieces=None):
    """Wave sum with the dense gridding (at-scale path). Returns
    (u, overflow)."""
    from mundy_tpu.ops.se_grid import (se_bin_dense, se_interp_dense,
                                              se_spread_dense)

    p = _shift(op, pos)
    if pieces is None:
        pieces = se_bin_dense(geom, p, forces.dtype)
    grid = se_spread_dense(geom, pieces, forces)
    ugrid = _k_apply_free(op, grid)
    u = se_interp_dense(geom, pieces, pos.shape[0],
                        ugrid.astype(forces.dtype))
    return u, pieces[1]


def freespace_rpy_apply(op: FreeSpaceStokes, pos: Array, forces: Array,
                        nmat, geom=None, pieces=None):
    """Full free-space RPY product: real (screened tables over the
    neighbor structure, no metric — free space) + wave (padded FFT) + self.
    Returns (u, overflow) — an overflowed gridding row DROPS bodies from
    the wave sum (silently wrong hydrodynamics), so callers must fold the
    flag into their sticky overflow state.

    Matches mobility.rpy dense free-space RPY to the builder tolerance on
    confined configs (tests/test_freespace.py)."""
    from mundy_tpu.geom.periodicity import free_space
    from mundy_tpu.mobility.ewald import ewald_real_apply

    u = ewald_real_apply(op.se.base, pos, forces, nmat,
                         free_space(pos.dtype))
    ovf = jnp.asarray(False)
    if geom is not None:
        uw, ovf = freespace_wave_apply_dense(op, geom, pos, forces,
                                             pieces=pieces)
        u = u + uw
    else:
        u = u + freespace_wave_apply(op, pos, forces)
    return u + op.se.base.self_coeff * forces, ovf


def freespace_geometry(op: FreeSpaceStokes, n_particles: int,
                       capacity_slack: float = 1.3):
    """Row-gridding geometry for the dense spread-interp path."""
    return make_se_geometry(op.se, n_particles, capacity_slack=capacity_slack)
