"""Spectral Ewald (SE / PME-class) wave-space RPY sum: FFT-accelerated
periodic Stokes mobility.

The reference plans PVFMM/STKFMM kernel-aggregated Stokes FMM for long-range
hydrodynamics (`TPLsList.cmake:29-30`, `dep/install_pvfmm.sh`); the
equivalent here of that O(N)/O(N log N) path is the spectral Ewald method
(Lindbo & Tornberg 2011): Gaussian-window gridding -> 3D FFT -> per-mode
RPY x Hasimoto screening (mobility/ewald.py's k-space factors) -> inverse
FFT -> Gaussian interpolation. FFTs and the k-space multiply are dense
XLA ops; gridding is the only irregular step.

Math (shape splitting): the Hasimoto screen exp(-k^2/4xi^2) is factored as
    exp(-(1-eta) k^2/4xi^2) * [exp(-eta k^2/8xi^2)]^2
and the two bracketed factors are realized as forward/backward convolution
with the spreading Gaussian
    g(x) = (2 xi^2 / (pi eta))^{3/2} exp(-2 xi^2 |x|^2 / eta),
truncated at P grid points per axis (error ~ exp(-2 xi^2 w^2 / eta) with
w = P h / 2; eta is chosen to push that to `tol`). The k-space factor is the
direct-sum coefficient (ewald.py build_ewald_rpy) times exp(+eta k^2/4xi^2)
to undo the two grid convolutions. Real-space correction tables and the self
term are shared with the direct-sum operator unchanged.

Cost: O(N P^3) gridding + O(G^3 log G) FFTs, vs O(N K) for the direct
k-sum — the 1M-bead path (BASELINE config #5).
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import jax.numpy as jnp
import numpy as np
from jax import Array

from mundy_tpu.mobility.ewald import EwaldRPY, build_ewald_rpy


class SpectralEwaldRPY(NamedTuple):
    """Precomputed spectral-Ewald operator (wave part on a (G,G,G) grid)."""

    base: EwaldRPY  # real-space tables + self term (shared with direct sum)
    grid_n: int  # G, FFT grid points per axis
    support: int  # P, Gaussian support in grid points per axis
    eta: float  # shape-splitting fraction
    kcoeff: object  # None — mode coefficients are built on device per
    # apply (a (G, G, G//2+1) constant baked into the jit program is 270 MB
    # at G=512 and overflows the remote-compile request; the elementwise
    # rebuild fuses with the FFT pipeline for free)
    kvec: tuple  # (kx (G,), ky (G,), kz (G//2+1,)) mode wavenumbers
    # "gaussian": screen-splitting Gaussian window (eta absorbs part of the
    # Hasimoto screen; forces G up until eta <= 0.9 — at the 1M chromatin
    # splitting that DOUBLES G). "es": exp-of-semicircle NUFFT window
    # (Barnett-Magland-Klinteberg), full screen kept in k-space, the
    # window transform divided out twice (PME-style deconvolution):
    # same tolerance at smaller P and ~1.6x smaller G.
    window: str = "gaussian"
    es_beta: float = 0.0
    # 1D window-transform samples for the deconvolution: (|w^(kx)| (G,),
    # |w^(kz)| (G//2+1,)) as device arrays; empty for the gaussian window
    wk: tuple = ()


def _fft_wavenumbers(G: int, box: float):
    k = 2.0 * np.pi * np.fft.fftfreq(G, d=box / G)  # (G,)
    kr = 2.0 * np.pi * np.fft.rfftfreq(G, d=box / G)  # (G//2+1,)
    return k, kr


def build_spectral_ewald(
    box: float,
    radius: float,
    viscosity: float,
    xi: Optional[float] = None,
    r_cut: Optional[float] = None,
    tol: float = 1e-4,
    support: Optional[int] = None,
    oversample: float = 1.0,
    n_particles: Optional[int] = None,
    dtype=jnp.float32,
    window: str = "es",
) -> SpectralEwaldRPY:
    """Precompute (host, float64) the SE operator.

    Defaults mirror build_ewald_rpy's splitting; the Gaussian support P and
    shape fraction eta are set from `tol` by the truncation/alias error
    balance (see below). `support` overrides P; `oversample` widens the grid
    beyond the kmax-resolving minimum.
    """
    s2 = max(math.log(1.0 / tol), 1.0)
    if xi is None and r_cut is None and n_particles is not None:
        # density-scaled splitting: the default xi targets r_cut ~ box/4,
        # which is right for small boxes but puts ~N/16 bodies inside the
        # real-space cutoff at scale. A few interparticle spacings is the
        # O(N)-balanced choice: the grid then grows as G ~ box (FFT O(N)).
        spacing = box / max(n_particles, 1) ** (1.0 / 3.0)
        r_cut = min(0.25 * box, 3.5 * spacing)
        xi = math.sqrt(s2) / r_cut
    base = build_ewald_rpy(box, radius, viscosity, xi=xi, r_cut=r_cut,
                           tol=tol, dtype=dtype)
    xi = base.xi
    kmax = 2.0 * xi * math.sqrt(s2)
    G_min = int(np.ceil(kmax * box / np.pi * oversample))

    if window == "es":
        # ES / NUFFT route: the full Hasimoto screen stays in k-space, the
        # window transform is divided out twice. Aliasing error of the ES
        # kernel (Barnett 2019): ~exp(-pi P sqrt(1 - 1/sigma)) at
        # oversampling sigma = k_N / kmax; sigma = 1.5 gives e^{-1.81 P}.
        sigma = 1.5
        if support is None:
            support = int(np.ceil(s2 / (np.pi * math.sqrt(1.0 - 1.0 / sigma))))
            support = max(support, 4)
        support = int(support)
        # FINUFFT's shape choice: beta = gamma pi P (1 - 1/(2 sigma))
        es_beta = 0.97 * np.pi * support * (1.0 - 1.0 / (2.0 * sigma))
        G = _smooth_size(max(int(np.ceil(sigma * G_min)), 2 * support, 16))
        eta = 0.0
        kx, _ = _fft_wavenumbers(G, box)
        _, kz = _fft_wavenumbers(G, box)
        h = box / G
        wh_x = 0.5 * support * h  # physical half-support
        wkx = _es_window_transform(kx, es_beta, wh_x)
        wkz = _es_window_transform(kz, es_beta, wh_x)
        return SpectralEwaldRPY(
            base=base, grid_n=G, support=support, eta=0.0, kcoeff=None,
            kvec=(jnp.asarray(kx, dtype), jnp.asarray(kx, dtype),
                  jnp.asarray(kz, dtype)),
            window="es", es_beta=float(es_beta),
            wk=(jnp.asarray(wkx, dtype), jnp.asarray(wkz, dtype)),
        )

    # Error balance (Lindbo & Tornberg 2011): window truncation
    # exp(-xi^2 P^2 h^2 / 2 eta) vs gridding alias exp(-eta k_N^2 / 8 xi^2)
    # with k_N = pi G / L. Equalizing both at tol gives
    #   eta = 8 xi^2 s2 / k_N^2,   P = 4 s2 / pi.
    G = G_min
    if support is None:
        support = int(np.ceil(4.0 * s2 / np.pi))
    G = max(G, 2 * support)
    G = int(2 ** np.ceil(np.log2(G)))  # power-of-two FFTs
    # enforce eta <= 0.9 (the window may not absorb the whole screen)
    while 8.0 * xi * xi * s2 / (np.pi * G / box) ** 2 > 0.9:
        G *= 2
    k_nyq = np.pi * G / box
    eta = 8.0 * xi * xi * s2 / (k_nyq * k_nyq)
    support = min(int(support), G)

    kx, _ = _fft_wavenumbers(G, box)
    ky = kx
    _, kz = _fft_wavenumbers(G, box)
    # mode coefficients are built on device inside _k_apply (see kcoeff
    # field note); modes beyond kmax contribute ~nothing but cost nothing
    # either — they stay screened by H rather than hard-truncated.
    return SpectralEwaldRPY(
        base=base, grid_n=G, support=int(support), eta=float(eta),
        kcoeff=None,
        kvec=(jnp.asarray(kx, dtype), jnp.asarray(ky, dtype),
              jnp.asarray(kz, dtype)),
    )


def _smooth_size(n: int) -> int:
    """Smallest 5-smooth integer >= n that is a multiple of 16 (the FFT
    stays fast and the gridding row decomposition needs m | G with m >= 8)."""
    def smooth(v):
        for p in (2, 3, 5):
            while v % p == 0:
                v //= p
        return v == 1

    n = ((n + 15) // 16) * 16
    while not smooth(n // 16) or not smooth(n):
        n += 16
    return n


def _es_window_transform(k: np.ndarray, beta: float, wh: float) -> np.ndarray:
    """1D Fourier transform of the ES window at wavenumbers k (host,
    float64 Gauss-Legendre quadrature): w^(k) = 2 int_0^wh
    exp(beta (sqrt(1 - (x/wh)^2) - 1)) cos(k x) dx."""
    nodes, wts = np.polynomial.legendre.leggauss(200)
    x = 0.5 * wh * (nodes + 1.0)  # [0, wh]
    jac = 0.5 * wh
    t = x / wh
    w = np.exp(beta * (np.sqrt(np.maximum(1.0 - t * t, 0.0)) - 1.0))
    # (K, Q) cosine matrix
    c = np.cos(np.asarray(k)[:, None] * x[None, :])
    return 2.0 * jac * (c * (w * wts)[None, :]).sum(axis=1)


def _window_1d(op: SpectralEwaldRPY, frac: Array, dtype):
    """(N, P) Gaussian window weights along one axis.

    frac: particle offset from its base grid point in grid units [0, 1).
    Returns weights at grid offsets -(P/2-1) + [0..P) relative to the base
    point, i.e. the P nearest grid points."""
    P = op.support
    h = op.base.box / op.grid_n
    offs = jnp.arange(P, dtype=dtype) - (P // 2 - 1)
    d = offs[None, :] - frac[:, None]  # (N, P) grid-unit distances
    if op.window == "es":
        t = d / (0.5 * P)
        s = jnp.sqrt(jnp.maximum(1.0 - t * t, 0.0))
        w = jnp.exp(jnp.asarray(op.es_beta, dtype) * (s - 1.0))
        return jnp.where(jnp.abs(t) < 1.0, w, 0.0)
    xi = op.base.xi
    c = 2.0 * xi * xi / op.eta
    pref = math.sqrt(c / math.pi)  # 1D-normalized Gaussian amplitude
    dx = d * h
    return pref * jnp.exp(-c * dx * dx)


def se_spread(op: SpectralEwaldRPY, pos: Array, forces: Array) -> Array:
    """Spread forces onto the (G, G, G, 3) grid (scatter-add gridding)."""
    G, P = op.grid_n, op.support
    dtype = forces.dtype
    h = op.base.box / G
    n = pos.shape[0]
    u = pos / h
    base = jnp.floor(u).astype(jnp.int32)
    frac = u - base  # in [0,1)
    wx = _window_1d(op, frac[:, 0], dtype)  # (N, P)
    wy = _window_1d(op, frac[:, 1], dtype)
    wz = _window_1d(op, frac[:, 2], dtype)
    offs = jnp.arange(P, dtype=jnp.int32) - (P // 2 - 1)
    gx = (base[:, 0:1] + offs[None, :]) % G  # (N, P)
    gy = (base[:, 1:2] + offs[None, :]) % G
    gz = (base[:, 2:3] + offs[None, :]) % G
    # (N, P, P, P) separable weights x (N, 1, 1, 1, 3) forces
    w = wx[:, :, None, None] * wy[:, None, :, None] * wz[:, None, None, :]
    vals = w[..., None] * forces[:, None, None, None, :]
    idx = (gx[:, :, None, None] * G + gy[:, None, :, None]) * G + gz[:, None, None, :]
    grid = jnp.zeros((G * G * G, 3), dtype)
    grid = grid.at[idx.reshape(-1)].add(vals.reshape(-1, 3))
    return grid.reshape(G, G, G, 3)


def se_interpolate(op: SpectralEwaldRPY, pos: Array, grid: Array) -> Array:
    """Interpolate grid velocities back to particles (gather + weights)."""
    G, P = op.grid_n, op.support
    dtype = grid.dtype
    h = op.base.box / G
    u = pos / h
    base = jnp.floor(u).astype(jnp.int32)
    frac = u - base
    wx = _window_1d(op, frac[:, 0], dtype)
    wy = _window_1d(op, frac[:, 1], dtype)
    wz = _window_1d(op, frac[:, 2], dtype)
    offs = jnp.arange(P, dtype=jnp.int32) - (P // 2 - 1)
    gx = (base[:, 0:1] + offs[None, :]) % G
    gy = (base[:, 1:2] + offs[None, :]) % G
    gz = (base[:, 2:3] + offs[None, :]) % G
    idx = (gx[:, :, None, None] * G + gy[:, None, :, None]) * G + gz[:, None, None, :]
    vals = grid.reshape(-1, 3)[idx.reshape(-1)].reshape(idx.shape + (3,))
    w = wx[:, :, None, None] * wy[:, None, :, None] * wz[:, None, None, :]
    vol_cell = h * h * h
    return jnp.sum(w[..., None] * vals, axis=(1, 2, 3)) * vol_cell


def se_wave_apply(op: SpectralEwaldRPY, pos: Array, forces: Array) -> Array:
    """Wave-space RPY sum via FFTs (scatter gridding — small N / reference
    path; use se_wave_apply_dense at scale). (N, 3) velocities.

    Normalization: fhat = (1/h^3) ghat(k) Fhat(k) (unnormalized rfftn of the
    spread field); u2(x_g) = G^3 h^3 irfftn(kcoeff P fhat) — the
    deconvolution e^{+eta k^2/4xi^2} is already inside kcoeff (built with
    the (1-eta) screen); interpolation contributes the final h^3."""
    dtype = forces.dtype
    grid = se_spread(op, pos, forces)  # (G, G, G, 3)
    ugrid = _k_apply(op, grid)
    return se_interpolate(op, pos, ugrid.astype(dtype))


def _k_apply(op: SpectralEwaldRPY, grid: Array) -> Array:
    """FFT -> transverse-project + scale each mode -> inverse FFT."""
    G = op.grid_n
    fhat = jnp.fft.rfftn(grid.astype(jnp.float32), axes=(0, 1, 2))
    kx, ky, kz = op.kvec
    KX = kx[:, None, None]
    KY = ky[None, :, None]
    KZ = kz[None, None, :]
    k2 = KX * KX + KY * KY + KZ * KZ
    inv_k2 = jnp.where(k2 > 0, 1.0 / jnp.maximum(k2, 1e-30), 0.0)
    kdotf = KX * fhat[..., 0] + KY * fhat[..., 1] + KZ * fhat[..., 2]
    proj = kdotf * inv_k2
    # on-device mode coefficients: sinc(ka)^2 (1 + k^2/4xi^2)
    # exp(-k^2 (1-eta)/4xi^2) / (visc k^2 V); k = 0 excluded
    xi = op.base.xi
    kn = jnp.sqrt(jnp.maximum(k2, 1e-30))
    sinc_ka = jnp.sinc(kn * (op.base.radius / jnp.pi))
    H = (1 + k2 / (4 * xi**2)) * jnp.exp(-k2 * ((1.0 - op.eta) / (4 * xi**2)))
    c = sinc_ka**2 * H * inv_k2 / (op.base.viscosity * op.base.box**3)
    if op.window == "es":
        # PME-style deconvolution: divide the separable physical-units
        # window transform out twice — once for the spread, once for the
        # interpolation (the Gaussian window instead folds its transform
        # into H via the eta screen splitting; ES keeps the full screen
        # above and uses an unnormalized interpolation kernel).
        wkx, wkz = op.wk
        wprod = (wkx[:, None, None] * wkx[None, :, None] * wkz[None, None, :])
        c = c / jnp.maximum(wprod * wprod, 1e-300)
    uhat = jnp.stack([
        c * (fhat[..., 0] - proj * KX),
        c * (fhat[..., 1] - proj * KY),
        c * (fhat[..., 2] - proj * KZ),
    ], axis=-1)
    ugrid = jnp.fft.irfftn(uhat, s=(G, G, G), axes=(0, 1, 2))
    return ugrid * (op.base.box ** 3)


def make_se_geometry(op: SpectralEwaldRPY, n_particles: int,
                     capacity_slack: float = 1.15):
    """(y, z)-column gridding geometry for the dense spread/interp
    (ops/se_grid.SEGridRows).

    `capacity_slack` scales the Poisson-max slot bound: the default fits
    near-uniform suspensions; clustered systems (touching-bead chains) need
    more — overflowed slots are dropped from the wave sum (flagged)."""
    from mundy_tpu.ops.se_grid import make_se_grid_rows

    return make_se_grid_rows(op.grid_n, op.support, op.base.box,
                             op.base.xi, op.eta, n_particles,
                             capacity_slack=capacity_slack,
                             kind=op.window, beta=op.es_beta)


def make_se_geometry_tiles(op: SpectralEwaldRPY, n_particles: int,
                           capacity_slack: float = 1.15):
    """3D-tile gridding geometry (ops/se_grid.SEGridTiles): bounds
    slot occupancy LOCALLY on all three axes, unlike the (y, z)-column row
    decomposition whose capacity a chain clustered along x blows up to the
    chain length (se_R = 1688 at 1M clustered chromatin)."""
    from mundy_tpu.ops.se_grid import make_se_grid_tiles

    return make_se_grid_tiles(op.grid_n, op.support, op.base.box,
                              op.base.xi, op.eta, n_particles,
                              capacity_slack=capacity_slack,
                              kind=op.window, beta=op.es_beta)


def se_bin_geom(geom, pos: Array, dtype=jnp.float32):
    """Binning for either dense-gridding geometry (rows or 3D tiles);
    overflow stays at pieces[1] in both layouts."""
    from mundy_tpu.ops.se_grid import (SEGridTiles, se_bin_dense,
                                              se_bin_tiles)

    if isinstance(geom, SEGridTiles):
        return se_bin_tiles(geom, pos, dtype)
    return se_bin_dense(geom, pos, dtype)


def se_wave_apply_dense(op: SpectralEwaldRPY, geom, pos: Array,
                        forces: Array, pieces=None):
    """Wave-space sum with dense gridding (ops/se_grid.py): the
    spread/interp contractions run as batched matmuls. `geom` selects the
    decomposition: SEGridTiles (3D tiles — the clustered-safe layout) or
    SEGridRows ((y, z) columns). Returns (u, overflow).

    `pieces` from se_bin_geom amortizes the binning sort across repeated
    applies at fixed positions (the BBPGD solve's mobility products)."""
    from mundy_tpu.ops.se_grid import (
        SEGridTiles,
        se_interp_dense,
        se_interp_tiles,
        se_spread_dense,
        se_spread_tiles,
    )

    dtype = forces.dtype
    if pieces is None:
        pieces = se_bin_geom(geom, pos, dtype)
    if isinstance(geom, SEGridTiles):
        grid = se_spread_tiles(geom, pieces, forces)
        ugrid = _k_apply(op, grid)
        u = se_interp_tiles(geom, pieces, ugrid.astype(dtype))
        return u, pieces[1]
    grid = se_spread_dense(geom, pieces, forces)
    ugrid = _k_apply(op, grid)
    u = se_interp_dense(geom, pieces, pos.shape[0], ugrid.astype(dtype))
    return u, pieces[1]


def se_rpy_apply_cells(op: SpectralEwaldRPY, cells, pos: Array,
                       forces: Array, box_lengths, geom,
                       pieces=None):
    """Full periodic RPY product with the dense 3D-cell real-space engine
    (neighbor.cells3d) + dense wave gridding — the at-scale path: no
    neighbor matrix anywhere (its K-pass build is the cost at wide hydro
    cutoffs). The cells engine's self-pair term IS self_coeff, so no
    separate self add. `cells` from build_cells3d with edge >= base.r_cut,
    rebuilt whenever positions move (one sort + scatter).

    Returns (u, overflow): `overflow` flags SE-grid binning row overflow —
    an overflowed slot is DROPPED from the wave sum, so callers must fold
    this into their sticky overflow flag (silently wrong hydrodynamics
    otherwise).

    `cells` may also be a CellsSplitState (neighbor.cells3d
    build_cells3d_split): the real-space sum then runs the density-split
    engine — base grid at ~2x-mean capacity plus compact dense-cell
    passes — which removes the (C_max/C_mean)^2 clustered-occupancy
    waste of the plain dense scan."""
    from mundy_tpu.mobility.ewald import (ewald_real_apply_cells,
                                          rpy_real_cells_kernel)
    from mundy_tpu.neighbor.cells3d import (CellsSplitState,
                                            pair_apply_cells3d_split)

    if isinstance(cells, CellsSplitState):
        u = pair_apply_cells3d_split(cells, box_lengths, forces,
                                     rpy_real_cells_kernel(op.base), 3)
    else:
        u = ewald_real_apply_cells(op.base, cells, forces, box_lengths)
    uw, ovf = se_wave_apply_dense(op, geom, pos, forces, pieces=pieces)
    return u + uw, ovf


def se_rpy_apply(op: SpectralEwaldRPY, pos: Array, forces: Array,
                 nmat, metric, geom=None, pieces=None) -> Array:
    """Full periodic RPY product: real (tables) + wave (FFT) + self.

    Pass `geom` (make_se_geometry / make_se_geometry_tiles) to route
    gridding through the dense contractions instead of scatter/gather;
    `pieces` (se_bin_geom) to amortize binning across applies at fixed
    positions."""
    from mundy_tpu.mobility.ewald import ewald_real_apply

    u = ewald_real_apply(op.base, pos, forces, nmat, metric)
    if geom is not None:
        uw, _ovf = se_wave_apply_dense(op, geom, pos, forces, pieces=pieces)
        u = u + uw
    else:
        u = u + se_wave_apply(op, pos, forces)
    return u + op.base.self_coeff * forces
