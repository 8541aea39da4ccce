"""Dense gridding for the spectral Ewald wave sum (spread/interp), pure XLA.

A plain scatter-add spread (and gather interpolation) touches N * P^3 grid
points at computed indices. This module instead bins particles by one sort
into (y, z) row columns (SEGridRows, cell edge m grid points, full x extent)
or 3D tiles (SEGridTiles), evaluates the separable window weights dense
along each slab axis, and spreads each row/tile with one matrix contraction
onto a private slab; slabs fold back into the (G, G, G, 3) grid by shifted
dense adds (periodic wrap included). Interpolation is the transposed
contraction. No scatter of grid points anywhere.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np
from jax import Array

XPAD = 16  # slab x padding (P <= 12 wraps fit; multiple of 8)


class SEGridRows(NamedTuple):
    """Static geometry of the gridding row decomposition."""

    G: int  # FFT grid points per axis
    m: int  # grid points per row cell edge (m | G)
    P: int  # window support points per axis
    R: int  # row slot capacity
    box: float
    c: float  # Gaussian window exponent coefficient 2 xi^2 / eta
    # window kind: "gaussian" (truncated screen-splitting Gaussian) or
    # "es" (exp-of-semicircle / Barnett-Magland-Klinteberg NUFFT kernel,
    # deconvolved in k-space — smaller P and G for the same tolerance)
    kind: str = "gaussian"
    beta: float = 0.0  # ES shape parameter
    wh: float = 0.0  # ES half-support in grid units (= P/2)


def window_weights_1d(geom: SEGridRows, d_grid: Array, dtype) -> Array:
    """1D gridding-window weights at grid-unit distances d_grid.

    Gaussian: physically-normalized sqrt(c/pi) exp(-c (d h)^2).
    ES: exp(beta (sqrt(1 - (d/wh)^2) - 1)), zero outside |d| < wh — NOT
    normalized; its transform is divided out in k-space (deconvolution)."""
    if geom.kind == "es":
        t = d_grid / geom.wh
        inside = jnp.abs(t) < 1.0
        s = jnp.sqrt(jnp.maximum(1.0 - t * t, 0.0))
        w = jnp.exp(jnp.asarray(geom.beta, dtype) * (s - 1.0))
        return jnp.where(inside, w, 0.0).astype(dtype)
    h = geom.box / geom.G
    pref = math.sqrt(geom.c / math.pi)
    dx = d_grid * h
    return (pref * jnp.exp(-geom.c * dx * dx)).astype(dtype)


def make_se_grid_rows(G: int, P: int, box: float, xi: float, eta: float,
                      n_particles: int, capacity_slack: float = 1.15,
                      min_m: int = 8, kind: str = "gaussian",
                      beta: float = 0.0) -> SEGridRows:
    """Choose the row cell size m (divides G, >= P to bound slab overlap)
    and the slot capacity.

    Capacity = Poisson-max estimate (mean + 6 sigma) x slack: every gridding
    term (window exps, outer products, the contraction K dim) scales
    with R, so slack is paid on every wave apply; the overflow flag + host
    regrow catches densification."""
    m = min_m
    while G % m != 0:
        m += 1
    n_rows = (G // m) ** 2
    occ = n_particles / n_rows
    R = int(occ * capacity_slack + 6 * math.sqrt(occ + 4) + 8)
    R = ((R + 7) // 8) * 8
    c = 2.0 * xi * xi / max(eta, 1e-300)
    return SEGridRows(G=G, m=m, P=P, R=R, box=box, c=c, kind=kind,
                      beta=float(beta), wh=0.5 * P)


def _bin_rows(geom: SEGridRows, pos: Array):
    """Sort particles into (n_rows, R) slot arrays (one sort + one scatter,
    exactly build_rows' construction). Returns per-slot planes + overflow."""
    G, m, R = geom.G, geom.m, geom.R
    nyz = G // m
    n = pos.shape[0]
    h = geom.box / G
    iy = jnp.clip((pos[:, 1] / (m * h)).astype(jnp.int32), 0, nyz - 1)
    iz = jnp.clip((pos[:, 2] / (m * h)).astype(jnp.int32), 0, nyz - 1)
    row = iy * nyz + iz
    order = jnp.argsort(row)
    row_s = row[order]
    first = jnp.concatenate([jnp.ones((1,), bool), row_s[1:] != row_s[:-1]])
    starts = jnp.where(first, jnp.arange(n, dtype=jnp.int32), 0)
    row_start = jax.lax.associative_scan(jnp.maximum, starts)
    rank = jnp.arange(n, dtype=jnp.int32) - row_start
    counts = jnp.zeros((nyz * nyz,), jnp.int32).at[row].add(1)
    overflow = jnp.any(counts > R)
    slot = row_s * R + jnp.minimum(rank, R - 1)
    slot = jnp.where(rank < R, slot, nyz * nyz * R)
    perm = jnp.full((nyz * nyz * R,), n, jnp.int32).at[slot].set(
        order.astype(jnp.int32), mode="drop")
    return perm.reshape(nyz * nyz, R), overflow  # particle id per slot (n = empty)


# ---------------------------------------------------------------------------
# Dense row gridding: the spread of one row is a CONTRACTION over slots,
#   slab(x, yz) = sum_s wx_s(x) * wyzf_s(yz),
# i.e. a (G+XPAD, R) @ (R, W*W*3) matmul per row once the windows are
# evaluated DENSE along each slab axis (the off-support values are
# exponentially tiny, so dense evaluation is a strict accuracy superset).
# ~20x more FLOPs than P-support rank-1 updates, in exchange for matrix
# products instead of serialized (P, W*3) read-modify-writes.
# Interpolation is the transposed matmul.
# ---------------------------------------------------------------------------


def se_bin_dense(geom: SEGridRows, pos: Array, dtype=jnp.float32):
    """Binning + per-slot grid-unit positions for the dense-matmul gridding.

    Returns (perm, overflow, u (n_rows, R, 3), valid (n_rows, R)).
    """
    if geom.P > XPAD:
        raise ValueError(
            f"window support P={geom.P} exceeds the dense-gridding x wrap "
            f"pad XPAD={XPAD}: wrapped window mass would be silently "
            "truncated")
    perm, overflow = _bin_rows(geom, pos)
    n = pos.shape[0]
    h = geom.box / geom.G
    valid = perm < n
    u = (pos[jnp.minimum(perm, n - 1)] / h).astype(dtype)
    return perm, overflow, u, valid


def _dense_axis_windows(geom: SEGridRows, u: Array, valid, dtype):
    """Dense window weights along the padded x axis for ONE row.

    u: (R, 3) grid-unit positions. Returns wx (R, G+XPAD), zeroed on
    invalid slots. (lax.map with batch_size vmaps this over row chunks.)"""
    G = geom.G
    xg = (jnp.arange(G + XPAD, dtype=dtype) - XPAD // 2)
    wx = window_weights_1d(geom, xg[None, :] - u[:, 0][:, None], dtype)
    return jnp.where(valid[:, None], wx, 0.0)


def _dense_yz(geom: SEGridRows, u: Array, iy: Array, iz: Array, dtype):
    """(R, W) y and z slab-axis windows for ONE row (slab origin at
    i*m - P//2)."""
    G, m, P = geom.G, geom.m, geom.P
    W = m + P
    offs_w = jnp.arange(W, dtype=dtype)
    yslab = (iy * m - P // 2).astype(dtype) + offs_w
    wy = window_weights_1d(geom, yslab[None, :] - u[:, 1][:, None], dtype)
    zslab = (iz * m - P // 2).astype(dtype) + offs_w
    wz = window_weights_1d(geom, zslab[None, :] - u[:, 2][:, None], dtype)
    return wy, wz


def _row_iyz(geom: SEGridRows):
    nyz = geom.G // geom.m
    row_ids = jnp.arange(nyz * nyz, dtype=jnp.int32)
    return row_ids // nyz, row_ids % nyz


def se_spread_dense(geom: SEGridRows, pieces_dense, forces: Array) -> Array:
    """(G, G, G, 3) spread grid via per-row matrix contractions.

    Memory shape: a scan over rows accumulates each row's slab directly
    into a y/z-padded grid with dynamic-slice adds — nothing of size
    O(n_rows * G * W^2) is ever materialized (the all-slabs layout costs
    10+ GB at G=512/1M bodies). Pad P per axis covers the W-window
    overhang; periodic wrap is two dense edge folds at the end."""
    if geom.P > XPAD:
        raise ValueError(f"P={geom.P} > XPAD={XPAD}: wrapped x window mass "
                         "would be silently truncated")
    G, m, P, R = geom.G, geom.m, geom.P, geom.R
    W = m + P
    nyz = G // m
    n_rows = nyz * nyz
    dtype = forces.dtype
    n = forces.shape[0]
    perm, _ovf, u, valid = pieces_dense
    f = jnp.where(valid[..., None], forces[jnp.minimum(perm, n - 1)], 0.0)
    iy_all, iz_all = _row_iyz(geom)
    hi = jax.lax.Precision.HIGHEST
    half = P // 2

    def body(acc, args):
        ur, vr, fr, iyr, izr = args
        wx = _dense_axis_windows(geom, ur, vr, dtype)       # (R, G+XPAD)
        wy, wz = _dense_yz(geom, ur, iyr, izr, dtype)       # (R, W)
        wzf = wz[:, :, None] * fr[:, None, :]               # (R, W, 3)
        wyzf = (wy[:, :, None, None] * wzf[:, None, :, :]).reshape(
            R, W * W * 3)
        slab = jnp.einsum("rx,rk->xk", wx, wyzf, precision=hi)
        slab = slab.reshape(G + XPAD, W, W, 3)
        # fold the x wrap pad immediately (slab x spans G + XPAD)
        core = slab[XPAD // 2:XPAD // 2 + G]
        core = core.at[G - XPAD // 2:].add(slab[:XPAD // 2])
        core = core.at[:XPAD // 2].add(slab[XPAD // 2 + G:])
        # accumulate into the padded grid: y/z start at i*m (pad offset half)
        zero = jnp.zeros((), iyr.dtype)
        y0 = iyr * m
        z0 = izr * m
        region = jax.lax.dynamic_slice(acc, (zero, y0, z0, zero), (G, W, W, 3))
        acc = jax.lax.dynamic_update_slice(acc, region + core,
                                           (zero, y0, z0, zero))
        return acc, ()

    gpad = jnp.zeros((G, G + P, G + P, 3), dtype)
    gpad, _ = jax.lax.scan(body, gpad, (u, valid, f, iy_all, iz_all))

    # fold the y/z periodic pads (front `half`, back `P - half`)
    g = gpad[:, half:half + G, :, :]
    g = g.at[:, G - half:, :, :].add(gpad[:, :half, :, :])
    g = g.at[:, :P - half, :, :].add(gpad[:, half + G:, :, :])
    g2 = g[:, :, half:half + G, :]
    g2 = g2.at[:, :, G - half:, :].add(g[:, :, :half, :])
    g2 = g2.at[:, :, :P - half, :].add(g[:, :, half + G:, :])
    return g2


def se_interp_dense(geom: SEGridRows, pieces_dense, n: int,
                    grid: Array) -> Array:
    """Interpolate grid velocities to particles: transposed contraction,
    reading each row's region from a y/z-padded grid inside the scan (the
    memory-shape mirror of se_spread_dense)."""
    G, m, P, R = geom.G, geom.m, geom.P, geom.R
    W = m + P
    nyz = G // m
    dtype = grid.dtype
    perm, _ovf, u, valid = pieces_dense
    iy_all, iz_all = _row_iyz(geom)
    hi = jax.lax.Precision.HIGHEST
    half = P // 2

    # y/z-padded periodic grid (pads replicate the wrap)
    gpad = jnp.pad(grid, ((0, 0), (half, P - half), (half, P - half), (0, 0)),
                   mode="wrap")

    def body(_, args):
        ur, vr, iyr, izr = args
        wx = _dense_axis_windows(geom, ur, vr, dtype)        # (R, G+XPAD)
        wy, wz = _dense_yz(geom, ur, iyr, izr, dtype)
        zero = jnp.zeros((), iyr.dtype)
        region = jax.lax.dynamic_slice(
            gpad, (zero, iyr * m, izr * m, zero), (G, W, W, 3))
        # x wrap pad: wrap-extend the region along x
        ext = jnp.concatenate([region[G - XPAD // 2:], region,
                               region[:XPAD // 2]], axis=0)
        zl = jnp.einsum("rx,xk->rk", wx,
                        ext.reshape(G + XPAD, W * W * 3),
                        precision=hi)                        # (R, W*W*3)
        zl = zl.reshape(R, W, W, 3)
        yred = jnp.sum(wy[:, :, None, None] * zl, axis=1)    # (R, W, 3)
        return None, jnp.sum(wz[:, :, None] * yred, axis=1)  # (R, 3)

    _, out = jax.lax.scan(body, None, (u, valid, iy_all, iz_all))

    perm_f = perm.reshape(-1)
    uacc = jnp.zeros((n + 1, 3), dtype).at[jnp.minimum(perm_f, n)].set(
        out.reshape(-1, 3), mode="drop")
    h = geom.box / G
    return uacc[:n] * (h * h * h)


# ---------------------------------------------------------------------------
# 3D-TILED dense gridding: the row decomposition above spans the FULL x axis
# per (y, z) column, so a chain clustered along x blows the column capacity R
# to the whole chain length (se_R = 1688 at 1M clustered chromatin).
# Tiles bound occupancy LOCALLY on all three axes:
# bin into (G/m)^3 cubes of m grid cells, spread each tile's slots onto its
# private (W, W, W) slab (W = m + P) with one matrix contraction
#     slab[xy, zc] = sum_s (wx wy)_s[xy] * (wz f)_s[zc],
# then fold the slabs into the (G, G, G, 3) grid with the same shifted
# dense adds per axis (periodic wrap included) — no scatters anywhere.
# FLOPs drop from n_rows * R * (G + XPAD) * W^2 to n_tiles * R * W^3: the x
# contraction extent shrinks from the full axis to one slab width.
# ---------------------------------------------------------------------------


class SEGridTiles(NamedTuple):
    """Static geometry of the 3D tile decomposition."""

    G: int  # FFT grid points per axis
    m: int  # grid points per tile edge (m | G)
    P: int  # window support points per axis
    R: int  # tile slot capacity
    box: float
    c: float  # Gaussian window exponent coefficient 2 xi^2 / eta
    kind: str = "gaussian"
    beta: float = 0.0
    wh: float = 0.0


def make_se_grid_tiles(G: int, P: int, box: float, xi: float, eta: float,
                       n_particles: int, capacity_slack: float = 1.15,
                       min_m: int = 8, kind: str = "gaussian",
                       beta: float = 0.0,
                       slab_budget_bytes: float = 4.5e9) -> SEGridTiles:
    """Choose the tile edge m (divides G; smallest admitted by the slab
    budget — small tiles minimize FLOPs ~ N_slots * W^3, and the static
    max-occupancy padding is density-set regardless of m) and the slot
    capacity (Poisson-max + slack; overflow-flagged, host regrow)."""
    m = min_m
    while (G % m != 0
           or ((G // m) ** 3) * (m + P) ** 3 * 3 * 4 > slab_budget_bytes):
        m += 1
        if m >= G:
            m = G
            break
    n_tiles = (G // m) ** 3
    occ = n_particles / n_tiles
    R = int(occ * capacity_slack + 6 * math.sqrt(occ + 4) + 8)
    R = ((R + 7) // 8) * 8
    c = 2.0 * xi * xi / max(eta, 1e-300)
    return SEGridTiles(G=G, m=m, P=P, R=R, box=box, c=c, kind=kind,
                       beta=float(beta), wh=0.5 * P)


def se_bin_tiles(geom: SEGridTiles, pos: Array, dtype=jnp.float32):
    """Bin into (n_tiles, R) slots (one sort + one scatter). Returns
    (perm, overflow, u, valid, slot_of): `u` per-slot grid-unit positions,
    `slot_of` (N,) the inverse map particle -> slot (n_tiles*R = dropped)
    so interpolation unsorts with one row GATHER instead of a slot
    scatter."""
    G, m, R = geom.G, geom.m, geom.R
    nt1 = G // m
    n_tiles = nt1 ** 3
    n = pos.shape[0]
    h = geom.box / G
    it = jnp.clip((pos / (m * h)).astype(jnp.int32), 0, nt1 - 1)  # (N, 3)
    tile = (it[:, 0] * nt1 + it[:, 1]) * nt1 + it[:, 2]
    order = jnp.argsort(tile)
    tile_s = tile[order]
    first = jnp.concatenate([jnp.ones((1,), bool),
                             tile_s[1:] != tile_s[:-1]])
    starts = jnp.where(first, jnp.arange(n, dtype=jnp.int32), 0)
    tile_start = jax.lax.associative_scan(jnp.maximum, starts)
    rank = jnp.arange(n, dtype=jnp.int32) - tile_start
    counts = jnp.zeros((n_tiles,), jnp.int32).at[tile].add(1)
    overflow = jnp.any(counts > R)
    slot = jnp.where(rank < R, tile_s * R + jnp.minimum(rank, R - 1),
                     n_tiles * R)
    perm = jnp.full((n_tiles * R + 1,), n, jnp.int32).at[slot].set(
        order.astype(jnp.int32), mode="drop")[:n_tiles * R]
    slot_of = jnp.full((n,), n_tiles * R, jnp.int32).at[order].set(
        slot.astype(jnp.int32))
    perm = perm.reshape(n_tiles, R)
    valid = perm < n
    u = (pos[jnp.minimum(perm, n - 1)] / h).astype(dtype)
    return perm, overflow, u, valid, slot_of


def _tile_origins(geom: SEGridTiles):
    nt1 = geom.G // geom.m
    idx = jnp.arange(nt1 ** 3, dtype=jnp.int32)
    return idx // (nt1 * nt1), (idx // nt1) % nt1, idx % nt1


def _tile_windows(geom: SEGridTiles, u: Array, i0: Array, dtype):
    """(R, W) window weights along one axis for ONE tile: slab origin
    i0*m - P//2, dense over the W slab points (off-support values are
    exponentially tiny — strict accuracy superset of P-point windows).
    lax.map vmaps this over tile chunks."""
    m, P = geom.m, geom.P
    W = m + P
    offs = jnp.arange(W, dtype=dtype)
    s = (i0 * m - P // 2).astype(dtype) + offs[None, :]
    return window_weights_1d(geom, s - u[:, None], dtype)


def _placement_matrix(G: int, m: int, P: int, dtype=jnp.float32) -> Array:
    """(G, nt1*W) static 0/1 placement: column nt*W + w contributes to grid
    row (nt*m + w - P//2) mod G. Folding a slab axis into the grid axis as
    ONE placement GEMM replaces a roll-based combine of W shifted
    full-slab adds, each of which streams the whole slab."""
    W = m + P
    nt1 = G // m
    S = np.zeros((G, nt1 * W), np.float32)
    for nt in range(nt1):
        for w in range(W):
            S[(nt * m + w - P // 2) % G, nt * W + w] = 1.0
    return jnp.asarray(S, dtype)


def se_spread_tiles(geom: SEGridTiles, pieces, forces: Array,
                    tile_batch: int = 128) -> Array:
    """(G, G, G, 3) spread grid via per-tile matrix contractions.

    Scans over x-planes of tiles (nt1 steps), so the full
    (n_tiles, W, W, W, 3) slab tensor is never materialized. Per tile the
    window outer product contracts slots into a FLAT (Wx, Wy*Wz*3) slab.
    The plane's y/z slab axes fold into grid axes by two placement GEMMs
    (static 0/1 matrices, exact at HIGHEST precision); only the W x-rows
    add into the carried grid."""
    G, m, P, R = geom.G, geom.m, geom.P, geom.R
    W = m + P
    nt1 = G // m
    dtype = forces.dtype
    n = forces.shape[0]
    perm, _ovf, u, valid, _slot_of = pieces
    f = jnp.where(valid[..., None], forces[jnp.minimum(perm, n - 1)], 0.0)
    hi = jax.lax.Precision.HIGHEST
    # tile coords within ONE x-plane (identical for every plane)
    j = jnp.arange(nt1 * nt1, dtype=jnp.int32)
    iy_p, iz_p = j // nt1, j % nt1
    S = _placement_matrix(G, m, P, dtype).reshape(G, nt1, W)

    u_p = u.reshape(nt1, nt1 * nt1, R, 3)
    v_p = valid.reshape(nt1, nt1 * nt1, R)
    f_p = f.reshape(nt1, nt1 * nt1, R, 3)

    def plane(acc, xs):
        px, u_r, v_r, f_r = xs

        def body(args):
            # ONE tile (lax.map with batch_size vmaps this -> a batched
            # contraction over the R slots)
            ur, vr, fr, iyr, izr = args
            wx = jnp.where(vr[:, None],
                           _tile_windows(geom, ur[:, 0], px, dtype), 0.0)
            wy = _tile_windows(geom, ur[:, 1], iyr, dtype)
            wz = _tile_windows(geom, ur[:, 2], izr, dtype)
            wzf = (wz[:, :, None] * fr[:, None, :]).reshape(R, W * 3)
            c1 = (wy[:, :, None] * wzf[:, None, :]).reshape(R, W * W * 3)
            return jnp.einsum("rx,rq->xq", wx, c1, precision=hi)

        slabs = jax.lax.map(body, (u_r, v_r, f_r, iy_p, iz_p),
                            batch_size=min(tile_batch, nt1 * nt1))
        # (nty, ntz, Wx, Wy, Wz*3) -> fold y then z into grid axes
        s = slabs.reshape(nt1, nt1, W, W, W * 3)
        s = jnp.einsum("gnq,nzxqk->gzxk", S, s, precision=hi)
        # (Gy, ntz, Wx, Wz*3) -> (Gz, Gy, Wx, 3)
        s = jnp.einsum("hzw,gzxwc->hgxc", S,
                       s.reshape(G, nt1, W, W, 3), precision=hi)
        s = jnp.transpose(s, (2, 1, 0, 3))  # (Wx, Gy, Gz, 3)
        # contiguous slice-add into the x-PADDED accumulator: plane px's
        # rows are [px*m, px*m + W) in padded coords (offset P//2), so no
        # wraparound and no dynamic-index scatter
        row0 = px * m
        z = jnp.zeros((), row0.dtype)
        cur = jax.lax.dynamic_slice(acc, (row0, z, z, z), (W, G, G, 3))
        return jax.lax.dynamic_update_slice(acc, cur + s,
                                            (row0, z, z, z)), None

    ph = P // 2
    # seed from the input so the carry carries the same varying-manual-axes
    # type as the body output under shard_map (a plain zeros carry fails
    # scan's carry-type check inside sharded callers)
    acc0 = jnp.zeros((G + P, G, G, 3), dtype) + (jnp.sum(f) * 0).astype(dtype)
    acc, _ = jax.lax.scan(
        plane, acc0,
        (jnp.arange(nt1, dtype=jnp.int32), u_p, v_p, f_p))
    # fold the periodic pad ends: padded row a = grid row (a - ph) mod G
    grid = acc[ph:ph + G]
    grid = grid.at[G - ph:].add(acc[:ph])
    grid = grid.at[:P - ph].add(acc[G + ph:])
    return grid


def se_interp_tiles(geom: SEGridTiles, pieces, grid: Array,
                    tile_batch: int = 128) -> Array:
    """Interpolate grid velocities to particles: transposed contraction
    over per-tile slab views (the memory mirror of se_spread_tiles —
    same x-plane scan, gathering each plane's W x-rows from the grid
    instead of materializing all (n_tiles, W, W, W, 3) slab views)."""
    G, m, P, R = geom.G, geom.m, geom.P, geom.R
    W = m + P
    nt1 = G // m
    dtype = grid.dtype
    perm, _ovf, u, valid, slot_of = pieces
    hi = jax.lax.Precision.HIGHEST
    j = jnp.arange(nt1 * nt1, dtype=jnp.int32)
    iy_p, iz_p = j // nt1, j % nt1

    u_p = u.reshape(nt1, nt1 * nt1, R, 3)
    v_p = valid.reshape(nt1, nt1 * nt1, R)
    S = _placement_matrix(G, m, P, dtype).reshape(G, nt1, W)

    # x-padded grid: plane px's rows are the contiguous slice
    # [px*m, px*m + W) — a dynamic_slice instead of a W-row dynamic-index
    # gather
    ph = P // 2
    gpad = jnp.concatenate([grid[G - ph:], grid, grid[:P - ph]], axis=0)

    def plane(_, xs):
        px, u_r, v_r = xs
        row0 = px * m
        z = jnp.zeros((), row0.dtype)
        gx = jax.lax.dynamic_slice(
            gpad, (row0, z, z, z), (W, G, G, 3))     # (Wx, Gy, Gz, 3)
        # transposed placement GEMMs (the extract mirror of the spread's
        # combine GEMMs — see _placement_matrix for why not roll-based)
        s = jnp.einsum("gnq,xghc->nqxhc", S, gx,
                       precision=hi)                 # (nty, Wy, Wx, Gz, 3)
        s = jnp.einsum("hzw,nqxhc->nzxqwc", S, s,
                       precision=hi)                 # (nty, ntz, Wx, Wy, Wz, 3)
        slabs = s.reshape(nt1 * nt1, W, W * W * 3)   # (tiles, Wx, Wy*Wz3)

        def body(args):
            # ONE tile (vmapped by lax.map)
            ur, vr, iyr, izr, sl = args
            wx = jnp.where(vr[:, None],
                           _tile_windows(geom, ur[:, 0], px, dtype), 0.0)
            wy = _tile_windows(geom, ur[:, 1], iyr, dtype)
            wz = _tile_windows(geom, ur[:, 2], izr, dtype)
            t1 = jnp.einsum("rx,xq->rq", wx, sl,
                            precision=hi)            # (R, Wy*Wz3)
            t2 = jnp.einsum("rq,rqk->rk", wy, t1.reshape(R, W, W * 3),
                            precision=hi)            # (R, Wz3)
            return jnp.sum(t2.reshape(R, W, 3) * wz[:, :, None], axis=1)

        out_r = jax.lax.map(body, (u_r, v_r, iy_p, iz_p, slabs),
                            batch_size=min(tile_batch, nt1 * nt1))
        return None, out_r

    _, out = jax.lax.scan(
        plane, None,
        (jnp.arange(nt1, dtype=jnp.int32), u_p, v_p))
    # unsort by the inverse map: one (N,) row gather (never a slot scatter)
    flat = jnp.concatenate([out.reshape(-1, 3),
                            jnp.zeros((1, 3), dtype)], axis=0)
    uvel = flat[jnp.minimum(slot_of, nt1 ** 3 * R)]
    h = geom.box / G
    return uvel * (h * h * h)
