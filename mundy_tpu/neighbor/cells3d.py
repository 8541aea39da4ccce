"""Dense 3D-cell engine: gather-free wide-cutoff pairwise operators.

The row engine (rows.py) keeps the x axis dense inside each (y, z) cell
column — right for contact-scale cutoffs where the row is O(10-100) slots.
For WIDE cutoffs (the spectral-Ewald real-space correction at r_cut ~ 3-8
interparticle spacings) the row design wastes the full x extent per pair,
and the (N, K) neighbor-matrix alternative is far worse: K grows to
O(100-2000) and its K-pass extraction + per-apply gathers dominate
everything (measured 20 s per hydro rebuild at 262k bodies).

This engine is the 3D completion of the row idea:

- particles live in a dense (nx, ny, nz, C) cell layout (cell edge >=
  cutoff, capacity C with sentinel-filled empty slots) — one sort + one
  scatter to build, like build_rows;
- the neighbor candidates of a cell are its 27 neighbor cells: 26 jnp.roll
  shifts over the three grid axes with periodic image pre-shifts applied
  per axis — ZERO per-pair minimum-image work and zero gathers;
- a pairwise tensor kernel (e.g. the RPY real-space correction) runs on
  dense (C, 27C) pair blocks, with per-slot payload channels
  (forces) riding the same rolled planes.

ref: this replaces the reference's neighbor-linker pipeline for the hydro
interaction class (`GenNeighborLinkers.hpp` + `RPYSpheres.hpp` O(N*k)
team sums).
"""

from __future__ import annotations

import math
from typing import Callable

import jax
import jax.numpy as jnp
import numpy as np
from jax import Array

from mundy_tpu.core.containers import pytree_dataclass, static_field


@pytree_dataclass
class CellGrid3D:
    origin: Array  # (3,)
    edge: Array  # (3,) cell edge per axis
    nx: int = static_field(default=1)
    ny: int = static_field(default=1)
    nz: int = static_field(default=1)
    capacity: int = static_field(default=8)


@pytree_dataclass
class Cells3DState:
    grid: CellGrid3D
    pos: Array  # (nx, ny, nz, C, 3) sentinel-filled
    perm: Array  # (nx, ny, nz, C) int32 particle id per slot (n = empty)
    overflow: Array  # () bool


def make_cell_grid3d(box_lengths, cutoff: float, n_particles: int,
                     capacity_slack: float = 1.15,
                     dtype=jnp.float32) -> CellGrid3D:
    """Cells with edge >= cutoff on every axis; capacity from the
    Poisson-max estimate with slack (overflow flag on violation)."""
    L = np.asarray(box_lengths, np.float64)
    n = np.maximum((L // cutoff).astype(int), 1)
    n_cells = int(n[0] * n[1] * n[2])
    occ = n_particles / n_cells
    cap = int(occ * capacity_slack + 6 * math.sqrt(occ + 4) + 4)
    cap = ((cap + 7) // 8) * 8
    return CellGrid3D(origin=jnp.zeros((3,), dtype),
                      edge=jnp.asarray(L / n, dtype),
                      nx=int(n[0]), ny=int(n[1]), nz=int(n[2]),
                      capacity=cap)


def build_cells3d(pos: Array, grid: CellGrid3D) -> Cells3DState:
    """Flat (N, 3) positions -> dense 3D cell layout (one sort + scatter)."""
    n = pos.shape[0]
    C = grid.capacity
    dims = jnp.asarray([grid.nx, grid.ny, grid.nz], jnp.int32)
    ic = jnp.clip(((pos - grid.origin) / grid.edge).astype(jnp.int32),
                  0, dims - 1)
    cell = (ic[:, 0] * grid.ny + ic[:, 1]) * grid.nz + ic[:, 2]
    order = jnp.argsort(cell)
    cell_s = cell[order]
    first = jnp.concatenate([jnp.ones((1,), bool), cell_s[1:] != cell_s[:-1]])
    starts = jnp.where(first, jnp.arange(n, dtype=jnp.int32), 0)
    cell_start = jax.lax.associative_scan(jnp.maximum, starts)
    rank = jnp.arange(n, dtype=jnp.int32) - cell_start
    n_cells = grid.nx * grid.ny * grid.nz
    counts = jnp.zeros((n_cells,), jnp.int32).at[cell].add(1)
    overflow = jnp.any(counts > C)
    slot = cell_s * C + jnp.minimum(rank, C - 1)
    slot = jnp.where(rank < C, slot, n_cells * C)
    # sentinel: empty slots sit ~1e6 boxes away in y (beyond every cutoff
    # against real particles; sentinel-sentinel pairs rely on zero payload)
    ext_y = grid.edge[1] * grid.ny
    sentinel_y = grid.origin[1] - 1e6 * (ext_y + 1.0)
    flat_pos = jnp.zeros((n_cells * C, 3), pos.dtype)
    flat_pos = flat_pos.at[:, 1].set(sentinel_y.astype(pos.dtype))
    flat_pos = flat_pos.at[slot].set(pos[order], mode="drop")
    flat_perm = jnp.full((n_cells * C,), n, jnp.int32).at[slot].set(
        order.astype(jnp.int32), mode="drop")
    shape = (grid.nx, grid.ny, grid.nz, C)
    return Cells3DState(grid=grid, pos=flat_pos.reshape(shape + (3,)),
                        perm=flat_perm.reshape(shape), overflow=overflow)


def _axis_shift(n: int, d: int, L: float, dtype) -> Array:
    idx = np.arange(n)
    s = np.where(idx + d >= n, L, np.where(idx + d < 0, -L, 0.0))
    return jnp.asarray(s, dtype)


def pair_apply_cells3d(
    state: Cells3DState,
    box_lengths,
    payload: Array,  # (nx, ny, nz, C, D) per-slot input channels (zeroed
    #                  on empty slots by the caller!)
    kernel: Callable[..., Array],
    out_dim: int,
    hbm_budget_bytes: float = 2.0e9,
    x_range=None,
) -> Array:
    """Dense pairwise reduction over the 27-cell neighborhood.

    kernel(DX, DY, DZ, r2, pj) with pair blocks (rows, nz, C, 27C) and
    payload pj (rows, nz, 27C, D) must return the REDUCED per-slot output
    (rows, nz, C, out_dim) (reduce over the 27C lane axis inside — the
    full pair-block output would be D x 27C times larger than the inputs).
    The kernel must vanish beyond the grid cutoff (sentinel slots separate
    themselves from real particles) AND for zero payload (sentinel-
    sentinel and empty-slot pairs carry payload 0). Self-pairs (sep = 0,
    own payload) are NOT excluded — kernels that must skip them subtract
    the self term or use an r2 > 0 mask.

    `x_range = (x0, nxl)`: evaluate only the x-slab of cells [x0, x0+nxl)
    as TARGETS (candidates still come from the full periodic grid) — the
    spatial-decomposition hook for sharded evaluation (x0 may be traced,
    nxl is static). Returns (nxl, ny, nz, C, out_dim); default full grid.

    Returns (nx, ny, nz, C, out_dim).
    """
    pos = state.pos
    nx, ny, nz, C = pos.shape[:4]
    dtype = pos.dtype
    L = tuple(float(v) for v in box_lengths)
    if nx < 3 or ny < 3 or nz < 3:
        raise ValueError("pair_apply_cells3d needs >= 3 cells per axis")
    D = payload.shape[-1]

    # 27 rolled candidate blocks, concatenated along one lane axis, with
    # periodic image shifts pre-applied per axis
    cand = []
    for dx in (-1, 0, 1):
        for dy in (-1, 0, 1):
            for dz in (-1, 0, 1):
                if (dx, dy, dz) == (0, 0, 0):
                    cp, cf = pos, payload
                else:
                    cp = jnp.roll(pos, (-dx, -dy, -dz), axis=(0, 1, 2))
                    cf = jnp.roll(payload, (-dx, -dy, -dz), axis=(0, 1, 2))
                x, y, z = cp[..., 0], cp[..., 1], cp[..., 2]
                if dx != 0:
                    x = x + _axis_shift(nx, dx, L[0], dtype)[:, None, None, None]
                if dy != 0:
                    y = y + _axis_shift(ny, dy, L[1], dtype)[None, :, None, None]
                if dz != 0:
                    z = z + _axis_shift(nz, dz, L[2], dtype)[None, None, :, None]
                cand.append((x, y, z, cf))
    cx = jnp.concatenate([c[0] for c in cand], axis=-1)  # (nx,ny,nz,27C)
    cy = jnp.concatenate([c[1] for c in cand], axis=-1)
    cz = jnp.concatenate([c[2] for c in cand], axis=-1)
    cf = jnp.concatenate([c[3] for c in cand], axis=-2)  # (nx,ny,nz,27C,D)

    ox, oy, oz = pos[..., 0], pos[..., 1], pos[..., 2]
    if x_range is not None:
        x0, nxl = x_range
        sl = lambda a: jax.lax.dynamic_slice_in_dim(a, x0, nxl, 0)  # noqa: E731
        ox, oy, oz = sl(ox), sl(oy), sl(oz)
        cx, cy, cz, cf = sl(cx), sl(cy), sl(cz), sl(cf)
        nx_out = nxl
    else:
        nx_out = nx
    ox = ox.reshape(nx_out * ny, nz, C)
    oy = oy.reshape(nx_out * ny, nz, C)
    oz = oz.reshape(nx_out * ny, nz, C)
    cx = cx.reshape(nx_out * ny, nz, 27 * C)
    cy = cy.reshape(nx_out * ny, nz, 27 * C)
    cz = cz.reshape(nx_out * ny, nz, 27 * C)
    cf = cf.reshape(nx_out * ny, nz, 27 * C, D)

    def chunk_fn(args):
        oxc, oyc, ozc, cxc, cyc, czc, cfc = args
        DX = cxc[..., None, :] - oxc[..., :, None]   # (rows, nz, C, 27C)
        DY = cyc[..., None, :] - oyc[..., :, None]
        DZ = czc[..., None, :] - ozc[..., :, None]
        r2 = DX * DX + DY * DY + DZ * DZ
        return kernel(DX, DY, DZ, r2, cfc)

    itemsize = jnp.dtype(dtype).itemsize
    bytes_per_row = (8 + 2 * D) * nz * C * 27 * C * itemsize
    cr = max(1, int(hbm_budget_bytes // max(bytes_per_row, 1)))
    out = jax.lax.map(chunk_fn, (ox, oy, oz, cx, cy, cz, cf), batch_size=cr)
    return out.reshape(nx_out, ny, nz, C, out_dim)


def scatter_to_flat(state: Cells3DState, values: Array, n: int) -> Array:
    """(nx, ny, nz, C, D) slot values -> flat (n, D) by particle id."""
    D = values.shape[-1]
    flat_perm = state.perm.reshape(-1)
    out = jnp.zeros((n + 1, D), values.dtype)
    out = out.at[jnp.minimum(flat_perm, n)].set(
        values.reshape(-1, D), mode="drop")
    return out[:n]


def gather_from_flat(state: Cells3DState, values: Array) -> Array:
    """Flat (n, D) -> (nx, ny, nz, C, D) slot layout (zero on empty)."""
    n = values.shape[0]
    perm = state.perm
    v = values[jnp.minimum(perm.reshape(-1), n - 1)]
    v = jnp.where((perm.reshape(-1) < n)[:, None], v, 0.0)
    return v.reshape(perm.shape + (values.shape[-1],))


# ---------------------------------------------------------------------------
# Density-split engine: the dense layout pays the GLOBAL max occupancy C in
# every cell, and the pair scan costs ~ C^2 per cell — clustered states
# (HP1 chromatin globules: measured max 50 vs mean 12 at r_cut 3.5) waste
# (C_max / C_mean)^2 ~ 15-35x of the compute-bound pair evaluations. The split
# keeps a BASE grid at a low capacity C_lo (~2x mean) plus a COMPACT list
# of the few dense cells carrying the excess particles; the quadratic pass
# runs at C_lo^2 and the dense-cell corrections run over O(DC) cells, not
# O(n_cells). ref: the reference offloads this whole interaction class to
# PVFMM (TPLsList.cmake:29) — this split is the dense-engine answer to
# the same clustering problem.
# ---------------------------------------------------------------------------


@pytree_dataclass
class CellsSplitState:
    """build_cells3d_split result: base grid + compact dense-cell excess."""

    base: Cells3DState  # capacity C_lo; ranks >= C_lo are NOT an overflow
    xs_pos: Array  # (DC, CE, 3) excess positions (sentinel on empty)
    xs_perm: Array  # (DC, CE) particle id per excess slot (n = empty)
    dc_cell: Array  # (DC,) flat cell id of each dense cell (n_cells = pad)
    dense_of: Array  # (n_cells,) dense slot of a cell (DC = not dense)
    overflow: Array  # () bool: dense cells > DC or a cell > C_lo + CE


def build_cells3d_split(pos: Array, grid: CellGrid3D, c_ex: int,
                        dc_cap: int) -> CellsSplitState:
    """Flat (N, 3) -> base cells at grid.capacity (= C_lo) + compact
    excess: particles with in-cell rank >= C_lo land in per-dense-cell
    slots (dense cell = count > C_lo; at most dc_cap of them, each with
    c_ex excess slots). One sort + three scatters."""
    n = pos.shape[0]
    C = grid.capacity
    dims = jnp.asarray([grid.nx, grid.ny, grid.nz], jnp.int32)
    ic = jnp.clip(((pos - grid.origin) / grid.edge).astype(jnp.int32),
                  0, dims - 1)
    cell = (ic[:, 0] * grid.ny + ic[:, 1]) * grid.nz + ic[:, 2]
    order = jnp.argsort(cell)
    cell_s = cell[order]
    first = jnp.concatenate([jnp.ones((1,), bool), cell_s[1:] != cell_s[:-1]])
    starts = jnp.where(first, jnp.arange(n, dtype=jnp.int32), 0)
    cell_start = jax.lax.associative_scan(jnp.maximum, starts)
    rank = jnp.arange(n, dtype=jnp.int32) - cell_start
    n_cells = grid.nx * grid.ny * grid.nz
    counts = jnp.zeros((n_cells,), jnp.int32).at[cell].add(1)

    dense = counts > C
    dcum = jnp.cumsum(dense.astype(jnp.int32))
    n_dense = dcum[n_cells - 1]
    dense_of = jnp.where(dense, jnp.minimum(dcum - 1, dc_cap), dc_cap)
    dense_of = dense_of.astype(jnp.int32)
    dc_cell = jnp.full((dc_cap + 1,), n_cells, jnp.int32).at[dense_of].set(
        jnp.arange(n_cells, dtype=jnp.int32), mode="drop")[:dc_cap]
    overflow = (n_dense > dc_cap) | jnp.any(counts > C + c_ex)

    # base slots (rank < C) — identical layout to build_cells3d
    slot = cell_s * C + jnp.minimum(rank, C - 1)
    slot = jnp.where(rank < C, slot, n_cells * C)
    ext_y = grid.edge[1] * grid.ny
    sentinel_y = grid.origin[1] - 1e6 * (ext_y + 1.0)
    flat_pos = jnp.zeros((n_cells * C, 3), pos.dtype)
    flat_pos = flat_pos.at[:, 1].set(sentinel_y.astype(pos.dtype))
    flat_pos = flat_pos.at[slot].set(pos[order], mode="drop")
    flat_perm = jnp.full((n_cells * C,), n, jnp.int32).at[slot].set(
        order.astype(jnp.int32), mode="drop")
    shape = (grid.nx, grid.ny, grid.nz, C)
    base = Cells3DState(grid=grid, pos=flat_pos.reshape(shape + (3,)),
                        perm=flat_perm.reshape(shape),
                        overflow=jnp.asarray(False))

    # excess slots (rank in [C, C + c_ex), dense slot of the cell)
    d_of = dense_of[cell_s]
    xrank = rank - C
    xslot = jnp.where((rank >= C) & (xrank < c_ex) & (d_of < dc_cap),
                      d_of * c_ex + xrank, dc_cap * c_ex)
    xs_pos = jnp.zeros((dc_cap * c_ex + 1, 3), pos.dtype)
    xs_pos = xs_pos.at[:, 1].set(sentinel_y.astype(pos.dtype))
    xs_pos = xs_pos.at[xslot].set(pos[order], mode="drop")[:dc_cap * c_ex]
    xs_perm = jnp.full((dc_cap * c_ex + 1,), n, jnp.int32).at[xslot].set(
        order.astype(jnp.int32), mode="drop")[:dc_cap * c_ex]
    return CellsSplitState(base=base,
                           xs_pos=xs_pos.reshape(dc_cap, c_ex, 3),
                           xs_perm=xs_perm.reshape(dc_cap, c_ex),
                           dc_cell=dc_cell, dense_of=dense_of,
                           overflow=overflow)


def pair_apply_cells3d_split(
    split: CellsSplitState,
    box_lengths,
    forces: Array,  # flat (n, D)
    kernel: Callable[..., Array],
    out_dim: int,
    hbm_budget_bytes: float = 2.0e9,
    dc_chunk: int = 128,
) -> Array:
    """Full pairwise sum (same kernel contract as pair_apply_cells3d) as
    base x base (dense quadratic pass at C_lo) + three compact dense-cell
    passes. Ordered pairs partition exactly by (target class, source
    class): A base<-base on the grid; B' base<-excess and C'/D'
    excess<-(base+excess) over each dense cell's 27-neighborhood (sources
    farther than one cell vanish by the kernel's cutoff). Every particle's
    self-pair appears exactly once (A for base ranks, D' for excess).
    Returns flat (n, out_dim)."""
    base = split.base
    grid = base.grid
    nx, ny, nz, C = base.perm.shape
    n_cells = nx * ny * nz
    n, D = forces.shape
    dtype = base.pos.dtype
    L = tuple(float(v) for v in box_lengths)
    DC, CE = split.xs_perm.shape

    payload = gather_from_flat(base, forces)
    uA = pair_apply_cells3d(base, box_lengths, payload, kernel, out_dim,
                            hbm_budget_bytes)
    out = jnp.zeros((n + 1, out_dim), dtype)
    flat_perm = base.perm.reshape(-1)
    out = out.at[jnp.minimum(flat_perm, n)].add(
        uA.reshape(-1, out_dim), mode="drop")

    # --- compact dense-cell machinery ---
    ci = jnp.minimum(split.dc_cell, n_cells - 1)  # (DC,) clamped pad
    cxi = ci // (ny * nz)
    cyi = (ci // nz) % ny
    czi = ci % nz
    noff, shifts = [], []
    for dx in (-1, 0, 1):
        for dy in (-1, 0, 1):
            for dz in (-1, 0, 1):
                nix = (cxi + dx) % nx
                niy = (cyi + dy) % ny
                niz = (czi + dz) % nz
                noff.append((nix * ny + niy) * nz + niz)
                sx = jnp.where(cxi + dx >= nx, L[0],
                               jnp.where(cxi + dx < 0, -L[0], 0.0))
                sy = jnp.where(cyi + dy >= ny, L[1],
                               jnp.where(cyi + dy < 0, -L[1], 0.0))
                sz = jnp.where(czi + dz >= nz, L[2],
                               jnp.where(czi + dz < 0, -L[2], 0.0))
                shifts.append(jnp.stack([sx, sy, sz], -1).astype(dtype))
    ncell = jnp.stack(noff, axis=1)  # (DC, 27)
    shift = jnp.stack(shifts, axis=1)  # (DC, 27, 3)

    bpos = base.pos.reshape(n_cells, C, 3)
    bpay = payload.reshape(n_cells, C, D)
    bperm = base.perm.reshape(n_cells, C)
    # neighborhood base candidates in the dense cell's frame (source
    # coords shifted by the periodic image; sentinel + L stays far)
    cand_pos = bpos[ncell] + shift[:, :, None, :]  # (DC, 27, C, 3)
    cand_pay = bpay[ncell]  # (DC, 27, C, D)
    # neighborhood excess candidates via the cell -> dense-slot map
    xs_pay = jnp.where((split.xs_perm < n)[..., None],
                       forces[jnp.minimum(split.xs_perm, n - 1)], 0.0)
    xs_pos_p = jnp.concatenate(
        [split.xs_pos,
         jnp.full((1, CE, 3), 0.0, dtype).at[..., 1].set(
             -1e6 * (float(L[1]) + 1.0))], axis=0)  # (DC+1, CE, 3) pad row
    xs_pay_p = jnp.concatenate([xs_pay, jnp.zeros((1, CE, D), dtype)], 0)
    nd = split.dense_of[ncell]  # (DC, 27) dense slot of neighbor (DC pad)
    xcand_pos = xs_pos_p[nd] + shift[:, :, None, :]  # (DC, 27, CE, 3)
    xcand_pay = xs_pay_p[nd]  # (DC, 27, CE, D)

    def pair_block(tgt, cpos, cpay):
        # tgt (b, T, 3), cpos (b, S, 3), cpay (b, S, D) -> (b, T, out_dim)
        DX = cpos[..., None, :, 0] - tgt[..., :, None, 0]
        DY = cpos[..., None, :, 1] - tgt[..., :, None, 1]
        DZ = cpos[..., None, :, 2] - tgt[..., :, None, 2]
        r2 = DX * DX + DY * DY + DZ * DZ
        return kernel(DX, DY, DZ, r2, cpay)

    # C' + D': excess targets <- all 27-neighborhood sources
    cpos_all = jnp.concatenate([cand_pos.reshape(DC, 27 * C, 3),
                                xcand_pos.reshape(DC, 27 * CE, 3)], axis=1)
    cpay_all = jnp.concatenate([cand_pay.reshape(DC, 27 * C, D),
                                xcand_pay.reshape(DC, 27 * CE, D)], axis=1)
    uX = jax.lax.map(lambda a: pair_block(a[0], a[1], a[2]),
                     (split.xs_pos, cpos_all, cpay_all),
                     batch_size=min(dc_chunk, DC))  # (DC, CE, out)
    out = out.at[jnp.minimum(split.xs_perm.reshape(-1), n)].add(
        uX.reshape(-1, out_dim), mode="drop")

    # B': neighborhood base targets <- this dense cell's excess sources.
    # Deltas in the dense cell's frame: the target sits at cand_pos
    # (already image-shifted), the source is the unshifted excess.
    uB = jax.lax.map(
        lambda a: pair_block(a[0].reshape(27 * C, 3), a[1], a[2]),
        (cand_pos, split.xs_pos, xs_pay),
        batch_size=min(dc_chunk, DC))  # (DC, 27C, out)
    tgt_ids = bperm[ncell].reshape(-1)  # (DC*27*C,)
    out = out.at[jnp.minimum(tgt_ids, n)].add(
        uB.reshape(-1, out_dim), mode="drop")
    return out[:n]
