"""Sharded spectral-Ewald RPY mobility: config #5's hydro over a mesh.

The multi-chip re-design of the long-range Stokes path (the PVFMM role,
ref `TPLsList.cmake:29-30`; single-chip counterpart
mobility/spectral.se_rpy_apply_cells):

- particles are block-sharded over the mesh axis (flat (N/d, 3) arrays);
- WAVE space: each shard bins + spreads its OWN particles onto a full
  (G, G, G, 3) grid with the dense gridding (the dominant cost — now
  divided by d), the partial grids are summed with ONE `psum`, every shard
  runs the (replicated) 3D FFT x Hasimoto screen x iFFT, and interpolates
  back only at its own particles;
- REAL space: positions/forces are all-gathered (one psum each), every
  shard builds the same 3D-cell structure, but each evaluates only ITS
  x-slab of cells (`pair_apply_cells3d(x_range=...)` — the 27C dense pair
  blocks, the dominant cost, divided by d); slab results meet in one psum.

Scaling notes: the replicated FFT caps wave-space scaling at the FFT cost
and the all-gather costs O(N) interconnect bytes per apply; a pencil-decomposed FFT and halo-restricted
ghosting are the known upgrades once these dominate.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from mundy_tpu.mobility.ewald import rpy_real_cells_kernel
from mundy_tpu.mobility.spectral import SpectralEwaldRPY, _k_apply


def make_se_local_apply(
    axis: str,
    d: int,
    op: SpectralEwaldRPY,
    geom,
    cells_grid,
    n_total: int,
    box_lengths,
):
    """Shard-LOCAL spectral-Ewald RPY apply for composition inside an
    existing `shard_map` program over mesh axis `axis` of size `d`.

    Returns local_apply(pos_l, f_l, pos_all=None, f_all=None) ->
    (u_local, overflow) where pos_l/f_l are the shard's (N/d, 3) blocks and
    pos_all/f_all are optional pre-gathered (N, 3) replicas (saves the
    all-gathers when the caller already holds them, e.g. the full sharded
    chromatin step which ghosts positions every step anyway).

    This is the engine behind make_sharded_se_rpy_apply; the full sharded
    chromatin step (parallel/chromatin_shard.py) reuses it so config #5's
    contact + KMC + hydro run in ONE distributed program (the reference
    runs the whole HP1 loop under one MPI world,
    `HP1...neigh_linker.cpp:1377-1524`).
    """
    from mundy_tpu.neighbor.cells3d import (
        build_cells3d,
        gather_from_flat,
        pair_apply_cells3d,
    )
    from mundy_tpu.ops.se_grid import (
        SEGridTiles,
        se_bin_dense,
        se_bin_tiles,
        se_interp_dense,
        se_interp_tiles,
        se_spread_dense,
        se_spread_tiles,
    )

    tiled = isinstance(geom, SEGridTiles)
    if n_total % d != 0:
        raise ValueError("n_total must divide the mesh axis")
    n_local = n_total // d
    nx = cells_grid.nx
    # per-shard x-slab of cells: sizes differ by at most 1; pad to equal
    # static length and let the dynamic start place each shard's slab
    nxl = -(-nx // d)
    L = tuple(float(v) for v in box_lengths)
    kernel = rpy_real_cells_kernel(op.base)

    def local_apply(pos_l, f_l, pos_all=None, f_all=None):
        me = jax.lax.axis_index(axis)

        # ---- all-gather positions + forces (one psum each) unless the
        # caller already ghosted them
        def allgather(v):
            buf = jnp.zeros((n_total, 3), v.dtype)
            buf = jax.lax.dynamic_update_slice_in_dim(
                buf, v, me * n_local, axis=0)
            return jax.lax.psum(buf, axis)

        if pos_all is None:
            pos_all = allgather(pos_l)
        if f_all is None:
            f_all = allgather(f_l)

        # ---- wave space: local spread -> psum'd grid -> replicated FFT
        # (geometry dispatch: 3D tiles for clustered systems, rows else)
        if tiled:
            pieces = se_bin_tiles(geom, pos_l, pos_l.dtype)
            grid = se_spread_tiles(geom, pieces, f_l)
        else:
            pieces = se_bin_dense(geom, pos_l, pos_l.dtype)
            grid = se_spread_dense(geom, pieces, f_l)
        grid = jax.lax.psum(grid, axis)
        ugrid = _k_apply(op, grid)
        if tiled:
            uw = se_interp_tiles(geom, pieces, ugrid.astype(pos_l.dtype))
        else:
            uw = se_interp_dense(geom, pieces, n_local,
                                 ugrid.astype(pos_l.dtype))
        overflow = pieces[1]

        # ---- real space: replicated cells, x-slab evaluation
        cells = build_cells3d(pos_all, cells_grid)
        overflow = overflow | cells.overflow
        payload = gather_from_flat(cells, f_all)
        x0 = jnp.minimum(me * nxl, nx - nxl)
        u_slab = pair_apply_cells3d(cells, L, payload, kernel, 3,
                                    x_range=(x0, nxl))
        # scatter the slab's per-slot velocities to flat ids; off-slab and
        # pad-overlap slots must not double-count: mask slots whose cell
        # belongs to another shard's slab
        perm_slab = jax.lax.dynamic_slice_in_dim(cells.perm, x0, nxl, 0)
        cell_x = x0 + jax.lax.broadcasted_iota(
            jnp.int32, perm_slab.shape, 0)
        owned = (cell_x >= me * nxl) & (cell_x < jnp.minimum(
            (me + 1) * nxl, nx))
        tgt = jnp.where(owned & (perm_slab < n_total), perm_slab, n_total)
        ur = jnp.zeros((n_total + 1, 3), pos_l.dtype).at[
            tgt.reshape(-1)].set(u_slab.reshape(-1, 3), mode="drop")[:-1]
        ur = jax.lax.psum(ur, axis)
        u_local = jax.lax.dynamic_slice_in_dim(ur, me * n_local, n_local, 0)
        # the cells self term IS self_coeff (sep = 0 pair), so no extra add
        u = u_local + uw
        overflow = jax.lax.pmax(overflow.astype(jnp.int32), axis) > 0
        return u, overflow

    return local_apply


def make_sharded_se_rpy_apply(
    mesh: Mesh,
    axis: str,
    op: SpectralEwaldRPY,
    geom,
    cells_grid,
    n_total: int,
    box_lengths,
    dtype=jnp.float32,
):
    """Returns (apply_fn, shard_in).

    apply_fn(pos, forces) -> (velocities, overflow): jitted shard_map over
    the mesh; pos/forces are (N, 3) arrays sharded (or shardable) over
    `axis` on their first dimension (N divisible by the axis size).
    `geom` from make_se_geometry(_tiles) sized for the PER-SHARD particle
    count (N/d); `cells_grid` from make_cell_grid3d for the full N.
    """
    d = mesh.shape[axis]
    local_apply = make_se_local_apply(axis, d, op, geom, cells_grid,
                                      n_total, box_lengths)

    apply_fn = jax.jit(
        jax.shard_map(
            local_apply, mesh=mesh,
            in_specs=(P(axis), P(axis)),
            out_specs=(P(axis), P()),
            check_vma=False,
        )
    )
    shard = NamedSharding(mesh, P(axis))
    return apply_fn, shard
