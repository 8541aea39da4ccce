"""Dense cell-list broad phase (static shapes, jit-compatible).

Replaces `GenNeighborLinks::generate` (`GenNeighborLinkers.hpp:510-741`):
search spheres -> coarse search -> filters -> link pools becomes
bin -> 27-cell gather -> masked cutoff -> (dense neighbor matrix | compacted
pair list). The skin-distance rebuild trigger mirrors the reference's
`objects_moved_too_much` displacement accumulation
(`HP1...neigh_linker.cpp:1404-1427`).

Shapes are static everywhere: the grid dims and capacities are Python ints
(recompile on regrow — the host-side "regrow path" of SURVEY.md §7), and
overflow is reported as a traced bool the host can check between steps.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp
import numpy as np
from jax import Array

from mundy_tpu.core.containers import pytree_dataclass, static_field
from mundy_tpu.geom.periodicity import Metric


@pytree_dataclass
class CellGrid:
    """Static grid geometry. dims/capacity are trace-time constants."""

    origin: Array  # (3,) lower corner of the binned domain
    cell_size: Array  # (3,) cell edge lengths
    dims: tuple = static_field(default=(1, 1, 1))  # (nx, ny, nz)
    periodic: tuple = static_field(default=(False, False, False))


@pytree_dataclass
class CellList:
    """Dense bucketed cells: entries[c, k] = particle index or -1."""

    grid: CellGrid
    entries: Array  # (ncells, cell_capacity) int32
    counts: Array  # (ncells,) int32
    cell_of: Array  # (N,) int32 cell index per particle
    overflow: Array  # () bool — some cell exceeded capacity


class NeighborMatrix(NamedTuple):
    """Per-particle dense neighbor ids (the force-kernel format)."""

    idx: Array  # (N, K) int32 neighbor ids, N (=self) marks empty slots
    mask: Array  # (N, K) bool
    overflow: Array  # () bool — a particle had more than K neighbors


class PairList(NamedTuple):
    """Compacted unique (i < j) pairs (the constraint-assembly format)."""

    i: Array  # (C,) int32
    j: Array  # (C,) int32
    mask: Array  # (C,) bool
    num_pairs: Array  # () int32
    overflow: Array  # () bool — more than C pairs found


def make_cell_grid(domain_low, domain_high, min_cell_size: float,
                   periodic=(False, False, False), dtype=jnp.float32) -> CellGrid:
    """Host-side grid setup: as many cells as fit with edge >= min_cell_size.

    min_cell_size must be >= the largest pair interaction cutoff so that all
    neighbors of a particle live in the 27 surrounding cells.
    """
    low = np.asarray(domain_low, dtype=np.float64)
    high = np.asarray(domain_high, dtype=np.float64)
    extent = high - low
    dims = np.maximum(np.floor(extent / min_cell_size).astype(int), 1)
    cell = extent / dims
    return CellGrid(
        origin=jnp.asarray(low, dtype),
        cell_size=jnp.asarray(cell, dtype),
        dims=tuple(int(d) for d in dims),
        periodic=tuple(bool(p) for p in periodic),
    )


def _cell_coords(grid: CellGrid, pos: Array) -> Array:
    """Integer cell coords of each position, clamped/wrapped into the grid."""
    rel = (pos - grid.origin) / grid.cell_size
    c = jnp.floor(rel).astype(jnp.int32)
    dims = jnp.asarray(grid.dims, jnp.int32)
    per = jnp.asarray(grid.periodic, bool)
    wrapped = jnp.mod(c, dims)
    clamped = jnp.clip(c, 0, dims - 1)
    return jnp.where(per, wrapped, clamped)


def _linear_cell(grid: CellGrid, c: Array) -> Array:
    nx, ny, _nz = grid.dims
    return c[..., 0] + nx * (c[..., 1] + ny * c[..., 2])


def build_cell_list(pos: Array, grid: CellGrid, cell_capacity: int,
                    valid: Optional[Array] = None) -> CellList:
    """Bin particles into the dense (ncells, capacity) table.

    Pure-XLA construction: sort by cell id, compute within-cell rank by a
    segment trick, scatter into the dense table. One sort = the Morton-sort
    locality pass of the reference's LBVH build. Rows with valid=False are
    dropped (capacity-padded inputs, e.g. shard slots/halo buffers).
    """
    n = pos.shape[0]
    ncells = int(np.prod(grid.dims))
    cell_of = _linear_cell(grid, _cell_coords(grid, pos))
    if valid is not None:
        cell_of = jnp.where(valid, cell_of, ncells)

    order = jnp.argsort(cell_of)
    sorted_cells = cell_of[order]

    # rank within cell: position since the start of this cell's run
    first_of_run = jnp.concatenate(
        [jnp.zeros((1,), bool), sorted_cells[1:] != sorted_cells[:-1]]
    )
    run_starts = jnp.where(first_of_run, jnp.arange(n, dtype=jnp.int32), 0)
    start_of_cell = jax.lax.associative_scan(jnp.maximum, run_starts)
    rank = jnp.arange(n, dtype=jnp.int32) - start_of_cell

    counts = jnp.zeros((ncells,), jnp.int32).at[cell_of].add(1)
    overflow = jnp.any(counts > cell_capacity)

    keep = rank < cell_capacity
    flat_slot = sorted_cells * cell_capacity + jnp.minimum(rank, cell_capacity - 1)
    entries = jnp.full((ncells * cell_capacity,), -1, jnp.int32)
    entries = entries.at[jnp.where(keep, flat_slot, ncells * cell_capacity)].set(
        order.astype(jnp.int32), mode="drop"
    )
    return CellList(
        grid=grid,
        entries=entries.reshape(ncells, cell_capacity),
        counts=counts,
        cell_of=cell_of,
        overflow=overflow,
    )


def _neighbor_cell_table(grid: CellGrid) -> np.ndarray:
    """(27, 3) integer offsets — trace-time constant."""
    offs = np.array(
        [(dx, dy, dz) for dx in (-1, 0, 1) for dy in (-1, 0, 1) for dz in (-1, 0, 1)],
        dtype=np.int32,
    )
    return offs


def _neighbor_cells_of(grid: CellGrid, coords: Array) -> tuple[Array, Array]:
    """For cell coords (..., 3) return (27 linear ids, validity) with wrap/clip."""
    offs = jnp.asarray(_neighbor_cell_table(grid))  # (27, 3)
    nb = coords[..., None, :] + offs  # (..., 27, 3)
    dims = jnp.asarray(grid.dims, jnp.int32)
    per = jnp.asarray(grid.periodic, bool)
    in_range = (nb >= 0) & (nb < dims)
    valid = jnp.all(in_range | per, axis=-1)  # (..., 27)
    nb = jnp.where(per, jnp.mod(nb, dims), jnp.clip(nb, 0, dims - 1))
    return _linear_cell(grid, nb), valid


def _compact_rows(cand: Array, ok: Array, k: int, empty_marker: int):
    """First-k row compaction via binary search on the row cumsum.

    cand/ok: (rows, ncand). Returns (idx (rows, k), mask (rows, k),
    count (rows,)). The column of the j-th hit is the first c with
    cumsum(ok)[c] >= j+1 — located with ceil(log2(ncand)) take_along_axis
    gathers (no sort, no scatter).
    """
    rows, ncand = cand.shape
    c = jnp.cumsum(ok, axis=1, dtype=jnp.int32)
    count = c[:, -1]
    targets = jnp.arange(1, k + 1, dtype=jnp.int32)[None, :]  # (1, k)
    lo = jnp.zeros((rows, k), jnp.int32)
    hi = jnp.full((rows, k), ncand, jnp.int32)
    steps = max(1, int(np.ceil(np.log2(ncand))))
    for _ in range(steps):
        mid = (lo + hi) >> 1
        cm = jnp.take_along_axis(c, jnp.minimum(mid, ncand - 1), axis=1)
        ge = cm >= targets
        hi = jnp.where(ge, mid, hi)
        lo = jnp.where(ge, lo, mid + 1)
    found = targets <= count[:, None]
    col = jnp.minimum(lo, ncand - 1)
    idx = jnp.take_along_axis(cand, col, axis=1)
    return jnp.where(found, idx, empty_marker), found, count


def neighbor_candidates(query_pos: Array, clist: CellList) -> Array:
    """(Q, 27*cap) candidate particle ids (-1 = empty) around each query
    position — the raw 27-cell stencil, no distance filter, no compaction.

    The subset-query primitive (the reference searches each interaction
    class separately, `HP1...neigh_linker.cpp:1436-1444`): for Q query
    points (e.g. crosslinker heads, Q << N) this costs Q * 27 * cap gathers
    instead of an N-wide neighbor-matrix build. All bodies within
    (cell_edge) of a query are guaranteed present; callers mask/weight by
    distance themselves."""
    grid = clist.grid
    cap = clist.entries.shape[1]
    q = query_pos.shape[0]
    coords = _cell_coords(grid, query_pos)
    cells27, valid27 = _neighbor_cells_of(grid, coords)  # (Q, 27)
    cand = clist.entries[cells27]  # (Q, 27, cap)
    cand = jnp.where(valid27[..., None], cand, -1)
    return cand.reshape(q, 27 * cap)


def neighbor_matrix(
    pos: Array,
    clist: CellList,
    search_radius: Array,
    metric: Optional[Metric] = None,
    max_neighbors: int = 32,
    chunk: int = 4096,
    exclude: Optional[Array] = None,
) -> NeighborMatrix:
    """Per-particle neighbor ids within search_radius_i + search_radius_j.

    Chunked over particles so the (chunk, 27*cap) candidate buffer stays
    small — at 1M particles nothing of size O(N * 27 * cap) is ever
    materialized. `exclude` is an optional (N, E) int32 table of particle ids
    to drop (the reference's ExcludeConnectedEntities filter,
    `GenNeighborLinkers.hpp:202`); self-pairs are always dropped
    (ExcludeSelfInteractions, `:185`).
    """
    n = pos.shape[0]
    grid = clist.grid
    cap = clist.entries.shape[1]
    search_radius = jnp.broadcast_to(search_radius, (n,))

    # pad to chunk multiple
    n_pad = ((n + chunk - 1) // chunk) * chunk
    pad = n_pad - n
    pos_p = jnp.concatenate([pos, jnp.zeros((pad, 3), pos.dtype)], axis=0)
    rad_p = jnp.concatenate([search_radius, jnp.zeros((pad,), search_radius.dtype)])
    if exclude is not None:
        excl_p = jnp.concatenate(
            [exclude, jnp.full((pad, exclude.shape[1]), -1, exclude.dtype)], axis=0
        )

    coords_all = _cell_coords(grid, pos_p)

    def one_chunk(start):
        sl = lambda a: jax.lax.dynamic_slice_in_dim(a, start, chunk, axis=0)
        p = sl(pos_p)  # (chunk, 3)
        r = sl(rad_p)
        coords = sl(coords_all)
        cells27, valid27 = _neighbor_cells_of(grid, coords)  # (chunk, 27)
        cand = clist.entries[cells27]  # (chunk, 27, cap)
        cand = jnp.where(valid27[..., None], cand, -1)
        cand = cand.reshape(chunk, 27 * cap)

        cand_idx = jnp.maximum(cand, 0)
        cand_pos = pos_p[cand_idx]
        cand_rad = rad_p[cand_idx]
        if metric is None:
            sep = cand_pos - p[:, None, :]
        else:
            sep = metric.sep(p[:, None, :], cand_pos)
        d2 = jnp.sum(sep * sep, axis=-1)
        cutoff = r[:, None] + cand_rad
        me = start + jnp.arange(chunk, dtype=jnp.int32)
        ok = (cand >= 0) & (d2 <= cutoff * cutoff) & (cand != me[:, None])
        if exclude is not None:
            ex = sl(excl_p)  # (chunk, E)
            ok &= jnp.all(cand[:, :, None] != ex[:, None, :], axis=-1)

        # compact each row to its first K hits without a sort, top_k or
        # scatter: find the k-th hit's column by binary search on the row
        # cumsum (take_along_axis gathers).
        row_idx, row_ok, count = _compact_rows(cand, ok, max_neighbors, n)
        return row_idx, row_ok, jnp.any(count > max_neighbors)

    starts = jnp.arange(0, n_pad, chunk, dtype=jnp.int32)
    idx_c, mask_c, ovf_c = jax.lax.map(one_chunk, starts)
    idx = idx_c.reshape(n_pad, max_neighbors)[:n]
    mask = mask_c.reshape(n_pad, max_neighbors)[:n]
    return NeighborMatrix(idx=idx, mask=mask, overflow=jnp.any(ovf_c))


def neighbor_matrix_query(
    pos_all: Array,
    clist: CellList,
    query_pos: Array,
    query_gid: Array,
    search_radius: Array,  # (N,) or scalar — per CANDIDATE body
    metric: Optional[Metric] = None,
    max_neighbors: int = 32,
    chunk: int = 4096,
    exclude: Optional[Array] = None,  # (Q, E) global ids to drop per query
) -> NeighborMatrix:
    """Neighbor rows for a SUBSET of bodies: query_pos (Q, 3) with global
    ids query_gid against the cell list built over pos_all. Returns
    (Q, K) rows whose idx are GLOBAL body ids — identical to the matching
    rows of neighbor_matrix(pos_all, ...) (same candidate order, same
    compaction), which is what lets a shard rebuild only its own rows and
    still match the single-device search bit-for-bit (the distributed-
    search role of `GenNeighborLinkers.hpp:652-663`)."""
    n = pos_all.shape[0]
    q = query_pos.shape[0]
    grid = clist.grid
    cap = clist.entries.shape[1]
    search_radius = jnp.broadcast_to(search_radius, (n,))

    q_pad = ((q + chunk - 1) // chunk) * chunk
    pad = q_pad - q
    qp = jnp.concatenate([query_pos, jnp.zeros((pad, 3), query_pos.dtype)])
    qg = jnp.concatenate([query_gid.astype(jnp.int32),
                          jnp.full((pad,), -1, jnp.int32)])
    if exclude is not None:
        excl_p = jnp.concatenate(
            [exclude, jnp.full((pad, exclude.shape[1]), -1, exclude.dtype)],
            axis=0)
    coords_all = _cell_coords(grid, qp)

    def one_chunk(start):
        sl = lambda a: jax.lax.dynamic_slice_in_dim(a, start, chunk, axis=0)
        p = sl(qp)
        me = sl(qg)
        coords = sl(coords_all)
        cells27, valid27 = _neighbor_cells_of(grid, coords)
        cand = clist.entries[cells27]
        cand = jnp.where(valid27[..., None], cand, -1)
        cand = cand.reshape(chunk, 27 * cap)
        cand_idx = jnp.maximum(cand, 0)
        cand_pos = pos_all[cand_idx]
        cand_rad = search_radius[cand_idx]
        if metric is None:
            sep = cand_pos - p[:, None, :]
        else:
            sep = metric.sep(p[:, None, :], cand_pos)
        d2 = jnp.sum(sep * sep, axis=-1)
        r = search_radius[jnp.maximum(me, 0)]
        cutoff = r[:, None] + cand_rad
        ok = (cand >= 0) & (d2 <= cutoff * cutoff) & (cand != me[:, None])             & (me >= 0)[:, None]
        if exclude is not None:
            ex = sl(excl_p)
            ok &= jnp.all(cand[:, :, None] != ex[:, None, :], axis=-1)
        row_idx, row_ok, count = _compact_rows(cand, ok, max_neighbors, n)
        return row_idx, row_ok, jnp.any(count > max_neighbors)

    starts = jnp.arange(0, q_pad, chunk, dtype=jnp.int32)
    idx_c, mask_c, ovf_c = jax.lax.map(one_chunk, starts)
    idx = idx_c.reshape(q_pad, max_neighbors)[:q]
    mask = mask_c.reshape(q_pad, max_neighbors)[:q]
    return NeighborMatrix(idx=idx, mask=mask, overflow=jnp.any(ovf_c))


def build_pair_list(nmat: NeighborMatrix, capacity: int) -> PairList:
    """Unique (i < j) pairs compacted from a neighbor matrix.

    The capacity-bounded replacement for dynamic link creation
    (`LinkData.hpp:159-183`): fixed-size output + overflow flag; padded slots
    carry mask=False and (0, 0) indices.
    """
    n, k = nmat.idx.shape
    ii = jnp.broadcast_to(jnp.arange(n, dtype=jnp.int32)[:, None], (n, k)).reshape(-1)
    jj = nmat.idx.reshape(-1).astype(jnp.int32)
    ok = nmat.mask.reshape(-1) & (ii < jj)

    num = jnp.sum(ok)
    slot = jnp.cumsum(ok) - 1
    dest = jnp.where(ok & (slot < capacity), slot, capacity)
    i_out = jnp.zeros((capacity,), jnp.int32).at[dest].set(ii, mode="drop")
    j_out = jnp.zeros((capacity,), jnp.int32).at[dest].set(jj, mode="drop")
    mask_out = jnp.zeros((capacity,), bool).at[dest].set(ok, mode="drop")
    return PairList(
        i=i_out, j=j_out, mask=mask_out, num_pairs=num, overflow=num > capacity
    )


def build_pair_list_ordered(nmat: NeighborMatrix, capacity: int) -> PairList:
    """ALL ordered (i, j) neighbor entries compacted from a neighbor matrix,
    sorted by i (row-major flatten order), padded slots carrying i = j = N.

    Each unordered contact appears twice — (i, j) and (j, i) — which makes
    one-sided force assembly a single sorted segmented reduction
    (ops/segments.py) instead of a two-sided scatter: the deterministic
    layout for the LCP collision pipeline. Padded i = j = N keeps the array sorted
    for the window binary search.

    Requires the neighbor matrix to be FRONT-PACKED (valid entries occupy
    the first count_i lanes of each row — true for both builders, which
    compact rows in hit order): compaction then needs no scatter at all —
    jnp.repeat expands row ids by their counts and a (C,)-row gather pulls
    the neighbor ids.
    """
    n, k = nmat.idx.shape
    cnt = jnp.sum(nmat.mask, axis=1, dtype=jnp.int32)
    base = jnp.concatenate([jnp.zeros((1,), jnp.int32),
                            jnp.cumsum(cnt, dtype=jnp.int32)])
    num = base[n]
    ii = jnp.repeat(jnp.arange(n, dtype=jnp.int32), cnt,
                    total_repeat_length=capacity)
    pos_in = jnp.arange(capacity, dtype=jnp.int32)
    valid = pos_in < num
    ii = jnp.where(valid, ii, n)
    ii_safe = jnp.minimum(ii, n - 1)
    lane = jnp.where(valid, pos_in - base[ii_safe], 0)
    jj = jnp.where(valid, nmat.idx[ii_safe, lane].astype(jnp.int32), n)
    return PairList(
        i=ii, j=jj, mask=valid, num_pairs=num, overflow=num > capacity
    )


def need_rebuild(pos: Array, ref_pos: Array, skin: Array,
                 metric: Optional[Metric] = None) -> Array:
    """True when any particle moved more than skin/2 since the list was built.

    Mirrors the reference's displacement-vs-skin trigger
    (`objects_moved_too_much`, HP1 driver `:1404-1427`): with search radii
    inflated by `skin`, the list stays valid until total displacement could
    close half the margin from each side.
    """
    if metric is None:
        disp = pos - ref_pos
    else:
        disp = metric.sep(ref_pos, pos)
    max_disp = jnp.max(jnp.linalg.norm(disp, axis=-1))
    return max_disp > 0.5 * skin
