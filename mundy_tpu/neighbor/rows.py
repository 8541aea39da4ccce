"""Dense row-grid engine: gather-free neighbor interactions.

Motivation: irregular-access primitives (argsort, top_k, scatter,
computed-index gathers) cost far more per element than dense arithmetic,
so per-pair candidate materialization tends to dominate a contact step.
This engine removes irregular access from the hot path entirely:

- particles live in a dense (ny, nz, R) row layout: a "row" is the full x
  extent of one (y, z) cell column, padded to R slots (structure-of-arrays
  with validity masks — the bucketed-mesh idea of STK, shaped for vector
  units);
- neighbor candidates of a row are the 9 rows (y+dy, z+dz): obtained by
  `jnp.roll` over the (ny, nz) axes — pure regular data movement, periodic
  wrap included (min-image metrics fix the coordinate offsets);
- pair interactions are dense (R x R) blocks — more FLOPs than a
  compacted neighbor list, but zero gathers;
- the state STAYS in row layout between rebuilds; a rebuild is one argsort
  of N keys + one N-element scatter, triggered by the skin
  displacement check. Engines wrap positions into the box only at a
  rebuild: the candidate pre-shifts assume each position stays near its
  row's cell, so a y/z wrap between rebuilds would move a body one box
  away from its row's neighbors (x is handled by the minimum image).

Cell size along y/z must be >= the interaction cutoff; x is not windowed
(a row spans the box in x), so rows should be O(10-100) particles — true
whenever nx ~ N^(1/3) >> 1.
"""

from __future__ import annotations

from typing import Callable, Optional

import jax
import jax.numpy as jnp
import numpy as np
from jax import Array

from mundy_tpu.core.containers import pytree_dataclass, static_field
from mundy_tpu.geom.periodicity import Metric


@pytree_dataclass
class RowGrid:
    """Static geometry of the (y, z) row decomposition."""

    origin: Array  # (3,)
    cell_yz: Array  # (2,) row cell edge along y, z
    ny: int = static_field(default=1)
    nz: int = static_field(default=1)
    row_capacity: int = static_field(default=32)


@pytree_dataclass
class RowState:
    """Dense row-layout particle state."""

    grid: RowGrid
    pos: Array  # (ny, nz, R, 3)
    gid: Array  # (ny, nz, R) int32 global ids (for RNG streams / unsort)
    valid: Array  # (ny, nz, R) bool
    ref_pos: Array  # (ny, nz, R, 3) positions at last rebuild
    overflow: Array  # () bool


def make_row_grid(domain_low, domain_high, cutoff: float, n_particles: int,
                  capacity_slack: float = 2.0, dtype=jnp.float32,
                  align: int = 1) -> RowGrid:
    """Rows sized so the y/z cell edge >= cutoff; capacity from the mean
    occupancy with slack (overflow flag + host regrow on violation).

    `align`: round ny/nz DOWN to a multiple of this (cells grow slightly
    past the cutoff — still correct)."""
    low = np.asarray(domain_low, np.float64)
    high = np.asarray(domain_high, np.float64)
    ext = high - low
    ny = max(int(ext[1] // cutoff), 1)
    nz = max(int(ext[2] // cutoff), 1)
    if align > 1:
        ny = max((ny // align) * align, min(ny, align))
        nz = max((nz // align) * align, min(nz, align))
    mean_occ = n_particles / (ny * nz)
    cap = int(np.ceil(mean_occ * capacity_slack + 8))
    # round capacity to a multiple of 8
    cap = ((cap + 7) // 8) * 8
    return RowGrid(
        origin=jnp.asarray(low, dtype),
        cell_yz=jnp.asarray([ext[1] / ny, ext[2] / nz], dtype),
        ny=ny, nz=nz, row_capacity=cap,
    )


def _row_coords(grid: RowGrid, pos: Array):
    iy = jnp.floor((pos[..., 1] - grid.origin[1]) / grid.cell_yz[0]).astype(jnp.int32)
    iz = jnp.floor((pos[..., 2] - grid.origin[2]) / grid.cell_yz[1]).astype(jnp.int32)
    iy = jnp.clip(iy, 0, grid.ny - 1)
    iz = jnp.clip(iz, 0, grid.nz - 1)
    return iy, iz


def build_rows(pos: Array, gid: Array, grid: RowGrid) -> RowState:
    """Flat (N, 3) positions -> dense row layout. One sort + one scatter."""
    n = pos.shape[0]
    R = grid.row_capacity
    iy, iz = _row_coords(grid, pos)
    row = iy * grid.nz + iz
    # two-key sort (x within row): sort by x, then stable-sort by row
    order_x = jnp.argsort(pos[:, 0])
    order = order_x[jnp.argsort(row[order_x], stable=True)]

    row_sorted = row[order]
    first = jnp.concatenate([jnp.ones((1,), bool), row_sorted[1:] != row_sorted[:-1]])
    starts = jnp.where(first, jnp.arange(n, dtype=jnp.int32), 0)
    row_start = jax.lax.associative_scan(jnp.maximum, starts)
    rank = jnp.arange(n, dtype=jnp.int32) - row_start

    counts = jnp.zeros((grid.ny * grid.nz,), jnp.int32).at[row].add(1)
    overflow = jnp.any(counts > R)

    slot = row_sorted * R + jnp.minimum(rank, R - 1)
    slot = jnp.where(rank < R, slot, grid.ny * grid.nz * R)  # drop overflows
    # Invalid slots carry a sentinel position far outside the box (y offset
    # ~1e6 box heights): any pair involving one is separated beyond every
    # cutoff, which lets central-force kernels skip the validity mask
    # entirely (pair_accumulate_central). Pairs of sentinels in the same row
    # coincide exactly, so sep = 0 and they contribute nothing either.
    extent_y = grid.cell_yz[0] * grid.ny
    sentinel_y = grid.origin[1] - 1e6 * (extent_y + 1.0)
    flat_pos = jnp.zeros((grid.ny * grid.nz * R, 3), pos.dtype)
    flat_pos = flat_pos.at[:, 1].set(sentinel_y.astype(pos.dtype))
    flat_pos = flat_pos.at[slot].set(pos[order], mode="drop")
    flat_gid = jnp.zeros((grid.ny * grid.nz * R,), jnp.int32)
    flat_gid = flat_gid.at[slot].set(gid[order].astype(jnp.int32), mode="drop")
    flat_valid = jnp.zeros((grid.ny * grid.nz * R,), bool)
    flat_valid = flat_valid.at[slot].set(True, mode="drop")

    shape = (grid.ny, grid.nz, R)
    p = flat_pos.reshape(shape + (3,))
    return RowState(grid=grid, pos=p, gid=flat_gid.reshape(shape),
                    valid=flat_valid.reshape(shape), ref_pos=p,
                    overflow=overflow)


def rows_to_flat(state: RowState, n: int):
    """Dense layout -> flat (N, 3) positions ordered by global id."""
    flat_pos = state.pos.reshape(-1, 3)
    flat_gid = state.gid.reshape(-1)
    flat_valid = state.valid.reshape(-1)
    out = jnp.zeros((n, 3), state.pos.dtype)
    idx = jnp.where(flat_valid, flat_gid, n)
    return out.at[idx].set(flat_pos, mode="drop")


def orthorhombic_lengths(metric: Metric):
    """Extract static (Lx, Ly, Lz) + per-axis periodic flags from a concrete
    diagonal metric, or None if the metric is triclinic / traced. Call at
    sim-construction time (outside jit) to enable the fast pair path."""
    if not getattr(metric, "diagonal", False):
        return None
    try:
        cell = np.asarray(metric.cell)
        per = np.asarray(metric.periodic)
    except Exception:
        return None  # traced inside jit; caller falls back to general path
    lengths = tuple(float(cell[i, i]) for i in range(3))
    flags = tuple(bool(per[i]) for i in range(3))
    return lengths, flags


def _roll_image_shift(n: int, d: int, L: float, dtype) -> Array:
    """Per-index coordinate shift that turns a rolled candidate row into the
    periodic image nearest its partner row: roll(x, -d)[i] = x[(i+d) % n], so
    indices with i + d >= n (or < 0) wrapped and live one box away."""
    idx = np.arange(n)
    s = np.where(idx + d >= n, L, np.where(idx + d < 0, -L, 0.0))
    return jnp.asarray(s, dtype)


def _shift_blocks(state: RowState, extra_fields: tuple, box: Optional[tuple]):
    """Materialize the 9 rolled candidate blocks (O(N) data movement).

    Returns (blocks, fast) where each block is
    (cand_pos, cand_valid, cand_extras, is_self). With `box` (static
    orthorhombic lengths + periodic flags), candidate coordinates are
    pre-shifted to the periodic image nearest their partner row, so the pair
    kernel only needs a one-component x minimum image instead of the full
    3-component fractional map (O(R) work instead of O(R^2) per row)."""
    pos, valid = state.pos, state.valid
    ny, nz = pos.shape[:2]
    dtype = pos.dtype

    fast = box is not None
    if fast:
        (lx, ly, lz), (px, py, pz) = box
        if (py and ny < 5) or (pz and nz < 5):
            fast = False

    blocks = []
    for dy in (-1, 0, 1):
        for dz in (-1, 0, 1):
            if dy == 0 and dz == 0:
                cand_pos, cand_valid, cand_extras = pos, valid, extra_fields
            else:
                cand_pos = jnp.roll(pos, (-dy, -dz), axis=(0, 1))
                cand_valid = jnp.roll(valid, (-dy, -dz), axis=(0, 1))
                cand_extras = tuple(
                    jnp.roll(f, (-dy, -dz), axis=(0, 1)) for f in extra_fields
                )
            if fast:
                if dy != 0 and py:
                    sy = _roll_image_shift(ny, dy, ly, dtype)
                    cand_pos = cand_pos + sy[:, None, None, None] * jnp.asarray(
                        [0.0, 1.0, 0.0], dtype)
                if dz != 0 and pz:
                    sz = _roll_image_shift(nz, dz, lz, dtype)
                    cand_pos = cand_pos + sz[None, :, None, None] * jnp.asarray(
                        [0.0, 0.0, 1.0], dtype)
            blocks.append((cand_pos, cand_valid, cand_extras, dy == 0 and dz == 0))
    return blocks, fast


def _pair_force_chunk(own_pos, own_valid, own_extras, blocks, metric, pair_fn,
                      fast, box, slot_ids):
    """Dense pair force for one y-chunk against the 9 candidate blocks."""
    dtype = own_pos.dtype
    if fast:
        (lx, _, _), (px, _, _) = box
        inv_lx = 1.0 / lx
        ex = jnp.asarray([1.0, 0.0, 0.0], dtype)
    force = jnp.zeros_like(own_pos)
    for cand_pos, cand_valid, cand_extras, is_self in blocks:
        if fast:
            # raw diff + one-component x minimum image, one fused expression
            sep = cand_pos[..., None, :, :] - own_pos[..., :, None, :]
            if px:
                dxr = cand_pos[..., 0][..., None, :] - own_pos[..., 0][..., :, None]
                sep = sep - (lx * jnp.round(dxr * inv_lx))[..., None] * ex
        else:
            sep = metric.sep(own_pos[..., :, None, :], cand_pos[..., None, :, :])
        r2 = jnp.sum(sep * sep, axis=-1)
        mask = own_valid[..., :, None] & cand_valid[..., None, :]
        if is_self:
            mask = mask & (slot_ids[..., :, None] != slot_ids[..., None, :])
        args = [sep, r2, mask]
        for own_f, cand_f in zip(own_extras, cand_extras):
            args.append(own_f[..., :, None])
            args.append(cand_f[..., None, :])
        force = force + jnp.sum(pair_fn(*args), axis=-2)
    return force


def _lane_pad(r: int) -> int:
    """Length-r minor axis rounded up to a multiple of 128 (the memory
    model's allowance for padded minor axes)."""
    return max(-(-r // 128) * 128, 128)


def pair_accumulate(
    state: RowState,
    metric: Metric,
    pair_fn: Callable[[Array, Array, Array], Array],
    extra_fields: tuple = (),
    box: Optional[tuple] = None,
    hbm_budget_bytes: float = 2.5e9,
) -> Array:
    """Accumulate sum_j pair_fn over the 9-row neighborhood, gather-free.

    pair_fn(sep_vec (..., 3), r2 (...), mask (...)) -> (..., 3) per-pair
    force contribution ON the row particle (already masked). extra_fields:
    optional per-particle (ny, nz, R, ...) arrays; pair_fn then receives
    (sep, r2, mask, own_field..., cand_field...) per extra field.

    Work: 9 * ny * nz * R^2 dense pair evals; the only data
    movement is 9 rolls of the row arrays.

    `box`: optional static ((Lx,Ly,Lz), (px,py,pz)) from orthorhombic_lengths
    — replaces the full per-pair min-image map with an O(R) candidate
    pre-shift plus a one-component x min-image (about half the per-pair flops;
    measured ~1.9x on the 1M-body hot path). Requires ny,nz >= 5 on periodic
    axes so a +-1-row offset never exceeds half a box.

    Large grids are evaluated in y-slabs under `lax.map` so the (R x R) pair
    temporaries stay within `hbm_budget_bytes` (at 1M bodies the unchunked
    graph wants ~19 GB of temporaries)."""
    pos = state.pos
    valid = state.valid
    ny, nz, R = pos.shape[:3]
    itemsize = jnp.dtype(pos.dtype).itemsize
    blocks, fast = _shift_blocks(state, extra_fields, box)
    slot_ids = jax.lax.broadcasted_iota(jnp.int32, (1, 1, R), 2)

    # ~30 live (R,R)-blocks per row in the compiled 9-shift graph, minor
    # dim counted padded to a multiple of 128 (_lane_pad); the budget bounds
    # the temporaries of one y-chunk.
    bytes_per_row = 30 * nz * R * _lane_pad(R) * itemsize
    cy = int(hbm_budget_bytes // max(bytes_per_row, 1))
    if cy >= ny or cy < 1:
        return _pair_force_chunk(pos, valid, extra_fields, blocks, metric,
                                 pair_fn, fast, box, slot_ids)

    n_chunks = -(-ny // cy)
    ny_pad = n_chunks * cy

    def pad(a, fill=0):
        cfg = [(0, ny_pad - ny)] + [(0, 0)] * (a.ndim - 1)
        return jnp.pad(a, cfg, constant_values=fill)

    pos_p, valid_p = pad(pos), pad(valid, False)
    extras_p = tuple(pad(f) for f in extra_fields)
    blocks_p = [
        (pad(cp), pad(cv, False), tuple(pad(f) for f in ce), s)
        for cp, cv, ce, s in blocks
    ]

    def chunk(c):
        y0 = c * cy
        sl = lambda a: jax.lax.dynamic_slice_in_dim(a, y0, cy, 0)  # noqa: E731
        cblocks = [(sl(cp), sl(cv), tuple(sl(f) for f in ce), s)
                   for cp, cv, ce, s in blocks_p]
        return _pair_force_chunk(sl(pos_p), sl(valid_p),
                                 tuple(sl(f) for f in extras_p),
                                 cblocks, metric, pair_fn, fast, box, slot_ids)

    force = jax.lax.map(chunk, jnp.arange(n_chunks, dtype=jnp.int32))
    return force.reshape((ny_pad, nz, R, 3))[:ny]


def _pair_multi_chunk(own_pos, own_valid, own_extras, blocks, metric,
                      pair_fn, fast, box, slot_ids):
    """Dense pair evaluation for one y-chunk, tuple-valued pair_fn: each
    output leaf (..., R, Rc, D) is summed over the candidate axis."""
    dtype = own_pos.dtype
    if fast:
        (lx, _, _), (px, _, _) = box
        inv_lx = 1.0 / lx
        ex = jnp.asarray([1.0, 0.0, 0.0], dtype)
    outs = None
    for cand_pos, cand_valid, cand_extras, is_self in blocks:
        if fast:
            sep = cand_pos[..., None, :, :] - own_pos[..., :, None, :]
            if px:
                dxr = cand_pos[..., 0][..., None, :] - own_pos[..., 0][..., :, None]
                sep = sep - (lx * jnp.round(dxr * inv_lx))[..., None] * ex
        else:
            sep = metric.sep(own_pos[..., :, None, :], cand_pos[..., None, :, :])
        r2 = jnp.sum(sep * sep, axis=-1)
        mask = own_valid[..., :, None] & cand_valid[..., None, :]
        if is_self:
            mask = mask & (slot_ids[..., :, None] != slot_ids[..., None, :])
        args = [sep, r2, mask]
        for own_f, cand_f in zip(own_extras, cand_extras):
            args.append(own_f[..., :, None, :] if own_f.ndim == own_pos.ndim
                        else own_f[..., :, None])
            args.append(cand_f[..., None, :, :] if cand_f.ndim == own_pos.ndim
                        else cand_f[..., None, :])
        res = pair_fn(*args)
        summed = tuple(jnp.sum(r, axis=-2) for r in res)
        outs = summed if outs is None else tuple(
            a + b for a, b in zip(outs, summed))
    return outs


def pair_accumulate_multi(
    state: RowState,
    metric: Metric,
    pair_fn: Callable,
    extra_fields: tuple = (),
    box: Optional[tuple] = None,
    hbm_budget_bytes: float = 2.5e9,
) -> tuple:
    """pair_accumulate for MULTI-OUTPUT pair kernels (e.g. force AND torque
    of a segment-segment contact: the rods/filaments narrow phase).

    pair_fn(sep (..., R, Rc, 3), r2, mask, own_f..., cand_f...) -> tuple of
    (..., R, Rc, D_i) arrays, each summed over the candidate axis to
    (ny, nz, R, D_i). Vector-valued extra fields — trailing axis > scalar,
    e.g. rod axes (ny, nz, R, 3) — are broadcast with the pair axes
    inserted before their component axis (own (..., R, 1, 3) /
    cand (..., 1, Rc, 3))."""
    pos = state.pos
    valid = state.valid
    ny, nz, R = pos.shape[:3]
    itemsize = jnp.dtype(pos.dtype).itemsize
    blocks, fast = _shift_blocks(state, extra_fields, box)
    slot_ids = jax.lax.broadcasted_iota(jnp.int32, (1, 1, R), 2)

    # multi-output kernels hold force AND torque (..., R, R, 3) temps per
    # shift block plus remat copies across the lax.map boundary — budget
    # with the padded minor dim (see pair_accumulate) and a 2x multi-output
    # factor.
    bytes_per_row = 60 * nz * R * _lane_pad(R) * itemsize
    cy = int(hbm_budget_bytes // max(bytes_per_row, 1))
    if cy >= ny or cy < 1:
        return _pair_multi_chunk(pos, valid, extra_fields, blocks, metric,
                                 pair_fn, fast, box, slot_ids)

    n_chunks = -(-ny // cy)
    ny_pad = n_chunks * cy

    def pad(a, fill=0):
        cfg = [(0, ny_pad - ny)] + [(0, 0)] * (a.ndim - 1)
        return jnp.pad(a, cfg, constant_values=fill)

    pos_p, valid_p = pad(pos), pad(valid, False)
    extras_p = tuple(pad(f) for f in extra_fields)
    blocks_p = [
        (pad(cp), pad(cv, False), tuple(pad(f) for f in ce), s)
        for cp, cv, ce, s in blocks
    ]

    def chunk(c):
        y0 = c * cy
        sl = lambda a: jax.lax.dynamic_slice_in_dim(a, y0, cy, 0)  # noqa: E731
        cblocks = [(sl(cp), sl(cv), tuple(sl(f) for f in ce), s)
                   for cp, cv, ce, s in blocks_p]
        return _pair_multi_chunk(sl(pos_p), sl(valid_p),
                                 tuple(sl(f) for f in extras_p),
                                 cblocks, metric, pair_fn, fast, box,
                                 slot_ids)

    outs = jax.lax.map(chunk, jnp.arange(n_chunks, dtype=jnp.int32))
    return tuple(o.reshape((ny_pad, nz, R) + o.shape[4:])[:ny] for o in outs)


def _candidate_planes(pos: Array, box: tuple, extra_fields: tuple = ()):
    """Concatenated 9-row candidate component planes.

    Returns (cx, cy, cz, cand_extras), each (ny, nz, 9R): the 9 rolled
    neighbor rows joined along one wide minor axis, with periodic y/z image
    shifts pre-applied per row so
    downstream kernels only need a one-component x minimum image."""
    ny, nz = pos.shape[:2]
    dtype = pos.dtype
    (lx, ly, lz), (px, py, pz) = box
    cand_x, cand_y, cand_z = [], [], []
    cand_extras = [[] for _ in extra_fields]
    for dy in (-1, 0, 1):
        for dz in (-1, 0, 1):
            if (dy, dz) == (0, 0):
                cp = pos
                ces = extra_fields
            else:
                cp = jnp.roll(pos, (-dy, -dz), axis=(0, 1))
                ces = tuple(jnp.roll(f, (-dy, -dz), axis=(0, 1))
                            for f in extra_fields)
            x, y, z = cp[..., 0], cp[..., 1], cp[..., 2]
            if dy != 0 and py:
                y = y + _roll_image_shift(ny, dy, ly, dtype)[:, None, None]
            if dz != 0 and pz:
                z = z + _roll_image_shift(nz, dz, lz, dtype)[None, :, None]
            cand_x.append(x)
            cand_y.append(y)
            cand_z.append(z)
            for acc, f in zip(cand_extras, ces):
                acc.append(f)
    cx = jnp.concatenate(cand_x, axis=-1)
    cy_ = jnp.concatenate(cand_y, axis=-1)
    cz = jnp.concatenate(cand_z, axis=-1)
    return cx, cy_, cz, tuple(jnp.concatenate(a, axis=-1) for a in cand_extras)


def _central_force_chunk(ox, oy, oz, own_extras, cx, cy_, cz, cand_extras,
                         scalar_fn, lx_px):
    """Fused pair force for one y-chunk: central forces f_i = sum_j w*sep.

    All arrays are component planes (chunk, nz, R) own / (chunk, nz, 9R)
    candidates — no (..., 3) trailing axis, so every (R, 9R) pair block is a
    wide contiguous plane. The whole body is one fused elementwise+reduce
    kernel: the only device-memory traffic is reading the O(N) planes and
    writing the force."""
    DX = cx[..., None, :] - ox[..., :, None]   # (chunk, nz, R, 9R)
    if lx_px is not None:
        lx, inv_lx = lx_px
        DX = DX - lx * jnp.round(DX * inv_lx)  # one-component min image
    DY = cy_[..., None, :] - oy[..., :, None]
    DZ = cz[..., None, :] - oz[..., :, None]
    r2 = DX * DX + DY * DY + DZ * DZ
    args = [r2]
    for own_f, cand_f in zip(own_extras, cand_extras):
        args.append(own_f[..., :, None])
        args.append(cand_f[..., None, :])
    w = scalar_fn(*args)
    fx = jnp.sum(w * DX, axis=-1)
    fy = jnp.sum(w * DY, axis=-1)
    fz = jnp.sum(w * DZ, axis=-1)
    return jnp.stack([fx, fy, fz], axis=-1)


def pair_accumulate_central(
    state: RowState,
    box: tuple,
    scalar_fn: Callable[..., Array],
    extra_fields: tuple = (),
    hbm_budget_bytes: float = 2.5e9,
) -> Array:
    """Accumulate CENTRAL pair forces f_i = sum_j w_ij * sep_ij with
    sep_ij = pos_j - pos_i (minimum image) and w = scalar_fn(r2,
    own_extra..., cand_extra...).

    Contract (enables the fast mask-free kernel):
      * scalar_fn must vanish for r2 beyond the grid cutoff (true for every
        contact law). Invalid slots carry sentinel positions far outside the
        box (build_rows), so they separate themselves — no validity mask, no
        boolean traffic in the hot loop.
      * self-pairs contribute w * 0 = 0 automatically (sep = 0), provided
        scalar_fn(0) is finite — clamp r2 away from zero inside scalar_fn.

    The 9 rolled candidate rows are concatenated along one axis (9R lanes in
    ceil(9R/128) tiles instead of 9 x ceil(R/128)), components are kept in
    separate planes, and the force is one fused elementwise+reduce kernel per
    y-slab (lax.map keeps pair temporaries inside `hbm_budget_bytes`).

    Requires static orthorhombic `box` from orthorhombic_lengths with
    ny,nz >= 5 on periodic axes; use pair_accumulate otherwise."""
    pos = state.pos
    ny, nz, R = pos.shape[:3]
    dtype = pos.dtype
    itemsize = jnp.dtype(dtype).itemsize
    (lx, ly, lz), (px, py, pz) = box
    if (py and ny < 5) or (pz and nz < 5):
        raise ValueError("pair_accumulate_central needs ny,nz >= 5 on "
                         "periodic axes; use pair_accumulate")

    cx, cy_, cz, cand_extras = _candidate_planes(pos, box, extra_fields)
    ox, oy, oz = pos[..., 0], pos[..., 1], pos[..., 2]
    lx_px = (lx, 1.0 / lx) if px else None

    # ~8 live (R, 9R) blocks in the fused kernel
    bytes_per_row = 8 * nz * R * 9 * R * itemsize
    chunk_y = int(hbm_budget_bytes // max(bytes_per_row, 1))
    if chunk_y >= ny or chunk_y < 1:
        return _central_force_chunk(ox, oy, oz, extra_fields,
                                    cx, cy_, cz, cand_extras,
                                    scalar_fn, lx_px)

    n_chunks = -(-ny // chunk_y)
    ny_pad = n_chunks * chunk_y

    def pad(a):
        cfg = [(0, ny_pad - ny)] + [(0, 0)] * (a.ndim - 1)
        return jnp.pad(a, cfg)

    planes = [pad(a) for a in (ox, oy, oz, cx, cy_, cz)]
    own_p = tuple(pad(f) for f in extra_fields)
    cand_p = tuple(pad(f) for f in cand_extras)

    def chunk(c):
        y0 = c * chunk_y
        sl = lambda a: jax.lax.dynamic_slice_in_dim(a, y0, chunk_y, 0)  # noqa: E731
        oxc, oyc, ozc, cxc, cyc, czc = (sl(a) for a in planes)
        return _central_force_chunk(oxc, oyc, ozc, tuple(sl(f) for f in own_p),
                                    cxc, cyc, czc, tuple(sl(f) for f in cand_p),
                                    scalar_fn, lx_px)

    force = jax.lax.map(chunk, jnp.arange(n_chunks, dtype=jnp.int32))
    return force.reshape((ny_pad, nz, R, 3))[:ny]


# Half stencil for Newton's-third-law accumulation: these four offsets plus
# their negations cover all 8 neighbor rows, so each unordered row pair is
# evaluated exactly once (requires ny, nz >= 3 so no offset is its own
# negation mod grid; the >=5 periodic-axis rule already guarantees it).
_SYM_OFFSETS = ((0, 1), (1, -1), (1, 0), (1, 1))


def _candidate_planes_half(pos: Array, box: tuple, extra_fields: tuple = ()):
    """Concatenated candidate component planes for the half stencil.

    Returns (cx, cy, cz, cand_extras), each (ny, nz, 5R): the self row plus
    the 4 _SYM_OFFSETS rolled rows joined along one lane axis, periodic y/z
    image shifts pre-applied (same construction as _candidate_planes)."""
    ny, nz = pos.shape[:2]
    dtype = pos.dtype
    (lx, ly, lz), (px, py, pz) = box
    cand_x = [pos[..., 0]]
    cand_y = [pos[..., 1]]
    cand_z = [pos[..., 2]]
    cand_extras = [[f] for f in extra_fields]
    for dy, dz in _SYM_OFFSETS:
        cp = jnp.roll(pos, (-dy, -dz), axis=(0, 1))
        ces = tuple(jnp.roll(f, (-dy, -dz), axis=(0, 1)) for f in extra_fields)
        x, y, z = cp[..., 0], cp[..., 1], cp[..., 2]
        if dy != 0 and py:
            y = y + _roll_image_shift(ny, dy, ly, dtype)[:, None, None]
        if dz != 0 and pz:
            z = z + _roll_image_shift(nz, dz, lz, dtype)[None, :, None]
        cand_x.append(x)
        cand_y.append(y)
        cand_z.append(z)
        for acc, f in zip(cand_extras, ces):
            acc.append(f)
    cx = jnp.concatenate(cand_x, axis=-1)
    cy_ = jnp.concatenate(cand_y, axis=-1)
    cz = jnp.concatenate(cand_z, axis=-1)
    return cx, cy_, cz, tuple(jnp.concatenate(a, axis=-1) for a in cand_extras)


def _central_force_chunk_sym(ox, oy, oz, own_extras, cx, cy_, cz, cand_extras,
                             scalar_fn, lx_px, R):
    """Half-stencil pair force for one y-chunk.

    Returns (f_own (..., R, 3), f_par (..., 4R, 3)): f_own is the
    candidate-axis reduction over all 5R lanes; f_par is minus the own-axis
    reduction of the 4 off-row blocks (the Newton's-third-law partner force,
    still in the rolled candidate frame — the caller rolls it back)."""
    DX = cx[..., None, :] - ox[..., :, None]   # (chunk, nz, R, 5R)
    if lx_px is not None:
        lx, inv_lx = lx_px
        DX = DX - lx * jnp.round(DX * inv_lx)  # one-component min image
    DY = cy_[..., None, :] - oy[..., :, None]
    DZ = cz[..., None, :] - oz[..., :, None]
    r2 = DX * DX + DY * DY + DZ * DZ
    args = [r2]
    for own_f, cand_f in zip(own_extras, cand_extras):
        args.append(own_f[..., :, None])
        args.append(cand_f[..., None, :])
    w = scalar_fn(*args)
    WX, WY, WZ = w * DX, w * DY, w * DZ
    f_own = jnp.stack([jnp.sum(WX, axis=-1), jnp.sum(WY, axis=-1),
                       jnp.sum(WZ, axis=-1)], axis=-1)
    f_par = jnp.stack([-jnp.sum(WX[..., :, R:], axis=-2),
                       -jnp.sum(WY[..., :, R:], axis=-2),
                       -jnp.sum(WZ[..., :, R:], axis=-2)], axis=-1)
    return f_own, f_par


def pair_accumulate_central_sym(
    state: RowState,
    box: tuple,
    scalar_fn: Callable[..., Array],
    extra_fields: tuple = (),
    hbm_budget_bytes: float = 2.5e9,
) -> Array:
    """Half-stencil variant of pair_accumulate_central (Newton's third law).

    Same contract as pair_accumulate_central plus one more requirement:
    scalar_fn must be SYMMETRIC under swapping the own/cand extra fields
    (true for every central pair potential), because each off-row pair is
    evaluated once and the partner receives -w * sep.

    Work drops from 9R to 5R candidate lanes per particle (self row + 4
    half-stencil rows; the other 4 arrive as inverse-rolled partner sums) at
    the cost of one extra own-axis reduction per off block — measured ~1.5x
    on the 1M-body hot path."""
    pos = state.pos
    ny, nz, R = pos.shape[:3]
    dtype = pos.dtype
    itemsize = jnp.dtype(dtype).itemsize
    (lx, ly, lz), (px, py, pz) = box
    if (py and ny < 5) or (pz and nz < 5):
        raise ValueError("pair_accumulate_central_sym needs ny,nz >= 5 on "
                         "periodic axes; use pair_accumulate")

    cx, cy_, cz, cand_extras = _candidate_planes_half(pos, box, extra_fields)
    ox, oy, oz = pos[..., 0], pos[..., 1], pos[..., 2]
    lx_px = (lx, 1.0 / lx) if px else None

    # ~8 live (R, 5R) blocks in the fused kernel
    bytes_per_row = 8 * nz * R * 5 * R * itemsize
    chunk_y = int(hbm_budget_bytes // max(bytes_per_row, 1))
    if chunk_y >= ny or chunk_y < 1:
        f_own, f_par = _central_force_chunk_sym(
            ox, oy, oz, extra_fields, cx, cy_, cz, cand_extras,
            scalar_fn, lx_px, R)
    else:
        n_chunks = -(-ny // chunk_y)
        ny_pad = n_chunks * chunk_y

        def pad(a):
            cfg = [(0, ny_pad - ny)] + [(0, 0)] * (a.ndim - 1)
            return jnp.pad(a, cfg)

        planes = [pad(a) for a in (ox, oy, oz, cx, cy_, cz)]
        own_p = tuple(pad(f) for f in extra_fields)
        cand_p = tuple(pad(f) for f in cand_extras)

        def chunk(c):
            y0 = c * chunk_y
            sl = lambda a: jax.lax.dynamic_slice_in_dim(a, y0, chunk_y, 0)  # noqa: E731
            oxc, oyc, ozc, cxc, cyc, czc = (sl(a) for a in planes)
            return _central_force_chunk_sym(
                oxc, oyc, ozc, tuple(sl(f) for f in own_p),
                cxc, cyc, czc, tuple(sl(f) for f in cand_p),
                scalar_fn, lx_px, R)

        f_own, f_par = jax.lax.map(chunk, jnp.arange(n_chunks, dtype=jnp.int32))
        f_own = f_own.reshape((ny_pad, nz, R, 3))[:ny]
        f_par = f_par.reshape((ny_pad, nz, 4 * R, 3))[:ny]

    # partner sums live in the rolled candidate frame: roll them back.
    # Wrapped rows saw image-shifted coordinates, but forces are translation
    # invariant so the shift needs no undoing.
    force = f_own
    for b, (dy, dz) in enumerate(_SYM_OFFSETS):
        fb = f_par[..., b * R:(b + 1) * R, :]
        force = force + jnp.roll(fb, (dy, dz), axis=(0, 1))
    return force


def _segment_pair_chunk(ox, oy, oz, oex, oey, oez, own_scalars,
                        cx, cy_, cz, cex, cey, cez, cand_scalars,
                        out_fn, lx_px):
    """Clamped segment-segment closest points for one y-chunk, entirely on
    component planes: own midpoints/half-edges (chunk, nz, R), candidates
    (chunk, nz, 9R), every per-pair quantity a (chunk, nz, R, 9R) plane
    with no size-3 minor axis. Same math
    as geom.distance.segment_segment_closest (edge-clamped Lumelsky with the
    near-parallel best-of-4-endpoint fallback; reference algorithm
    distance/LineSegmentLineSegment.hpp:51-200), so the two engines agree to
    roundoff."""
    o = lambda p: p[..., :, None]    # own plane -> pair block  # noqa: E731
    k = lambda p: p[..., None, :]    # cand plane -> pair block  # noqa: E731
    SX = k(cx) - o(ox)               # cand mid - own mid (minimum image)
    if lx_px is not None:
        lx, inv_lx = lx_px
        SX = SX - lx * jnp.round(SX * inv_lx)
    SY = k(cy_) - o(oy)
    SZ = k(cz) - o(oz)
    # segment endpoints: own a0/a1 = -/+ E, cand b0/b1 = S -/+ F, so
    # u = 2E, v = 2F, w = a0 - b0 = F - E - S (componentwise planes)
    dt = ox.dtype
    eps = jnp.asarray(1e-12 if dt == jnp.float64 else 1e-8, dt)
    WX = k(cex) - o(oex) - SX
    WY = k(cey) - o(oey) - SY
    WZ = k(cez) - o(oez) - SZ
    a = 4.0 * o(oex * oex + oey * oey + oez * oez)
    c = 4.0 * k(cex * cex + cey * cey + cez * cez)
    b = 4.0 * (o(oex) * k(cex) + o(oey) * k(cey) + o(oez) * k(cez))
    d = 2.0 * (o(oex) * WX + o(oey) * WY + o(oez) * WZ)
    e = 2.0 * (k(cex) * WX + k(cey) * WY + k(cez) * WZ)
    D = a * c - b * b

    sN = b * e - c * d
    tN = a * e - b * d
    sD = jnp.where(D > 0, D, 1.0)
    tD = sD
    s_lo = sN < 0.0
    s_hi = sN > sD
    tN = jnp.where(s_lo, e, jnp.where(s_hi, e + b, tN))
    tD = jnp.where(s_lo | s_hi, c, tD)
    sN = jnp.clip(sN, 0.0, sD)
    t_lo = tN < 0.0
    t_hi = tN > tD
    sN = jnp.where(t_lo, jnp.clip(-d, 0.0, a),
                   jnp.where(t_hi, jnp.clip(b - d, 0.0, a), sN))
    sD = jnp.where(t_lo | t_hi, jnp.maximum(a, eps), sD)
    tN = jnp.clip(tN, 0.0, tD)
    s = sN / jnp.maximum(sD, eps)
    t = tN / jnp.maximum(tD, eps)

    # Take the best of FIVE candidates: the generic clamped solution plus
    # the four endpoint projections, compared on the expanded quadratic
    # d2(s,t) = w2 + s^2 a + t^2 c + 2sd - 2te - 2stb. Unlike a
    # near-parallel THRESHOLD switch (geom.distance uses D < 1e-9*ac), a
    # min over always-feasible candidates is continuous in the inputs: at a
    # threshold the two branches disagree by O(sin(theta) * L) in distance,
    # so jit-vs-eager FMA contraction could flip borderline pairs into
    # contact asymmetrically — observed as a 4e-3 momentum violation in the
    # filament active-wave test. For near-parallel segments an endpoint
    # projection attains the true minimum, so min-of-5 is exact in both
    # regimes.
    w2 = WX * WX + WY * WY + WZ * WZ
    inv_a = 1.0 / jnp.maximum(a, eps)
    inv_c = 1.0 / jnp.maximum(c, eps)
    zero = jnp.zeros_like(s)
    one = jnp.ones_like(s)
    cands = (
        (zero, jnp.clip(e * inv_c, 0.0, 1.0)),
        (one, jnp.clip((e + b) * inv_c, 0.0, 1.0)),
        (jnp.clip(-d * inv_a, 0.0, 1.0), zero),
        (jnp.clip((b - d) * inv_a, 0.0, 1.0), one),
    )

    def q(ss, tt):
        return (w2 + ss * ss * a + tt * tt * c + 2.0 * ss * d
                - 2.0 * tt * e - 2.0 * ss * tt * b)

    d2_best = q(s, t)
    for ss, tt in cands:
        d2c = q(ss, tt)
        take = d2c < d2_best
        s = jnp.where(take, ss, s)
        t = jnp.where(take, tt, t)
        d2_best = jnp.where(take, d2c, d2_best)

    # closest vector own -> cand: c2 - c1 = -(w + s u - t v)
    DXc = 2.0 * (t * k(cex) - s * o(oex)) - WX
    DYc = 2.0 * (t * k(cey) - s * o(oey)) - WY
    DZc = 2.0 * (t * k(cez) - s * o(oez)) - WZ
    d2 = DXc * DXc + DYc * DYc + DZc * DZc
    # Coincident closest points have no defined contact normal: report an
    # EXACT zero vector there so force laws that blow up as d2 -> 0
    # (w ~ mag/dist) multiply a true zero. Without this, self-pairs (every
    # slot vs itself in the center block) rely on D == 0 bitwise — an FMA
    # contraction under jit can pick a tied candidate with t = b/c =
    # 1 - 1ulp, making D ~ eps * L and w * D a finite garbage force
    # (observed: 4e-3 momentum violation in the filament active-wave test).
    # Threshold: squared machine-eps noise floor of the reconstruction,
    # scaled by the pair's own length/separation scales.
    m_eps = jnp.asarray(float(jnp.finfo(ox.dtype).eps), ox.dtype)
    noise2 = (32.0 * m_eps) ** 2 * (a + c + w2)
    clean = d2 > noise2
    DXc = jnp.where(clean, DXc, 0.0)
    DYc = jnp.where(clean, DYc, 0.0)
    DZc = jnp.where(clean, DZc, 0.0)
    d2 = jnp.where(clean, d2, 0.0)
    args = [s, t, DXc, DYc, DZc, d2]
    for own_f, cand_f in zip(own_scalars, cand_scalars):
        args.append(o(own_f))
        args.append(k(cand_f))
    outs = out_fn(*args)
    return tuple(jnp.sum(ov, axis=-1) for ov in outs)


def pair_accumulate_segments(
    state: RowState,
    box: tuple,
    half_edges: Array,
    out_fn: Callable[..., tuple],
    extra_fields: tuple = (),
    hbm_budget_bytes: float = 2.5e9,
) -> tuple:
    """Gather-free segment-segment narrow phase on component planes — the
    rods/filaments hot path (reference kernels: mundy_linkers
    SpherocylinderSegment narrow phase).

    state.pos holds segment MIDPOINTS in the row layout; `half_edges`
    (ny, nz, R, 3) the half-edge vectors (endpoints = mid -/+ e). For every
    9-stencil candidate pair the clamped closest points are computed
    componentwise — scalar planes only, no (..., R, R, 3) temporaries, which
    is ~300x faster than running the vector segment kernel on 5-D blocks
    (the minor-axis-3 layout forces relayouts and 1.8x lane padding).

    out_fn(s, t, dx, dy, dz, d2, own_extra..., cand_extra...) receives
    (ny_chunk, nz, R, 9R) planes: clamped arc parameters in [0, 1], the
    closest-vector components (own -> cand), its squared norm, and the
    broadcast scalar extra fields. It returns a tuple of per-pair planes;
    each is reduced over the candidate axis to (ny, nz, R).

    Contract (sentinel masking, as pair_accumulate_central): outputs must
    vanish for pairs beyond the grid cutoff (invalid slots separate
    themselves via build_rows sentinels) and for coincident segments
    (d2 == 0 — true for anything proportional to the closest vector)."""
    pos = state.pos
    ny, nz, R = pos.shape[:3]
    dtype = pos.dtype
    itemsize = jnp.dtype(dtype).itemsize
    (lx, ly, lz), (px, py, pz) = box
    if (py and ny < 5) or (pz and nz < 5):
        raise ValueError("pair_accumulate_segments needs ny,nz >= 5 on "
                         "periodic axes; use pair_accumulate_multi")

    ex, ey, ez = half_edges[..., 0], half_edges[..., 1], half_edges[..., 2]
    fields = (ex, ey, ez) + tuple(extra_fields)
    cx, cy_, cz, cand_f = _candidate_planes(pos, box, fields)
    cex, cey, cez = cand_f[:3]
    cand_scalars = cand_f[3:]
    ox, oy, oz = pos[..., 0], pos[..., 1], pos[..., 2]
    lx_px = (lx, 1.0 / lx) if px else None

    # ~28 live (R, 9R) planes in the fused closest-point kernel
    bytes_per_row = 28 * nz * R * 9 * R * itemsize
    chunk_y = int(hbm_budget_bytes // max(bytes_per_row, 1))
    if chunk_y >= ny or chunk_y < 1:
        return _segment_pair_chunk(ox, oy, oz, ex, ey, ez, extra_fields,
                                   cx, cy_, cz, cex, cey, cez, cand_scalars,
                                   out_fn, lx_px)

    n_chunks = -(-ny // chunk_y)
    ny_pad = n_chunks * chunk_y

    def pad(arr):
        cfg = [(0, ny_pad - ny)] + [(0, 0)] * (arr.ndim - 1)
        return jnp.pad(arr, cfg)

    own_planes = [pad(p) for p in (ox, oy, oz, ex, ey, ez)]
    own_sc = tuple(pad(f) for f in extra_fields)
    cand_planes = [pad(p) for p in (cx, cy_, cz, cex, cey, cez)]
    cand_sc = tuple(pad(f) for f in cand_scalars)

    def chunk(ci):
        y0 = ci * chunk_y
        sl = lambda arr: jax.lax.dynamic_slice_in_dim(arr, y0, chunk_y, 0)  # noqa: E731
        oxc, oyc, ozc, exc, eyc, ezc = (sl(p) for p in own_planes)
        cxc, cyc, czc, cexc, ceyc, cezc = (sl(p) for p in cand_planes)
        return _segment_pair_chunk(oxc, oyc, ozc, exc, eyc, ezc,
                                   tuple(sl(f) for f in own_sc),
                                   cxc, cyc, czc, cexc, ceyc, cezc,
                                   tuple(sl(f) for f in cand_sc),
                                   out_fn, lx_px)

    outs = jax.lax.map(chunk, jnp.arange(n_chunks, dtype=jnp.int32))
    return tuple(ov.reshape((ny_pad, nz, R) + ov.shape[4:])[:ny]
                 for ov in outs)


def _unsort_rows_to_gid(vals_flat: Array, state: RowState, n: int) -> Array:
    """(slots, K) per-row-slot values -> (N, K) in gid order.

    Instead of a `.at[gid].set(vals)` scatter of K-wide rows, build the
    gid->slot inverse permutation with a single-int scatter and then
    row-GATHER the values. Bodies dropped by row overflow (no
    slot) get the padded all-`n` row; the caller's overflow flag covers
    them."""
    slots = vals_flat.shape[0]
    k = vals_flat.shape[1]
    flat_gid = state.gid.reshape(-1)
    flat_valid = state.valid.reshape(-1)
    tgt = jnp.where(flat_valid, flat_gid, n)
    slot_of = jnp.full((n + 1,), slots, jnp.int32).at[tgt].set(
        jnp.arange(slots, dtype=jnp.int32), mode="drop")[:n]
    vals_pad = jnp.concatenate(
        [vals_flat, jnp.full((1, k), n, vals_flat.dtype)], axis=0)
    return vals_pad[jnp.minimum(slot_of, slots)]


def extract_kernel_ok(grid: RowGrid, max_neighbors: int, itemsize: int = 4,
                      periodic_axes=(True, True, True)) -> bool:
    """True when neighbor_matrix_rows runs the Triton extraction kernel
    (ops/pallas/row_extract.py): on the GPU, f32, all axes periodic, and
    the static kernel envelope admits (R, K)."""
    from mundy_tpu.ops.pallas.row_extract import row_extract_fits

    return (jax.default_backend() == "gpu" and itemsize == 4
            and all(periodic_axes) and grid.ny >= 5 and grid.nz >= 5
            and row_extract_fits(grid.row_capacity, max_neighbors))


def row_extract_xla(state: RowState, box: tuple, cutoff: float,
                    max_neighbors: int, hbm_budget_bytes: float = 2.5e9,
                    search_radii: Optional[Array] = None):
    """XLA K-nearest extraction on the row layout: K argmin passes over the
    dense (R, 9R) candidate blocks (ties resolved by first-lane argmin, so
    equal distances extract on successive passes).

    Returns (ids (ny, nz, R, K) int32 gids nearest first, padded with -1,
    count (ny, nz, R)) — the contract of the kernel's row_neighbor_extract.
    Rows are chunked along y so ~4 live (R, 9R) blocks per row stay under
    hbm_budget_bytes.
    `search_radii` (N,) switches to the per-pair cutoff sri + srj."""
    lengths, flags = box
    ny, nz, R = state.gid.shape
    dtype = state.pos.dtype
    itemsize = jnp.dtype(dtype).itemsize
    n = int(search_radii.shape[0]) if search_radii is not None else None
    k_out = max_neighbors
    gid_f = state.gid.astype(dtype)  # gid rides the plane machinery as f32
    if search_radii is not None:
        safe = jnp.minimum(state.gid, n - 1)
        sr_rows = jnp.where(state.valid,
                            jnp.asarray(search_radii, dtype)[safe], 0.0)
        cx, cy_, cz, (cgid, csr) = _candidate_planes(
            state.pos, box, (gid_f, sr_rows))
    else:
        sr_rows = None
        cx, cy_, cz, (cgid,) = _candidate_planes(state.pos, box, (gid_f,))
        csr = None
    ox, oy, oz = state.pos[..., 0], state.pos[..., 1], state.pos[..., 2]
    lx, px = lengths[0], flags[0]
    cut2 = jnp.asarray(cutoff * cutoff, dtype)
    lanes = jnp.arange(9 * R, dtype=jnp.int32)

    def extract(oxc, oyc, ozc, ogc, ovc, cxc, cyc, czc, cgc,
                osr=None, csrc=None):
        DX = cxc[..., None, :] - oxc[..., :, None]
        if px:
            DX = DX - lx * jnp.round(DX * (1.0 / lx))
        DY = cyc[..., None, :] - oyc[..., :, None]
        DZ = czc[..., None, :] - ozc[..., :, None]
        r2 = DX * DX + DY * DY + DZ * DZ
        if osr is not None:
            cut = osr[..., :, None] + csrc[..., None, :]
            pair_cut2 = cut * cut
        else:
            pair_cut2 = cut2
        hit = (r2 < pair_cut2) & (cgc[..., None, :] != ogc[..., :, None])
        count = jnp.sum(hit, axis=-1)
        r2m = jnp.where(hit, r2, jnp.inf)
        ids = []
        for _ in range(k_out):
            amin = jnp.argmin(r2m, axis=-1).astype(jnp.int32)
            v = jnp.take_along_axis(r2m, amin[..., None], axis=-1)[..., 0]
            g = jnp.take_along_axis(cgc[..., None, :], amin[..., None],
                                    axis=-1)[..., 0]
            ok = jnp.isfinite(v) & ovc
            ids.append(jnp.where(ok, g.astype(jnp.int32), -1))
            r2m = jnp.where(lanes == amin[..., None], jnp.inf, r2m)
        return jnp.stack(ids, axis=-1), jnp.where(ovc, count, 0)

    # ~4 live (R, 9R) blocks in the extraction graph
    bytes_per_row = 4 * nz * R * 9 * R * itemsize
    chunk_y = int(hbm_budget_bytes // max(bytes_per_row, 1))
    if chunk_y < 1:
        # even ONE y-plane of (nz, R, 9R) blocks busts the budget — the
        # heavily-clustered regime (R integrates clustering over the full
        # x axis). Refuse loudly: the unchunked graph would not fit device
        # memory. Callers should use the cell-list builder here (3D cells
        # bound occupancy locally; see rows_extract_feasible).
        raise ValueError(
            f"neighbor_matrix_rows: one y-plane of the extraction graph "
            f"needs {bytes_per_row / 1e9:.1f} GB (> budget "
            f"{hbm_budget_bytes / 1e9:.1f} GB) at R={R}, nz={nz} — the "
            "distribution is too clustered for the row layout; use the "
            "cell-list builder (neighbor_matrix)")
    if chunk_y >= ny:
        return extract(ox, oy, oz, state.gid, state.valid,
                       cx, cy_, cz, cgid, sr_rows, csr)
    n_chunks = -(-ny // chunk_y)
    ny_pad = n_chunks * chunk_y

    def pad(a, fill=0):
        cfg = [(0, ny_pad - ny)] + [(0, 0)] * (a.ndim - 1)
        return jnp.pad(a, cfg, constant_values=fill)

    planes = [pad(a) for a in (ox, oy, oz, cx, cy_, cz, cgid)]
    gid_p, valid_p = pad(state.gid), pad(state.valid, False)
    sr_p = pad(sr_rows) if sr_rows is not None else None
    csr_p = pad(csr) if csr is not None else None

    def chunk(c):
        y0 = c * chunk_y
        sl = lambda a: jax.lax.dynamic_slice_in_dim(a, y0, chunk_y, 0)  # noqa: E731
        oxc, oyc, ozc, cxc, cyc, czc, cgc = (sl(a) for a in planes)
        return extract(oxc, oyc, ozc, sl(gid_p), sl(valid_p),
                       cxc, cyc, czc, cgc,
                       sl(sr_p) if sr_p is not None else None,
                       sl(csr_p) if csr_p is not None else None)

    ids, count = jax.lax.map(chunk, jnp.arange(n_chunks, dtype=jnp.int32))
    return (ids.reshape((ny_pad, nz, R, k_out))[:ny],
            count.reshape((ny_pad, nz, R))[:ny])


def neighbor_matrix_rows(
    pos: Array,
    search_radius: float,
    box_lengths,
    periodic_axes=(True, True, True),
    origin=(0.0, 0.0, 0.0),
    max_neighbors: int = 8,
    capacity_slack: float = 1.9,
    hbm_budget_bytes: float = 2.5e9,
    grid: Optional[RowGrid] = None,
    search_radii: Optional[Array] = None,
):
    """NeighborMatrix built through the row layout — the fast broad phase.

    Replaces neighbor/cell_list.neighbor_matrix for contact-scale cutoffs:
    that builder gathers (chunk, 27*cap) candidate tables per particle;
    this one sorts once (build_rows) and extracts the K nearest from the
    dense 9-row candidate blocks — with the Triton kernel on the GPU when
    extract_kernel_ok, else with row_extract_xla (cost linear in K). Use
    the cell-list builder when max_neighbors is large or the box has fewer
    than 5 cells per periodic axis.

    Pair cutoff is 2*search_radius (uniform radii) or, with `search_radii`
    (N,) given, the per-pair sri + srj — matching neighbor_matrix's
    search_radius_i + search_radius_j convention; `search_radius` must then
    be max(search_radii) (it sizes the row cells). Polydisperse extraction
    rides the same plane machinery (radii as a payload channel; XLA path
    only — the kernel assumes a uniform cutoff).
    Returns NeighborMatrix(idx (N,K) with N marking empty, mask, overflow).
    """
    from mundy_tpu.neighbor.cell_list import NeighborMatrix

    n = pos.shape[0]
    dtype = pos.dtype
    k_out = max_neighbors
    cutoff = 2.0 * float(search_radius)
    lengths = tuple(float(v) for v in box_lengths)
    flags = tuple(bool(v) for v in periodic_axes)
    if grid is None:
        low = np.asarray(origin, np.float64)
        high = low + np.asarray(lengths, np.float64)
        grid = make_row_grid(low, high, cutoff, n,
                             capacity_slack=capacity_slack, dtype=dtype,
                             align=8)
    ny, nz = grid.ny, grid.nz
    if (flags[1] and ny < 5) or (flags[2] and nz < 5):
        raise ValueError("neighbor_matrix_rows needs >=5 cells per periodic "
                         "y/z axis; use neighbor_matrix")

    # Wrap periodic axes into the primary cell: the row layout bins by
    # clamped y/z cell coordinates, so an out-of-box position (unwrapped
    # trajectories, e.g. chained filament midpoints) would land in an edge
    # row the partner's 9-stencil never scans — silently missing pairs.
    orig = jnp.asarray(grid.origin, dtype)
    L = jnp.asarray(lengths, dtype)
    wrapped = orig + jnp.mod(pos - orig, L)
    pos = jnp.where(jnp.asarray(flags), wrapped, pos)

    state = build_rows(pos, jnp.arange(n, dtype=jnp.int32), grid)
    if search_radii is None and extract_kernel_ok(
            grid, k_out, jnp.dtype(dtype).itemsize, flags):
        from mundy_tpu.ops.pallas.row_extract import row_neighbor_extract

        ids, count = row_neighbor_extract(state.pos, state.gid, state.valid,
                                          lengths, cutoff, k_out)
    else:
        ids, count = row_extract_xla(state, (lengths, flags), cutoff, k_out,
                                     hbm_budget_bytes, search_radii)
    # row slots back to flat gid order (inverse permutation + row gather)
    idx = _unsort_rows_to_gid(ids.reshape(-1, k_out), state, n)
    idx = jnp.where(idx < 0, n, idx)
    mask = idx < n
    overflow = state.overflow | jnp.any(count > k_out)
    return NeighborMatrix(idx=idx, mask=mask, overflow=overflow)


def rows_extract_feasible(grid: RowGrid, max_neighbors: int,
                          itemsize: int = 4,
                          hbm_budget_bytes: float = 2.5e9) -> bool:
    """True when neighbor_matrix_rows can extract at this grid's shape —
    either the extraction kernel runs (extract_kernel_ok) or the XLA path
    can chunk at least one y-plane under the memory budget. False means the
    distribution is too clustered for the row layout (R integrates
    clustering over the full x axis); callers should use the cell-list
    builder, whose 3D cells bound occupancy locally."""
    if extract_kernel_ok(grid, max_neighbors, itemsize):
        return True
    nz, R = grid.nz, grid.row_capacity
    return 4 * nz * R * 9 * R * itemsize <= hbm_budget_bytes


def moved_beyond_skin(state: RowState, metric: Metric, skin: float) -> Array:
    disp = metric.sep(state.ref_pos, state.pos)
    d2 = jnp.sum(disp * disp, axis=-1)
    d2 = jnp.where(state.valid, d2, 0.0)
    return jnp.max(d2) > (0.5 * skin) ** 2
