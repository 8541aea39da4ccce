"""Pallas kernel (Triton route): K-nearest neighbor extraction on the row layout.

The XLA row broad phase (neighbor/rows.neighbor_matrix_rows) runs K argmin
passes over the (R, 9R) candidate distance block of every (y, z) row, and
each pass reads and rewrites the whole block through device memory. This
kernel keeps the block on chip: one program per (y, z, own-slot tile) loads
its 9 candidate rows once (periodic y/z wrap computed here, x by minimum
image), builds the (RB, C) key block, runs the K select passes on it, and
writes only (ids, count). Programs share nothing and use no atomics, so the
output is deterministic.

Tie-breaking without argmin: squared distances are bitcast to int32 (order
preserving for non-negative floats), the low log2(C) mantissa bits are
replaced by the candidate lane index (unique per lane), and the minimum is
taken over ints. The selected lane is then the low bits of the minimum, and
pass k takes the smallest key above pass k-1's. The in-cutoff test uses the
unmodified r2, so the lane field only reorders near-equal distances, never
changes the extracted neighbor SET while count <= K. Lanes follow the XLA
path's (dy, dz)-major order, s * R + slot.

Shapes: C = 9R rounded up to a power of two (pad lanes masked), RB own slots
per program (power of two, RB * C <= _BLOCK_ELEMS), K padded to a power of
two in the output tile. `row_extract_fits` is the static envelope check;
callers take the XLA extraction outside it.

ref: the coarse_search + linker generation pipeline this replaces,
`mundy/mesh/src/mundy_mesh/GenNeighborLinkers.hpp:510-663`.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax import Array
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

_INT_INF = 0x7F7FFFFF  # bits of f32 max: above every in-cutoff key
_BLOCK_ELEMS = 8192    # (RB, C) key block size per program
_MAX_LANES = 4096      # C cap: R <= 455
_MAX_K = 64            # unrolled select passes
_NUM_WARPS = 4


def _pow2(n: int) -> int:
    return 1 << max(int(n) - 1, 0).bit_length()


def _plan(R: int, K: int):
    """(C, RB, NB, KP) for the kernel, or None outside its envelope."""
    C = _pow2(9 * R)
    if C > _MAX_LANES or K > _MAX_K or K < 1:
        return None
    RB = max(1, min(32, _BLOCK_ELEMS // C, _pow2(R)))
    return C, RB, -(-R // RB), _pow2(K)


def row_extract_fits(R: int, K: int) -> bool:
    """True when the kernel's static envelope admits row capacity R and K
    neighbors (otherwise callers take the XLA extraction)."""
    return _plan(R, K) is not None


def _extract_kernel(px_ref, py_ref, pz_ref, g_ref, v_ref, ids_ref, cnt_ref,
                    *, box, cut2, ny, nz, R, RB, C, K, KP):
    f32, i32 = jnp.float32, jnp.int32
    lx, ly, lz = box
    iy, iz, ib = pl.program_id(0), pl.program_id(1), pl.program_id(2)

    def cand(lane):
        """Flat slot index, liveness and y/z image shifts of lane ids."""
        s = jax.lax.div(lane, i32(R))
        slot = lane - s * R
        sy = jax.lax.div(s, i32(3))
        yy = iy + sy - 1
        zz = iz + (s - 3 * sy) - 1
        ysh = jnp.where(yy < 0, f32(-ly), jnp.where(yy >= ny, f32(ly), f32(0)))
        zsh = jnp.where(zz < 0, f32(-lz), jnp.where(zz >= nz, f32(lz), f32(0)))
        yy = jnp.where(yy < 0, yy + ny, jnp.where(yy >= ny, yy - ny, yy))
        zz = jnp.where(zz < 0, zz + nz, jnp.where(zz >= nz, zz - nz, zz))
        live = s < 9
        flat = jnp.where(live, (yy * nz + zz) * R + slot, 0)
        return flat, live, ysh, zsh

    lanes = jax.lax.broadcasted_iota(i32, (C,), 0)
    cflat, clive, ysh, zsh = cand(lanes)
    cx = px_ref[cflat]
    cy = py_ref[cflat] + ysh
    cz = pz_ref[cflat] + zsh
    cg = g_ref[cflat]

    r = ib * RB + jax.lax.broadcasted_iota(i32, (RB,), 0)
    oflat = (iy * nz + iz) * R + jnp.minimum(r, R - 1)
    ox, oy, oz = px_ref[oflat], py_ref[oflat], pz_ref[oflat]
    og = g_ref[oflat]
    ov = (v_ref[oflat] != 0) & (r < R)

    t = cx[None, :] - ox[:, None]
    t = t - f32(lx) * jnp.floor(t * f32(1.0 / lx) + f32(0.5))
    r2 = t * t
    t = cy[None, :] - oy[:, None]
    r2 = r2 + t * t
    t = cz[None, :] - oz[:, None]
    r2 = r2 + t * t
    hit = ((r2 < f32(cut2)) & (cg[None, :] != og[:, None])
           & clive[None, :] & ov[:, None])
    lane_mask = -C  # ~(C - 1): clears the low log2(C) bits
    bits = jax.lax.bitcast_convert_type(r2, i32)
    key = jnp.where(hit, (bits & lane_mask) | lanes[None, :], _INT_INF)
    cnt_ref[...] = jnp.sum(hit.astype(i32), axis=1)

    kcol = jax.lax.broadcasted_iota(i32, (RB, KP), 1)
    ids = jnp.full((RB, KP), -1, i32)
    prev = jnp.full((RB,), -1, i32)
    for k in range(K):
        m = jnp.min(jnp.where(key > prev[:, None], key, _INT_INF), axis=1)
        kflat, _, _, _ = cand(m & (C - 1))
        gk = jnp.where(m < _INT_INF, g_ref[kflat], -1)
        ids = jnp.where(kcol == k, gk[:, None], ids)
        prev = m
    ids_ref[...] = ids


def row_neighbor_extract(
    pos: Array,    # (ny, nz, R, 3) f32 from build_rows (sentinel slots)
    gid: Array,    # (ny, nz, R) int32
    valid: Array,  # (ny, nz, R) bool
    box,           # (3,) periodic lengths
    cutoff: float,
    max_neighbors: int,
    interpret: bool = False,
) -> tuple[Array, Array]:
    """K nearest in-cutoff neighbor gids per row slot, plus hit counts.

    Returns (ids (ny, nz, R, K) int32 gids sorted by distance with -1
    padding, count (ny, nz, R) int32; count > K means truncation and the
    caller must flag overflow). All three axes periodic; ny, nz >= 5.
    Raises ValueError outside the kernel envelope (row_extract_fits)."""
    ny, nz, R, _ = pos.shape
    K = max_neighbors
    if ny < 5 or nz < 5:
        raise ValueError("row_neighbor_extract needs ny, nz >= 5")
    plan = _plan(R, K)
    if plan is None:
        raise ValueError(f"row_neighbor_extract: (R={R}, K={K}) is outside "
                         "the kernel envelope; use the XLA extraction")
    C, RB, NB, KP = plan
    kern = functools.partial(
        _extract_kernel, box=tuple(float(v) for v in box),
        cut2=float(cutoff) ** 2, ny=ny, nz=nz, R=R, RB=RB, C=C, K=K, KP=KP)
    flat = lambda a, dt: a.reshape(-1).astype(dt)  # noqa: E731
    ids, cnt = pl.pallas_call(
        kern,
        grid=(ny, nz, NB),
        out_specs=(
            pl.BlockSpec((None, None, RB, KP), lambda i, j, b: (i, j, b, 0)),
            pl.BlockSpec((None, None, RB), lambda i, j, b: (i, j, b)),
        ),
        out_shape=(
            jax.ShapeDtypeStruct((ny, nz, NB * RB, KP), jnp.int32),
            jax.ShapeDtypeStruct((ny, nz, NB * RB), jnp.int32),
        ),
        compiler_params=plgpu.CompilerParams(num_warps=_NUM_WARPS,
                                             num_stages=1),
        backend="triton",
        interpret=interpret,
        name="row_neighbor_extract",
    )(flat(pos[..., 0], jnp.float32), flat(pos[..., 1], jnp.float32),
      flat(pos[..., 2], jnp.float32), flat(gid, jnp.int32),
      flat(valid, jnp.int32))
    return ids[:, :, :R, :K], cnt[:, :, :R]
