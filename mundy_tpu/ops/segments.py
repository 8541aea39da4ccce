"""Blocked segmented reduction for sorted ids (the LCP force assembly).

For SORTED ids the reduction is a sequence of small dense products:
partition bodies into blocks of B, slice each block's contiguous pair window
(<= W pairs, found at rebuild), and reduce with a (B, W) one-hot matmul.
bf16 one-hot entries are exact; f32 values go through a hi/mid/lo bf16 split
that captures the full 24-bit mantissa (~1-2 ulp f32 per summand), so the
products can run at bf16 rate with f32 accumulation. Whether this beats a
plain sorted `segment_sum` on a given device is a measurement.

This is the force-assembly primitive of the LCP collision path (the
reference's `sum_collision_force`, `scrap/lcp_spheres/StkNgpLCP.cpp:578`,
runs atomic scatter-adds under Kokkos; sorted one-sided assembly is
deterministic).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp
from jax import Array


class SegmentWindows(NamedTuple):
    """Rebuild-time block structure for sorted-id segmented reductions.

    starts: (nb,) int32 — first row of each B-body block's window (binary
    search over the sorted id array). overflow: any block holds > W rows
    (host must regrow W and rebuild).
    """

    starts: Array
    block_bodies: int  # B
    window: int  # W
    overflow: Array


def segment_windows(ids: Array, n_segments: int, block_bodies: int,
                    window: int, body_starts: Optional[Array] = None
                    ) -> SegmentWindows:
    """Build the block windows for sorted `ids` (padded tail >= n_segments).

    `body_starts` ((n_segments+1,) exclusive-cumulative per-body counts,
    e.g. body_pair_starts on the neighbor matrix the list was compacted
    from) replaces the searchsorted — a serial ~20-probe gather chain —
    with one (nb+1,)-row gather."""
    B, W = block_bodies, window
    nb = -(-n_segments // B)
    # pads carry id == n_segments: clip the edges so the trailing pad run
    # never counts into the last block's occupancy
    edges = jnp.minimum(jnp.arange(0, nb * B + 1, B, dtype=jnp.int32),
                        n_segments)
    if body_starts is not None:
        # clamp to the (possibly truncated) list length so overflowed
        # configs keep windows consistent with the stored slots
        bounds = jnp.minimum(body_starts[edges],
                             ids.shape[0]).astype(jnp.int32)
    else:
        bounds = jnp.searchsorted(ids, edges).astype(jnp.int32)
    counts = bounds[1:] - bounds[:-1]
    return SegmentWindows(starts=bounds[:-1], block_bodies=B, window=W,
                          overflow=jnp.any(counts > W))


class StridedWindows(NamedTuple):
    """Static-offset block structure: pairs of segment block b occupy slots
    [b*W, b*W + count_b) (constraints/collision.active_pair_subset_strided).
    Unlike SegmentWindows there is nothing to search at rebuild — block b's
    window IS [b*W, (b+1)*W)."""

    block_bodies: int  # B
    window: int  # W
    nb: int
    overflow: Array  # any block's active count exceeded W


def segment_sum_strided(
    values: Array,  # (nb*W, D) — padded rows must carry ZERO values
    ids: Array,  # (nb*W,) int32 segment ids; block b's slots hold ids in
    #              [b*B, (b+1)*B) (pads carry >= n_segments)
    n_segments: int,
    windows: StridedWindows,
) -> Array:
    """Strided-layout segmented reduction -> (n_segments, D): the windowed
    blocked reduction with the static starts b*W."""
    B, W, nb = windows.block_bodies, windows.window, windows.nb
    starts = jnp.arange(nb, dtype=jnp.int32) * W
    win = SegmentWindows(starts=starts, block_bodies=B, window=W,
                         overflow=windows.overflow)
    return segment_sum_sorted_blocked(values, ids, n_segments, win)


def strided_t(
    gamma: Array,  # (nb*W,) f32 multipliers, ZERO on padded slots
    normals: Array,  # (nb*W, 3) unit normals
    ids: Array,  # (nb*W,) int32 body ids (block b's slots in [b*B, (b+1)*B))
    n_segments: int,
    windows: StridedWindows,
) -> Array:
    """i-side Delassus half-apply on the strided layout -> (nb*W,).

    t_p = -n_p . F_{i(p)}, F = strided assembly of -gamma n, then one row
    gather of F per slot.
    """
    B, W, nb = windows.block_bodies, windows.window, windows.nb
    blk = jnp.repeat(jnp.arange(nb, dtype=jnp.int32), W)
    loc = ids - blk * B
    f = segment_sum_strided(-gamma[:, None] * normals, ids, n_segments,
                            windows)
    valid = (loc >= 0) & (loc < B)
    fi = f[jnp.minimum(jnp.where(valid, ids, 0), n_segments - 1)]
    return jnp.where(valid, -jnp.sum(normals * fi, axis=-1), 0.0)


def segment_sum_sorted_blocked(
    values: Array,  # (C, D) f32, zero on padded rows
    ids: Array,  # (C,) int32 sorted ascending; pads carry >= n_segments
    n_segments: int,
    windows: SegmentWindows,
    batch_size: int = 64,
) -> Array:
    """sum_{rows with ids == s} values -> (n_segments, D).

    Rows beyond a block's W window are dropped silently — callers must check
    `windows.overflow` at rebuild time. Padded rows are harmless as long as
    their values are zero (they may fall inside the last block's id range).
    """
    B, W = windows.block_bodies, windows.window
    nb = windows.starts.shape[0]
    D = values.shape[1]
    vpad = jnp.pad(values, ((0, W), (0, 0)))
    ipad = jnp.pad(ids, (0, W), constant_values=nb * B + B)
    lanes = jnp.arange(B, dtype=jnp.int32)

    f32_path = values.dtype == jnp.float32

    def blk(b):
        p0 = windows.starts[b]
        vw = jax.lax.dynamic_slice_in_dim(vpad, p0, W, 0)
        iw = jax.lax.dynamic_slice_in_dim(ipad, p0, W, 0)
        loc = iw - b * B
        onehot = loc[None, :] == lanes[:, None]
        if not f32_path:  # f64: exact dot at HIGHEST precision
            return jnp.dot(onehot.astype(values.dtype), vw,
                           precision=jax.lax.Precision.HIGHEST)
        oh = onehot.astype(jnp.bfloat16)
        # barriers keep XLA from collapsing the f32->bf16->f32 round trips
        # (hi included — otherwise CPU folds hi back to the f32 value and
        # tests never see the bf16-product precision) or refolding the
        # terms into one bf16 dot. THREE bf16 terms recover the full 24-bit
        # f32 mantissa (8 bits each): a 2-term split's ~2^-17 relative
        # error is a BBPGD residual floor at 1M bodies (~2e-5 > the 1e-5
        # overlap tolerance). The one-hot operand is shared, so the third
        # dot adds ~1/3 of the value-stream cost, not 50%.
        hi = jax.lax.optimization_barrier(vw.astype(jnp.bfloat16))
        rem = vw - hi.astype(jnp.float32)
        mid = jax.lax.optimization_barrier(rem.astype(jnp.bfloat16))
        lo = jax.lax.optimization_barrier(
            (rem - mid.astype(jnp.float32)).astype(jnp.bfloat16))
        return (jnp.dot(oh, hi, preferred_element_type=jnp.float32)
                + jnp.dot(oh, mid, preferred_element_type=jnp.float32)
                + jnp.dot(oh, lo, preferred_element_type=jnp.float32))

    out = jax.lax.map(blk, jnp.arange(nb, dtype=jnp.int32),
                      batch_size=batch_size)
    return out.reshape(nb * B, D)[:n_segments]
