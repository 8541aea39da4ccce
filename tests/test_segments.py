"""Blocked sorted-id segmented reduction (ops/segments.py) vs segment_sum."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from mundy_tpu.ops.segments import segment_sum_sorted_blocked, segment_windows


def _case(rng, n, mean, B, W, capacity):
    counts = rng.poisson(mean, n)
    ids = np.repeat(np.arange(n), counts)
    ids = ids[:capacity] if ids.size >= capacity else np.pad(
        ids, (0, capacity - ids.size), constant_values=n)
    ids = np.sort(ids)
    vals = rng.normal(size=(capacity, 3))
    vals[ids >= n] = 0.0
    return jnp.asarray(ids, jnp.int32), jnp.asarray(vals)


def test_matches_segment_sum(rng):
    n, B, W, cap = 1000, 64, 256, 2048
    ids, vals = _case(rng, n, 1.3, B, W, cap)
    win = segment_windows(ids, n, B, W)
    assert not bool(win.overflow)
    out = segment_sum_sorted_blocked(vals, ids, n, win)
    ref = jax.ops.segment_sum(vals, ids, num_segments=n + 1)[:n]
    np.testing.assert_allclose(np.asarray(out), np.asarray(ref), atol=1e-10)


def test_f32_bf16_split_accuracy(rng):
    """The f32 path reduces via a 3-term bf16 hi/mid/lo dot that
    recovers the full 24-bit f32 mantissa (~1-2 ulp per summand). All
    terms sit behind optimization barriers, so this exercises the real
    bf16-product rounding even on CPU (where XLA would otherwise fold the
    f32->bf16->f32 round trip away and the test would vacuously pass).
    The tight tolerance is the point: the 2-term split's ~2^-17 relative
    error was the BBPGD residual floor at 1M bodies."""
    n, B, W, cap = 1000, 64, 256, 2048
    ids, vals = _case(rng, n, 1.3, B, W, cap)
    vals32 = vals.astype(jnp.float32)
    win = segment_windows(ids, n, B, W)
    out = segment_sum_sorted_blocked(vals32, ids, n, win)
    assert out.dtype == jnp.float32
    ref = jax.ops.segment_sum(vals, ids, num_segments=n + 1)[:n]
    scale = float(jnp.max(jnp.abs(vals)))
    np.testing.assert_allclose(np.asarray(out), np.asarray(ref),
                               atol=3e-7 * scale)


def test_windows_from_body_starts_match_searchsorted(rng):
    """The body-starts gather path (one (nb+1,)-row gather, replacing a
    serial searchsorted) must reproduce the windows
    exactly — including with a truncated (overflowed) list."""
    n, B, W, cap = 1000, 64, 256, 2048
    counts = rng.poisson(1.3, n)
    body_starts = jnp.asarray(
        np.concatenate([[0], np.cumsum(counts)]), jnp.int32)
    ids = np.repeat(np.arange(n), counts)
    for capacity in (cap, int(ids.size * 0.7)):  # full + truncated
        idc = np.sort(ids)[:capacity]
        idc = np.pad(idc, (0, max(0, capacity - idc.size)),
                     constant_values=n)
        idj = jnp.asarray(idc, jnp.int32)
        ref = segment_windows(idj, n, B, W)
        got = segment_windows(idj, n, B, W, body_starts=body_starts)
        np.testing.assert_array_equal(np.asarray(got.starts),
                                      np.asarray(ref.starts))
        assert bool(got.overflow) == bool(ref.overflow)


def test_window_overflow_flags(rng):
    n, B, cap = 256, 32, 1024
    # everything piled on body 0: one block holds all pairs
    ids = jnp.asarray(np.sort(np.zeros(900, np.int32).tolist() +
                              [n] * (cap - 900)), jnp.int32)
    win = segment_windows(ids, n, B, 512)
    assert bool(win.overflow)
    win2 = segment_windows(ids, n, B, 1024)
    assert not bool(win2.overflow)


def test_pad_run_not_counted(rng):
    """Trailing pads (id == n) must not count into the last block."""
    n, B = 64, 32
    ids = jnp.asarray([0, 1, 5, 63] + [n] * 100, jnp.int32)
    win = segment_windows(ids, n, B, 8)
    assert not bool(win.overflow)
    vals = jnp.zeros((104, 3)).at[:4].set(1.0)
    out = segment_sum_sorted_blocked(vals, ids, n, win)
    assert float(out.sum()) == 12.0


def _strided_case(rng, n, B, W, mean=1.3):
    """Random strided-layout case: block b's slots hold sorted ids in
    [b*B, (b+1)*B), front-packed, pads carrying n with zero values."""
    nb = -(-n // B)
    counts = rng.poisson(mean, n)
    ids = np.full((nb * W,), n, np.int64)
    for b in range(nb):
        blk = np.repeat(np.arange(b * B, min((b + 1) * B, n)),
                        counts[b * B:(b + 1) * B])[:W]
        ids[b * W:b * W + blk.size] = blk
    vals = rng.normal(size=(nb * W, 3))
    vals[ids >= n] = 0.0
    return (jnp.asarray(ids, jnp.int32), jnp.asarray(vals, jnp.float32), nb)


def test_strided_matches_segment_sum(rng):
    from mundy_tpu.ops.segments import StridedWindows, segment_sum_strided

    n, B, W = 1000, 128, 256
    ids, vals, nb = _strided_case(rng, n, B, W)
    win = StridedWindows(block_bodies=B, window=W, nb=nb,
                         overflow=jnp.asarray(False))
    out = segment_sum_strided(vals, ids, n, win)
    ref = jax.ops.segment_sum(vals, ids, num_segments=n + 1)[:n]
    scale = float(jnp.max(jnp.abs(vals)))
    np.testing.assert_allclose(np.asarray(out), np.asarray(ref),
                               atol=3e-7 * scale)


@pytest.mark.parametrize("n,B,W", [(512, 128, 128), (1000, 64, 256),
                                   (77, 32, 64)])
def test_strided_matches_numpy(rng, n, B, W):
    """segment_sum_strided (f32 values through the 3-term bf16 split)
    against a float64 NumPy add.at reference."""
    from mundy_tpu.ops.segments import StridedWindows, segment_sum_strided

    ids, vals, nb = _strided_case(rng, n, B, W)
    win = StridedWindows(block_bodies=B, window=W, nb=nb,
                         overflow=jnp.asarray(False))
    got = np.asarray(segment_sum_strided(vals, ids, n, win))
    want = np.zeros((n + 1, 3))
    np.add.at(want, np.asarray(ids), np.asarray(vals, np.float64))
    # a few f32 ulp of the summed magnitude (f32 accumulation of a
    # handful of terms, each carried to ~1 ulp by the split)
    scale = float(jnp.max(jnp.abs(vals)))
    np.testing.assert_allclose(got, want[:n], atol=1e-6 * scale)


def test_active_pair_subset_strided_parity(rng):
    """Strided compaction vs the front-packed compaction: same active pair
    SET, same per-block membership, per-block slot base b*W."""
    from mundy_tpu.constraints.collision import (CollisionSetup,
                                                 active_pair_subset,
                                                 active_pair_subset_strided)
    from mundy_tpu.neighbor.cell_list import PairList
    from mundy_tpu.ops.segments import segment_windows

    n, B, W, cap = 300, 32, 64, 1024
    counts = rng.poisson(2.0, n)
    ids = np.repeat(np.arange(n), counts)[:cap]
    ids = np.pad(ids, (0, cap - ids.size), constant_values=n)
    ids = np.sort(ids)
    mask = ids < n
    j = rng.integers(0, n, cap)
    sep0 = rng.normal(size=cap).astype(np.float32)
    pairs = PairList(i=jnp.asarray(ids, jnp.int32),
                     j=jnp.asarray(np.where(mask, j, n), jnp.int32),
                     mask=jnp.asarray(mask),
                     num_pairs=jnp.asarray(int(mask.sum()), jnp.int32),
                     overflow=jnp.asarray(False))
    normals = jnp.asarray(rng.normal(size=(cap, 3)), jnp.float32)
    setup = CollisionSetup(pairs=pairs, normals=normals,
                           sep0=jnp.asarray(sep0))
    body_starts = jnp.asarray(
        np.concatenate([[0], np.cumsum(np.bincount(ids[mask], minlength=n))]),
        jnp.int32)
    seg = segment_windows(pairs.i, n, B, W, body_starts=body_starts)
    margin = 0.0
    res = active_pair_subset_strided(setup, margin, n, B, W, seg.starts)
    s_act, sel, n_act, blk_max = (res.setup, res.sel, res.n_act,
                                  res.block_max)
    assert not bool(res.overflow)
    ref_act, ref_sel, ref_n, _ref_ovf = active_pair_subset(
        setup, margin, cap, n, seg_starts=seg.starts, block_bodies=B,
        window=W)
    assert int(n_act) == int(ref_n)
    got_slots = set(np.asarray(sel)[np.asarray(sel) < cap].tolist())
    ref_slots = set(np.asarray(ref_sel)[np.asarray(ref_sel) < cap].tolist())
    assert got_slots == ref_slots
    # strided invariant: active slot s holds a pair of body block s // W
    sel_np = np.asarray(sel)
    for s in np.nonzero(sel_np < cap)[0]:
        assert ids[sel_np[s]] // B == s // W
    # block_max matches the densest block's true active count
    per_block = np.bincount(ids[mask & (sep0 < margin)] // B,
                            minlength=len(np.asarray(seg.starts)))
    assert int(blk_max) == int(per_block.max())
    # assembly parity through collision_forces on both layouts
    from mundy_tpu.constraints.collision import collision_forces
    g_full = rng.normal(size=cap).astype(np.float32)
    ga = jnp.asarray(g_full)[jnp.minimum(sel, cap - 1)]
    gr = jnp.asarray(g_full)[jnp.minimum(ref_sel, cap - 1)]
    fa = collision_forces(s_act, ga, n)
    fr = collision_forces(ref_act, gr, n)
    np.testing.assert_allclose(np.asarray(fa), np.asarray(fr), atol=1e-5)
