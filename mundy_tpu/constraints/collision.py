"""Non-penetration collision resolution via matrix-free BBPGD LCP.

Re-designs the reference's collision pipeline (`scrap/lcp_spheres/
StkNgpLCP.cpp`): constraint generation (`:468-510`), force assembly D*gamma
(`sum_collision_force:578`), mobility product U = M F (`:612`), constraint
rate sdot = D^T U (`compute_rate_of_change_of_sep:635`), and the BBPGD
iteration with Dai-Fletcher residual (`:705-875`) — as one call into the
generic BBPGD solver (mundy_tpu.math.convex) with the Delassus operator
A = dt * D^T M D expressed matrix-free through scatter/gather + a pluggable
mobility apply.

LCP statement (per the reference): find gamma >= 0 with
    sep_new = sep0 + dt * D^T M D gamma >= 0,  gamma . sep_new = 0
i.e. A = dt * D^T M D, q = sep0, residual measured on sep_new (the
projected-gradient residual of convex.py equals the reference's
`compute_maximum_abs_projected_sep` with tol on overlap distance).
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import jax
import jax.numpy as jnp
from jax import Array

from mundy_tpu.geom.periodicity import Metric
from mundy_tpu.math.convex import PGDConfig, SolveResult, solve_lcp
from mundy_tpu.neighbor.cell_list import PairList


class CollisionSetup(NamedTuple):
    """Per-pair constraint data (capacity-padded, mask in `pairs.mask`).

    Two assembly layouts:
    - ORDERED (preferred): `pairs` from build_pair_list_ordered — every
      contact present in both directions, i sorted — and `windows` the
      rebuild-time block structure; D gamma is ONE blocked segmented
      reduction (ops/segments.py). The
      duplicated system is exactly equivalent: gamma stays symmetric under
      BBPGD because the gradient is (sdot is identical for (i,j) and
      (j,i)), and each ordered pair pushes only its own i.
    - UNORDERED fallback: unique i < j pairs; two-sided scatter-add
      assembly (optionally segment sums via `j_perm`).
    """

    pairs: PairList
    normals: Array  # (C, 3) unit, from body i toward body j
    sep0: Array  # (C,) signed separation at assembly time
    j_perm: Optional[Array] = None
    windows: Optional[object] = None  # SegmentWindows for the ordered layout


def body_pair_starts(nmat) -> Array:
    """(N+1,) int32 exclusive-cumulative per-body pair counts of an
    (N, K) neighbor matrix — the flat position of each body's run in the
    ordered pair list build_pair_list_ordered compacts from it (row-major
    compaction preserves per-body contiguity). One mask-sum + cumsum:
    O(N), vs a searchsorted over two 1M-slot id arrays (XLA lowers it to
    a serial 21-probe gather chain)."""
    counts = jnp.sum(nmat.mask, axis=1, dtype=jnp.int32)
    return jnp.concatenate([jnp.zeros((1,), jnp.int32), jnp.cumsum(counts)])


def remap_gamma(old_pairs: PairList, old_gamma: Array, new_pairs: PairList,
                probes: int, old_starts: Optional[Array] = None,
                old_nmat=None) -> Array:
    """Carry warm-start multipliers across a pair-list rebuild BY PAIR
    IDENTITY (i, j), not by slot.

    A rebuild re-sorts the pair list, so slot k before != slot k after —
    passing gamma through by slot scrambles the warm start exactly on the
    expensive (post-rebuild) steps. Both lists are sorted by i with padded
    slots at i = N (build_pair_list_ordered), so each new pair finds its
    old slot at the start of the old i-run plus `probes` j-comparisons
    (`probes` >= the broad phase's max neighbors per body bounds the run
    length). Unmatched (fresh) pairs start at 0.

    `old_starts` ((N+1,) from body_pair_starts on the OLD neighbor matrix)
    locates the runs with one gather; without it a vectorized searchsorted
    is used (fine for small lists; a serial probe chain at scale).

    `old_nmat` (the OLD NeighborMatrix the old pair list was compacted
    from, with `old_starts`) replaces the `probes`-deep probing loop —
    12 probes x 4 gathers over the full old list — with ONE (C_new, K)
    row gather of the old neighbor rows: the
    old slot of pair (i, j) is old_starts[i] + (count of valid old slots
    before j's lane), because build_pair_list_ordered compacts row-major.

    Values may carry trailing dims (e.g. (C, 3) tangential-displacement
    history for frictional DEM) — matched slots copy whole rows.
    """
    c_old = old_pairs.i.shape[0]
    if old_nmat is not None and old_starts is not None:
        n = old_starts.shape[0] - 1
        safe_i = jnp.minimum(new_pairs.i, n - 1)
        rows = old_nmat.idx[safe_i]  # (C_new, K) — one row gather
        rmask = old_nmat.mask[safe_i]
        match = (rmask & (rows == new_pairs.j[:, None])
                 & (new_pairs.mask & (new_pairs.i < n))[:, None])
        prefix = jnp.cumsum(rmask.astype(jnp.int32), axis=1) - rmask
        # last matching lane wins (= the probing loop's overwrite order;
        # only reachable if a row carries duplicate neighbor ids)
        t = jnp.max(jnp.where(match, prefix, -1), axis=1).astype(jnp.int32)
        slot = old_starts[safe_i] + jnp.maximum(t, 0)
        # pairs the old list truncated (overflow) carry no multiplier
        hit = (t >= 0) & (slot < c_old)
        vals = old_gamma[jnp.minimum(slot, c_old - 1)]
        hit_b = hit.reshape(hit.shape + (1,) * (old_gamma.ndim - 1))
        return jnp.where(hit_b, vals, jnp.zeros_like(vals))
    if old_starts is not None:
        n = old_starts.shape[0] - 1
        safe_i = jnp.minimum(new_pairs.i, n - 1)
        start = jnp.where(new_pairs.i < n, old_starts[safe_i],
                          c_old).astype(jnp.int32)
    else:
        n_mark = jnp.maximum(jnp.max(old_pairs.i), jnp.max(new_pairs.i)) + 1
        # padded slots must sort to the END regardless of the builder's pad
        # convention (build_pair_list pads i with 0, *_ordered with N)
        old_i = jnp.where(old_pairs.mask, old_pairs.i, n_mark)
        start = jnp.searchsorted(old_i, new_pairs.i).astype(jnp.int32)
    out = jnp.zeros(new_pairs.i.shape + old_gamma.shape[1:], old_gamma.dtype)
    for t in range(probes):
        idx = jnp.minimum(start + t, c_old - 1)
        hit = ((old_pairs.i[idx] == new_pairs.i)
               & (old_pairs.j[idx] == new_pairs.j)
               & old_pairs.mask[idx] & new_pairs.mask)
        hit_b = hit.reshape(hit.shape + (1,) * (old_gamma.ndim - 1))
        out = jnp.where(hit_b, old_gamma[idx], out)
    return out


def active_pair_subset(setup: CollisionSetup, margin, capacity: int,
                       n_bodies: int, seg_starts: Optional[Array] = None,
                       block_bodies: int = 0, window: int = 0):
    """Per-step active-set compaction: the near-contact subset
    (sep0 < margin) of a full skin-buffered constraint list.

    The skin-buffered pair list holds every pair within
    2r + buffer (+ skin drift), but complementarity pins gamma = 0 on any
    pair whose final separation stays positive — with margin safely above
    the per-step displacement scale, pairs beyond it provably carry zero
    multipliers, so the BBPGD iterations (whose gathers scale with slot
    count) need never see them. This is the reference's own semantics: it
    generates constraints only from the current-step search
    (`StkNgpLCP.cpp:468-510`), paying a per-step BVH instead of a skin.

    The compaction is ONE inverse-map scatter: active slot c writes its
    full-list index at output position cum[c]-1 (cumsum over the active
    mask). A searchsorted formulation (slot k = searchsorted(cum, k+1))
    was measured at 190 ms for 1M slots — a 21-probe binary-search gather
    storm — vs ~10 ms for the scatter (~8.6 ns/row). Order (i-sorted) is
    preserved either way, so the blocked segment machinery applies
    directly.

    Returns (setup_act, sel, n_act, overflow): `sel` (capacity,) int32 maps
    active slot -> full-list slot, padded past n_act with C (the full
    capacity — never a real slot when the full list itself has headroom);
    overflow = n_act > capacity.

    With `seg_starts` (the FULL list's per-block window starts, from
    segment_windows at rebuild) plus `block_bodies`/`window`, the active
    list's SegmentWindows are derived from the compaction cumsum itself
    (active window start of block b = number of active pairs before the
    full list's block start) and attached to the returned setup. This
    replaces a per-step searchsorted over the active ids that XLA lowers
    to a serial probe chain (measured 28-40 ms at 1M bodies vs ~0 for the
    977-element gather here).
    """
    pairs = setup.pairs
    c_full = pairs.i.shape[0]
    act = pairs.mask & (setup.sep0 < margin)
    cum = jnp.cumsum(act.astype(jnp.int32))
    n_act = cum[c_full - 1]
    # inactive slots and beyond-capacity actives land on the trimmed pad
    # position; active positions cum-1 are unique, so the scatter is
    # deterministic where it matters
    slots = jnp.where(act, jnp.minimum(cum - 1, capacity), capacity)
    sel = jnp.full((capacity + 1,), c_full, jnp.int32).at[slots].set(
        jnp.arange(c_full, dtype=jnp.int32))[:capacity]
    valid = sel < c_full
    sel_c = jnp.minimum(sel, c_full - 1)
    ai = jnp.where(valid, pairs.i[sel_c], n_bodies)
    aj = jnp.where(valid, pairs.j[sel_c], n_bodies)
    an = jnp.where(valid[:, None], setup.normals[sel_c], 0.0)
    as0 = jnp.where(valid, setup.sep0[sel_c], 1.0)
    apairs = PairList(i=ai, j=aj, mask=valid, num_pairs=n_act,
                      overflow=n_act > capacity)
    windows = None
    if seg_starts is not None:
        from mundy_tpu.ops.segments import SegmentWindows
        n_act_c = jnp.minimum(n_act, capacity)
        astarts = jnp.where(
            seg_starts > 0,
            jnp.minimum(cum[jnp.maximum(seg_starts - 1, 0)], n_act_c),
            0).astype(jnp.int32)
        counts = jnp.diff(jnp.append(astarts, n_act_c))
        windows = SegmentWindows(starts=astarts, block_bodies=block_bodies,
                                 window=window,
                                 overflow=jnp.any(counts > window))
    return (CollisionSetup(pairs=apairs, normals=an, sep0=as0,
                           windows=windows),
            jnp.where(valid, sel, c_full), n_act, n_act > capacity)


class StridedActive(NamedTuple):
    """active_pair_subset_strided result."""

    setup: CollisionSetup
    sel: Array  # (nb*W,) active slot -> full-list slot (pad = C)
    n_act: Array  # () int32 total active pairs (uncapped)
    block_max: Array  # () int32 largest uncapped per-block count
    overflow: Array  # () bool any block count > W
    cum: Array  # (C,) int32 inclusive active cumsum (next step's warm map)
    dual: Optional[Array] = None  # (A,) active slot of the (j,i) duplicate
    gamma0: Optional[Array] = None  # (A,) warm-start multipliers


def active_pair_subset_strided(setup: CollisionSetup, margin,
                               n_bodies: int, block_bodies: int, window: int,
                               full_starts: Array,
                               dual_full: Optional[Array] = None,
                               prev: Optional[tuple] = None,
                               gamma_full: Optional[Array] = None):
    """Per-step active-set compaction into the STRIDED layout: active pairs
    of body block b (bodies [b*B, (b+1)*B)) land at slots [b*W, b*W + c_b).

    Same complementarity argument as active_pair_subset (pairs beyond the
    margin provably carry zero multipliers), but block windows get STATIC
    offsets, so nothing is searched at rebuild (block b's window IS
    [b*W, (b+1)*W)). The
    cost is pad slots interspersed between blocks instead of one tail run;
    every consumer already masks by slot validity.

    `full_starts`: (nb,) int32, the FULL list's per-block window starts
    (segment_windows at rebuild).

    `dual_full` ((C,) from pair_dual_slots): also emit `dual`, the ACTIVE
    slot of each active pair's (j, i) duplicate — in-margin is a symmetric
    property (same sep0 both directions), so the dual of an active pair is
    always active; its slot follows from this step's cumsum, no extra
    scatter. Duals whose block overflowed W fall back to self (that state
    is already flagged by `overflow`).

    `prev` ((prev_cum, prev_gamma, prev_window)): also emit `gamma0`, last
    step's multiplier for every persisting active pair, via gathers into
    last step's cumsum — the inverse-scatter map this replaces cost 44 ms
    at 1M bodies (one (C,) scatter/step); three (A,) gathers cost ~10 ms.
    Pairs entering the set fall back to `gamma_full` (the rebuild-time
    full-list snapshot) when given, else 0.
    """
    from mundy_tpu.ops.segments import StridedWindows

    pairs = setup.pairs
    c_full = pairs.i.shape[0]
    B, W = block_bodies, window
    nb = full_starts.shape[0]
    dtype = setup.sep0.dtype
    # the packed-f32 columns below carry ids/cumsums exactly only below the
    # f32 integer ceiling (shapes are static, so this is a build-time check)
    assert c_full < (1 << 24) and n_bodies < (1 << 24), \
        "packed compaction carries ids in f32 (exact below 2^24)"
    act = pairs.mask & (setup.sep0 < margin)
    cum = jnp.cumsum(act.astype(jnp.int32))  # inclusive
    n_act = cum[c_full - 1]
    # actives before each block's full window start
    base = jnp.where(full_starts > 0,
                     cum[jnp.maximum(full_starts - 1, 0)], 0)
    ends = jnp.append(full_starts[1:], jnp.asarray(c_full, jnp.int32))
    counts = jnp.where(ends > 0, cum[jnp.maximum(ends - 1, 0)], 0) - base
    block_max = jnp.max(counts)
    overflow = block_max > W
    bid = jnp.minimum(pairs.i // B, nb - 1)
    rank = cum - 1 - base[bid]
    ok = act & (rank < W)
    slot = jnp.where(ok, bid * W + rank, nb * W)
    sel = jnp.full((nb * W + 1,), c_full, jnp.int32).at[slot].set(
        jnp.arange(c_full, dtype=jnp.int32), mode="drop")[:nb * W]
    valid = sel < c_full
    sel_c = jnp.minimum(sel, c_full - 1)

    # ONE packed row gather for every per-full-slot column (ids, normals,
    # sep0, dual slot, warm-start cumsums, entry multipliers). The column-
    # at-a-time formulation pays ~9 separate (A,)-row gathers from loop-
    # carried arrays (the "pack params, gather once" rule).
    cols = [pairs.i.astype(dtype), pairs.j.astype(dtype),
            setup.normals[:, 0], setup.normals[:, 1], setup.normals[:, 2],
            setup.sep0]
    n_base = len(cols)
    c_dual = c_prev = c_gf = None
    if dual_full is not None:
        c_dual = len(cols)
        cols.append(dual_full.astype(dtype))
    if prev is not None:
        prev_cum, prev_gamma, w_old = prev
        c_prev = len(cols)
        cols.append(prev_cum.astype(dtype))
        # exclusive prev cumsum as its own column: replaces the second
        # (sel_c - 1)-indexed gather the was-active test used to pay
        cols.append(jnp.concatenate([jnp.zeros((1,), dtype),
                                     prev_cum[:-1].astype(dtype)]))
        if gamma_full is not None:
            c_gf = len(cols)
            cols.append(gamma_full)
    packed = jnp.stack(cols, axis=1)  # (C, ncols)
    g = packed[sel_c]  # (A, ncols) — the one gather

    ai = jnp.where(valid, g[:, 0].astype(jnp.int32), n_bodies)
    aj = jnp.where(valid, g[:, 1].astype(jnp.int32), n_bodies)
    an = jnp.where(valid[:, None], g[:, 2:5], 0.0)
    as0 = jnp.where(valid, g[:, 5], 1.0)
    apairs = PairList(i=ai, j=aj, mask=valid, num_pairs=n_act,
                      overflow=overflow)
    windows = StridedWindows(block_bodies=B, window=W, nb=nb,
                             overflow=overflow)
    setup_act = CollisionSetup(pairs=apairs, normals=an, sep0=as0,
                               windows=windows)

    dual = None
    if dual_full is not None:
        d = jnp.minimum(g[:, c_dual].astype(jnp.int32), c_full - 1)
        bid_j = jnp.minimum(jnp.minimum(aj, n_bodies - 1) // B, nb - 1)
        rank_j = cum[d] - 1 - base[bid_j]
        self_slot = jnp.arange(nb * W, dtype=jnp.int32)
        dual = jnp.where(valid & (rank_j >= 0) & (rank_j < W),
                         bid_j * W + rank_j, self_slot)

    gamma0 = None
    if prev is not None:
        a_old = prev_gamma.shape[0]
        base_old = jnp.where(full_starts > 0,
                             prev_cum[jnp.maximum(full_starts - 1, 0)], 0)
        pc = g[:, c_prev].astype(jnp.int32)
        was_act = pc > g[:, c_prev + 1].astype(jnp.int32)
        # block of active slot p is p // W by construction of the strided
        # layout — an explicit repeat, not a bid[sel_c] gather
        bid_a = jnp.repeat(jnp.arange(nb, dtype=jnp.int32), W)
        rank_old = pc - 1 - jnp.repeat(base_old, W)
        slot_old = jnp.minimum(bid_a * w_old + rank_old, a_old - 1)
        hit = valid & was_act & (rank_old >= 0) & (rank_old < w_old)
        g_entry = (g[:, c_gf] if c_gf is not None else 0.0)
        gamma0 = jnp.where(hit, prev_gamma[jnp.maximum(slot_old, 0)],
                           jnp.where(valid, g_entry, 0.0))

    return StridedActive(setup=setup_act, sel=sel, n_act=n_act,
                         block_max=block_max, overflow=overflow, cum=cum,
                         dual=dual, gamma0=gamma0)


def pair_dual_slots(pairs: PairList, starts: Array, nmat,
                    near: Optional[Array] = None) -> tuple:
    """Full-list slot of each pair's (j, i) duplicate -> ((C,) int32, missing).

    The ordered layout stores every contact twice; the dual slot is what
    lets a scalar-mobility Delassus apply run block-local:
    sdot_p = c_i t_p + c_j t_{dual(p)} (ops/segments.strided_t). Same
    one-row-gather construction as remap_gamma: (j, i) sits at
    starts[j] + rank of i within j's neighbor row (build_pair_list_ordered
    compacts nmat row-major). `missing` flags asymmetric rows — fold it
    into overflow; the dual of a missing pair points at the pair itself
    with the safe consequence that its j-side contribution reads its own t.

    `near` ((C,) bool): restrict `missing` to pairs the flag can actually
    matter for. Asymmetry has two causes: (a) a TRUNCATED neighbor row
    dropped one direction (real overflow — but that also raises the
    broad phase's own K-overflow flag), and (b) a pair within ~1 ulp of
    the search radius whose two directions round the cutoff test
    differently (the 9-stencil candidate planes pre-shift coordinates for
    min-image, so (i, j) and (j, i) evaluate r^2 with different
    roundings). Case (b) is physically irrelevant — the pair sits at the
    FULL skin-buffer separation, provably outside every active margin
    until the next skin-triggered rebuild — yet at 1M bodies it raises
    the sticky overflow within ~10 steps of any window. Callers pass near = (gap < buffer/2) at rebuild
    positions so only contact-capable asymmetry trips the flag.
    """
    n = starts.shape[0] - 1
    c_full = pairs.i.shape[0]
    safe_j = jnp.minimum(pairs.j, n - 1)
    rows = nmat.idx[safe_j]  # (C, K) one row gather
    rmask = nmat.mask[safe_j]
    live = pairs.mask & (pairs.j < n)
    match = rmask & (rows == pairs.i[:, None]) & live[:, None]
    prefix = jnp.cumsum(rmask.astype(jnp.int32), axis=1) - rmask
    t = jnp.max(jnp.where(match, prefix, -1), axis=1).astype(jnp.int32)
    slot = starts[safe_j] + jnp.maximum(t, 0)
    hit = (t >= 0) & (slot < c_full)
    self_slot = jnp.arange(c_full, dtype=jnp.int32)
    dual = jnp.where(hit, slot, self_slot)
    relevant = live if near is None else (live & near)
    missing = jnp.any(relevant & ~hit)
    return dual, missing


def pair_j_permutation(pairs: PairList, n_bodies: int) -> Array:
    """Rebuild-time permutation sorting pairs by j (padded slots last)."""
    key = jnp.where(pairs.mask, pairs.j, n_bodies)
    return jnp.argsort(key).astype(jnp.int32)


def collision_setup_spheres(
    pos: Array,
    radius: Array,
    pairs: PairList,
    metric: Optional[Metric] = None,
    j_perm: Optional[Array] = None,
    windows: Optional[object] = None,
) -> CollisionSetup:
    """Signed separation + contact normal per pair.

    VECTOR gathers on purpose: one (C, 3) row gather instead of three
    scalar-plane gathers (gather cost is mostly per ROW, not per
    element). Component planes are only for BILLION-slot
    candidate tables where the (M, 3) intermediate's 42x lane padding
    out-sizes HBM (chromatin KMC) — that is a memory rule, not a speed
    rule. Orthorhombic boxes still skip the metric's fractional-coordinate
    einsum for a per-component min image.

    ref: compute_signed_separation_distance_and_contact_normal
    (`StkNgpLCP.cpp:468-510`).
    """
    from mundy_tpu.neighbor.rows import orthorhombic_lengths

    box = None if metric is None else orthorhombic_lengths(metric)
    pi = pos[pairs.i]
    pj = pos[pairs.j]
    if metric is None or box is not None:
        sep = pj - pi
        if box is not None:
            lens, flags = box
            shift = jnp.asarray([l if f else 0.0 for l, f in
                                 zip(lens, flags)], pos.dtype)
            safe = jnp.where(shift > 0, shift, 1.0)
            sep = sep - shift * jnp.round(sep / safe)
        d2 = jnp.maximum(jnp.sum(sep * sep, axis=-1), 1e-24)
        rinv = jax.lax.rsqrt(d2) if d2.dtype == jnp.float32 else d2 ** -0.5
        d = d2 * rinv
        normals = sep * rinv[..., None]
    else:
        sep = metric.sep(pi, pj)
        d = jnp.sqrt(jnp.maximum(jnp.sum(sep * sep, axis=-1), 1e-24))
        normals = sep / d[..., None]
    radius = jnp.asarray(radius, pos.dtype)
    if radius.ndim == 0:
        # monodisperse: NO radius gathers. XLA cannot fold
        # broadcast(scalar)[carried_idx] when the indices live in a loop
        # carry (with compile-time-constant indices they fold to a splat
        # and cost nothing, which hides the cost in microbenches).
        sep0 = d - 2.0 * radius
    else:
        radius = jnp.broadcast_to(radius, pos.shape[:1])
        sep0 = d - radius[pairs.i] - radius[pairs.j]
    return CollisionSetup(pairs=pairs, normals=normals, sep0=sep0,
                          j_perm=j_perm, windows=windows)


def collision_forces(setup: CollisionSetup, gamma: Array, n_bodies: int) -> Array:
    """F = D gamma: -gamma*n to body i, +gamma*n to body j.

    ref: sum_collision_force (`StkNgpLCP.cpp:578-610`). With `j_perm` both
    sides run as sorted segment-sums (build_pair_list emits pairs already
    sorted by i; padded ids map to the dropped segment n_bodies); without it
    fall back to index-add scatters.
    """
    g = jnp.where(setup.pairs.mask, gamma, 0.0)
    gn = g[:, None] * setup.normals
    if setup.windows is not None:
        # ordered layout: pair (i, j) pushes -gamma n on i only; the (j, i)
        # duplicate delivers +gamma n to j. One blocked segmented reduction.
        from mundy_tpu.ops.segments import (StridedWindows,
                                            segment_sum_sorted_blocked,
                                            segment_sum_strided)
        if isinstance(setup.windows, StridedWindows):
            return segment_sum_strided(-gn, setup.pairs.i, n_bodies,
                                       setup.windows)
        return segment_sum_sorted_blocked(-gn, setup.pairs.i, n_bodies,
                                          setup.windows)
    if setup.j_perm is not None:
        i_ids = jnp.where(setup.pairs.mask, setup.pairs.i, n_bodies)
        f_i = jax.ops.segment_sum(gn, i_ids, num_segments=n_bodies,
                                  indices_are_sorted=True)
        jp = setup.j_perm
        j_ids = jnp.where(setup.pairs.mask[jp], setup.pairs.j[jp], n_bodies)
        f_j = jax.ops.segment_sum(gn[jp], j_ids, num_segments=n_bodies,
                                  indices_are_sorted=True)
        return f_j - f_i
    f = jnp.zeros((n_bodies, 3), gn.dtype)
    f = f.at[setup.pairs.i].add(-gn)
    f = f.at[setup.pairs.j].add(gn)
    return f


def _sep_rate(setup: CollisionSetup, vel: Array) -> Array:
    """sdot = D^T U = -n . (U_i - U_j).

    Vector gathers on purpose — this runs once per BBPGD iteration, and
    one (C, 3) gather instead of three scalar-plane gathers (gather cost
    is mostly per ROW, not per element; see collision_setup_spheres).

    ref: compute_rate_of_change_of_sep (`StkNgpLCP.cpp:635-668`).
    """
    dv = vel[setup.pairs.i] - vel[setup.pairs.j]
    return -jnp.sum(setup.normals * dv, axis=-1)


def make_local_drag_apply(setup: CollisionSetup, dual: Array, n_bodies: int,
                          dt, mobility_i=None, mobility_j=None):
    """Block-local Delassus apply for SCALAR (local-drag) mobility.

    With the ordered layout F_i is entirely block-local (every pair (i, j)
    pushes only on i; the (j, i) duplicate handles j), and the j-side of
    sdot is the dual pair's i-side:
        sdot_p = -n_p.(U_i - U_j) = c_i t_p + c_j t_{dual(p)},
        t_q = -n_q . F_{i(q)}.
    ops/segments.strided_t computes t (block-local assembly + one row
    gather, no global (A, 3) velocity gathers) and one (A,) scalar gather
    crosses blocks.

    `mobility_i`/`mobility_j`: per-pair drag mobilities c_{i(p)}, c_{j(p)}
    ((A,) arrays for polydisperse radii) or scalars; both default 1 (fold
    the constant into dt for monodisperse).

    ref: fuses `StkNgpLCP.cpp:578-668` (sum_collision_force +
    compute_the_mobility_problem + compute_rate_of_change_of_sep) for the
    dry local-drag mobility.
    """
    from mundy_tpu.ops.segments import strided_t

    windows = setup.windows
    n_slots = setup.pairs.i.shape[0]
    ci = 1.0 if mobility_i is None else mobility_i
    cj = 1.0 if mobility_j is None else mobility_j
    dt = jnp.asarray(dt, setup.sep0.dtype)

    def apply_A(gamma):
        g = jnp.where(setup.pairs.mask, gamma, 0.0)
        t = strided_t(g, setup.normals, setup.pairs.i, n_bodies, windows)
        td = t[jnp.minimum(dual, n_slots - 1)]
        return dt * (ci * t + cj * td)

    return apply_A


def assemble_block_delassus(setup: CollisionSetup) -> Array:
    """(nb, W, W) i-side Delassus diagonal blocks on the strided layout:

        M[b, p, q] = (i_p == i_q) * (n_p . n_q)      (block-local slots p, q)

    The active set is FIXED across a solve's iterations, so assembling M
    once per step turns every BBPGD iteration's i-side half-apply into a
    bandwidth-bound batched matvec (read nb*W^2 f32 ~ 1 GB at 1M bodies)
    instead of a one-hot assembly chain of skinny (3, W) x (W, B)
    products per iteration. The j-side coupling
    stays a dual-slot gather (make_block_delassus_apply).

    Pure elementwise construction (broadcast compares + 3 FMA per element,
    f32 exact — no matmul, no bf16): XLA fuses it into the single (nb, W, W)
    output write. Invalid slots (mask off / id outside the block) zero
    their row and column; the diagonal carries |n_p|^2 = 1, pair p's own
    contribution to F_{i(p)} — identical semantics to strided_t.

    ref: the assembled form of `sum_collision_force` +
    `compute_rate_of_change_of_sep` (`scrap/lcp_spheres/StkNgpLCP.cpp:578,
    635`) restricted to one body block; the reference keeps it
    matrix-free, here the rebuild-once/apply-many trade favors assembly.
    """
    from mundy_tpu.ops.segments import StridedWindows

    windows = setup.windows
    assert isinstance(windows, StridedWindows)
    B, W, nb = windows.block_bodies, windows.window, windows.nb
    ids = setup.pairs.i.reshape(nb, W)
    blk = jnp.arange(nb, dtype=jnp.int32)[:, None] * B
    loc = ids - blk
    valid = setup.pairs.mask.reshape(nb, W) & (loc >= 0) & (loc < B)
    locv = jnp.where(valid, loc, -1)
    eq = ((locv[:, :, None] == locv[:, None, :])
          & valid[:, :, None] & valid[:, None, :])
    nrm = setup.normals.reshape(nb, W, 3)
    dots = (nrm[:, :, None, 0] * nrm[:, None, :, 0]
            + nrm[:, :, None, 1] * nrm[:, None, :, 1]
            + nrm[:, :, None, 2] * nrm[:, None, :, 2])
    return jnp.where(eq, dots, 0.0)


def assemble_band_delassus(setup: CollisionSetup, k_band: int) -> Array:
    """(k_band-1, A) i-side Delassus BAND: band[d-1, p] = M[p, p+d] =
    (i_p == i_{p+d}) * (n_p . n_{p+d}).

    The active list is i-sorted (the strided compaction preserves the
    rebuild order), so every body's active pairs form a CONTIGUOUS run —
    M[p, q] = (i_p == i_q) n_p.n_q is nonzero only for |p - q| < run
    length <= k_band (the broad phase's per-body neighbor cap bounds the
    run structurally: the pair list is compacted from a (N, K) neighbor
    matrix). The dense (nb, W, W) block form reads nb*W^2 f32 ~ 1.6 GB
    per BBPGD iteration at 1M bodies for ~7 nonzeros per row; the band
    reads (k_band-1)*A ~ 40 MB — ~40x less traffic for the identical
    operator.

    Wrap-around of the shifts is harmless by construction: rolled-in
    slots are either pads (zero normals -> zero band entry) or belong to
    a different body block (ids never match).

    ref: the banded form of `sum_collision_force` +
    `compute_rate_of_change_of_sep` (`scrap/lcp_spheres/StkNgpLCP.cpp:578,
    635`) restricted to one body's contiguous constraint run.
    """
    ids = setup.pairs.i
    n = setup.normals
    nx, ny, nz = n[:, 0], n[:, 1], n[:, 2]
    rows = []
    for d in range(1, k_band):
        same = ids == jnp.roll(ids, -d)
        dots = (nx * jnp.roll(nx, -d) + ny * jnp.roll(ny, -d)
                + nz * jnp.roll(nz, -d))
        rows.append(jnp.where(same, dots, 0.0))
    return jnp.stack(rows, axis=0)


def make_band_delassus_apply(setup: CollisionSetup, dual: Array,
                             dt, k_band: int,
                             mobility_i=None, mobility_j=None):
    """Delassus apply via the banded i-side matrix (scalar mobility).

    u = M g runs as 2*(k_band-1) shifted fused multiply-adds over the
    flat (A,) active list (the diagonal is exactly 1: |n_p|^2, and padded
    slots carry zero g); the j-side stays the dual-slot gather:
        (A gamma)_p = dt * (c_i u_p + c_j u_{dual(p)}).
    Per iteration ~0.4 ms of band traffic + one (A,) gather — vs ~6.5 ms
    for the dense per-block GEMV at 1M bodies (same operator, same
    results to f32 rounding).
    """
    n_slots = setup.pairs.i.shape[0]
    band = assemble_band_delassus(setup, k_band)
    ci = 1.0 if mobility_i is None else mobility_i
    cj = 1.0 if mobility_j is None else mobility_j
    dt = jnp.asarray(dt, setup.sep0.dtype)
    dual_c = jnp.minimum(dual, n_slots - 1)

    def apply_A(gamma):
        g = jnp.where(setup.pairs.mask, gamma, 0.0)
        u = g
        for d in range(1, k_band):
            bd = band[d - 1]
            u = u + bd * jnp.roll(g, -d) + jnp.roll(bd * g, d)
        return dt * (ci * u + cj * u[dual_c])

    return apply_A


def make_block_delassus_apply(setup: CollisionSetup, dual: Array,
                              dt, mobility_i=None, mobility_j=None):
    """Delassus apply via precomputed per-block matrices (scalar mobility).

    u = blockdiag(M) gamma gives the i-side half-apply (u_p = t_p of
    strided_t); the j-side is the dual pair's value:
        (A gamma)_p = dt * (c_i u_p + c_j u_{dual(p)}).
    Per iteration: one batched GEMV (HIGHEST precision — the bf16 default
    would put the ~2^-8 operator noise right at the BBPGD residual floor)
    + one (A,) gather. ~2x per-iteration over the one-hot kernel path at
    1M bodies.
    """
    from mundy_tpu.ops.segments import StridedWindows

    windows = setup.windows
    assert isinstance(windows, StridedWindows)
    W, nb = windows.window, windows.nb
    n_slots = nb * W
    M = assemble_block_delassus(setup)
    ci = 1.0 if mobility_i is None else mobility_i
    cj = 1.0 if mobility_j is None else mobility_j
    dt = jnp.asarray(dt, setup.sep0.dtype)
    dual_c = jnp.minimum(dual, n_slots - 1)

    def apply_A(gamma):
        g = jnp.where(setup.pairs.mask, gamma, 0.0)
        u = jnp.einsum("bpq,bq->bp", M, g.reshape(nb, W),
                       precision=jax.lax.Precision.HIGHEST)
        u = u.reshape(n_slots)
        return dt * (ci * u + cj * u[dual_c])

    return apply_A


def resolve_collisions(
    setup: CollisionSetup,
    mobility_apply: Callable[[Array], Array],
    n_bodies: int,
    dt,
    max_allowable_overlap: float = 1e-5,
    max_iterations: int = 10_000,
    gamma0: Optional[Array] = None,
    axis_names=None,
    u_ext: Optional[Array] = None,
    alpha0: Optional[Array] = None,
    apply_override: Optional[Callable[[Array], Array]] = None,
) -> tuple[Array, Array, SolveResult]:
    """Solve for contact impulses gamma; returns (gamma, velocities, result).

    `mobility_apply(F) -> U` is any matrix-free mobility (local drag, RPY
    neighbors, dense RPY, periphery-corrected...). Defaults mirror the
    reference driver: tol 1e-5 overlap, 10k iteration cap, alternating BB
    steps, warm start from `gamma0` (`StkNgpLCP.cpp` main params, `:705-875`).

    `u_ext` (n_bodies, 3): KNOWN velocities the step will apply alongside
    the constraint response (Brownian drift, background flow, external
    forces through the mobility). They enter the LCP's constant term
    q = sep0 + dt * D^T u_ext, so the solve enforces non-penetration of the
    ACTUAL end-of-step configuration. Omitting a nonzero drift here lets it
    re-penetrate pairs after every solve — overlap then stalls at the
    per-step drift scale instead of max_allowable_overlap. The returned
    velocity does NOT include u_ext (it is the constraint response M D
    gamma only; the caller adds its drift exactly once).

    `apply_override` replaces the default D^T M D chain with a fused
    Delassus apply (e.g. make_local_drag_apply's block-local kernel path);
    the final velocity still goes through `mobility_apply` once.
    """
    dt = jnp.asarray(dt, setup.sep0.dtype)

    if apply_override is not None:
        apply_A = apply_override
    else:
        def apply_A(gamma):
            f = collision_forces(setup, gamma, n_bodies)
            u = mobility_apply(f)
            return dt * _sep_rate(setup, u)

    q = setup.sep0
    if u_ext is not None:
        q = q + dt * _sep_rate(setup, u_ext)
    cfg = PGDConfig(
        max_iters=max_iterations,
        tol=max_allowable_overlap,
        bb_rule="alternating",
        residual="projected_gradient",
        axis_names=axis_names,
    )
    res = solve_lcp(apply_A, q, x0=gamma0, config=cfg, mask=setup.pairs.mask,
                    alpha0=alpha0)
    gamma = res.x
    vel = mobility_apply(collision_forces(setup, gamma, n_bodies))
    return gamma, vel, res
