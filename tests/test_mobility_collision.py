"""RPY mobility + LCP collision resolution vs analytic/dense references."""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from mundy_tpu.constraints import (
    collision_forces,
    collision_setup_spheres,
    resolve_collisions,
)
from mundy_tpu.mobility import (
    local_drag_mobility,
    rpy_apply_dense,
    rpy_apply_neighbors,
    rpy_self_mobility,
)
from mundy_tpu.neighbor import NeighborMatrix, PairList


def rpy_matrix_np(pos, a, mu):
    """Dense far-field RPY matrix (numpy reference, no overlap correction)."""
    n = len(pos)
    M = np.zeros((3 * n, 3 * n))
    for i in range(n):
        M[3 * i:3 * i + 3, 3 * i:3 * i + 3] = np.eye(3) / (6 * np.pi * mu * a)
        for j in range(n):
            if i == j:
                continue
            r = pos[i] - pos[j]
            rn = np.linalg.norm(r)
            rh = np.outer(r, r) / rn**2
            blk = (np.eye(3) + rh) / rn + (2 * a**2 / (3 * rn**3)) * (np.eye(3) - 3 * rh)
            M[3 * i:3 * i + 3, 3 * j:3 * j + 3] = blk / (8 * np.pi * mu)
    return M


def test_rpy_dense_matches_matrix(rng):
    n = 20
    a, mu = 0.5, 1.3
    pos = rng.uniform(0, 10, (n, 3))
    # enforce min separation > 2a so far-field formula is exact
    f = rng.normal(size=(n, 3))
    M = rpy_matrix_np(pos, a, mu)
    expect = (M @ f.ravel()).reshape(n, 3)
    got = rpy_apply_dense(jnp.asarray(pos), jnp.asarray(f), a, mu, chunk=8)
    np.testing.assert_allclose(np.asarray(got), expect, rtol=1e-10)


def test_rpy_positive_definite_sampling(rng):
    """Far-field RPY with self term must be SPD for well-separated spheres
    (needed for BBPGD convergence)."""
    n = 15
    a, mu = 0.4, 1.0
    # grid positions, spacing 3 > 2a
    g = np.stack(np.meshgrid(*[np.arange(3) * 3.0] * 3, indexing="ij"), -1).reshape(-1, 3)[:n]
    M = rpy_matrix_np(g, a, mu)
    w = np.linalg.eigvalsh(M)
    assert w.min() > 0


def test_rpy_symmetry(rng):
    """Pairwise: velocity at i from force at j mirrors j from i."""
    a, mu = 0.5, 1.0
    pos = jnp.asarray([[0.0, 0, 0], [3.0, 0, 0]])
    f = jnp.asarray([[0.0, 1.0, 0], [0.0, 0, 0]])
    u = rpy_apply_dense(pos, f, a, mu, include_self=False, chunk=2)
    f2 = jnp.asarray([[0.0, 0, 0], [0.0, 1.0, 0]])
    u2 = rpy_apply_dense(pos, f2, a, mu, include_self=False, chunk=2)
    np.testing.assert_allclose(np.asarray(u[1]), np.asarray(u2[0]), atol=1e-14)


def test_rpy_neighbors_matches_dense_for_full_graph(rng):
    n = 12
    a, mu = 0.3, 0.7
    pos = jnp.asarray(rng.uniform(0, 8, (n, 3)))
    f = jnp.asarray(rng.normal(size=(n, 3)))
    # full neighbor matrix (everyone neighbors everyone)
    idx = jnp.asarray([[j for j in range(n) if j != i] for i in range(n)], jnp.int32)
    mask = jnp.ones((n, n - 1), bool)
    nmat = NeighborMatrix(idx=idx, mask=mask, overflow=jnp.asarray(False))
    dense = rpy_apply_dense(pos, f, a, mu, chunk=4)
    nb = rpy_apply_neighbors(pos, f, nmat, a, mu)
    np.testing.assert_allclose(np.asarray(nb), np.asarray(dense), rtol=1e-10)


def test_rpy_overlap_correction_finite():
    pos = jnp.asarray([[0.0, 0, 0], [0.1, 0, 0]])
    f = jnp.asarray([[1.0, 0, 0], [0.0, 0, 0]])
    u = rpy_apply_dense(pos, f, 0.5, 1.0, overlap_correction=True, chunk=2)
    assert np.isfinite(np.asarray(u)).all()
    # at r -> 0 the pair mobility approaches the self mobility
    pos2 = jnp.asarray([[0.0, 0, 0], [1e-8, 0, 0]])
    u2 = rpy_apply_dense(pos2, f, 0.5, 1.0, include_self=False, overlap_correction=True, chunk=2)
    self_u = rpy_self_mobility(f[0], 0.5, 1.0)
    np.testing.assert_allclose(np.asarray(u2[1]), np.asarray(self_u), rtol=1e-5)


# ---------------------------------------------------------------- collision
def make_pairs(i, j, capacity):
    n = len(i)
    pad = capacity - n
    return PairList(
        i=jnp.asarray(list(i) + [0] * pad, jnp.int32),
        j=jnp.asarray(list(j) + [0] * pad, jnp.int32),
        mask=jnp.asarray([True] * n + [False] * pad),
        num_pairs=jnp.asarray(n),
        overflow=jnp.asarray(False),
    )


def test_two_sphere_collision_analytic():
    """Two overlapping spheres, local drag: gamma resolves overlap in one dt."""
    pos = jnp.asarray([[0.0, 0, 0], [1.5, 0, 0]], jnp.float64)
    radius = 1.0
    mu = 1.0
    dt = 0.1
    pairs = make_pairs([0], [1], 4)
    setup = collision_setup_spheres(pos, jnp.asarray(radius), pairs)
    np.testing.assert_allclose(float(setup.sep0[0]), -0.5)

    mob = lambda f: local_drag_mobility(f, radius, mu)
    gamma, vel, res = resolve_collisions(setup, mob, 2, dt, max_allowable_overlap=1e-8)
    assert bool(res.converged)
    # analytic: sep_new = sep0 + dt * 2 * gamma/(6 pi mu a) = 0
    m = 1.0 / (6 * math.pi * mu * radius)
    gamma_exact = 0.5 / (dt * 2 * m)
    np.testing.assert_allclose(float(gamma[0]), gamma_exact, rtol=1e-6)
    # velocities push spheres apart along x
    assert float(vel[0, 0]) < 0 < float(vel[1, 0])
    # and the post-step separation is (near) zero
    new_sep = float(setup.sep0[0] + dt * (-(vel[0, 0] - vel[1, 0]) * -1.0))
    pos_new = pos + dt * vel
    d = float(jnp.linalg.norm(pos_new[1] - pos_new[0])) - 2 * radius
    assert abs(d) < 1e-6


def test_separated_pair_no_force():
    pos = jnp.asarray([[0.0, 0, 0], [3.0, 0, 0]], jnp.float64)
    pairs = make_pairs([0], [1], 4)
    setup = collision_setup_spheres(pos, jnp.asarray(1.0), pairs)
    mob = lambda f: local_drag_mobility(f, 1.0, 1.0)
    gamma, vel, res = resolve_collisions(setup, mob, 2, 0.1)
    assert bool(res.converged)
    assert int(res.num_iters) == 0
    np.testing.assert_allclose(np.asarray(gamma), 0.0, atol=1e-14)


def test_cluster_collision_resolves(rng):
    """Dense random cluster: after the solve, linearized overlaps < tol."""
    n = 40
    pos = jnp.asarray(rng.uniform(0, 4.0, (n, 3)))
    radius = 0.5
    dt = 0.05
    ii, jj = np.triu_indices(n, 1)
    d = np.linalg.norm(np.asarray(pos)[ii] - np.asarray(pos)[jj], axis=1)
    keep = d < 2.5 * radius
    pairs = make_pairs(ii[keep], jj[keep], 2048)
    setup = collision_setup_spheres(pos, jnp.asarray(radius), pairs)
    mob = lambda f: local_drag_mobility(f, radius, 1.0)
    gamma, vel, res = resolve_collisions(setup, mob, n, dt, max_allowable_overlap=1e-6)
    assert bool(res.converged)
    pos_new = pos + dt * vel
    dd = np.linalg.norm(np.asarray(pos_new)[ii[keep]] - np.asarray(pos_new)[jj[keep]], axis=1)
    overlap = 2 * radius - dd
    assert overlap.max() < 1e-3  # linearization error only
    assert float(jnp.min(gamma)) >= 0.0


def test_collision_with_rpy_mobility(rng):
    """Hydrodynamic coupling: solver still converges with RPY mobility."""
    n = 10
    pos = jnp.asarray(rng.uniform(0, 2.5, (n, 3)), jnp.float64)
    radius = 0.5
    ii, jj = np.triu_indices(n, 1)
    pairs = make_pairs(ii, jj, 64)
    setup = collision_setup_spheres(pos, jnp.asarray(radius), pairs)
    mob = lambda f: rpy_apply_dense(pos, f, radius, 1.0, chunk=4,
                                    overlap_correction=True)
    gamma, vel, res = resolve_collisions(setup, mob, n, 0.05, max_allowable_overlap=1e-6)
    assert bool(res.converged)
    assert float(jnp.min(gamma)) >= 0.0


def test_collision_forces_momentum_free():
    pos = jnp.asarray([[0.0, 0, 0], [1.0, 0, 0], [0.5, 0.8, 0]])
    pairs = make_pairs([0, 0, 1], [1, 2, 2], 8)
    setup = collision_setup_spheres(pos, jnp.asarray(0.6), pairs)
    f = collision_forces(setup, jnp.asarray([1.0, 2.0, 3.0] + [0.0] * 5), 3)
    np.testing.assert_allclose(np.asarray(f).sum(axis=0), np.zeros(3), atol=1e-12)


def test_remap_gamma_by_pair_identity():
    """Warm-start multipliers must follow (i, j) identity across a rebuild
    that re-sorts the pair list; fresh pairs start at 0 (VERDICT weak #5)."""
    from mundy_tpu.constraints import remap_gamma
    from mundy_tpu.neighbor import PairList

    n = 6

    def plist(ij, cap):
        ij = sorted(ij)
        i = [a for a, b in ij] + [n] * (cap - len(ij))
        j = [b for a, b in ij] + [n] * (cap - len(ij))
        m = [True] * len(ij) + [False] * (cap - len(ij))
        return PairList(i=jnp.asarray(i, jnp.int32), j=jnp.asarray(j, jnp.int32),
                        mask=jnp.asarray(m), num_pairs=jnp.asarray(len(ij)),
                        overflow=jnp.asarray(False))

    # ordered-duplicate layout: each contact in both directions
    old_contacts = [(0, 1), (1, 0), (0, 3), (3, 0), (2, 4), (4, 2), (4, 5), (5, 4)]
    old = plist(old_contacts, 12)
    gamma_old = jnp.asarray([10.0 * a + b for a, b in sorted(old_contacts)]
                            + [0.0] * 4)
    # after "rebuild": (0,3) gone, (1,2) fresh, rest persist at new slots
    new_contacts = [(0, 1), (1, 0), (1, 2), (2, 1), (2, 4), (4, 2), (4, 5), (5, 4)]
    new = plist(new_contacts, 10)
    out = np.asarray(remap_gamma(old, gamma_old, new, probes=4))
    expect = {(0, 1): 1.0, (1, 0): 10.0, (1, 2): 0.0, (2, 1): 0.0,
              (2, 4): 24.0, (4, 2): 42.0, (4, 5): 45.0, (5, 4): 54.0}
    for slot, (a, b) in enumerate(sorted(new_contacts)):
        assert out[slot] == expect[(a, b)], (a, b, out[slot])
    assert (out[len(new_contacts):] == 0).all()


def test_active_pair_subset_matches_mask(rng):
    """The scatter-based compaction must select EXACTLY the in-margin pairs,
    in i-sorted order, and flag overflow when they exceed the capacity."""
    from mundy_tpu.constraints.collision import active_pair_subset
    from mundy_tpu.constraints import collision_setup_spheres

    n, c_full = 200, 256
    pos = jnp.asarray(rng.uniform(0, 10, (n, 3)))
    i = np.sort(rng.integers(0, n, c_full)).astype(np.int32)
    j = rng.integers(0, n, c_full).astype(np.int32)
    mask = rng.uniform(size=c_full) < 0.8
    pairs = PairList(i=jnp.asarray(np.where(mask, i, n)),
                     j=jnp.asarray(np.where(mask, j, n)),
                     mask=jnp.asarray(mask),
                     num_pairs=jnp.asarray(int(mask.sum())),
                     overflow=jnp.asarray(False))
    setup = collision_setup_spheres(pos, jnp.asarray(0.5), pairs)
    margin = jnp.asarray(2.0)
    want = np.nonzero(mask & (np.asarray(setup.sep0) < 2.0))[0]

    for cap in (int(len(want)) + 8, max(int(len(want)) - 4, 1)):
        sub, sel, n_act, ovf = active_pair_subset(setup, margin, cap, n)
        assert int(n_act) == len(want)
        if cap >= len(want):
            assert not bool(ovf)
            got = np.asarray(sel)[: len(want)]
            assert (got == want).all()  # exact set, i-sorted order
            assert (np.asarray(sel)[len(want):] == setup.sep0.shape[0]).all()
            assert (np.asarray(sub.pairs.i)[: len(want)]
                    == np.asarray(pairs.i)[want]).all()
        else:
            assert bool(ovf)


def test_remap_gamma_with_body_starts_matches_searchsorted(rng):
    """The one-gather run-start path (body_pair_starts on the old neighbor
    matrix) must reproduce the searchsorted remap exactly — it replaces a
    serial searchsorted over 1M slots."""
    from mundy_tpu.constraints.collision import body_pair_starts, remap_gamma
    from mundy_tpu.neighbor import NeighborMatrix, build_pair_list_ordered

    n, k = 40, 6

    def random_nmat():
        idx = rng.integers(0, n, (n, k)).astype(np.int32)
        cnt = rng.integers(0, k + 1, n)
        mask = np.arange(k)[None, :] < cnt[:, None]  # front-packed
        return NeighborMatrix(idx=jnp.asarray(np.where(mask, idx, n)),
                              mask=jnp.asarray(mask),
                              overflow=jnp.asarray(False))

    old_nmat, new_nmat = random_nmat(), random_nmat()
    old = build_pair_list_ordered(old_nmat, 256)
    new = build_pair_list_ordered(new_nmat, 256)
    gamma_old = jnp.asarray(rng.uniform(0, 5, 256), jnp.float64)

    ref = np.asarray(remap_gamma(old, gamma_old, new, probes=k))
    got = np.asarray(remap_gamma(old, gamma_old, new, probes=k,
                                 old_starts=body_pair_starts(old_nmat)))
    np.testing.assert_array_equal(got, ref)

    # the nmat row-match fast path (replaces the 1.13 s probing loop at 1M)
    # must agree exactly, including trailing value dims
    fast = np.asarray(remap_gamma(old, gamma_old, new, probes=k,
                                  old_starts=body_pair_starts(old_nmat),
                                  old_nmat=old_nmat))
    np.testing.assert_array_equal(fast, ref)
    gv = jnp.stack([gamma_old, 2 * gamma_old], axis=-1)
    ref_v = np.asarray(remap_gamma(old, gv, new, probes=k))
    fast_v = np.asarray(remap_gamma(old, gv, new, probes=k,
                                    old_starts=body_pair_starts(old_nmat),
                                    old_nmat=old_nmat))
    np.testing.assert_array_equal(fast_v, ref_v)


def test_active_pair_subset_derived_windows(rng):
    """Windows derived from the compaction cumsum + the full list's
    seg_starts must match segment_windows run on the active ids."""
    from mundy_tpu.constraints.collision import active_pair_subset
    from mundy_tpu.constraints import collision_setup_spheres
    from mundy_tpu.ops.segments import segment_windows

    n, c_full, block = 200, 256, 32
    pos = jnp.asarray(rng.uniform(0, 10, (n, 3)))
    # front-packed full list (the build_pair_list_ordered invariant the
    # derivation relies on): valid i-sorted pairs first, pads at the tail
    n_valid = 200
    i = np.sort(rng.integers(0, n, n_valid)).astype(np.int32)
    j = rng.integers(0, n, n_valid).astype(np.int32)
    pad = np.full(c_full - n_valid, n, np.int32)
    mask = np.arange(c_full) < n_valid
    pairs = PairList(i=jnp.asarray(np.concatenate([i, pad])),
                     j=jnp.asarray(np.concatenate([j, pad])),
                     mask=jnp.asarray(mask),
                     num_pairs=jnp.asarray(n_valid),
                     overflow=jnp.asarray(False))
    setup = collision_setup_spheres(pos, jnp.asarray(0.5), pairs)
    full_windows = segment_windows(
        jnp.where(pairs.mask, pairs.i, n), n, block, window=64)
    cap = c_full
    sub, sel, n_act, ovf = active_pair_subset(
        setup, jnp.asarray(2.0), cap, n,
        seg_starts=full_windows.starts, block_bodies=block, window=16)
    ref = segment_windows(sub.pairs.i, n, block, window=16)
    np.testing.assert_array_equal(np.asarray(sub.windows.starts),
                                  np.asarray(ref.starts))
    assert bool(sub.windows.overflow) == bool(ref.overflow)


def _ordered_pipeline(rng, n=240, box=12.0, cap=2048):
    """Real broad-phase fixture: ordered pair list + starts + dual slots."""
    from mundy_tpu.constraints.collision import (body_pair_starts,
                                                 pair_dual_slots)
    from mundy_tpu.geom import periodic
    from mundy_tpu.neighbor import (build_cell_list, build_pair_list_ordered,
                                    make_cell_grid, neighbor_matrix)

    metric = periodic(np.array([box] * 3))
    pos = jnp.asarray(rng.uniform(0, box, (n, 3)))
    grid = make_cell_grid([0, 0, 0], np.array([box] * 3), 2.4, (True,) * 3)
    clist = build_cell_list(pos, grid, 64)
    nmat = neighbor_matrix(pos, clist, jnp.asarray(1.2), metric=metric,
                           max_neighbors=32, chunk=256)
    assert not bool(nmat.overflow)
    pairs = build_pair_list_ordered(nmat, cap)
    assert not bool(pairs.overflow)
    starts = body_pair_starts(nmat)
    dual, missing = pair_dual_slots(pairs, starts, nmat)
    assert not bool(missing)
    return metric, pos, nmat, pairs, starts, dual


def test_pair_dual_slots_points_at_reverse_pair(rng):
    _metric, _pos, _nmat, pairs, _starts, dual = _ordered_pipeline(rng)
    i = np.asarray(pairs.i)
    j = np.asarray(pairs.j)
    mask = np.asarray(pairs.mask)
    d = np.asarray(dual)
    for s in np.nonzero(mask)[0]:
        assert mask[d[s]]
        assert i[d[s]] == j[s] and j[d[s]] == i[s]
        assert d[d[s]] == s  # involution


def test_pair_dual_slots_near_gates_missing(rng):
    """`missing` fires only for asymmetric pairs the caller marks `near`:
    a cutoff-boundary pair whose two directions round differently sits at
    the full skin-buffer separation (gamma = 0 provable) and must not
    raise the sticky overflow (the 1M settle_overflow caveat)."""
    from mundy_tpu.constraints.collision import pair_dual_slots
    from mundy_tpu.neighbor.cell_list import NeighborMatrix

    _metric, _pos, nmat, pairs, starts, _dual = _ordered_pipeline(rng)
    # break ONE direction: drop pair slot s's (j, i) duplicate from j's
    # neighbor row (the shape of a one-sided cutoff rounding)
    s = int(np.nonzero(np.asarray(pairs.mask))[0][0])
    jj = int(pairs.j[s])
    ii = int(pairs.i[s])
    row = np.asarray(nmat.idx[jj])
    lane = int(np.nonzero(row == ii)[0][0])
    mask2 = np.asarray(nmat.mask).copy()
    mask2[jj, lane] = False
    nmat2 = NeighborMatrix(idx=nmat.idx, mask=jnp.asarray(mask2),
                           overflow=nmat.overflow)
    _d, missing_all = pair_dual_slots(pairs, starts, nmat2)
    assert bool(missing_all)  # ungated: asymmetry flags
    near_no = jnp.zeros(pairs.i.shape, bool).at[s].set(False)
    near_yes = jnp.zeros(pairs.i.shape, bool).at[s].set(True)
    _d, m_far = pair_dual_slots(pairs, starts, nmat2, near=near_no)
    _d, m_near = pair_dual_slots(pairs, starts, nmat2, near=near_yes)
    assert not bool(m_far)  # boundary pair, not near contact: benign
    assert bool(m_near)  # contact-capable asymmetry still trips


def test_fused_drag_apply_matches_general(rng):
    """Block-local fused Delassus apply == D^T M D chain for scalar drag,
    arbitrary (not necessarily symmetric) gamma."""
    from mundy_tpu.constraints.collision import (_sep_rate,
                                                 active_pair_subset_strided,
                                                 make_local_drag_apply)
    from mundy_tpu.ops.segments import segment_windows

    metric, pos, _nmat, pairs, starts, dual = _ordered_pipeline(rng)
    n = pos.shape[0]
    B, W = 32, 512
    setup_full = collision_setup_spheres(pos, jnp.asarray(0.5), pairs,
                                         metric=metric)
    seg = segment_windows(pairs.i, n, B, window=512, body_starts=starts)
    res = active_pair_subset_strided(setup_full, jnp.asarray(10.0), n, B, W,
                                     seg.starts, dual_full=dual)
    assert not bool(res.overflow)
    setup = res.setup
    dt = 1e-3
    radius, mu = 0.5, 1.3
    mobc = 1.0 / (6.0 * math.pi * mu * radius)

    gamma = jnp.asarray(rng.normal(size=setup.sep0.shape))
    gamma = jnp.where(setup.pairs.mask, gamma, 0.0)

    def general(g):
        f = collision_forces(setup, g, n)
        u = local_drag_mobility(f, radius, mu)
        return jnp.asarray(dt) * _sep_rate(setup, u)

    fused = make_local_drag_apply(setup, res.dual, n, dt,
                                  mobility_i=mobc, mobility_j=mobc)
    ref = np.asarray(general(gamma))
    got = np.asarray(fused(gamma))
    m = np.asarray(setup.pairs.mask)
    np.testing.assert_allclose(got[m], ref[m], rtol=1e-10, atol=1e-12)

    # per-body drag (polydisperse): per-pair mobility channels
    radii = rng.uniform(0.3, 0.7, n)
    invdrag = jnp.asarray(1.0 / (6.0 * math.pi * mu * radii))

    def general_poly(g):
        f = collision_forces(setup, g, n)
        u = invdrag[:, None] * f
        return jnp.asarray(dt) * _sep_rate(setup, u)

    mi = invdrag[jnp.minimum(setup.pairs.i, n - 1)]
    mj = invdrag[jnp.minimum(setup.pairs.j, n - 1)]
    fused_p = make_local_drag_apply(setup, res.dual, n, dt,
                                    mobility_i=mi, mobility_j=mj)
    np.testing.assert_allclose(np.asarray(fused_p(gamma))[m],
                               np.asarray(general_poly(gamma))[m],
                               rtol=1e-10, atol=1e-12)


def test_strided_warm_start_gather_matches_inverse_scatter(rng):
    """The gather-based warm map (prev_cum) == the old inverse-scatter map:
    persisting actives carry last step's multiplier, entrants fall back to
    the full-list snapshot."""
    from mundy_tpu.constraints.collision import active_pair_subset_strided
    from mundy_tpu.ops.segments import segment_windows

    metric, pos, _nmat, pairs, starts, dual = _ordered_pipeline(rng)
    n = pos.shape[0]
    B, W = 32, 512
    cap = pairs.i.shape[0]
    setup_full = collision_setup_spheres(pos, jnp.asarray(0.5), pairs,
                                         metric=metric)
    seg = segment_windows(pairs.i, n, B, window=512, body_starts=starts)
    # step 1: a mid margin selects a strict subset
    m1 = jnp.asarray(float(jnp.median(jnp.where(pairs.mask, setup_full.sep0,
                                                jnp.inf))))
    r1 = active_pair_subset_strided(setup_full, m1, n, B, W, seg.starts)
    gamma1 = jnp.where(r1.setup.pairs.mask,
                       jnp.asarray(rng.normal(size=r1.sel.shape)) ** 2, 0.0)
    gamma_full = jnp.asarray(rng.normal(size=(cap,)) ** 2)
    # step 2: a wider margin admits entrants
    m2 = m1 * 2.0
    r2 = active_pair_subset_strided(setup_full, m2, n, B, W, seg.starts,
                                    prev=(r1.cum, gamma1, W),
                                    gamma_full=gamma_full)
    # reference: inverse-scatter map over full slots
    a_cap = r1.sel.shape[0]
    inv = np.full(cap + 1, a_cap, np.int64)
    sel1 = np.asarray(r1.sel)
    inv[np.minimum(sel1, cap)] = np.arange(a_cap)
    inv[cap] = a_cap
    sel2 = np.asarray(r2.sel)
    expect = np.zeros(a_cap)
    g1 = np.asarray(gamma1)
    gf = np.asarray(gamma_full)
    for a in range(a_cap):
        s = sel2[a]
        if s >= cap:
            continue
        expect[a] = g1[inv[s]] if inv[s] < a_cap else gf[s]
    got = np.asarray(r2.gamma0)
    valid = sel2 < cap
    np.testing.assert_allclose(got[valid], expect[valid], rtol=1e-12)
    assert np.all(got[~valid] == 0.0)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_strided_t_matches_numpy(rng, dtype):
    """strided_t (assemble F = sum -gamma n per body, then t_p = -n_p .
    F_{i(p)}) against a NumPy reference; pad slots give 0."""
    from mundy_tpu.ops.segments import StridedWindows, strided_t

    nb, B, W = 3, 128, 32
    n = nb * B
    ids = []
    for b in range(nb):
        k = rng.integers(10, W)
        blk_ids = np.sort(rng.integers(b * B, (b + 1) * B, k))
        ids.append(np.concatenate([blk_ids, np.full(W - k, n)]))
    ids = np.concatenate(ids).astype(np.int32)
    valid = ids < n
    gamma = np.where(valid, rng.normal(size=nb * W), 0.0)
    normals = rng.normal(size=(nb * W, 3))
    normals /= np.linalg.norm(normals, axis=1, keepdims=True)
    normals = np.where(valid[:, None], normals, 0.0)

    f = np.zeros((n + 1, 3))
    np.add.at(f, ids, -gamma[:, None] * normals)
    want = np.where(valid, -np.sum(normals * f[ids], axis=1), 0.0)

    win = StridedWindows(block_bodies=B, window=W, nb=nb,
                         overflow=jnp.asarray(False))
    got = np.asarray(strided_t(jnp.asarray(gamma, dtype),
                               jnp.asarray(normals, dtype),
                               jnp.asarray(ids), n, win))
    scale = max(1.0, float(np.abs(want).max()))
    tol = 3e-6 if dtype == np.float32 else 1e-12
    np.testing.assert_allclose(got, want, atol=tol * scale)
    assert (got[~valid] == 0).all()


def test_block_delassus_apply_matches_general(rng):
    """Precomputed per-block Delassus matvec == D^T M D chain for scalar
    drag (and per-body drag), arbitrary gamma."""
    from mundy_tpu.constraints.collision import (_sep_rate,
                                                 active_pair_subset_strided,
                                                 make_block_delassus_apply)
    from mundy_tpu.ops.segments import segment_windows

    metric, pos, _nmat, pairs, starts, dual = _ordered_pipeline(rng)
    n = pos.shape[0]
    B, W = 32, 512
    setup_full = collision_setup_spheres(pos, jnp.asarray(0.5), pairs,
                                         metric=metric)
    seg = segment_windows(pairs.i, n, B, window=512, body_starts=starts)
    res = active_pair_subset_strided(setup_full, jnp.asarray(10.0), n, B, W,
                                     seg.starts, dual_full=dual)
    assert not bool(res.overflow)
    setup = res.setup
    dt = 1e-3
    radius, mu = 0.5, 1.3
    mobc = 1.0 / (6.0 * math.pi * mu * radius)

    gamma = jnp.asarray(rng.normal(size=setup.sep0.shape))
    gamma = jnp.where(setup.pairs.mask, gamma, 0.0)

    def general(g):
        f = collision_forces(setup, g, n)
        u = local_drag_mobility(f, radius, mu)
        return jnp.asarray(dt) * _sep_rate(setup, u)

    fused = make_block_delassus_apply(setup, res.dual, dt,
                                      mobility_i=mobc, mobility_j=mobc)
    m = np.asarray(setup.pairs.mask)
    np.testing.assert_allclose(np.asarray(fused(gamma))[m],
                               np.asarray(general(gamma))[m],
                               rtol=1e-10, atol=1e-12)

    radii = rng.uniform(0.3, 0.7, n)
    invdrag = jnp.asarray(1.0 / (6.0 * math.pi * mu * radii))

    def general_poly(g):
        f = collision_forces(setup, g, n)
        u = invdrag[:, None] * f
        return jnp.asarray(dt) * _sep_rate(setup, u)

    mi = invdrag[jnp.minimum(setup.pairs.i, n - 1)]
    mj = invdrag[jnp.minimum(setup.pairs.j, n - 1)]
    fused_p = make_block_delassus_apply(setup, res.dual, dt,
                                        mobility_i=mi, mobility_j=mj)
    np.testing.assert_allclose(np.asarray(fused_p(gamma))[m],
                               np.asarray(general_poly(gamma))[m],
                               rtol=1e-10, atol=1e-12)


def test_band_delassus_apply_matches_general(rng):
    """Banded i-side Delassus apply == the D^T M D chain for scalar and
    per-body drag (the active list is i-sorted, so each body's pairs are
    contiguous and the i-side matrix is a band of width <= the broad
    phase's per-body neighbor cap)."""
    from mundy_tpu.constraints.collision import (_sep_rate,
                                                 active_pair_subset_strided,
                                                 make_band_delassus_apply)
    from mundy_tpu.ops.segments import segment_windows

    metric, pos, nmat, pairs, starts, dual = _ordered_pipeline(rng)
    n = pos.shape[0]
    B, W = 32, 512
    setup_full = collision_setup_spheres(pos, jnp.asarray(0.5), pairs,
                                         metric=metric)
    seg = segment_windows(pairs.i, n, B, window=512, body_starts=starts)
    res = active_pair_subset_strided(setup_full, jnp.asarray(10.0), n, B, W,
                                     seg.starts, dual_full=dual)
    assert not bool(res.overflow)
    setup = res.setup
    dt = 1e-3
    radius, mu = 0.5, 1.3
    mobc = 1.0 / (6.0 * math.pi * mu * radius)
    k_band = int(nmat.idx.shape[1])

    gamma = jnp.asarray(rng.normal(size=setup.sep0.shape))
    gamma = jnp.where(setup.pairs.mask, gamma, 0.0)

    def general(g):
        f = collision_forces(setup, g, n)
        u = local_drag_mobility(f, radius, mu)
        return jnp.asarray(dt) * _sep_rate(setup, u)

    fused = make_band_delassus_apply(setup, res.dual, dt, k_band,
                                     mobility_i=mobc, mobility_j=mobc)
    m = np.asarray(setup.pairs.mask)
    np.testing.assert_allclose(np.asarray(fused(gamma))[m],
                               np.asarray(general(gamma))[m],
                               rtol=1e-10, atol=1e-12)

    radii = rng.uniform(0.3, 0.7, n)
    invdrag = jnp.asarray(1.0 / (6.0 * math.pi * mu * radii))

    def general_poly(g):
        f = collision_forces(setup, g, n)
        u = invdrag[:, None] * f
        return jnp.asarray(dt) * _sep_rate(setup, u)

    mi = invdrag[jnp.minimum(setup.pairs.i, n - 1)]
    mj = invdrag[jnp.minimum(setup.pairs.j, n - 1)]
    fused_p = make_band_delassus_apply(setup, res.dual, dt, k_band,
                                       mobility_i=mi, mobility_j=mj)
    np.testing.assert_allclose(np.asarray(fused_p(gamma))[m],
                               np.asarray(general_poly(gamma))[m],
                               rtol=1e-10, atol=1e-12)
