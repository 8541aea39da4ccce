"""Row-grid engine: layout round-trips and physics equivalence vs the
neighbor-matrix engine."""

import jax
import jax.numpy as jnp
import numpy as np

from mundy_tpu.driver.apps.spheres import SpheresConfig, SpheresSim
from mundy_tpu.driver.apps.spheres_rows import RowSpheresSim
from mundy_tpu.geom import periodic
from mundy_tpu.forces.contact import effective_youngs, hertzian_pair_force
from mundy_tpu.neighbor.rows import (
    build_rows,
    make_row_grid,
    pair_accumulate_central,
    pair_accumulate_central_sym,
    rows_to_flat,
)


def test_rows_round_trip(rng):
    n = 500
    box = 12.0
    pos = jnp.asarray(rng.uniform(0, box, (n, 3)))
    grid = make_row_grid([0, 0, 0], [box] * 3, 1.5, n, dtype=jnp.float64)
    rows = build_rows(pos, jnp.arange(n, dtype=jnp.int32), grid)
    assert not bool(rows.overflow)
    assert int(jnp.sum(rows.valid)) == n
    back = rows_to_flat(rows, n)
    np.testing.assert_allclose(np.asarray(back), np.asarray(pos), atol=1e-12)


def test_rows_overflow_flag(rng):
    # all particles in one row -> tiny capacity must overflow
    n = 200
    pos = jnp.zeros((n, 3)) + 0.5
    grid = make_row_grid([0, 0, 0], [10, 10, 10], 1.0, 8, dtype=jnp.float64)
    rows = build_rows(pos, jnp.arange(n, dtype=jnp.int32), grid)
    assert bool(rows.overflow)


def cfg(**kw):
    base = dict(num_spheres=300, box_size=12.0, radius=0.5,
                youngs_modulus=200.0, diffusion_coeff=0.05, dt=2e-4,
                num_steps=50, skin=0.3, dtype="float64", chunk=512,
                log_every=1000)
    base.update(kw)
    return SpheresConfig(**base)


def test_row_engine_matches_nmat_engine():
    """Identical seeds and physics: the two engines agree. Forces at the
    shared initial configuration match to f64 roundoff; trajectories agree to
    integration tolerance over a short run (the row fast path computes the
    minimum image with different-but-equivalent arithmetic, so borderline
    contacts may flip at the 1e-14 level and diverge slowly)."""
    c = cfg()
    sim_a = SpheresSim(c)
    sim_b = RowSpheresSim(c)
    state_a = sim_a.init()
    state_b = sim_b.init()

    # force equivalence at identical positions (tight)
    from mundy_tpu.forces import hertzian_contact_forces
    fa = np.asarray(hertzian_contact_forces(
        state_a.pos, jnp.asarray(c.radius, jnp.float64),
        jnp.asarray(c.youngs_modulus, jnp.float64),
        jnp.asarray(c.poissons_ratio, jnp.float64),
        state_a.nmat, metric=sim_a.metric))
    fb_rows = sim_b._forces(state_b.rows)  # noqa: SLF001
    fb = np.zeros_like(fa)
    gid = np.asarray(state_b.rows.gid)[np.asarray(state_b.rows.valid)]
    fb[gid] = np.asarray(fb_rows[state_b.rows.valid])
    np.testing.assert_allclose(fb, fa, atol=1e-10)

    sa = sim_a.run_block(state_a, 40)
    sb = sim_b.run_block(state_b, 40)
    assert not bool(sa.overflow) and not bool(sb.overflow)
    pa = np.asarray(sa.pos)
    pb = np.asarray(sim_b.positions(sb))
    np.testing.assert_allclose(pb, pa, atol=2e-3)


def test_row_engine_overlap_relaxes():
    c = cfg(num_steps=300)
    sim = RowSpheresSim(c)
    state = sim.init()
    o0 = sim.max_overlap(state)
    assert o0 > 0
    state = sim.run_block(state, 300)
    assert sim.max_overlap(state) < 0.6 * o0
    assert int(state.rebuild_count) >= 1


def _hertz_scalar_fn(radius=0.5, youngs=1000.0, poisson=0.3):
    e_eff = effective_youngs(youngs, youngs, poisson, poisson)
    two_r = jnp.float32(2 * radius)
    r_eff = jnp.float32(0.5 * radius)

    def fn(r2):
        r2 = jnp.maximum(r2, 1e-24)
        rinv = jax.lax.rsqrt(r2)
        d = r2 * rinv
        mag = hertzian_pair_force(d - two_r, r_eff, jnp.float32(e_eff))
        return -mag * rinv

    return fn


def test_sym_xla_matches_full_stencil():
    """Half-stencil central forces (both Newton's-third-law sums) equal the
    full 9-row stencil."""
    n, box = 4000, 12.0
    rng = np.random.default_rng(3)
    pos = jnp.asarray(rng.uniform(0, box, (n, 3)), jnp.float32)
    grid = make_row_grid([0, 0, 0], [box] * 3, 1.4, n, dtype=jnp.float32,
                         align=8)
    state = build_rows(pos, jnp.arange(n, dtype=jnp.int32), grid)
    boxs = ((box,) * 3, (True,) * 3)
    f9 = pair_accumulate_central(state, boxs, _hertz_scalar_fn())
    f5 = pair_accumulate_central_sym(state, boxs, _hertz_scalar_fn())
    np.testing.assert_allclose(np.asarray(f5), np.asarray(f9),
                               atol=2e-3 * float(jnp.abs(f9).max()))


def test_row_engine_keeps_contact_across_periodic_boundary():
    """A body pushed across the y boundary between rebuilds keeps its
    contact: the row engine must not wrap y/z before the next rebuild (a
    wrapped body would sit one box away from its row's neighbors)."""
    c = cfg(num_spheres=200, box_size=12.0, diffusion_coeff=0.0, dt=2e-4)
    sim_a = SpheresSim(c)
    sim_b = RowSpheresSim(c)
    pos = np.asarray(sim_a.init().pos).copy()
    pos[0] = [6.0, 0.0005, 6.0]   # pushed to -y by body 1: crosses y = 0
    pos[1] = [6.0, 0.4, 6.0]
    far = np.linalg.norm(pos[2:, None] - pos[None, :2], axis=-1) < 2.0
    pos[2:][far.any(axis=1)] += 3.0  # keep the pair isolated
    pos = jnp.asarray(np.mod(pos, 12.0))
    state_a = sim_a.init()
    state_a = sim_a._rebuild(state_a.replace(pos=pos, ref_pos=pos))  # noqa: SLF001
    state_b = sim_b.init()
    state_b = state_b.replace(rows=build_rows(
        pos, jnp.arange(200, dtype=jnp.int32), sim_b.grid))
    sa = sim_a.run_block(state_a, 3)
    sb = sim_b.run_block(state_b, 3)
    pa = np.asarray(sa.pos)
    pb = np.asarray(sim_b.positions(sb))
    assert pa[0, 1] > 11.0  # body 0 did cross the boundary
    d = pa - pb
    d -= 12.0 * np.round(d / 12.0)
    np.testing.assert_allclose(d, 0.0, atol=1e-9)
