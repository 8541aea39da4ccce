"""Sharded spectral-Ewald mobility (parallel/spectral_shard.py) vs the
single-device se_rpy_apply_cells on the 8-virtual-device CPU mesh."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import Mesh

from mundy_tpu.mobility import build_spectral_ewald
from mundy_tpu.mobility.spectral import make_se_geometry, se_rpy_apply_cells
from mundy_tpu.neighbor.cells3d import build_cells3d, make_cell_grid3d
from mundy_tpu.ops.se_grid import se_bin_dense
from mundy_tpu.parallel.spectral_shard import make_sharded_se_rpy_apply

pytestmark = pytest.mark.slow


@pytest.fixture(scope="module")
def mesh8():
    devs = jax.devices()
    if len(devs) < 8:
        pytest.skip("needs 8 virtual devices")
    return Mesh(devs[:8], ("shard",))


def test_sharded_matches_single_device(mesh8):
    n, box = 1024, 18.0
    rng = np.random.default_rng(3)
    pos = jnp.asarray(rng.uniform(0, box, (n, 3)))
    f = jnp.asarray(rng.normal(size=(n, 3)))

    op = build_spectral_ewald(box, 0.5, 1.0, tol=1e-4, n_particles=n,
                              dtype=jnp.float64)
    cells_grid = make_cell_grid3d([box] * 3, op.base.r_cut, n,
                                  dtype=jnp.float64)

    # single device reference
    geom_full = make_se_geometry(op, n)
    pieces = se_bin_dense(geom_full, pos, jnp.float64)
    cells = build_cells3d(pos, cells_grid)
    assert not bool(cells.overflow) and not bool(pieces[1])
    u_ref, ovf = se_rpy_apply_cells(op, cells, pos, f, (box,) * 3,
                                    geom_full, pieces=pieces)
    assert not bool(ovf)

    # sharded
    geom_loc = make_se_geometry(op, n // 8, capacity_slack=3.0)
    apply_fn, shard = make_sharded_se_rpy_apply(
        mesh8, "shard", op, geom_loc, cells_grid, n, (box,) * 3,
        dtype=jnp.float64)
    pos_s = jax.device_put(pos, shard)
    f_s = jax.device_put(f, shard)
    u_sh, ovf_sh = apply_fn(pos_s, f_s)
    assert not bool(ovf_sh)
    ur = np.asarray(u_ref)
    us = np.asarray(u_sh)
    scale = np.abs(ur).max()
    np.testing.assert_allclose(us, ur, atol=1e-9 * scale)


def test_sharded_flags_binning_overflow(mesh8):
    """Cramming every particle into one SE row column must trip the sticky
    overflow (dropped bodies would silently corrupt the wave sum)."""
    n, box = 512, 18.0
    rng = np.random.default_rng(4)
    pos = np.asarray(rng.uniform(0, box, (n, 3)))
    pos[:, 1:] = 0.5  # all in one (y, z) binning column
    pos = jnp.asarray(pos)
    f = jnp.asarray(rng.normal(size=(n, 3)))
    op = build_spectral_ewald(box, 0.5, 1.0, tol=1e-4, n_particles=n,
                              dtype=jnp.float64)
    cells_grid = make_cell_grid3d([box] * 3, op.base.r_cut, n,
                                  dtype=jnp.float64)
    cells_grid = cells_grid.replace(capacity=max(cells_grid.capacity, 512))
    geom_loc = make_se_geometry(op, n // 8)  # way undersized for a column
    apply_fn, shard = make_sharded_se_rpy_apply(
        mesh8, "shard", op, geom_loc, cells_grid, n, (box,) * 3,
        dtype=jnp.float64)
    _u, ovf = apply_fn(jax.device_put(pos, shard), jax.device_put(f, shard))
    assert bool(ovf)


def test_sharded_chromatin_matches_single_device(mesh8):
    """ChromatinSim(mesh=...) runs BASELINE #5's hydro sharded over the
    mesh; the trajectory must track the single-device app."""
    from mundy_tpu.driver.apps.chromatin import ChromatinConfig, ChromatinSim

    def cfg():
        return ChromatinConfig(
            num_chains=2, beads_per_chain=64, bead_radius=0.5,
            num_crosslinkers=0, diffusion_coeff=0.0, dt=2e-4,
            hydro="rpy_spectral", box_size=24.0, num_steps=10,
            dtype="float64", chunk=256, log_every=1000)

    single = ChromatinSim(cfg())
    sharded = ChromatinSim(cfg(), mesh=mesh8)
    s1 = single.init()
    s2 = sharded.init()
    # built lazily in init() once se_geom is right-sized from occupancy
    assert sharded.sharded_se is not None
    s1 = single.run_block(s1, 10)
    s2 = sharded.run_block(s2, 10)
    jax.block_until_ready(s2.pos)
    assert not bool(s1.overflow) and not bool(s2.overflow)
    p1, p2 = np.asarray(s1.pos), np.asarray(s2.pos)
    diff = p1 - p2
    diff -= 24.0 * np.round(diff / 24.0)
    assert np.abs(diff).max() < 1e-8, np.abs(diff).max()
