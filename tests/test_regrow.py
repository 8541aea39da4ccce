"""Host regrow loop (driver/regrow.py): deliberately undersized capacities
must be grown automatically until a run completes — the static-shape
replacement for
the reference's dynamic entity/link creation (LinkData.hpp:159-183,446)."""

import jax.numpy as jnp
import numpy as np

from mundy_tpu.driver.apps.chromatin import ChromatinConfig, ChromatinSim
from mundy_tpu.driver.apps.lcp_spheres import LCPSpheresConfig, LCPSpheresSim
from mundy_tpu.driver.apps.spheres import SpheresConfig, SpheresSim


def test_spheres_regrow_from_undersized():
    cfg = SpheresConfig(num_spheres=300, box_size=10.0, radius=0.5,
                        diffusion_coeff=0.1, dt=1e-4, num_steps=30,
                        max_neighbors=1, cell_capacity=1,
                        dtype="float64", log_every=10)
    sim = SpheresSim(cfg)
    state = sim.init()
    assert bool(state.overflow)  # undersized on purpose
    logs = []
    state = sim.run(state, log=logs.append)
    assert not bool(state.overflow)
    assert any("regrow" in line for line in logs)
    assert np.isfinite(np.asarray(state.pos)).all()
    assert cfg.max_neighbors > 1 and cfg.cell_capacity > 1


def test_lcp_regrow_from_undersized_neighbors():
    n = 400
    box = float((n * (4 / 3) * np.pi * 0.125 / 0.20) ** (1 / 3))  # phi 20%
    cfg = LCPSpheresConfig(num_spheres=n, box_size=box, radius=0.5,
                           dt=1e-3, num_steps=20, max_neighbors=2,
                           dtype="float64", log_every=10)
    sim = LCPSpheresSim(cfg)
    sim.rows_k = 2  # undersize the rows broad phase too
    state = sim.init()
    logs = []
    state = sim.run(state, log=logs.append)
    assert not bool(state.overflow)
    # dense packing with K=2 must have overflowed and regrown
    assert any("regrow" in line for line in logs)
    assert sim.max_overlap(state) < 0.05


def test_chromatin_regrow_from_undersized():
    cfg = ChromatinConfig(num_chains=2, beads_per_chain=64,
                          num_crosslinkers=8, diffusion_coeff=0.05,
                          dt=2e-4, num_steps=20, cell_capacity=1,
                          max_neighbors=2, dtype="float64", chunk=256,
                          log_every=10)
    sim = ChromatinSim(cfg)
    sim.kmc_cell_capacity = 8  # way below the ~100 a dense chain needs
    state = sim.init()
    logs = []
    state = sim.run(state, log=logs.append)
    assert not bool(state.overflow)
    assert any("regrow" in line for line in logs)
    pos = np.asarray(state.pos).reshape(2, 64, 3)
    bond_len = np.linalg.norm(np.diff(pos, axis=1), axis=-1)
    assert bond_len.max() < 1.5  # backbone survived the regrows
