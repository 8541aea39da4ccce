"""Flexible filament app (BASELINE config #4) on CPU."""

import jax.numpy as jnp
import numpy as np

from mundy_tpu.driver.apps.filaments import FilamentsConfig, FilamentsSim
import pytest

pytestmark = pytest.mark.slow


def cfg(**kw):
    base = dict(num_filaments=12, nodes_per_filament=8, segment_length=1.0,
                radius=0.25, bend_modulus=2.0, stretch_stiffness=100.0,
                box_size=24.0, dt=2e-4, num_steps=50, dtype="float64",
                chunk=256, log_every=1000)
    base.update(kw)
    return FilamentsConfig(**base)


def test_filaments_hold_together():
    """Segments keep their rest length under dynamics (chain connectivity)."""
    sim = FilamentsSim(cfg())
    state = sim.init()
    state = sim.run_block(state, 100)
    assert not bool(state.overflow)
    seg = np.asarray(state.pos[:, 1:, :] - state.pos[:, :-1, :])
    lengths = np.linalg.norm(seg, axis=-1)
    np.testing.assert_allclose(lengths, 1.0, atol=0.1)
    assert np.isfinite(np.asarray(state.pos)).all()


def test_filaments_straighten():
    """With zero rest curvature, bent filaments relax toward straight.
    Parameters sit in a fast-relaxing regime (tau ~ gamma L^4 / B)."""
    sim = FilamentsSim(cfg(num_filaments=2, nodes_per_filament=5,
                           bend_modulus=20.0, stretch_stiffness=500.0,
                           box_size=30.0))
    state = sim.init()
    # kink filament 0 near the end
    pos = np.array(state.pos)
    pos[0, 3:, 1] += np.arange(2) * 0.5
    state = state.replace(pos=jnp.asarray(pos))
    from mundy_tpu.mech import init_rod_edges, rod_curvature

    state = state.replace(rod=init_rod_edges(state.pos))
    _, k0 = rod_curvature(state.rod)
    e0 = float(jnp.sum(k0**2))
    state = sim._rebuild(state)
    state = sim.run_block(state, 1500)
    _, k1 = rod_curvature(state.rod)
    e1 = float(jnp.sum(k1**2))
    assert e1 < 0.15 * e0


def test_contact_separates_crossing_filaments():
    """Two filaments threaded through each other get pushed apart."""
    sim = FilamentsSim(cfg(num_filaments=2, nodes_per_filament=6, box_size=30.0))
    state = sim.init()
    # filament 0 along x at z=0; filament 1 along y at z=0.3 (overlap: 2r=0.5)
    arc = np.arange(6) * 1.0
    p = np.zeros((2, 6, 3))
    p[0, :, 0] = arc + 10.0
    p[0, :, 1] = 12.0
    p[0, :, 2] = 12.0
    p[1, :, 1] = arc + 10.0
    p[1, :, 0] = 12.0
    p[1, :, 2] = 12.3
    from mundy_tpu.mech import init_rod_edges

    state = state.replace(pos=jnp.asarray(p), rod=init_rod_edges(jnp.asarray(p)))
    state = sim._rebuild(state)
    f = sim._contact_node_forces(state.pos, state.nmat)
    f = np.asarray(f)
    # filament 0 pushed down (-z), filament 1 up (+z)
    assert f[0, :, 2].sum() < -1e-6
    assert f[1, :, 2].sum() > 1e-6
    np.testing.assert_allclose(f.sum(axis=(0, 1)), 0.0, atol=1e-9)


def test_active_wave_propels():
    """Active curvature wave + anisotropic drag -> net swimming; with
    isotropic drag the COM provably cannot move (momentum-free internal
    forces), so the anisotropy contrast is the validation."""
    base = dict(num_filaments=1, nodes_per_filament=10, active_amplitude=0.6,
                wave_k=1.5, wave_omega=30.0, dt=5e-4, box_size=30.0)
    sim = FilamentsSim(cfg(**base))
    state = sim.init()
    com0 = np.asarray(state.pos).mean(axis=1)[0]
    state = sim.run_block(state, 800)
    disp = np.linalg.norm(np.asarray(state.pos).mean(axis=1)[0] - com0)
    assert np.isfinite(disp) and disp > 5e-5

    sim_iso = FilamentsSim(cfg(drag_anisotropy=1.0, **base))
    s2 = sim_iso.init()
    com0 = np.asarray(s2.pos).mean(axis=1)[0]
    s2 = sim_iso.run_block(s2, 800)
    disp_iso = np.linalg.norm(np.asarray(s2.pos).mean(axis=1)[0] - com0)
    assert disp_iso < 1e-9  # exact momentum conservation
    assert disp > 10 * max(disp_iso, 1e-12)


def test_rows_contact_engine_matches_nmat():
    """The gather-free row-block narrow phase must reproduce the (N, K)
    engine's trajectory exactly (same contact set, same arithmetic)."""
    import jax

    sim_n = FilamentsSim(cfg(contact_engine="nmat", diffusion_coeff=0.0))
    sim_r = FilamentsSim(cfg(contact_engine="rows", diffusion_coeff=0.0))
    assert sim_r.contact_engine == "rows"
    s_n = sim_n.init()
    s_r = sim_r.init()
    steps = 40
    s_n = sim_n.run_block(s_n, steps)
    s_r = sim_r.run_block(s_r, steps)
    jax.block_until_ready(s_r.pos)
    assert not bool(s_n.overflow) and not bool(s_r.overflow)
    pn, pr = np.asarray(s_n.pos), np.asarray(s_r.pos)
    assert np.abs(pn - pr).max() < 1e-9, np.abs(pn - pr).max()


def test_rows_broadphase_build_matches_cell_list():
    """The f32 rows-layout BUILD of the (N, K) matrix (row
    extraction + adjacency post-filter) must produce the same neighbor
    pair set as the cell-list builder at the same cutoff."""
    from mundy_tpu.neighbor import build_cell_list, neighbor_matrix

    sim = FilamentsSim(cfg(num_filaments=40, nodes_per_filament=5,
                           box_size=12.0, dtype="float32",
                           diffusion_coeff=0.05))
    state = sim.init()
    # the f32 + n_cells>=5 gate admits the rows build here
    assert int(sim.config.box_size // (2 * sim.search_radius)) >= 5
    nmat, ovf = sim._build_nmat(state.pos)
    assert not bool(ovf)
    _a, _b, mid = sim._segments(state.pos)
    clist = build_cell_list(mid, sim.grid, sim.config.cell_capacity)
    ref = neighbor_matrix(mid, clist,
                          jnp.asarray(sim.search_radius, sim.dtype),
                          metric=sim.metric,
                          max_neighbors=sim.config.max_neighbors,
                          chunk=256, exclude=sim.exclude)
    assert not bool(clist.overflow | ref.overflow)

    def pair_set(nm):
        i = np.repeat(np.arange(nm.idx.shape[0]), nm.idx.shape[1])
        j = np.asarray(nm.idx).ravel()
        m = np.asarray(nm.mask).ravel()
        return set(zip(i[m].tolist(), j[m].tolist()))

    assert pair_set(nmat) == pair_set(ref)
