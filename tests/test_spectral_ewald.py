"""Spectral Ewald (FFT wave-space) RPY vs the validated direct k-sum.

Mirrors the reference's planned PVFMM/STKFMM role (`TPLsList.cmake:29-30`):
the fast long-range Stokes path must agree with the direct lattice sum to
its construction tolerance, be splitting-parameter independent, and stay SPD.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from mundy_tpu.geom import periodic
from mundy_tpu.mobility import (
    build_ewald_rpy,
    build_spectral_ewald,
    ewald_rpy_apply,
    se_rpy_apply,
    se_wave_apply,
)
from mundy_tpu.mobility.ewald import ewald_wave_apply
from mundy_tpu.neighbor import build_cell_list, make_cell_grid, neighbor_matrix

BOX, A, VISC = 10.0, 0.5, 1.0


@pytest.fixture
def system(rng):
    n = 160
    pos = jnp.asarray(rng.uniform(0, BOX, (n, 3)))
    F = jnp.asarray(rng.normal(size=(n, 3)))
    return pos, F


def _nmat(pos, r_cut):
    metric = periodic([BOX] * 3, dtype=jnp.float64)
    grid = make_cell_grid([0, 0, 0], [BOX] * 3, min(r_cut, BOX / 3),
                          (True,) * 3, jnp.float64)
    cl = build_cell_list(pos, grid, 64)
    return neighbor_matrix(pos, cl, jnp.asarray(0.5 * r_cut), metric=metric,
                           max_neighbors=128, chunk=256), metric


def test_wave_matches_direct_sum(system):
    pos, F = system
    op_d = build_ewald_rpy(BOX, A, VISC, tol=1e-6, dtype=jnp.float64)
    u_ref = ewald_wave_apply(op_d, pos, F)
    op_s = build_spectral_ewald(BOX, A, VISC, tol=1e-6, dtype=jnp.float64)
    u_se = se_wave_apply(op_s, pos, F)
    rel = float(jnp.linalg.norm(u_se - u_ref) / jnp.linalg.norm(u_ref))
    assert rel < 3e-6, rel


def test_full_operator_matches(system):
    pos, F = system
    op_d = build_ewald_rpy(BOX, A, VISC, tol=1e-6, dtype=jnp.float64)
    nm, metric = _nmat(pos, op_d.r_cut)
    u_ref = ewald_rpy_apply(op_d, pos, F, nm, metric)
    op_s = build_spectral_ewald(BOX, A, VISC, tol=1e-6, dtype=jnp.float64)
    u_se = se_rpy_apply(op_s, pos, F, nm, metric)
    rel = float(jnp.linalg.norm(u_se - u_ref) / jnp.linalg.norm(u_ref))
    assert rel < 3e-6, rel


def test_xi_independence(system):
    pos, F = system
    op1 = build_spectral_ewald(BOX, A, VISC, tol=1e-6, dtype=jnp.float64)
    op2 = build_spectral_ewald(BOX, A, VISC, xi=2.0 / (0.25 * BOX),
                               tol=1e-6, dtype=jnp.float64)
    nm1, metric = _nmat(pos, op1.base.r_cut)
    nm2, _ = _nmat(pos, op2.base.r_cut)
    u1 = se_rpy_apply(op1, pos, F, nm1, metric)
    u2 = se_rpy_apply(op2, pos, F, nm2, metric)
    rel = float(jnp.linalg.norm(u2 - u1) / jnp.linalg.norm(u1))
    assert rel < 5e-4, rel


def test_spd_and_symmetry(system):
    pos, F = system
    op_s = build_spectral_ewald(BOX, A, VISC, tol=1e-4, dtype=jnp.float64)
    nm, metric = _nmat(pos, op_s.base.r_cut)
    u = se_rpy_apply(op_s, pos, F, nm, metric)
    assert float(jnp.sum(F * u)) > 0
    # symmetry: <G, M F> == <F, M G>
    G = jnp.asarray(np.random.default_rng(7).normal(size=F.shape))
    uG = se_rpy_apply(op_s, pos, G, nm, metric)
    a = float(jnp.sum(G * u))
    b = float(jnp.sum(F * uG))
    assert abs(a - b) / max(abs(a), 1e-12) < 1e-4


@pytest.mark.parametrize("layout", ["rows", "tiles"])
@pytest.mark.parametrize("window", ["gaussian", "es"])
def test_dense_wave_apply_matches_scatter(rng, layout, window):
    """End-to-end dense wave apply (row columns or 3D tiles) against
    se_wave_apply's scatter/gather reference gridding, both windows."""
    from mundy_tpu.mobility import build_spectral_ewald
    from mundy_tpu.mobility.spectral import (make_se_geometry,
                                             make_se_geometry_tiles,
                                             se_wave_apply_dense)

    n = 200
    pos = jnp.asarray(rng.uniform(0, BOX, (n, 3)))
    F = jnp.asarray(rng.normal(size=(n, 3)))
    op = build_spectral_ewald(BOX, A, VISC, tol=1e-4, dtype=jnp.float64,
                              window=window)
    make = make_se_geometry if layout == "rows" else make_se_geometry_tiles
    u, ovf = se_wave_apply_dense(op, make(op, n), pos, F)
    assert not bool(ovf)
    u_ref = se_wave_apply(op, pos, F)
    rel = float(jnp.abs(u - u_ref).max() / jnp.abs(u_ref).max())
    assert rel < 3e-4, rel


def test_dense_gridding_matches_scatter(rng):
    """Dense-contraction spread/interp vs the scatter/gather reference
    gridding (dense evaluates the full slab axes — a strict accuracy
    superset of the P-point windows, so differences sit at the window
    truncation level)."""
    from mundy_tpu.mobility.spectral import se_spread, se_interpolate
    from mundy_tpu.ops.se_grid import (
        make_se_grid_rows, se_bin_dense, se_spread_dense, se_interp_dense)
    from mundy_tpu.mobility import build_spectral_ewald

    n = 250
    pos = jnp.asarray(rng.uniform(0, BOX, (n, 3)))
    F = jnp.asarray(rng.normal(size=(n, 3)))
    op = build_spectral_ewald(BOX, A, VISC, tol=1e-4, dtype=jnp.float64)
    from mundy_tpu.mobility.spectral import make_se_geometry
    geom = make_se_geometry(op, n)
    pieces = se_bin_dense(geom, pos, jnp.float64)
    assert not bool(pieces[1])
    g_ref = se_spread(op, pos, F)
    g_new = se_spread_dense(geom, pieces, F)
    assert float(jnp.abs(g_new - g_ref).max()) < 2e-4 * float(jnp.abs(g_ref).max())
    u_ref = se_interpolate(op, pos, g_ref)
    u_new = se_interp_dense(geom, pieces, n, g_ref)
    assert float(jnp.abs(u_new - u_ref).max()) < 2e-4 * float(jnp.abs(u_ref).max())


def test_es_window_shrinks_grid(system):
    """The ES deconvolution window needs no eta screen-splitting, so it
    escapes the G-doubling the Gaussian window forces at scale-like
    splittings (round-1 weak #6), at equal accuracy."""
    import math

    pos, F = system
    box, r_cut = 152.0, 3.5
    xi = math.sqrt(math.log(1e4)) / r_cut
    op_g = build_spectral_ewald(box, A, VISC, tol=1e-4, xi=xi, r_cut=r_cut,
                                dtype=jnp.float64, window="gaussian")
    op_e = build_spectral_ewald(box, A, VISC, tol=1e-4, xi=xi, r_cut=r_cut,
                                dtype=jnp.float64, window="es")
    assert op_e.grid_n < op_g.grid_n
    assert op_e.support < op_g.support
    # both windows approximate the same wave operator (small-box check)
    op_g2 = build_spectral_ewald(BOX, A, VISC, tol=1e-4, dtype=jnp.float64,
                                 window="gaussian")
    op_e2 = build_spectral_ewald(BOX, A, VISC, tol=1e-4, dtype=jnp.float64,
                                 window="es")
    ug = se_wave_apply(op_g2, pos, F)
    ue = se_wave_apply(op_e2, pos, F)
    rel = float(jnp.abs(ug - ue).max() / jnp.abs(ug).max())
    assert rel < 2e-4, rel


def test_tile_gridding_matches_scatter(rng):
    """3D-tiled spread/interp vs the scatter/gather reference gridding
    (tiles bound occupancy locally on all three axes — the clustered-safe
    layout; accuracy class identical to the dense rows path)."""
    from mundy_tpu.mobility.spectral import (se_spread, se_interpolate,
                                             make_se_geometry_tiles,
                                             se_wave_apply,
                                             se_wave_apply_dense)
    from mundy_tpu.ops.se_grid import (se_bin_tiles, se_spread_tiles,
                                              se_interp_tiles)
    from mundy_tpu.mobility import build_spectral_ewald

    n = 250
    pos = jnp.asarray(rng.uniform(0, BOX, (n, 3)))
    F = jnp.asarray(rng.normal(size=(n, 3)))
    op = build_spectral_ewald(BOX, A, VISC, tol=1e-4, dtype=jnp.float64)
    geom = make_se_geometry_tiles(op, n)
    pieces = se_bin_tiles(geom, pos, jnp.float64)
    assert not bool(pieces[1])
    g_ref = se_spread(op, pos, F)
    g_new = se_spread_tiles(geom, pieces, F)
    assert float(jnp.abs(g_new - g_ref).max()) < 2e-4 * float(jnp.abs(g_ref).max())
    u_ref = se_interpolate(op, pos, g_ref)
    u_new = se_interp_tiles(geom, pieces, g_ref)
    assert float(jnp.abs(u_new - u_ref).max()) < 2e-4 * float(jnp.abs(u_ref).max())
    # end-to-end wave apply through the dispatching entry point
    u_full, ovf = se_wave_apply_dense(op, geom, pos, F)
    assert not bool(ovf)
    u_sc = se_wave_apply(op, pos, F)
    rel = float(jnp.abs(u_full - u_sc).max() / jnp.abs(u_sc).max())
    assert rel < 3e-4, rel
