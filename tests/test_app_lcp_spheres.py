"""End-to-end LCP spheres app (BASELINE config #2) on CPU."""

import jax.numpy as jnp
import numpy as np
import pytest

from mundy_tpu.driver.apps.lcp_spheres import LCPSpheresConfig, LCPSpheresSim


def cfg(**kw):
    base = dict(
        num_spheres=150,
        box_size=8.0,
        radius=0.5,
        dt=2e-3,
        num_steps=30,
        dtype="float64",
        chunk=256,
        max_allowable_overlap=1e-6,
        max_col_iterations=2000,
        log_every=1000,
    )
    base.update(kw)
    return LCPSpheresConfig(**base)


def test_overlaps_resolved_dry():
    sim = LCPSpheresSim(cfg())
    state = sim.init()
    assert sim.max_overlap(state) > 0.1  # dense random start overlaps a lot
    state = sim.run_block(state, 30)
    assert not bool(state.overflow)
    # after the relaxation steps, worst overlap ~ solver tol + linearization
    assert sim.max_overlap(state) < 0.02
    assert int(state.lcp_iters) < 2000


def test_overlaps_resolved_rpy():
    # Dilute enough that the neighbor-truncated RPY operator stays positive
    # definite (truncation can break SPD in dense regimes — same caveat as
    # the reference's HYDRO_NEAREST level).
    sim = LCPSpheresSim(cfg(hydro="rpy_neighbors", num_steps=20, box_size=14.0))
    state = sim.run_block(sim.init(), 20)
    assert not bool(state.overflow)
    assert sim.max_overlap(state) < 0.03


def test_brownian_lcp_steady_state():
    """Brownian drift enters the LCP constant term (q = sep0 + dt D^T u_b,
    reference semantics: constraints see every known velocity), so the
    end-of-step overlap holds at max_allowable_overlap — NOT at the
    per-step drift scale sqrt(2 D dt), which is what an after-the-solve
    noise kick would leave behind."""
    sim = LCPSpheresSim(cfg(diffusion_coeff=0.02, num_steps=40))
    state = sim.run_block(sim.init(), 40)
    assert not bool(state.overflow)
    # drift scale here is sqrt(2 * 0.02 * 1e-3) ~ 6e-3; demand 100x better
    assert sim.max_overlap(state) < 5e-5
    pos = np.asarray(state.pos)
    assert (pos >= 0).all() and (pos <= 8.0).all()


def test_warm_start_reduces_iterations():
    sim = LCPSpheresSim(cfg())
    state = sim.init()
    s1 = sim.step(state)
    first_iters = int(s1.lcp_iters)
    # a few steps later the warm start should cut iterations well down
    s = s1
    for _ in range(5):
        s = sim.step(s)
    assert int(s.lcp_iters) <= first_iters


def test_overlaps_resolved_ewald_hydro():
    """Full periodic RPY (Ewald) mobility inside the collision LCP."""
    sim = LCPSpheresSim(cfg(hydro="rpy_ewald", num_steps=15, box_size=14.0,
                            dt=2e-3))
    state = sim.init()
    o0 = sim.max_overlap(state)
    state = sim.run_block(state, 15)
    assert not bool(state.overflow)
    assert sim.max_overlap(state) < 0.1 * max(o0, 1e-6)


def test_overlaps_resolved_spectral_hydro():
    """FFT spectral-Ewald RPY mobility (dense gridding) inside the
    collision LCP."""
    sim = LCPSpheresSim(cfg(hydro="rpy_spectral", num_steps=15, box_size=14.0,
                            dt=2e-3))
    state = sim.init()
    o0 = sim.max_overlap(state)
    state = sim.run_block(state, 15)
    assert not bool(state.overflow)
    assert sim.max_overlap(state) < 0.1 * max(o0, 1e-6)
