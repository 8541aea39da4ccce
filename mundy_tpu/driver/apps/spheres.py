"""BASELINE config #1: spheres in a periodic box — Hertzian contact,
overdamped (Stokes drag) dynamics, optional Brownian motion, explicit Euler.

This is the JAX re-design of the minimal reference pipeline (SURVEY.md §7
step 6): cell-list neighbors with a skin-distance rebuild trigger
(HP1 driver `:1404-1427`), Hertzian pair forces
(`SphereSphereHertzianContact.cpp`), local-drag mobility U = F/(6 pi mu r)
(`StkNgpLCP.cpp:620-624`), Brownian velocity (`SpheresKernel.cpp:119-123`),
node-Euler update (HP1 `:1523`).

Everything — including the conditional neighbor rebuild — lives inside one
jitted `step`, so a whole `steps_per_block` window runs on-chip with zero
host round-trips (`lax.cond` executes the rebuild branch only when the skin
is broken).
"""

from __future__ import annotations

import dataclasses
import math as _math
import time
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np
from jax import Array

from mundy_tpu.core.config import validate_config
from mundy_tpu.core.containers import pytree_dataclass, static_field
from mundy_tpu.dynamics import brownian_velocity_keyed, euler_step
from mundy_tpu.forces import hertzian_contact_forces
from mundy_tpu.geom import periodic
from mundy_tpu.geom.periodicity import Metric
from mundy_tpu.neighbor import (
    CellList,
    NeighborMatrix,
    build_cell_list,
    make_cell_grid,
    neighbor_matrix,
)


@dataclasses.dataclass
class SpheresConfig:
    """Validated config (ref: the ParameterList sublists of the drivers)."""

    num_spheres: int = 10_000
    box_size: float = 40.0  # cubic periodic box edge
    radius: float = 0.5
    # relative half-width of a uniform radius distribution: r_i = radius *
    # (1 + U(-p, p)). 0 keeps every engine on the uniform fast paths; > 0
    # fields per-particle radii through search, contact, drag, and noise
    # (the reference fields radius everywhere, compute_aabb.hpp:48-131)
    polydispersity: float = 0.0
    youngs_modulus: float = 1000.0
    poissons_ratio: float = 0.3
    viscosity: float = 1.0
    diffusion_coeff: float = 0.0  # 0 disables Brownian motion
    dt: float = 1e-4
    num_steps: int = 1000
    skin: float = 0.25  # neighbor-list margin (distance units)
    max_neighbors: int = 48
    cell_capacity: int = 24
    chunk: int = 8192
    seed: int = 1234
    dtype: str = "float32"
    log_every: int = 100

    def __validate__(self):
        assert self.num_spheres > 0, "num_spheres must be positive"
        assert self.box_size > 4 * (self.radius + self.skin), "box too small"
        assert self.dt > 0 and self.num_steps >= 0
        assert 0.0 <= self.polydispersity < 1.0


@pytree_dataclass
class SpheresState:
    pos: Array  # (N, 3)
    key: Array  # PRNG key
    step: Array  # () int32
    nmat: NeighborMatrix
    ref_pos: Array  # positions at last rebuild
    rebuild_count: Array  # () int32
    overflow: Array  # () bool (sticky)


class SpheresSim:
    """Assembles the jitted step for the spheres config."""

    def __init__(self, config: SpheresConfig):
        self.config = config
        validate_config(config)
        c = config
        self.dtype = jnp.dtype(c.dtype)
        box = np.array([c.box_size] * 3)
        self.metric: Metric = periodic(box, dtype=self.dtype)
        # search radius = bounding radius + skin/2 per body => pair cutoff
        # = r_i + r_j + skin; cell edge must cover the MAX pair cutoff.
        self.radii = None
        self.search_radii = None
        if c.polydispersity > 0:
            rng = np.random.default_rng(c.seed + 777)
            rr = c.radius * (1.0 + c.polydispersity
                             * rng.uniform(-1.0, 1.0, c.num_spheres))
            self.radii = jnp.asarray(rr, self.dtype)
            self.search_radius = float(rr.max()) + 0.5 * c.skin
            self.search_radii = self.radii + jnp.asarray(0.5 * c.skin,
                                                         self.dtype)
        else:
            self.search_radius = c.radius + 0.5 * c.skin
        self.grid = make_cell_grid(
            [0, 0, 0], box, min_cell_size=2 * self.search_radius,
            periodic=(True,) * 3, dtype=self.dtype,
        )
        self.inv_drag = 1.0 / (6.0 * _math.pi * c.viscosity * c.radius)
        if self.radii is not None:
            self.inv_drag = (1.0 / (6.0 * _math.pi * c.viscosity
                                    * self.radii))[:, None]
        self._step_jit = jax.jit(self._step)
        self._init_jit = jax.jit(self._init)

    # ------------------------------------------------------------------
    def _build_nmat(self, pos: Array) -> tuple[NeighborMatrix, Array]:
        c = self.config
        clist = build_cell_list(pos, self.grid, c.cell_capacity)
        sr = (self.search_radii if self.search_radii is not None
              else jnp.asarray(self.search_radius, self.dtype))
        nmat = neighbor_matrix(
            pos, clist, sr,
            metric=self.metric,
            max_neighbors=c.max_neighbors,
            chunk=min(c.chunk, max(256, c.num_spheres)),
        )
        return nmat, clist.overflow | nmat.overflow

    def _init(self, key: Array) -> SpheresState:
        c = self.config
        kpos, kstate = jax.random.split(key)
        pos = jax.random.uniform(
            kpos, (c.num_spheres, 3), dtype=self.dtype, maxval=c.box_size
        )
        nmat, ovf = self._build_nmat(pos)
        return SpheresState(
            pos=pos, key=kstate, step=jnp.asarray(0, jnp.int32), nmat=nmat,
            ref_pos=pos, rebuild_count=jnp.asarray(1, jnp.int32), overflow=ovf,
        )

    def init(self, key: Optional[Array] = None) -> SpheresState:
        if key is None:
            key = jax.random.PRNGKey(self.config.seed)
        return self._init_jit(key)

    # ------------------------------------------------------------------
    def _inner_step(self, state: SpheresState) -> SpheresState:
        """Force + Brownian + Euler against the current neighbor matrix
        (the cheap per-step work; no rebuild)."""
        c = self.config
        pos = state.pos
        radius = (self.radii if self.radii is not None
                  else jnp.asarray(c.radius, self.dtype))
        force = hertzian_contact_forces(
            pos,
            radius,  # scalar: gather-free path; (N,): packed-params path
            jnp.asarray(c.youngs_modulus, self.dtype),
            jnp.asarray(c.poissons_ratio, self.dtype),
            state.nmat,
            metric=self.metric,
        )
        vel = self.inv_drag * force
        if c.diffusion_coeff > 0.0:
            # keyed per-gid streams: identical to the row/slab engines;
            # Stokes-Einstein per-particle D_i = D0 * r0 / r_i
            diff = jnp.asarray(c.diffusion_coeff, self.dtype)
            if self.radii is not None:
                diff = diff * jnp.asarray(c.radius, self.dtype) / self.radii
            vel = vel + brownian_velocity_keyed(
                state.key, state.step, jnp.arange(c.num_spheres),
                diff, c.dt, dtype=self.dtype,
            )
        new_pos = euler_step(pos, vel, jnp.asarray(c.dt, self.dtype), metric=self.metric)
        return state.replace(pos=new_pos, step=state.step + 1)

    def _rebuild(self, state: SpheresState) -> SpheresState:
        nmat, ovf = self._build_nmat(state.pos)
        return state.replace(
            nmat=nmat, ref_pos=state.pos,
            rebuild_count=state.rebuild_count + 1,
            overflow=state.overflow | ovf,
        )

    def _step(self, state: SpheresState) -> SpheresState:
        """Single step with skin-triggered rebuild (lax.cond). Fine for
        one-off stepping; run_block uses the nested-while structure instead
        (a cond-wrapped rebuild inside lax.scan can execute its branch every
        iteration)."""
        c = self.config
        disp = self.metric.sep(state.ref_pos, state.pos)
        moved = jnp.max(jnp.sum(disp * disp, axis=-1)) > (0.5 * c.skin) ** 2
        state = jax.lax.cond(moved, self._rebuild, lambda s: s, state)
        return self._inner_step(state)

    def step(self, state: SpheresState) -> SpheresState:
        return self._step_jit(state)

    def _run_n(self, state: SpheresState, n_steps: int) -> SpheresState:
        """n_steps fully on-chip: outer while rebuilds, inner do-while runs
        cheap steps until the skin margin is spent or the block ends.

        This is the device-resident shape of the reference's skin-triggered
        rebuild loop (HP1 `:1404-1427`): rebuild cost only when needed, and
        no conditional on the hot path.
        """
        c = self.config
        target = jnp.asarray(n_steps, jnp.int32)
        skin_sq = jnp.asarray((0.5 * c.skin) ** 2, self.dtype)

        def moved_beyond_skin(s):
            disp = self.metric.sep(s.ref_pos, s.pos)
            return jnp.max(jnp.sum(disp * disp, axis=-1)) > skin_sq

        # The skin trigger is computed IN THE BODY and carried as a flag
        # the cond merely reads: a while cond is a separate XLA computation
        # that cannot fuse with the body, so moved() in the cond re-streams
        # pos/ref_pos per iteration; the same reduction in the body fuses
        # into the step for free.
        def inner_cond(carry):
            s, done, fired = carry
            return jnp.logical_and(done < target, jnp.logical_not(fired))

        def inner_body(carry):
            s, done, _ = carry
            s = self._inner_step(s)
            return s, done + 1, moved_beyond_skin(s)

        def outer_cond(carry):
            _s, done, _f = carry
            return done < target

        def outer_body(carry):
            s, done, _ = carry
            s = self._rebuild(s)
            # do-while: always take at least one step per rebuild so the
            # loop progresses even if a single step breaks the skin
            carry = inner_body((s, done, jnp.asarray(False)))
            return jax.lax.while_loop(inner_cond, inner_body, carry)

        state, _, _ = jax.lax.while_loop(
            outer_cond, outer_body,
            (state, jnp.asarray(0, jnp.int32), jnp.asarray(False))
        )
        return state

    def run_block(self, state: SpheresState, n_steps: int) -> SpheresState:
        """n_steps fully on-chip (nested while: rebuild + step bursts)."""
        # n_steps is traced (used only in comparisons), so one compiled
        # program serves every block size — no recompile per block length
        if not hasattr(self, '_run_jit'):
            self._run_jit = jax.jit(self._run_n)
        import jax.numpy as _jnp
        return self._run_jit(state, _jnp.asarray(n_steps, _jnp.int32))

    def regrow(self, state: SpheresState) -> SpheresState:
        """Grow the overflow-bounded capacities and rebuild the search
        structures from the state's positions (driver/regrow.py)."""
        from mundy_tpu.driver.regrow import grow_int

        c = self.config
        c.cell_capacity = grow_int(c.cell_capacity)
        c.max_neighbors = grow_int(c.max_neighbors)
        self.__dict__.pop("_run_jit", None)
        nmat, ovf = self._build_nmat(state.pos)
        return state.replace(nmat=nmat, ref_pos=state.pos, overflow=ovf)

    # ------------------------------------------------------------------
    def run(self, state: Optional[SpheresState] = None, log=print):
        """Host loop with tps telemetry (ref HP1 driver `:1496-1516`) and
        overflow-triggered capacity regrow."""
        from mundy_tpu.driver.regrow import run_blocks

        c = self.config
        if state is None:
            state = self.init()

        def status(s, done, tps):
            return (f"step {done}/{c.num_steps}  tps={tps:.1f}  "
                    f"rebuilds={int(s.rebuild_count)}  "
                    f"overflow={bool(s.overflow)}")

        return run_blocks(self, state, c.num_steps, c.log_every, log, status)

    # diagnostics ------------------------------------------------------
    def max_overlap(self, state: SpheresState) -> float:
        """Worst pair overlap (positive = penetration), for validation."""
        c = self.config
        pos = state.pos
        idx = jnp.minimum(state.nmat.idx, c.num_spheres - 1)
        sep = self.metric.sep(pos[:, None, :], pos[idx])
        d = jnp.linalg.norm(sep, axis=-1) - 2 * c.radius
        d = jnp.where(state.nmat.mask, d, jnp.inf)
        return float(-jnp.min(d))
