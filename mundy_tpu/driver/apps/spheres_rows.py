"""Spheres app on the dense row-grid engine (gather-free hot path).

Same physics as driver.apps.spheres (BASELINE config #1) but the state lives
in the (ny, nz, R) row layout between rebuilds: the inner step is 9 rolls +
dense (R x R) pair blocks with ZERO gathers/scatters, and a
rebuild is one sort + one N-element scatter. See neighbor/rows.py for the
measured irregular-access costs that motivate this design.
"""

from __future__ import annotations

import math as _math
import time
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np
from jax import Array

from mundy_tpu.core.config import validate_config
from mundy_tpu.core.containers import pytree_dataclass
from mundy_tpu.driver.apps.spheres import SpheresConfig
from mundy_tpu.dynamics import brownian_velocity_keyed
from mundy_tpu.forces.contact import effective_youngs, hertzian_pair_force
from mundy_tpu.geom import periodic
from mundy_tpu.neighbor.rows import (
    RowState,
    build_rows,
    make_row_grid,
    moved_beyond_skin,
    orthorhombic_lengths,
    pair_accumulate,
    pair_accumulate_central,
    rows_to_flat,
)


@pytree_dataclass
class RowSpheresState:
    rows: RowState
    key: Array
    step: Array
    rebuild_count: Array
    overflow: Array


class RowSpheresSim:
    """Assembled row-engine simulation for SpheresConfig."""

    def __init__(self, config: SpheresConfig, capacity_slack: float = 1.9):
        self.config = c = config
        validate_config(config)
        self.dtype = jnp.dtype(c.dtype)
        box = np.array([c.box_size] * 3)
        self.metric = periodic(box, dtype=self.dtype)
        self.cutoff = 2 * c.radius + c.skin
        self.grid = make_row_grid([0, 0, 0], box, self.cutoff, c.num_spheres,
                                  capacity_slack=capacity_slack,
                                  dtype=self.dtype, align=8)
        self.box_static = orthorhombic_lengths(self.metric)
        # polydisperse radii (same draw as SpheresSim: seed + 777, so the
        # engines are trajectory-comparable); cutoff covers the max pair
        self.radii = None
        if c.polydispersity > 0:
            rng = np.random.default_rng(c.seed + 777)
            rr = c.radius * (1.0 + c.polydispersity
                             * rng.uniform(-1.0, 1.0, c.num_spheres))
            self.radii = jnp.asarray(rr, self.dtype)
            self.cutoff = 2 * float(rr.max()) + c.skin
            self.grid = make_row_grid([0, 0, 0], box, self.cutoff,
                                      c.num_spheres,
                                      capacity_slack=capacity_slack,
                                      dtype=self.dtype, align=8)
        self.inv_drag = 1.0 / (6.0 * _math.pi * c.viscosity * c.radius)
        self.e_eff = effective_youngs(c.youngs_modulus, c.youngs_modulus,
                                      c.poissons_ratio, c.poissons_ratio)

    def init(self, key: Optional[Array] = None) -> RowSpheresState:
        c = self.config
        if key is None:
            key = jax.random.PRNGKey(c.seed)
        kp, ks = jax.random.split(key)
        pos = jax.random.uniform(kp, (c.num_spheres, 3), dtype=self.dtype,
                                 maxval=c.box_size)
        rows = build_rows(pos, jnp.arange(c.num_spheres, dtype=jnp.int32), self.grid)
        # Right-size the row capacity from the measured max occupancy: the
        # pair pass's work scales with R x 9R, so slack is paid every step. +12.5% margin (occupancy
        # drifts between rebuilds), 8-aligned, sticky overflow flag catches
        # later violations.
        occ = jnp.sum(rows.valid.reshape(-1, self.grid.row_capacity), axis=1)
        max_occ = int(jax.device_get(jnp.max(occ)))
        tight = ((int(max_occ * 1.125) + 4 + 7) // 8) * 8
        if tight < self.grid.row_capacity:
            self.grid = self.grid.replace(row_capacity=tight)
            rows = build_rows(pos, jnp.arange(c.num_spheres, dtype=jnp.int32),
                              self.grid)
        return RowSpheresState(rows=rows, key=ks, step=jnp.asarray(0, jnp.int32),
                               rebuild_count=jnp.asarray(1, jnp.int32),
                               overflow=rows.overflow)

    # ------------------------------------------------------------------
    def _forces(self, rows: RowState) -> Array:
        c = self.config
        r_eff = jnp.asarray(0.5 * c.radius, self.dtype)
        e_eff = jnp.asarray(self.e_eff, self.dtype)
        two_r = jnp.asarray(2.0 * c.radius, self.dtype)

        g = rows.pos.shape
        use_central = (self.box_static is not None and g[0] >= 5 and g[1] >= 5)
        if use_central and self.radii is not None:
            # polydisperse: radii ride a payload plane; sentinel slots carry
            # r = 0 so their r_eff (hence the Hertzian magnitude) vanishes
            safe = jnp.minimum(rows.gid, c.num_spheres - 1)
            r_rows = jnp.where(rows.valid, self.radii[safe], 0.0)

            def scalar_fn_poly(r2, ro, rc):
                r2 = jnp.maximum(r2, 1e-24)
                rinv = jax.lax.rsqrt(r2)
                d = r2 * rinv
                re = (ro * rc) / jnp.maximum(ro + rc, 1e-12)
                mag = hertzian_pair_force(d - (ro + rc), re, e_eff)
                return -mag * rinv

            return pair_accumulate_central(rows, self.box_static,
                                           scalar_fn_poly,
                                           extra_fields=(r_rows,))
        if use_central:
            # Hertzian repulsion is central: f_i = sum_j w * (x_j - x_i) with
            # w = -mag/d <= 0 -> mask-free fused row kernel (sentinel slots
            # and self-pairs eliminate themselves; see pair_accumulate_central)
            def scalar_fn(r2):
                r2 = jnp.maximum(r2, 1e-24)
                rinv = jax.lax.rsqrt(r2)
                d = r2 * rinv
                mag = hertzian_pair_force(d - two_r, r_eff, e_eff)
                return -mag * rinv

            # The full 9-row stencil evaluates every off-row pair from both
            # sides. pair_accumulate_central_sym (half stencil) does ~0.6x
            # the elementwise work, but its dual-axis reduction makes XLA
            # materialize the (R, 5R) weight blocks in device memory.
            return pair_accumulate_central(rows, self.box_static, scalar_fn)

        def pair_fn(sep, r2, mask):
            r2 = jnp.maximum(r2, 1e-24)
            rinv = jax.lax.rsqrt(r2)
            d = r2 * rinv
            mag = hertzian_pair_force(d - two_r, r_eff, e_eff)
            w = jnp.where(mask, mag * rinv, 0.0)
            return -w[..., None] * sep

        return pair_accumulate(rows, self.metric, pair_fn, box=self.box_static)

    def _inner_step(self, state: RowSpheresState) -> RowSpheresState:
        c = self.config
        rows = state.rows
        force = self._forces(rows)
        if self.radii is not None:
            safe = jnp.minimum(rows.gid, c.num_spheres - 1)
            r_rows = jnp.maximum(self.radii[safe], 1e-12)
            inv_drag = jnp.where(
                rows.valid, 1.0 / (6.0 * jnp.pi * c.viscosity * r_rows),
                0.0)[..., None]
            vel = inv_drag * force
        else:
            vel = self.inv_drag * force
        if c.diffusion_coeff > 0:
            # gid-keyed counter-based noise: identical streams to the flat
            # engine, no gid gather (brownian_velocity_keyed)
            diff = jnp.asarray(c.diffusion_coeff, self.dtype)
            if self.radii is not None:
                diff = diff * jnp.asarray(c.radius, self.dtype) / r_rows
            bz = brownian_velocity_keyed(
                state.key, state.step, rows.gid, diff, c.dt,
                dtype=self.dtype)
            vel = vel + jnp.where(rows.valid[..., None], bz, 0.0)
        # no wrap between rebuilds (neighbor/rows.py): _rebuild wraps
        new_pos = rows.pos + jnp.asarray(c.dt, self.dtype) * vel
        new_pos = jnp.where(rows.valid[..., None], new_pos, rows.pos)
        return state.replace(rows=rows.replace(pos=new_pos), step=state.step + 1)

    def _rebuild(self, state: RowSpheresState) -> RowSpheresState:
        c = self.config
        flat = self.positions(state)
        rows = build_rows(flat, jnp.arange(c.num_spheres, dtype=jnp.int32), self.grid)
        return state.replace(rows=rows,
                             rebuild_count=state.rebuild_count + 1,
                             overflow=state.overflow | rows.overflow)

    def _run_n(self, state: RowSpheresState, n_steps: int) -> RowSpheresState:
        c = self.config
        target = jnp.asarray(n_steps, jnp.int32)

        # skin trigger computed in the BODY, carried as a flag the cond
        # reads (a while cond can't fuse with the body)
        def inner_cond(carry):
            s, done, fired = carry
            return jnp.logical_and(done < target, jnp.logical_not(fired))

        def inner_body(carry):
            s, done, _ = carry
            s = self._inner_step(s)
            return s, done + 1, moved_beyond_skin(s.rows, self.metric, c.skin)

        def outer_body(carry):
            s, done, _ = carry
            s = self._rebuild(s)
            carry = inner_body((s, done, jnp.asarray(False)))
            return jax.lax.while_loop(inner_cond, inner_body, carry)

        state, _, _ = jax.lax.while_loop(
            lambda carry: carry[1] < target, outer_body,
            (state, jnp.asarray(0, jnp.int32), jnp.asarray(False)),
        )
        return state

    def run_block(self, state: RowSpheresState, n_steps: int) -> RowSpheresState:
        # n_steps is traced (used only in comparisons), so one compiled
        # program serves every block size — no recompile per block length
        if not hasattr(self, '_run_jit'):
            self._run_jit = jax.jit(self._run_n)
        import jax.numpy as _jnp
        return self._run_jit(state, _jnp.asarray(n_steps, _jnp.int32))

    def regrow(self, state: RowSpheresState) -> RowSpheresState:
        """Grow the row slot capacity and re-sort the current positions
        into the bigger layout (driver/regrow.py)."""
        from mundy_tpu.driver.regrow import grow_int

        c = self.config
        if int(jnp.sum(state.rows.valid)) != c.num_spheres:
            # the row layout is the primary state: a build that dropped
            # particles has already lost their positions — nothing to
            # recover from (cannot happen mid-run: the sticky flag makes
            # run_blocks retry from the last complete state)
            raise RuntimeError("row state lost particles; cannot regrow")
        pos = self.positions(state)
        self.grid = self.grid.replace(
            row_capacity=grow_int(self.grid.row_capacity))
        self.__dict__.pop("_run_jit", None)
        rows = build_rows(pos, jnp.arange(c.num_spheres, dtype=jnp.int32),
                          self.grid)
        return state.replace(rows=rows, overflow=rows.overflow)

    def run(self, state: Optional[RowSpheresState] = None, log=print):
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
    def positions(self, state: RowSpheresState) -> Array:
        return self.metric.wrap(rows_to_flat(state.rows,
                                             self.config.num_spheres))

    def max_overlap(self, state: RowSpheresState) -> float:
        c = self.config
        two_r = 2.0 * c.radius

        def pair_fn(sep, r2, mask):
            d = jnp.sqrt(jnp.maximum(r2, 1e-24))
            ov = jnp.where(mask, jnp.maximum(two_r - d, 0.0), 0.0)
            # hijack the (..., 3) contract: store overlap in component 0
            out = jnp.zeros(sep.shape, sep.dtype)
            return out.at[..., 0].set(ov)

        # max via accumulate-sum isn't right; do a direct (jitted) pass
        def _worst(pos, valid):
            R = pos.shape[2]
            slot_ids = jax.lax.broadcasted_iota(jnp.int32, (1, 1, R), 2)
            worst = jnp.asarray(0.0, self.dtype)
            for dy in (-1, 0, 1):
                for dz in (-1, 0, 1):
                    cand_pos = jnp.roll(pos, (-dy, -dz), axis=(0, 1)) if (dy, dz) != (0, 0) else pos
                    cand_valid = jnp.roll(valid, (-dy, -dz), axis=(0, 1)) if (dy, dz) != (0, 0) else valid
                    sep = self.metric.sep(pos[..., :, None, :], cand_pos[..., None, :, :])
                    d = jnp.linalg.norm(sep, axis=-1)
                    mask = valid[..., :, None] & cand_valid[..., None, :]
                    if (dy, dz) == (0, 0):
                        mask = mask & (slot_ids[..., :, None] != slot_ids[..., None, :])
                    ov = jnp.where(mask, two_r - d, -jnp.inf)
                    worst = jnp.maximum(worst, jnp.max(ov))
            return worst

        if not hasattr(self, "_worst_jit"):
            self._worst_jit = jax.jit(_worst)
        return float(self._worst_jit(state.rows.pos, state.rows.valid))
