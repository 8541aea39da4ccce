"""Row-engine spherocylinder suspension (BASELINE config #3 at speed).

The gather-free treatment of the segment-segment narrow phase: rod centers
live in the dense row layout (neighbor/rows.py) with the orientation
quaternion riding as a payload channel; contact candidates are the 9 rolled
neighbor rows, and each (R x 9-block) pair block runs the branch-free
clamped segment-segment closest-point kernel + Hertzian contact + torque
as dense elementwise blocks — zero gathers on the hot path (the (N, K)
neighbor-matrix engine pays per-pair gathers of centers AND axes).

Physics identical to RodsSim (driver/apps/rods.py — mirrors the reference
SpherocylinderSegment linker kernels in `scrap/parameter_interface/linkers/
src/mundy_linkers/`): same contact law, same isotropic drag, same
node-Euler + quaternion update; equivalence is tested directly against it.
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
from mundy_tpu.driver.apps.rods import RodsConfig
from mundy_tpu.dynamics import brownian_velocity_keyed, euler_step_rigid
from mundy_tpu.forces.contact import effective_youngs, hertzian_pair_force
from mundy_tpu.geom import periodic
from mundy_tpu.geom.randomize import random_unit_quaternions
from mundy_tpu.math.quaternion import quat_rotate
from mundy_tpu.neighbor.rows import (
    RowState,
    build_rows,
    make_row_grid,
    moved_beyond_skin,
    orthorhombic_lengths,
    pair_accumulate_segments,
    rows_to_flat,
)


@pytree_dataclass
class RowRodsState:
    rows: RowState  # centers
    quat: Array  # (ny, nz, R, 4) orientations (body z = axis)
    key: Array
    step: Array
    rebuild_count: Array
    overflow: Array


class RowRodsSim:
    """Row-engine simulation for RodsConfig."""

    def __init__(self, config: RodsConfig, capacity_slack: float = 1.9):
        self.config = c = config
        validate_config(config)
        self.dtype = jnp.dtype(c.dtype)
        box = np.array([c.box_size] * 3)
        self.metric = periodic(box, dtype=self.dtype)
        # pair cutoff between centers = 2 * bounding radius + skin
        self.cutoff = c.length + 2 * c.radius + c.skin
        self.capacity_slack = capacity_slack
        self.grid = make_row_grid([0, 0, 0], box, self.cutoff, c.num_rods,
                                  capacity_slack=capacity_slack,
                                  dtype=self.dtype, align=8)
        if self.grid.ny < 5 or self.grid.nz < 5:
            raise ValueError("box too small for the row engine "
                             "(need >= 5 cells per periodic axis)")
        self.box_static = orthorhombic_lengths(self.metric)
        a_eff = (0.75 * (0.5 * c.length + c.radius)
                 * c.radius * c.radius) ** (1.0 / 3.0)
        self.inv_drag_t = 1.0 / (6.0 * _math.pi * c.viscosity * a_eff)
        self.inv_drag_r = 1.0 / (8.0 * _math.pi * c.viscosity * a_eff**3)
        self.e_eff = effective_youngs(c.youngs_modulus, c.youngs_modulus,
                                      c.poissons_ratio, c.poissons_ratio)

    # ------------------------------------------------------------------
    def init(self, key: Optional[Array] = None,
             pos: Optional[Array] = None,
             quat: Optional[Array] = None) -> RowRodsState:
        c = self.config
        if key is None:
            key = jax.random.PRNGKey(c.seed)
        kp, kq, ks = jax.random.split(key, 3)
        if pos is None:
            pos = jax.random.uniform(kp, (c.num_rods, 3), dtype=self.dtype,
                                     maxval=c.box_size)
        if quat is None:
            quat = random_unit_quaternions(kq, c.num_rods, dtype=self.dtype)
        rows = build_rows(jnp.asarray(pos, self.dtype),
                          jnp.arange(c.num_rods, dtype=jnp.int32), self.grid)
        # right-size R from measured occupancy (work scales with R)
        occ = jnp.sum(rows.valid.reshape(-1, self.grid.row_capacity), axis=1)
        max_occ = int(jax.device_get(jnp.max(occ)))
        tight = ((int(max_occ * 1.125) + 4 + 7) // 8) * 8
        if tight < self.grid.row_capacity:
            self.grid = self.grid.replace(row_capacity=tight)
            rows = build_rows(jnp.asarray(pos, self.dtype),
                              jnp.arange(c.num_rods, dtype=jnp.int32),
                              self.grid)
        quat_rows = self._payload_to_rows(jnp.asarray(quat, self.dtype), rows)
        return RowRodsState(rows=rows, quat=quat_rows, key=ks,
                            step=jnp.asarray(0, jnp.int32),
                            rebuild_count=jnp.asarray(1, jnp.int32),
                            overflow=rows.overflow)

    def _payload_to_rows(self, flat: Array, rows: RowState) -> Array:
        """Gather a flat gid-ordered payload into the row layout (identity
        quaternion on invalid slots)."""
        n = self.config.num_rods
        safe = jnp.minimum(rows.gid, n - 1)
        out = flat[safe]
        ident = jnp.zeros((flat.shape[-1],), flat.dtype).at[0].set(1.0)
        return jnp.where(rows.valid[..., None], out, ident)

    # ------------------------------------------------------------------
    def _forces_torques(self, rows: RowState, quat: Array):
        """Dense row-block segment-segment Hertzian contact.

        Computes axes = R(q) z once per rod (regular O(N)), then evaluates
        every candidate pair in the 9-row stencil on COMPONENT PLANES
        (pair_accumulate_segments): closest points of the two center
        segments, Hertzian push along the connecting line, and the torque
        from the surface contact point (matches
        RodsSim._contact_forces_torques arithmetic exactly)."""
        c = self.config
        # python-float closure constants: weak typing keeps the state dtype
        half = float(0.5 * c.length)
        two_r = float(2.0 * c.radius)
        r_eff = float(0.5 * c.radius)
        e_eff = float(self.e_eff)
        radius = float(c.radius)
        zhat = jnp.zeros((3,), self.dtype).at[2].set(1.0)
        axes = quat_rotate(quat, zhat)  # (ny, nz, R, 3)
        hedges = half * jnp.where(rows.valid[..., None], axes, 0.0)
        hx, hy, hz = hedges[..., 0], hedges[..., 1], hedges[..., 2]

        def out_fn(s, t, dx, dy, dz, d2, oex, _cex, oey, _cey, oez, _cez):
            d2c = jnp.maximum(d2, 1e-24)
            rinv = jax.lax.rsqrt(d2c)
            dist = d2c * rinv
            mag = hertzian_pair_force(dist - two_r, r_eff, e_eff)
            w = -(mag * rinv)  # force on the own rod along own -> cand
            fx, fy, fz = w * dx, w * dy, w * dz
            # contact point in the own-center frame: c1 + radius * d_hat
            # with c1 = (2s - 1) * half_edge
            u2 = 2.0 * s - 1.0
            rr = radius * rinv
            px = u2 * oex + rr * dx
            py = u2 * oey + rr * dy
            pz = u2 * oez + rr * dz
            return (fx, fy, fz,
                    py * fz - pz * fy,
                    pz * fx - px * fz,
                    px * fy - py * fx)

        fx, fy, fz, tx, ty, tz = pair_accumulate_segments(
            rows, self.box_static, hedges, out_fn,
            extra_fields=(hx, hy, hz))
        return (jnp.stack([fx, fy, fz], axis=-1),
                jnp.stack([tx, ty, tz], axis=-1))

    def _inner_step(self, state: RowRodsState) -> RowRodsState:
        c = self.config
        rows = state.rows
        force, torque = self._forces_torques(rows, state.quat)
        vel = self.inv_drag_t * force
        omega = self.inv_drag_r * torque
        if c.diffusion_coeff > 0:
            vel = vel + brownian_velocity_keyed(
                state.key, state.step, rows.gid,
                jnp.asarray(c.diffusion_coeff, self.dtype), c.dt,
                dtype=self.dtype)
        if c.rot_diffusion_coeff > 0:
            krot = jax.random.fold_in(state.key, 0x5EED)
            omega = omega + brownian_velocity_keyed(
                krot, state.step, rows.gid,
                jnp.asarray(c.rot_diffusion_coeff, self.dtype), c.dt,
                dtype=self.dtype)
        # no wrap between rebuilds (neighbor/rows.py): _rebuild wraps
        pos, quat = euler_step_rigid(rows.pos, state.quat, vel, omega,
                                     jnp.asarray(c.dt, self.dtype))
        pos = jnp.where(rows.valid[..., None], pos, rows.pos)
        return state.replace(rows=rows.replace(pos=pos), quat=quat,
                             step=state.step + 1)

    def _rebuild(self, state: RowRodsState) -> RowRodsState:
        c = self.config
        n = c.num_rods
        flat_pos = self.positions(state)
        # flatten the quaternion payload by gid, then regather
        fq = jnp.zeros((n, 4), self.dtype)
        idx = jnp.where(state.rows.valid.reshape(-1),
                        state.rows.gid.reshape(-1), n)
        fq = fq.at[idx].set(state.quat.reshape(-1, 4), mode="drop")
        rows = build_rows(flat_pos, jnp.arange(n, dtype=jnp.int32), self.grid)
        quat = self._payload_to_rows(fq, rows)
        return state.replace(rows=rows, quat=quat,
                             rebuild_count=state.rebuild_count + 1,
                             overflow=state.overflow | rows.overflow)

    def _run_n(self, state: RowRodsState, n_steps) -> RowRodsState:
        c = self.config
        target = jnp.asarray(n_steps, jnp.int32)

        def moved(s):
            return moved_beyond_skin(s.rows, self.metric, c.skin)

        # skin trigger computed in the BODY, carried as a flag the cond
        # reads (a while cond can't fuse with the body)
        def inner_cond(carry):
            s, done, fired = carry
            return jnp.logical_and(done < target, jnp.logical_not(fired))

        def inner_body(carry):
            s, done, _ = carry
            s = self._inner_step(s)
            return s, done + 1, moved(s)

        def outer_body(carry):
            s, done, _ = carry
            s = self._rebuild(s)
            carry = inner_body((s, done, jnp.asarray(False)))
            return jax.lax.while_loop(inner_cond, inner_body, carry)

        state, _, _ = jax.lax.while_loop(
            lambda carry: carry[1] < target, outer_body,
            (state, jnp.asarray(0, jnp.int32), jnp.asarray(False)))
        return state

    def run_block(self, state: RowRodsState, n_steps: int) -> RowRodsState:
        if not hasattr(self, "_run_jit"):
            self._run_jit = jax.jit(self._run_n)
        return self._run_jit(state, jnp.asarray(n_steps, jnp.int32))

    def regrow(self, state: RowRodsState) -> RowRodsState:
        from mundy_tpu.driver.regrow import grow_int

        c = self.config
        if int(jnp.sum(state.rows.valid)) != c.num_rods:
            raise RuntimeError("row state lost particles; cannot regrow")
        flat_pos = self.positions(state)
        fq = jnp.zeros((c.num_rods, 4), self.dtype)
        idx = jnp.where(state.rows.valid.reshape(-1),
                        state.rows.gid.reshape(-1), c.num_rods)
        fq = fq.at[idx].set(state.quat.reshape(-1, 4), mode="drop")
        self.grid = self.grid.replace(
            row_capacity=grow_int(self.grid.row_capacity))
        self.__dict__.pop("_run_jit", None)
        rows = build_rows(flat_pos, jnp.arange(c.num_rods, dtype=jnp.int32),
                          self.grid)
        return state.replace(rows=rows,
                             quat=self._payload_to_rows(fq, rows),
                             overflow=rows.overflow)

    def run(self, state: Optional[RowRodsState] = None, log=print):
        from mundy_tpu.driver.regrow import run_blocks

        c = self.config
        if state is None:
            state = self.init()

        def status(s, done, tps):
            return (f"step {done}/{c.num_steps}  tps={tps:.2f}  "
                    f"rebuilds={int(s.rebuild_count)}  "
                    f"overflow={bool(s.overflow)}")

        return run_blocks(self, state, c.num_steps, c.log_every, log, status)

    # diagnostics ------------------------------------------------------
    def positions(self, state: RowRodsState) -> Array:
        return self.metric.wrap(rows_to_flat(state.rows,
                                             self.config.num_rods))

    def quaternions(self, state: RowRodsState) -> Array:
        n = self.config.num_rods
        fq = jnp.zeros((n, 4), self.dtype)
        idx = jnp.where(state.rows.valid.reshape(-1),
                        state.rows.gid.reshape(-1), n)
        return fq.at[idx].set(state.quat.reshape(-1, 4), mode="drop")
