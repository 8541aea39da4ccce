"""Granular DEM: inertial spheres with frictional Hertzian contact.

The app-level exercise of the frictional contact kernels
(forces/friction.py — the reference's FrictionalHertzianContact family,
`scrap/parameter_interface/linkers/.../SpherocylinderSegmentSpherocylinder
SegmentFrictionalHertzianContact.cpp:440-520`, exercised at app scale by
`scrap/parameter_interface/alens/tests/performance_tests/
CollidingFrictionalSperm.cpp`). LAMMPS granular hertz/history convention:
spring-dashpot normal force, tangential spring on the per-contact
accumulated displacement with Coulomb cap, inertial (not overdamped)
integration, gravity settling into a box with a Hertzian floor.

Per-contact tangential history lives in the pair-list slots and is carried
across neighbor rebuilds BY PAIR IDENTITY (remap_gamma) — the slot-stable
warm start the reference gets for free from persistent linker entities.
"""

from __future__ import annotations

import dataclasses
import math as _math
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np
from jax import Array

from mundy_tpu.core.config import validate_config
from mundy_tpu.constraints import remap_gamma
from mundy_tpu.core.containers import pytree_dataclass
from mundy_tpu.forces.friction import frictional_hertzian_contact
from mundy_tpu.neighbor import (
    build_cell_list,
    build_pair_list,
    make_cell_grid,
    neighbor_matrix,
)


@dataclasses.dataclass
class GranularConfig:
    num_spheres: int = 2000
    box_size: float = 20.0  # x/y periodic-free box walls; z floor at 0
    radius: float = 0.5
    density: float = 1.0
    gravity: float = 10.0  # -z
    friction_coeff: float = 0.5
    normal_spring: float = 5e4
    normal_damping: float = 20.0
    tang_spring: float = 2e4
    tang_damping: float = 10.0
    wall_spring: float = 5e4
    dt: float = 1e-4
    num_steps: int = 1000
    skin: float = 0.3
    max_neighbors: int = 16
    cell_capacity: int = 16
    pair_capacity_per_body: int = 8
    chunk: int = 16384
    seed: int = 1234
    dtype: str = "float32"
    log_every: int = 200

    def __validate__(self):
        assert self.friction_coeff >= 0 and self.num_spheres > 0
        assert self.box_size > 4 * (self.radius + self.skin)


@pytree_dataclass
class GranularState:
    pos: Array  # (N, 3)
    vel: Array  # (N, 3)
    key: Array
    step: Array
    pairs: object  # PairList (unique i < j, skin-buffered)
    tang_disp: Array  # (C, 3) per-pair tangential history
    ref_pos: Array
    rebuild_count: Array
    overflow: Array


class GranularSim:
    def __init__(self, config: GranularConfig):
        self.config = c = config
        validate_config(config)
        self.dtype = jnp.dtype(c.dtype)
        self.search_radius = c.radius + 0.5 * c.skin
        ext = np.array([c.box_size, c.box_size, 2.0 * c.box_size])
        self.grid = make_cell_grid([0, 0, 0], ext, 2 * self.search_radius,
                                   (False,) * 3, self.dtype)
        self.pair_capacity = c.pair_capacity_per_body * c.num_spheres
        self.mass = (4.0 / 3.0) * _math.pi * c.density * c.radius**3

    def _broad_phase(self, pos):
        c = self.config
        clist = build_cell_list(pos, self.grid, c.cell_capacity)
        nmat = neighbor_matrix(
            pos, clist, jnp.asarray(self.search_radius, self.dtype),
            max_neighbors=c.max_neighbors,
            chunk=min(c.chunk, max(256, c.num_spheres)))
        pairs = build_pair_list(nmat, self.pair_capacity)
        return pairs, clist.overflow | nmat.overflow | pairs.overflow

    def init(self, key: Optional[Array] = None) -> GranularState:
        c = self.config
        if key is None:
            key = jax.random.PRNGKey(c.seed)
        kp, ks = jax.random.split(key)
        # loose cloud above the floor, settling under gravity
        pos = jax.random.uniform(
            kp, (c.num_spheres, 3), dtype=self.dtype,
            minval=jnp.asarray([2 * c.radius] * 3, self.dtype),
            maxval=jnp.asarray([c.box_size - 2 * c.radius,
                                c.box_size - 2 * c.radius,
                                2.0 * c.box_size - 2 * c.radius], self.dtype))
        pairs, ovf = self._broad_phase(pos)
        return GranularState(
            pos=pos, vel=jnp.zeros_like(pos), key=ks,
            step=jnp.asarray(0, jnp.int32), pairs=pairs,
            tang_disp=jnp.zeros((self.pair_capacity, 3), self.dtype),
            ref_pos=pos, rebuild_count=jnp.asarray(1, jnp.int32),
            overflow=ovf)

    def _wall_force(self, pos: Array) -> Array:
        """Hertzian-spring walls: floor z=0, ceiling, and the 4 box sides
        (frictionless; the reference confines via periphery level sets)."""
        c = self.config
        r = c.radius
        k = c.wall_spring

        def spring(over):
            return k * jnp.maximum(over, 0.0) ** 1.5

        f = jnp.zeros_like(pos)
        f = f.at[:, 2].add(spring(r - pos[:, 2]))  # floor
        f = f.at[:, 2].add(-spring(pos[:, 2] - (2.0 * c.box_size - r)))
        for ax in (0, 1):
            f = f.at[:, ax].add(spring(r - pos[:, ax]))
            f = f.at[:, ax].add(-spring(pos[:, ax] - (c.box_size - r)))
        return f

    def _inner_step(self, state: GranularState) -> GranularState:
        c = self.config
        res = frictional_hertzian_contact(
            state.pos, state.vel, jnp.asarray(c.radius, self.dtype),
            state.pairs, state.tang_disp, jnp.asarray(c.dt, self.dtype),
            normal_spring=c.normal_spring, normal_damping=c.normal_damping,
            tang_spring=c.tang_spring, tang_damping=c.tang_damping,
            friction_coeff=c.friction_coeff, density=c.density)
        f = res.forces + self._wall_force(state.pos)
        f = f.at[:, 2].add(-self.mass * c.gravity)
        vel = state.vel + (jnp.asarray(c.dt, self.dtype) / self.mass) * f
        pos = state.pos + jnp.asarray(c.dt, self.dtype) * vel
        return state.replace(pos=pos, vel=vel, tang_disp=res.tang_disp,
                             step=state.step + 1)

    def _rebuild(self, state: GranularState) -> GranularState:
        pairs, ovf = self._broad_phase(state.pos)
        # tangential history follows its contact by (i, j) identity
        tang = remap_gamma(state.pairs, state.tang_disp, pairs,
                           probes=self.config.max_neighbors)
        return state.replace(pairs=pairs, tang_disp=tang, ref_pos=state.pos,
                             rebuild_count=state.rebuild_count + 1,
                             overflow=state.overflow | ovf)

    def _run_n(self, state: GranularState, n_steps) -> GranularState:
        c = self.config
        target = jnp.asarray(n_steps, jnp.int32)
        skin_sq = jnp.asarray((0.5 * c.skin) ** 2, self.dtype)

        def moved(s):
            disp = s.pos - s.ref_pos
            return jnp.max(jnp.sum(disp * disp, axis=-1)) > skin_sq

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

    def run_block(self, state: GranularState, n_steps: int) -> GranularState:
        if not hasattr(self, "_run_jit"):
            self._run_jit = jax.jit(self._run_n)
        return self._run_jit(state, jnp.asarray(n_steps, jnp.int32))

    def regrow(self, state: GranularState) -> GranularState:
        from mundy_tpu.driver.regrow import grow_int

        c = self.config
        old_pairs, old_tang = state.pairs, state.tang_disp
        c.cell_capacity = grow_int(c.cell_capacity)
        c.max_neighbors = grow_int(c.max_neighbors)
        self.pair_capacity = grow_int(self.pair_capacity, align=1024)
        self.__dict__.pop("_run_jit", None)
        pairs, ovf = self._broad_phase(state.pos)
        tang = remap_gamma(old_pairs, old_tang, pairs, probes=c.max_neighbors)
        return state.replace(pairs=pairs, tang_disp=tang, ref_pos=state.pos,
                             overflow=ovf)

    def run(self, state: Optional[GranularState] = None, log=print):
        from mundy_tpu.driver.regrow import run_blocks

        c = self.config
        if state is None:
            state = self.init()

        def status(s, done, tps):
            ke = 0.5 * self.mass * float(jnp.sum(s.vel * s.vel))
            return (f"step {done}/{c.num_steps}  tps={tps:.1f}  "
                    f"KE={ke:.3e}  rebuilds={int(s.rebuild_count)}  "
                    f"overflow={bool(s.overflow)}")

        return run_blocks(self, state, c.num_steps, c.log_every, log, status)

    def kinetic_energy(self, state: GranularState) -> float:
        return float(0.5 * self.mass * jnp.sum(state.vel * state.vel))
