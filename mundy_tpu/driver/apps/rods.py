"""BASELINE config #3: spherocylinder (rod) suspension — segment-segment
narrow phase, Hertzian contact with torques, Brownian motion, rigid-body
Euler/quaternion update.

JAX re-design of the reference's rod pipeline: broad phase over rod AABBs
(ComputeAABB for spherocylinders), SpherocylinderSegmentSpherocylinderSegment
narrow-phase + Hertzian kernels (`scrap/parameter_interface/linkers/.../
SpherocylinderSegmentSpherocylinderSegmentHertzianContact`), contact-point
torque induction, and local-drag rigid mobility.
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
from mundy_tpu.core.containers import pytree_dataclass
from mundy_tpu.dynamics import brownian_velocity, brownian_angular_velocity
from mundy_tpu.dynamics.integrators import euler_step_rigid
from mundy_tpu.forces.contact import effective_youngs, hertzian_pair_force
from mundy_tpu.geom import periodic
from mundy_tpu.geom.distance import (segment_closest_planes,
                                     segment_segment_closest)
from mundy_tpu.math.quaternion import quat_rotate
from mundy_tpu.neighbor import build_cell_list, make_cell_grid, neighbor_matrix
from mundy_tpu.neighbor.rows import orthorhombic_lengths


@dataclasses.dataclass
class RodsConfig:
    num_rods: int = 10_000
    box_size: float = 60.0
    radius: float = 0.25
    length: float = 2.0  # cylindrical length between cap centers
    youngs_modulus: float = 1000.0
    poissons_ratio: float = 0.3
    viscosity: float = 1.0
    diffusion_coeff: float = 0.0  # translational
    rot_diffusion_coeff: float = 0.0
    dt: float = 1e-4
    num_steps: int = 1000
    skin: float = 0.3
    max_neighbors: int = 32
    cell_capacity: int = 16
    chunk: int = 16384
    seed: int = 1234
    dtype: str = "float32"
    log_every: int = 100
    # "rows" = gather-free dense row-block narrow phase (RowRodsSim, the
    # fast path), "nmat" = the (N, K) neighbor-matrix engine, "auto" picks
    # rows when the box admits >= 5 cells per axis
    engine: str = "auto"
    # "spherocylinder" (segment-segment narrow phase) or "ellipsoid"
    # (prolate ellipsoids, semi-axes (radius, radius, length/2 + radius):
    # shared-normal in-kernel minimization — multistart PGD + the L-BFGS
    # chart polish, the reference's EllipsoidEllipsoid.hpp:45-110 showcase)
    shape: str = "spherocylinder"
    ellipsoid_pgd_iters: int = 24
    ellipsoid_refine_iters: int = 8
    # temporal warm start (ellipsoid narrow phase): persist each pair
    # slot's converged shared normal; between rebuilds seed the PGD from
    # it and skip the 7-point multistart (the full sweep runs once per
    # rebuild to initialize the slots). Contact normals are strongly
    # step-coherent at dt where contacts persist, so the warm start cuts
    # the per-pair cost.
    ellipsoid_warm_start: bool = True
    ellipsoid_warm_pgd_iters: int = 6
    # frictional segment-segment contact (the CollidingFrictionalSperm
    # capability, `SpherocylinderSegmentSpherocylinderSegment
    # FrictionalHertzianContact.cpp:440-520`): tangential spring on the
    # accumulated contact-point slip, Coulomb-capped; slip velocity from
    # the LAGGED body velocities (explicit closure for overdamped
    # dynamics). History lives in the neighbor-row slots and is remapped
    # by pair identity across rebuilds.
    friction: bool = False
    friction_coeff: float = 0.5
    tang_spring: float = 100.0
    tang_damping: float = 0.0

    def __validate__(self):
        assert self.length >= 0 and self.radius > 0
        assert self.box_size > 2 * (self.length + 2 * self.radius + self.skin)
        assert self.engine in ("auto", "rows", "nmat")
        assert self.shape in ("spherocylinder", "ellipsoid")
        if self.friction:
            assert self.shape == "spherocylinder", \
                "friction runs on the segment narrow phase"


@pytree_dataclass
class RodsState:
    pos: Array  # (N, 3) centers
    quat: Array  # (N, 4) orientations (body z = axis)
    key: Array
    step: Array
    nmat: object  # NeighborMatrix
    ref_pos: Array
    rebuild_count: Array
    overflow: Array
    # (N, K, 3) per-pair-slot shared normals (ellipsoid warm start; a
    # (1, 1, 3) placeholder for spherocylinder runs)
    warm_n: Array = None
    # frictional-contact state (config.friction; (1, 1, 3)/(1, 3)
    # placeholders otherwise): per-slot tangential history + the lagged
    # body velocities the slip rate is evaluated from
    tang: Array = None
    prev_vel: Array = None
    prev_omega: Array = None


class RodsSim:
    def __init__(self, config: RodsConfig):
        self.config = c = config
        validate_config(config)
        self.dtype = jnp.dtype(c.dtype)
        box = np.array([c.box_size] * 3)
        self.metric = periodic(box, dtype=self.dtype)
        # bounding-sphere search radius (ComputeBoundingRadius analog)
        self.search_radius = 0.5 * c.length + c.radius + 0.5 * c.skin
        self.grid = make_cell_grid([0, 0, 0], box, 2 * self.search_radius,
                                   (True,) * 3, self.dtype)
        self.rows_slack = 1.9  # row-broad-phase slot slack (regrow-grown)
        # isotropic local drag for a rod of half-length+cap envelope
        a_eff = (0.75 * (0.5 * c.length + c.radius) * c.radius * c.radius) ** (1.0 / 3.0)
        self.inv_drag_t = 1.0 / (6.0 * _math.pi * c.viscosity * a_eff)
        self.inv_drag_r = 1.0 / (8.0 * _math.pi * c.viscosity * a_eff**3)

    # ------------------------------------------------------------------
    def _axes(self, quat: Array) -> Array:
        zhat = jnp.zeros((3,), self.dtype).at[2].set(1.0)
        return quat_rotate(quat, zhat)

    def _build_nmat(self, pos: Array):
        c = self.config
        n_cells = int(c.box_size // (2 * self.search_radius))
        if n_cells >= 5:
            # gather-free row-layout broad phase (one sort + dense K-nearest
            # extraction) instead of the cell-list builder's per-particle
            # candidate-table gathers. Gated on extraction work: the XLA
            # extraction's K passes each scan 9*R candidates per body, so
            # fat-cutoff/sparse regimes (rods: R~200, K=32) stay on the
            # cell-list builder unless the extraction kernel runs
            # (extract_kernel_ok: the K passes stay on chip).
            from mundy_tpu.neighbor.rows import (extract_kernel_ok,
                                                 make_row_grid,
                                                 neighbor_matrix_rows)

            rg = make_row_grid([0, 0, 0], (c.box_size,) * 3,
                               2 * float(self.search_radius), c.num_rods,
                               capacity_slack=self.rows_slack,
                               dtype=self.dtype, align=8)
            kernel_ok = extract_kernel_ok(rg, c.max_neighbors,
                                          jnp.dtype(self.dtype).itemsize)
            if kernel_ok or c.max_neighbors * rg.row_capacity <= 2048:
                nmat = neighbor_matrix_rows(
                    pos, float(self.search_radius), (c.box_size,) * 3,
                    max_neighbors=c.max_neighbors, grid=rg)
                return nmat, nmat.overflow
        clist = build_cell_list(pos, self.grid, c.cell_capacity)
        nmat = neighbor_matrix(
            pos, clist, jnp.asarray(self.search_radius, self.dtype),
            metric=self.metric, max_neighbors=c.max_neighbors,
            chunk=min(c.chunk, max(256, c.num_rods)),
        )
        return nmat, clist.overflow | nmat.overflow

    def _contact_forces_torques(self, pos: Array, quat: Array, nmat):
        """Segment-segment Hertzian contact over the neighbor matrix.

        Returns (forces (N,3), torques (N,3)). One-sided accumulation per
        rod row; torque from the contact-point moment arm.
        """
        c = self.config
        n = c.num_rods
        axis = self._axes(quat)  # (N, 3)
        half = float(0.5 * c.length)
        idx = jnp.minimum(nmat.idx, n - 1)

        # ONE packed payload gather per pair (midpoint + half-edge in one
        # row): computed-index gathers cost ~4.3 ns/ROW regardless of width,
        # so separate pos[idx] / axis[idx] gathers double the dominant cost
        hedge = half * axis
        payload = jnp.concatenate([pos, hedge], axis=1)  # (N, 6)
        cand = payload[idx]  # (N, K, 6) — the one gather

        # component planes transposed to (6, K, N): the minor axis is N, so
        # every per-pair plane is a wide contiguous vector — unlike an
        # (N, K, 3) layout with a size-3 minor axis
        candT = jnp.transpose(cand, (2, 1, 0))
        ownT = payload.T  # (6, N)
        SX = candT[0] - ownT[0][None, :]
        SY = candT[1] - ownT[1][None, :]
        SZ = candT[2] - ownT[2][None, :]
        box = orthorhombic_lengths(self.metric)
        if box is not None:
            (lx, ly, lz), (px, py, pz) = box
            if px:
                SX = SX - lx * jnp.round(SX * (1.0 / lx))
            if py:
                SY = SY - ly * jnp.round(SY * (1.0 / ly))
            if pz:
                SZ = SZ - lz * jnp.round(SZ * (1.0 / lz))
        else:
            sep = self.metric.sep(pos[:, None, :], pos[idx])
            SX, SY, SZ = (jnp.transpose(sep, (2, 1, 0))[i] for i in range(3))
        s, _t, DX, DY, DZ, d2 = segment_closest_planes(
            SX, SY, SZ,
            ownT[3][None, :], ownT[4][None, :], ownT[5][None, :],
            candT[3], candT[4], candT[5])

        d2c = jnp.maximum(d2, 1e-24)
        rinv = jax.lax.rsqrt(d2c)
        dist = d2c * rinv
        e_eff = effective_youngs(c.youngs_modulus, c.youngs_modulus,
                                 c.poissons_ratio, c.poissons_ratio)
        mag = hertzian_pair_force(dist - 2.0 * c.radius,
                                  float(0.5 * c.radius), float(e_eff))
        maskT = nmat.mask.T  # (K, N)
        w = jnp.where(maskT, -(mag * rinv), 0.0)
        fx, fy, fz = w * DX, w * DY, w * DZ
        # torque: contact point on OUR surface = own closest point
        # (2s - 1) * half_edge plus radius * d_hat
        u2 = 2.0 * s - 1.0
        rr = c.radius * rinv
        px_ = u2 * ownT[3][None, :] + rr * DX
        py_ = u2 * ownT[4][None, :] + rr * DY
        pz_ = u2 * ownT[5][None, :] + rr * DZ
        force = jnp.stack([jnp.sum(fx, axis=0), jnp.sum(fy, axis=0),
                           jnp.sum(fz, axis=0)], axis=-1)
        torque = jnp.stack([
            jnp.sum(py_ * fz - pz_ * fy, axis=0),
            jnp.sum(pz_ * fx - px_ * fz, axis=0),
            jnp.sum(px_ * fy - py_ * fx, axis=0)], axis=-1)
        return force, torque

    def _ellipsoid_narrow(self, pos: Array, quat: Array, nmat,
                          warm_n: Array = None):
        """Shared-normal narrow phase over the neighbor matrix; `warm_n`
        (N, K, 3) seeds the per-slot minimization from the previous step's
        converged normals (skips the 7-point multistart; the full sweep
        runs once per rebuild to initialize the slots)."""
        from mundy_tpu.geom.primitives import Ellipsoid

        c = self.config
        n = c.num_rods
        idx = jnp.minimum(nmat.idx, n - 1)
        a = 0.5 * c.length + c.radius  # polar semi-axis (body z = rod axis)
        radii = jnp.asarray([c.radius, c.radius, a], self.dtype)
        # min-image the candidate centers around our own
        pj = pos[idx]
        sep = self.metric.sep(pos[:, None, :], pj)
        cj = pos[:, None, :] + sep
        e_own = Ellipsoid(center=pos[:, None, :],
                          radii=radii[None, None, :],
                          orientation=quat[:, None, :])
        e_cand = Ellipsoid(center=cj, radii=radii[None, None, :],
                           orientation=quat[idx])
        from mundy_tpu.geom.distance import distance_ellipsoid_ellipsoid
        warm = warm_n is not None
        res = distance_ellipsoid_ellipsoid(
            e_own, e_cand,
            newton_iters=(c.ellipsoid_warm_pgd_iters if warm
                          else c.ellipsoid_pgd_iters),
            refine="lbfgs", refine_iters=c.ellipsoid_refine_iters,
            n0=warm_n)
        return res, idx

    def _contact_forces_torques_ellipsoid(self, pos: Array, quat: Array,
                                          nmat, warm_n: Array = None):
        """Prolate-ellipsoid Hertzian contact over the neighbor matrix.

        Narrow phase: shared-normal signed separation via the in-kernel
        minimization (geom/distance.distance_ellipsoid_ellipsoid, PGD
        multistart + L-BFGS chart polish — PGD alone stalls at O(0.1)
        errors on strong anisotropy, see test_geom_distance). ref: the
        linker kernels dispatching EllipsoidEllipsoid.hpp:45-110.

        Returns (force, torque, normals) — normals persist as the next
        step's warm seed.
        """
        c = self.config
        res, _idx = self._ellipsoid_narrow(pos, quat, nmat, warm_n)
        e_eff = effective_youngs(c.youngs_modulus, c.youngs_modulus,
                                 c.poissons_ratio, c.poissons_ratio)
        mag = hertzian_pair_force(res.dist, float(0.5 * c.radius),
                                  float(e_eff))
        mag = jnp.where(nmat.mask, mag, 0.0)
        f_pair = -mag[..., None] * res.normal  # push own along -n
        arm = res.point1 - pos[:, None, :]  # contact point on OUR surface
        t_pair = jnp.cross(arm, f_pair)
        # persist normals for ALL valid slots (round-4 advisor fix): every
        # seed then descends from the rebuild-time FULL multistart and is
        # refreshed each step, so a pair that first reaches contact between
        # rebuilds tracks its multistart basin continuously instead of
        # falling back to a single center-line start. (The earlier
        # near-only blanking existed to avoid FROZEN stale normals; a
        # per-step refresh removes that staleness at the source.)
        warm_out = jnp.where(nmat.mask[..., None], res.normal, 0.0)
        return (jnp.sum(f_pair, axis=1), jnp.sum(t_pair, axis=1), warm_out)

    def _inner_step(self, state: RodsState) -> RodsState:
        c = self.config
        warm_out = None
        tang_out = None
        if c.shape == "ellipsoid":
            seed = state.warm_n if c.ellipsoid_warm_start else None
            force, torque, nrm = self._contact_forces_torques_ellipsoid(
                state.pos, state.quat, state.nmat, warm_n=seed)
            if c.ellipsoid_warm_start:
                warm_out = nrm
        elif c.friction:
            from mundy_tpu.forces.friction import (
                frictional_segment_contact_rows)
            hedge = (0.5 * c.length) * self._axes(state.quat)
            res = frictional_segment_contact_rows(
                state.pos, hedge, state.prev_vel, state.prev_omega,
                state.nmat.idx, state.nmat.mask, state.tang,
                jnp.asarray(c.dt, self.dtype), c.radius,
                c.youngs_modulus, c.poissons_ratio, c.tang_spring,
                c.friction_coeff, tang_damping=c.tang_damping,
                metric=self.metric)
            force, torque, tang_out = res.forces, res.torques, res.tang_disp
        else:
            force, torque = self._contact_forces_torques(
                state.pos, state.quat, state.nmat)
        vel = self.inv_drag_t * force
        omega = self.inv_drag_r * torque
        if c.diffusion_coeff > 0:
            vel = vel + brownian_velocity(state.key, state.step, c.num_rods,
                                          jnp.asarray(c.diffusion_coeff, self.dtype),
                                          c.dt, dtype=self.dtype)
        if c.rot_diffusion_coeff > 0:
            omega = omega + brownian_angular_velocity(
                state.key, state.step, c.num_rods,
                jnp.asarray(c.rot_diffusion_coeff, self.dtype), c.dt, dtype=self.dtype)
        pos, quat = euler_step_rigid(state.pos, state.quat, vel, omega,
                                     jnp.asarray(c.dt, self.dtype), metric=self.metric)
        out = state.replace(pos=pos, quat=quat, step=state.step + 1)
        if warm_out is not None:
            out = out.replace(warm_n=warm_out)
        if tang_out is not None:
            # lag the TOTAL velocities (contact + noise): the next step's
            # slip rate sees the motion that actually happened
            out = out.replace(tang=tang_out, prev_vel=vel, prev_omega=omega)
        return out

    def _rebuild(self, state: RodsState) -> RodsState:
        c = self.config
        nmat, ovf = self._build_nmat(state.pos)
        if c.friction:
            # tangential history follows its contact by pair identity
            from mundy_tpu.forces.friction import remap_row_history
            state = state.replace(tang=remap_row_history(
                state.nmat.idx, state.nmat.mask, state.tang,
                nmat.idx, nmat.mask))
        state = state.replace(nmat=nmat, ref_pos=state.pos,
                              rebuild_count=state.rebuild_count + 1,
                              overflow=state.overflow | ovf)
        if c.shape == "ellipsoid" and c.ellipsoid_warm_start:
            # the rows reordered: re-seed EVERY valid slot from the full
            # multistart ONCE per rebuild (cold), so the per-step narrow
            # phase can ride the single warm seed until the next rebuild
            res, _idx = self._ellipsoid_narrow(state.pos, state.quat, nmat)
            state = state.replace(
                warm_n=jnp.where(nmat.mask[..., None], res.normal, 0.0))
        return state

    def _run_n(self, state: RodsState, n_steps: int) -> RodsState:
        c = self.config
        target = jnp.asarray(n_steps, jnp.int32)
        skin_sq = jnp.asarray((0.5 * c.skin) ** 2, self.dtype)

        def moved(s):
            disp = self.metric.sep(s.ref_pos, s.pos)
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
            (state, jnp.asarray(0, jnp.int32), jnp.asarray(False)),
        )
        return state

    def run_block(self, state: RodsState, n_steps: int) -> RodsState:
        # n_steps is traced (used only in comparisons), so one compiled
        # program serves every block size — no recompile per block length
        if not hasattr(self, '_run_jit'):
            self._run_jit = jax.jit(self._run_n)
        import jax.numpy as _jnp
        return self._run_jit(state, _jnp.asarray(n_steps, _jnp.int32))

    def init(self, key: Optional[Array] = None) -> RodsState:
        c = self.config
        if key is None:
            key = jax.random.PRNGKey(c.seed)
        kp, kq, ks = jax.random.split(key, 3)
        pos = jax.random.uniform(kp, (c.num_rods, 3), dtype=self.dtype,
                                 maxval=c.box_size)
        from mundy_tpu.geom import random_unit_quaternions

        quat = random_unit_quaternions(kq, c.num_rods, dtype=self.dtype)
        nmat, ovf = self._build_nmat(pos)
        if c.shape == "ellipsoid" and c.ellipsoid_warm_start:
            res, _i = self._ellipsoid_narrow(pos, quat, nmat)
            warm_n = jnp.where(nmat.mask[..., None], res.normal, 0.0)
        else:
            warm_n = jnp.zeros((1, 1, 3), self.dtype)
        if c.friction:
            tang = jnp.zeros(nmat.idx.shape + (3,), self.dtype)
            pvel = jnp.zeros((c.num_rods, 3), self.dtype)
        else:
            tang = jnp.zeros((1, 1, 3), self.dtype)
            pvel = jnp.zeros((1, 3), self.dtype)
        return RodsState(pos=pos, quat=quat, key=ks,
                         step=jnp.asarray(0, jnp.int32), nmat=nmat, ref_pos=pos,
                         rebuild_count=jnp.asarray(1, jnp.int32), overflow=ovf,
                         warm_n=warm_n, tang=tang, prev_vel=pvel,
                         prev_omega=jnp.zeros_like(pvel))

    def regrow(self, state: RodsState) -> RodsState:
        """Grow the neighbor capacities and rebuild (driver/regrow.py)."""
        from mundy_tpu.driver.regrow import grow_int

        c = self.config
        c.cell_capacity = grow_int(c.cell_capacity)
        c.max_neighbors = grow_int(c.max_neighbors)
        self.rows_slack *= 1.5  # row-slot overflow must also grow R
        self.__dict__.pop("_run_jit", None)
        nmat, ovf = self._build_nmat(state.pos)
        if c.friction:
            from mundy_tpu.forces.friction import remap_row_history
            state = state.replace(tang=remap_row_history(
                state.nmat.idx, state.nmat.mask, state.tang,
                nmat.idx, nmat.mask))
        state = state.replace(nmat=nmat, ref_pos=state.pos, overflow=ovf)
        if c.shape == "ellipsoid" and c.ellipsoid_warm_start:
            # K changed: re-seed the warm slots against the regrown rows
            res, _i = self._ellipsoid_narrow(state.pos, state.quat, nmat)
            state = state.replace(
                warm_n=jnp.where(nmat.mask[..., None], res.normal, 0.0))
        return state

    def run(self, state: Optional[RodsState] = None, log=print):
        from mundy_tpu.driver.regrow import run_blocks

        c = self.config
        if state is None:
            state = self.init()

        def status(s, done, tps):
            return (f"step {done}/{c.num_steps}  tps={tps:.2f}  "
                    f"rebuilds={int(s.rebuild_count)}  "
                    f"overflow={bool(s.overflow)}")

        return run_blocks(self, state, c.num_steps, c.log_every, log, status)

    def max_overlap(self, state: RodsState) -> float:
        _f, _t = None, None
        c = self.config
        nmat, _ = self._build_nmat(state.pos)
        axis = self._axes(state.quat)
        half = 0.5 * c.length
        idx = jnp.minimum(nmat.idx, c.num_rods - 1)
        pj = state.pos[idx]
        shift = self.metric.sep(state.pos[:, None, :], pj) - (pj - state.pos[:, None, :])
        pj = pj + shift
        aj = axis[idx]
        a0 = (state.pos - half * axis)[:, None, :]
        a1 = (state.pos + half * axis)[:, None, :]
        _s, _t2, c1, c2 = segment_segment_closest(
            jnp.broadcast_to(a0, pj.shape), jnp.broadcast_to(a1, pj.shape),
            pj - half * aj, pj + half * aj)
        d = jnp.linalg.norm(c2 - c1, axis=-1) - 2 * c.radius
        d = jnp.where(nmat.mask, d, jnp.inf)
        return float(-jnp.min(d))
