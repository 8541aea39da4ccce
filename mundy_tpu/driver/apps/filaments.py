"""BASELINE config #4: flexible filaments / flagella — chained
spherocylinder segments with Kirchhoff bending/twist mechanics + collision.

JAX re-design of the reference's sperm/filament pipeline
(`scrap/Sperm.cpp`, CollidingFrictionalSperm performance tests): per step
    1. rod internal forces (centerline-twist energy gradients, mech.rod)
    2. segment-segment Hertzian contact across filaments (adjacent
       same-filament segments excluded, like ExcludeConnectedEntities)
    3. optional active rest-curvature wave (the swimming drive,
       Sperm.cpp rest-curvature modulation)
    4. overdamped node update + edge-frame transport.

State is (F, M, 3) node positions — all filaments step in lockstep.
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
from mundy_tpu.dynamics import brownian_velocity_keyed
from mundy_tpu.forces.contact import effective_youngs, hertzian_pair_force
from mundy_tpu.geom import periodic
from mundy_tpu.mech import RodState, init_rod_edges, rod_internal_forces, update_rod_edges
from mundy_tpu.neighbor import build_cell_list, make_cell_grid, neighbor_matrix


def segment_contact_split_forces(payload_own, payload_all, idx, mask,
                                 metric, two_r, r_eff, e_eff):
    """Hertzian segment-segment contact for `payload_own` rows against
    candidates gathered from `payload_all` — the shared narrow phase of the
    single-device app (own == all) and the sharded engine (own = the
    shard's (S/d, 6) block, all = the replicated (S, 6) payload), so the
    two paths are arithmetically identical per segment.

    payload rows are [mid(3), half_edge(3)]; returns (f_start, f_end) of
    shape (S_own, 3) — the contact force split to the segment's two nodes
    by the arc parameter of the closest point.
    """
    from mundy_tpu.geom.distance import segment_closest_planes
    from mundy_tpu.neighbor.rows import orthorhombic_lengths

    n_all = payload_all.shape[0]
    idx = jnp.minimum(idx, n_all - 1)
    cand = payload_all[idx]  # (S_own, K, 6) — the one gather
    candT = jnp.transpose(cand, (2, 1, 0))  # (6, K, S_own)
    ownT = payload_own.T
    SX = candT[0] - ownT[0][None, :]
    SY = candT[1] - ownT[1][None, :]
    SZ = candT[2] - ownT[2][None, :]
    box = orthorhombic_lengths(metric)
    if box is not None:
        (lx, ly, lz), (px, py, pz) = box
        if px:
            SX = SX - lx * jnp.round(SX * (1.0 / lx))
        if py:
            SY = SY - ly * jnp.round(SY * (1.0 / ly))
        if pz:
            SZ = SZ - lz * jnp.round(SZ * (1.0 / lz))
    else:
        sep = metric.sep(payload_own[:, None, :3], cand[..., :3])
        SX, SY, SZ = (jnp.transpose(sep, (2, 1, 0))[i] for i in range(3))
    s, _t, DX, DY, DZ, d2 = segment_closest_planes(
        SX, SY, SZ,
        ownT[3][None, :], ownT[4][None, :], ownT[5][None, :],
        candT[3], candT[4], candT[5])
    d2c = jnp.maximum(d2, 1e-24)
    rinv = jax.lax.rsqrt(d2c)
    dist = d2c * rinv
    mag = hertzian_pair_force(dist - two_r, r_eff, e_eff)
    w = jnp.where(mask.T, -(mag * rinv), 0.0)  # (K, S_own)
    fx, fy, fz = w * DX, w * DY, w * DZ
    # distribute to segment nodes by the arc parameter of the contact
    ws, we = 1.0 - s, s
    f_start = jnp.stack([jnp.sum(ws * fx, axis=0),
                         jnp.sum(ws * fy, axis=0),
                         jnp.sum(ws * fz, axis=0)], axis=-1)
    f_end = jnp.stack([jnp.sum(we * fx, axis=0),
                       jnp.sum(we * fy, axis=0),
                       jnp.sum(we * fz, axis=0)], axis=-1)
    return f_start, f_end


def rft_velocity(pos, f, inv_drag, drag_anisotropy):
    """Resistive-force-theory mobility: v = F_par/gamma_par +
    F_perp/gamma_perp with the node tangent from adjacent edges.
    Anisotropy is what converts a curvature wave into net propulsion.
    Shape-agnostic on the leading (filament) axis — shared by the
    single-device app and the sharded engine."""
    edge_t = pos[:, 1:, :] - pos[:, :-1, :]
    edge_t = edge_t / jnp.maximum(
        jnp.linalg.norm(edge_t, axis=-1, keepdims=True), 1e-12)
    node_t = jnp.concatenate(
        [edge_t[:, :1, :],
         0.5 * (edge_t[:, :-1, :] + edge_t[:, 1:, :]),
         edge_t[:, -1:, :]], axis=1)
    node_t = node_t / jnp.maximum(
        jnp.linalg.norm(node_t, axis=-1, keepdims=True), 1e-12)
    f_par = jnp.sum(f * node_t, axis=-1, keepdims=True) * node_t
    f_perp = f - f_par
    return inv_drag * (f_par + f_perp / drag_anisotropy)


def rest_curvature_wave(step, n_fil, n_edges, amplitude, wave_k, wave_omega,
                       segment_length, dt, dtype):
    """Active rest-curvature wave kappa0(s, t) (the swimming drive,
    Sperm.cpp rest-curvature modulation) — filament-independent, so the
    sharded engine's per-shard slice equals the single-device rows."""
    if amplitude == 0.0:
        return jnp.zeros((n_fil, n_edges - 1, 3), dtype)
    s_arc = jnp.arange(1, n_edges, dtype=dtype) * segment_length
    t = step.astype(dtype) * dt
    wave = amplitude * jnp.sin(wave_k * s_arc - wave_omega * t)
    k0 = jnp.zeros((n_fil, n_edges - 1, 3), dtype)
    return k0.at[..., 0].set(wave[None, :])


@dataclasses.dataclass
class FilamentsConfig:
    num_filaments: int = 64
    nodes_per_filament: int = 16
    segment_length: float = 1.0
    radius: float = 0.25
    bend_modulus: float = 5.0
    stretch_stiffness: float = 200.0
    youngs_modulus: float = 500.0
    poissons_ratio: float = 0.3
    viscosity: float = 1.0
    # resistive-force-theory drag anisotropy: gamma_perp / gamma_par. 1.0 =
    # isotropic (no self-propulsion possible); slender-body value ~2.
    drag_anisotropy: float = 2.0
    diffusion_coeff: float = 0.0
    # active curvature wave (sperm swimming): kappa0(s, t) =
    # amplitude * sin(wave_k * s - wave_omega * t) about the body-1 axis
    active_amplitude: float = 0.0
    wave_k: float = 1.0
    wave_omega: float = 1.0
    box_size: float = 40.0
    dt: float = 1e-4
    num_steps: int = 100
    skin: float = 0.3
    max_neighbors: int = 24
    cell_capacity: int = 16
    chunk: int = 8192
    seed: int = 1234
    dtype: str = "float64"
    log_every: int = 100
    # "nmat" = compacted (N, K) packed-gather narrow phase (the default:
    # robust to chain/row-axis alignment), "rows" = dense row-block engine
    # (only competitive when chains are short vs the cell size), "auto" =
    # nmat
    contact_engine: str = "auto"

    def __validate__(self):
        assert self.nodes_per_filament >= 3
        assert self.contact_engine in ("auto", "rows", "nmat")


@pytree_dataclass
class FilamentsState:
    pos: Array  # (F, M, 3)
    rod: RodState  # edge frames per filament
    key: Array
    step: Array
    nmat: object
    ref_pos: Array  # (S, 3) segment midpoints at rebuild
    rebuild_count: Array
    overflow: Array


class FilamentsSim:
    def __init__(self, config: FilamentsConfig):
        self.config = c = config
        validate_config(config)
        self.dtype = jnp.dtype(c.dtype)
        self.F = c.num_filaments
        self.M = c.nodes_per_filament
        self.E = self.M - 1  # segments per filament
        self.S = self.F * self.E  # total segments
        box = np.array([c.box_size] * 3)
        self.metric = periodic(box, dtype=self.dtype)
        self.search_radius = 0.5 * c.segment_length + c.radius + 0.5 * c.skin
        self.grid = make_cell_grid([0, 0, 0], box, 2 * self.search_radius,
                                   (True,) * 3, self.dtype)
        # Engine default: the compacted (N, K) engine. The dense row engine
        # is mismatched to straight chains — a filament aligned near the
        # row (x) axis drops ALL its segments into one (y, z) column, so
        # the measured max row occupancy is ~15x the mean (R 56 -> 488 at
        # the 2000x50 benchmark config) and every step pays dense
        # R x 9R pair blocks sized by that worst column. The (N, K)
        # engine's packed-gather narrow phase costs ~4.3 ns/pair-row flat.
        if c.contact_engine not in ("auto", "rows", "nmat"):
            raise ValueError(
                f"contact_engine {c.contact_engine!r} not in "
                "('auto', 'rows', 'nmat')")
        self.contact_engine = (c.contact_engine if c.contact_engine != "auto"
                               else "nmat")
        if self.contact_engine == "rows":
            from mundy_tpu.neighbor.rows import make_row_grid
            self.row_grid = make_row_grid(
                [0, 0, 0], box, 2 * self.search_radius, self.S,
                capacity_slack=1.9, dtype=self.dtype, align=8)
            if self.row_grid.ny < 5 or self.row_grid.nz < 5:
                self.contact_engine = "nmat"
        self.inv_drag = 1.0 / (6.0 * _math.pi * c.viscosity * c.radius)
        # rows-layout broad-phase capacity slack (grown by regrow)
        self.rows_slack = 1.9
        # adjacency exclusion table: same-filament neighbors k-1, k+1
        seg_ids = np.arange(self.S)
        k = seg_ids % self.E
        left = np.where(k > 0, seg_ids - 1, -1)
        right = np.where(k < self.E - 1, seg_ids + 1, -1)
        self.exclude = jnp.asarray(np.stack([left, right], 1), jnp.int32)

    # ------------------------------------------------------------------
    def _segments(self, pos: Array):
        """(S,3) starts, ends, midpoints from (F, M, 3) nodes."""
        a = pos[:, :-1, :].reshape(self.S, 3)
        b = pos[:, 1:, :].reshape(self.S, 3)
        return a, b, 0.5 * (a + b)

    def _build_nmat(self, pos: Array):
        c = self.config
        _a, _b, mid = self._segments(pos)
        if self.contact_engine == "rows":
            from mundy_tpu.neighbor.rows import build_rows
            rows = build_rows(mid, jnp.arange(self.S, dtype=jnp.int32),
                              self.row_grid)
            return rows, rows.overflow
        # Rows-layout BUILD of the (N, K) matrix when the extraction
        # envelope admits it (the same per-class pattern as chromatin and
        # rods): the cell-list builder's candidate tables pay ~4.3 ns/row
        # computed-index gathers and dominate the filament rebuild. The
        # adjacency exclusion (same-filament k-1/k+1 — always in cutoff)
        # rides as 2 extra lanes and a post-filter.
        n_cells = int(c.box_size // (2 * self.search_radius))
        if self.dtype == jnp.float32 and n_cells >= 5:
            from mundy_tpu.neighbor.rows import (make_row_grid,
                                                 neighbor_matrix_rows,
                                                 rows_extract_feasible)
            k_want = c.max_neighbors + 2
            rg = make_row_grid([0, 0, 0], (c.box_size,) * 3,
                               2 * float(self.search_radius), self.S,
                               capacity_slack=self.rows_slack,
                               dtype=self.dtype, align=8)
            if rows_extract_feasible(rg, k_want):
                nmat = neighbor_matrix_rows(
                    mid, float(self.search_radius), (c.box_size,) * 3,
                    max_neighbors=k_want, grid=rg)
                excl_hit = jnp.any(
                    nmat.idx[:, :, None] == self.exclude[:, None, :],
                    axis=-1)
                nmat = nmat._replace(mask=nmat.mask & ~excl_hit,
                                     idx=jnp.where(excl_hit, self.S,
                                                   nmat.idx))
                return nmat, nmat.overflow
        clist = build_cell_list(mid, self.grid, c.cell_capacity)
        nmat = neighbor_matrix(
            mid, clist, jnp.asarray(self.search_radius, self.dtype),
            metric=self.metric, max_neighbors=c.max_neighbors,
            chunk=min(c.chunk, max(256, self.S)), exclude=self.exclude,
        )
        return nmat, clist.overflow | nmat.overflow

    def _contact_node_forces_rows(self, pos: Array, rows) -> Array:
        """Gather-free dense row-block segment contact (same physics as
        _contact_node_forces): midpoints refreshed into the (skin-buffered)
        row layout by ONE slot->gid gather, endpoints ride as payload
        half-edge vectors, every 9-stencil pair block runs the clamped
        segment-segment kernel as dense blocks, and the two node-split force
        sums return via one scatter each."""
        from mundy_tpu.neighbor.rows import (
            orthorhombic_lengths,
            pair_accumulate_segments,
        )

        c = self.config
        a, b, mid = self._segments(pos)
        e = 0.5 * (b - a)  # half-edge: a = mid - e, b = mid + e
        safe = jnp.minimum(rows.gid, self.S - 1)
        row_mid = jnp.where(rows.valid[..., None], mid[safe], rows.pos)
        row_e = jnp.where(rows.valid[..., None], e[safe], 0.0)
        # segment gid as f32 payload for the adjacency exclusion (exact to
        # 2^24; adjacency = |dg| == 1 within one filament)
        gid_f = jnp.where(rows.valid, rows.gid.astype(self.dtype),
                          jnp.asarray(-10.0, self.dtype))
        rows_cur = rows.replace(pos=row_mid)
        # python-float closure constants: weak typing keeps the state dtype
        two_r = float(2.0 * c.radius)
        r_eff = float(0.5 * c.radius)
        e_eff = float(effective_youngs(c.youngs_modulus, c.youngs_modulus,
                                       c.poissons_ratio, c.poissons_ratio))
        E = self.E

        def out_fn(s, t, dx, dy, dz, d2, own_g, cand_g):
            d2c = jnp.maximum(d2, 1e-24)
            rinv = jax.lax.rsqrt(d2c)
            dist = d2c * rinv
            mag = hertzian_pair_force(dist - two_r, r_eff, e_eff)
            # exclude same-filament adjacent segments (the nmat exclude
            # table): |dg| == 1 and min gid not at a filament boundary
            dg = cand_g - own_g
            min_g = jnp.minimum(own_g, cand_g)
            adjacent = (jnp.abs(jnp.abs(dg) - 1.0) < 0.5) & (
                jnp.abs(jnp.mod(min_g, float(E)) - (E - 1)) > 0.5)
            w = jnp.where(adjacent, 0.0, -(mag * rinv))
            fx, fy, fz = w * dx, w * dy, w * dz
            ws, we = 1.0 - s, s
            return (ws * fx, ws * fy, ws * fz, we * fx, we * fy, we * fz)

        fsx, fsy, fsz, fex, fey, fez = pair_accumulate_segments(
            rows_cur, orthorhombic_lengths(self.metric), row_e, out_fn,
            extra_fields=(gid_f,))
        fs_rows = jnp.stack([fsx, fsy, fsz], axis=-1)
        fe_rows = jnp.stack([fex, fey, fez], axis=-1)
        idx = jnp.where(rows.valid.reshape(-1), rows.gid.reshape(-1), self.S)
        f_start = jnp.zeros((self.S, 3), self.dtype).at[idx].set(
            fs_rows.reshape(-1, 3), mode="drop")
        f_end = jnp.zeros((self.S, 3), self.dtype).at[idx].set(
            fe_rows.reshape(-1, 3), mode="drop")
        node_f = jnp.zeros((self.F, self.M, 3), self.dtype)
        node_f = node_f.at[:, :-1, :].add(f_start.reshape(self.F, self.E, 3))
        node_f = node_f.at[:, 1:, :].add(f_end.reshape(self.F, self.E, 3))
        return node_f

    def _contact_node_forces(self, pos: Array, nmat) -> Array:
        """Hertzian segment contact -> node forces (F, M, 3); dispatches to
        the engine the search structure was built for."""
        if self.contact_engine == "rows":
            return self._contact_node_forces_rows(pos, nmat)
        return self._contact_node_forces_nmat(pos, nmat)

    def _contact_node_forces_nmat(self, pos: Array, nmat) -> Array:
        """(N, K) neighbor-matrix narrow phase: ONE packed payload gather
        (midpoint + half-edge, 6-wide — computed-index gathers cost
        ~4.3 ns/row regardless of width) feeding the component-plane
        segment kernel on (K, N) planes (lane axis = N, so no 4x lane
        padding from a (..., 3) minor axis). Same arithmetic as
        RodsSim._contact_forces_torques."""
        c = self.config
        a, b, mid = self._segments(pos)
        e = 0.5 * (b - a)
        payload = jnp.concatenate([mid, e], axis=1)  # (S, 6)
        e_eff = effective_youngs(c.youngs_modulus, c.youngs_modulus,
                                 c.poissons_ratio, c.poissons_ratio)
        f_start, f_end = segment_contact_split_forces(
            payload, payload, nmat.idx, nmat.mask, self.metric,
            2.0 * c.radius, float(0.5 * c.radius), float(e_eff))
        node_f = jnp.zeros((self.F, self.M, 3), self.dtype)
        node_f = node_f.at[:, :-1, :].add(f_start.reshape(self.F, self.E, 3))
        node_f = node_f.at[:, 1:, :].add(f_end.reshape(self.F, self.E, 3))
        return node_f

    def _rest_curvature(self, step: Array) -> Array:
        c = self.config
        return rest_curvature_wave(step, self.F, self.E, c.active_amplitude,
                                   c.wave_k, c.wave_omega, c.segment_length,
                                   c.dt, self.dtype)

    def _inner_step(self, state: FilamentsState) -> FilamentsState:
        c = self.config
        pos = state.pos
        f_rod, tau = rod_internal_forces(
            state.rod, pos, self._rest_curvature(state.step),
            c.bend_modulus, c.stretch_stiffness, c.segment_length,
        )
        f = f_rod + self._contact_node_forces(pos, state.nmat)
        vel = rft_velocity(pos, f, self.inv_drag, c.drag_anisotropy)
        if c.diffusion_coeff > 0:
            # gid-keyed counter stream (pure function of key/step/gid) —
            # shard-local generation in the sharded engine yields identical
            # noise (parallel/filaments_shard.py), same as chromatin
            bv = brownian_velocity_keyed(
                state.key, state.step,
                jnp.arange(self.F * self.M, dtype=jnp.int32),
                jnp.asarray(c.diffusion_coeff, self.dtype),
                c.dt, dtype=self.dtype)
            vel = vel + bv.reshape(self.F, self.M, 3)
        new_pos = pos + jnp.asarray(c.dt, self.dtype) * vel
        rod = update_rod_edges(state.rod, new_pos,
                               twist_rate=self.inv_drag * tau, dt=c.dt)
        return state.replace(pos=new_pos, rod=rod, step=state.step + 1)

    def _rebuild(self, state: FilamentsState) -> FilamentsState:
        nmat, ovf = self._build_nmat(state.pos)
        _a, _b, mid = self._segments(state.pos)
        return state.replace(nmat=nmat, ref_pos=mid,
                             rebuild_count=state.rebuild_count + 1,
                             overflow=state.overflow | ovf)

    def _run_n(self, state: FilamentsState, n_steps: int) -> FilamentsState:
        c = self.config
        target = jnp.asarray(n_steps, jnp.int32)
        skin_sq = jnp.asarray((0.5 * c.skin) ** 2, self.dtype)

        def moved(s):
            _a, _b, mid = self._segments(s.pos)
            disp = self.metric.sep(s.ref_pos, mid)
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

    def run_block(self, state: FilamentsState, n_steps: int) -> FilamentsState:
        # n_steps is traced (used only in comparisons), so one compiled
        # program serves every block size — no recompile per block length
        if not hasattr(self, '_run_jit'):
            self._run_jit = jax.jit(self._run_n)
        import jax.numpy as _jnp
        return self._run_jit(state, _jnp.asarray(n_steps, _jnp.int32))

    # ------------------------------------------------------------------
    def init(self, key: Optional[Array] = None) -> FilamentsState:
        """Straight filaments at random positions/orientations (clipped into
        the box), like the reference's chain declaration."""
        c = self.config
        if key is None:
            key = jax.random.PRNGKey(c.seed)
        kp, kd, ks = jax.random.split(key, 3)
        L = self.E * c.segment_length
        margin = L + 2 * c.radius
        start = jax.random.uniform(kp, (self.F, 3), dtype=self.dtype,
                                   minval=0.0, maxval=c.box_size)
        d = jax.random.normal(kd, (self.F, 3), dtype=self.dtype)
        d = d / jnp.linalg.norm(d, axis=1, keepdims=True)
        arc = jnp.arange(self.M, dtype=self.dtype) * c.segment_length
        pos = start[:, None, :] + arc[None, :, None] * d[:, None, :]
        pos = self.metric.wrap(pos.reshape(-1, 3)).reshape(self.F, self.M, 3)
        # NOTE: node coords are wrapped; rod edge vectors use min-image via
        # unwrapped local geometry — keep filaments shorter than box/2.
        assert margin < c.box_size / 2, "filament longer than half the box"
        # unwrap each filament relative to its first node for rod mechanics
        rel = self.metric.sep(pos[:, :1, :], pos)
        pos = pos[:, :1, :] + rel
        rod = init_rod_edges(pos)
        n_cells = int(c.box_size // (2 * self.search_radius))
        if (self.contact_engine == "nmat" and self.dtype == jnp.float32
                and n_cells >= 5):
            # Right-size the rows-extraction slack from the MEASURED midpoint
            # row occupancy: a straight filament aligned near the x axis drops
            # all its segments into one (y, z) column (~15x the mean), so the
            # default mean-occupancy slack overflows at benchmark-scale inits
            # — a sticky flag plus silently truncated rows in any run_block
            # window that never reaches the regrow loop.
            from mundy_tpu.neighbor.rows import make_row_grid
            _a0, _b0, mid0 = self._segments(pos)
            rg = make_row_grid([0, 0, 0], (c.box_size,) * 3,
                               2.0 * float(self.search_radius), self.S,
                               capacity_slack=self.rows_slack,
                               dtype=self.dtype, align=8)
            p = np.mod(np.asarray(jax.device_get(mid0)), c.box_size)
            iy = np.clip((p[:, 1] / (c.box_size / rg.ny)).astype(int),
                         0, rg.ny - 1)
            iz = np.clip((p[:, 2] / (c.box_size / rg.nz)).astype(int),
                         0, rg.nz - 1)
            occ = int(np.bincount(iy * rg.nz + iz,
                                  minlength=rg.ny * rg.nz).max())
            need = int(occ * 1.3) + 8
            if need > rg.row_capacity:
                mean = self.S / (rg.ny * rg.nz)
                self.rows_slack = max(self.rows_slack, (need - 8) / mean)
        nmat, ovf = self._build_nmat(pos)
        if self.contact_engine == "rows":
            # Right-size the row capacity from the measured max occupancy
            # (both directions): chain beads cluster far above the
            # mean-occupancy bound make_row_grid assumes, and slack is paid
            # every step in the pair kernel's R x ceil(9R/128) tiles. On
            # overflow the measured max is capped at capacity, so grow
            # until the build fits, then tighten once.
            for _ in range(8):
                if not bool(jax.device_get(ovf)):
                    break
                self.row_grid = self.row_grid.replace(
                    row_capacity=((int(self.row_grid.row_capacity * 1.5)
                                   + 7) // 8) * 8)
                nmat, ovf = self._build_nmat(pos)
            occ = jnp.sum(nmat.valid.reshape(-1, self.row_grid.row_capacity),
                          axis=1)
            tight = ((int(jax.device_get(jnp.max(occ)) * 1.125) + 4 + 7)
                     // 8) * 8
            if tight != self.row_grid.row_capacity:
                self.row_grid = self.row_grid.replace(row_capacity=tight)
                nmat, ovf = self._build_nmat(pos)
        _a, _b, mid = self._segments(pos)
        return FilamentsState(pos=pos, rod=rod, key=ks,
                              step=jnp.asarray(0, jnp.int32), nmat=nmat,
                              ref_pos=mid, rebuild_count=jnp.asarray(1, jnp.int32),
                              overflow=ovf)

    def regrow(self, state: FilamentsState) -> FilamentsState:
        """Grow the neighbor capacities and rebuild (driver/regrow.py)."""
        from mundy_tpu.driver.regrow import grow_int

        c = self.config
        c.cell_capacity = grow_int(c.cell_capacity)
        c.max_neighbors = grow_int(c.max_neighbors)
        if self.contact_engine == "rows":
            self.row_grid = self.row_grid.replace(
                row_capacity=grow_int(self.row_grid.row_capacity))
        self.rows_slack *= 1.5
        self.__dict__.pop("_run_jit", None)
        nmat, ovf = self._build_nmat(state.pos)
        _a, _b, mid = self._segments(state.pos)
        return state.replace(nmat=nmat, ref_pos=mid, overflow=ovf)

    def run(self, state: Optional[FilamentsState] = None, log=print):
        from mundy_tpu.driver.regrow import run_blocks

        c = self.config
        if state is None:
            state = self.init()

        def status(s, done, tps):
            return (f"step {done}/{c.num_steps}  tps={tps:.2f}  "
                    f"rebuilds={int(s.rebuild_count)}  "
                    f"overflow={bool(s.overflow)}")

        return run_blocks(self, state, c.num_steps, c.log_every, log, status)
