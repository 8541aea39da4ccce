"""BASELINE config #2: N spheres with LCP non-penetration constraints.

The JAX re-design of the reference's lcp_spheres driver
(`scrap/lcp_spheres/StkNgpLCP.cpp` main + time loop, SURVEY.md §3.1):
per step — broad phase (cell list) -> pair constraints (signed sep +
normals) -> matrix-free BBPGD with warm-started lagrange multipliers ->
Euler update with the constraint velocities. Mobility is pluggable: dry
local drag (the benchmark default) or neighbor-restricted RPY
(HYDRO_NEAREST).
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
from mundy_tpu.constraints import (
    collision_setup_spheres,
    remap_gamma,
    resolve_collisions,
)
from mundy_tpu.ops.segments import segment_windows
from mundy_tpu.core.containers import pytree_dataclass
from mundy_tpu.dynamics import brownian_velocity_keyed, euler_step
from mundy_tpu.geom import periodic
from mundy_tpu.mobility import (
    build_ewald_rpy,
    build_spectral_ewald,
    ewald_rpy_apply,
    local_drag_mobility,
    rpy_apply_neighbors,
    se_rpy_apply,
)
from mundy_tpu.mobility.spectral import make_se_geometry_tiles
from mundy_tpu.neighbor import (
    build_cell_list,
    build_pair_list_ordered,
    make_cell_grid,
    neighbor_matrix,
    neighbor_matrix_rows,
)


@dataclasses.dataclass
class LCPSpheresConfig:
    num_spheres: int = 10_000
    box_size: float = 40.0
    radius: float = 0.5
    # r_i = radius * (1 + U(-p, p)); mixed-size suspensions on the fast
    # paths (search, constraints, drag). Hydro modes are equal-radius RPY,
    # so polydispersity requires hydro == "none".
    polydispersity: float = 0.0
    viscosity: float = 1.0
    diffusion_coeff: float = 0.0
    dt: float = 1e-3
    num_steps: int = 100
    # constraint generation margin: pairs within 2r + buffer become
    # constraints (reference uses search boxes of the sphere AABBs)
    constraint_buffer: float = 0.2
    # active-set margin: each step the BBPGD solve runs only on pairs with
    # sep0 < active_margin (complementarity pins gamma = 0 beyond it as
    # long as the margin exceeds the per-step displacement scale; the
    # reference likewise builds constraints from a per-step search,
    # StkNgpLCP.cpp:468). None -> 0.5 * constraint_buffer.
    active_margin: Optional[float] = None
    max_allowable_overlap: float = 1e-5  # StkNgpLCP main param
    max_col_iterations: int = 10_000
    # "rpy_ring" = dense all-pairs RPY sharded over the device mesh by
    # ring-rotating source blocks (parallel/ring_rpy.py) — the mid-size
    # multi-chip dense-mobility mode, with Hilbert-curve particle ordering
    # applied at init so contiguous shard blocks are spatially local (the
    # reference's setup-time RCB balance, HP1...neigh_linker.cpp:820)
    hydro: str = "none"  # "none"|"rpy_neighbors"|"rpy_ewald"|"rpy_spectral"|"rpy_ring"
    pair_capacity_per_body: int = 2
    max_neighbors: int = 32
    cell_capacity: int = 16
    chunk: int = 32768
    seed: int = 1234
    dtype: str = "float32"
    log_every: int = 10

    def __validate__(self):
        assert self.hydro in ("none", "rpy_neighbors", "rpy_ewald",
                              "rpy_spectral", "rpy_ring"), self.hydro
        assert self.num_spheres > 0 and self.dt > 0
        assert 0.0 <= self.polydispersity < 1.0
        if self.polydispersity > 0:
            assert self.hydro == "none", \
                "the RPY hydro modes assume equal radii"


@pytree_dataclass
class LCPSpheresState:
    pos: Array
    gamma: Array  # (A,) active-set warm-start multipliers
    gamma_sel: Array  # (A,) int32 full-list slot per active pair (C = pad)
    gamma_full: Array  # (C,) rebuild-time snapshot for set-entry warm starts
    key: Array
    step: Array
    nmat: object  # NeighborMatrix (skin-buffered)
    pairs: object  # PairList (skin-buffered constraint candidates)
    hydro_nmat: object  # NeighborMatrix for hydrodynamics (wider cutoff)
    seg_starts: Array  # (nb,) first-pair index per body block (assembly)
    dual_full: Array  # (C,) full-list slot of each pair's (j,i) duplicate
    prev_cum: Array  # (C,) last step's active cumsum (warm-start map);
    #                  zeros = invalid (post-rebuild/resize)
    ref_pos: Array  # positions at last rebuild
    rebuild_count: Array
    lcp_iters: Array  # () int32 — last solve iterations
    lcp_iters_max: Array  # () int32 — max iterations since last reset
    lcp_residual: Array
    lcp_alpha: Array  # () last solve's final BB step (next solve's alpha0)
    act_count: Array  # () int32 — last step's active-pair count
    act_block_max: Array  # () int32 — last step's max active pairs per block
    overflow: Array


class LCPSpheresSim:
    def __init__(self, config: LCPSpheresConfig, mesh=None,
                 mesh_axis: str = "shard"):
        self.config = c = config
        validate_config(config)
        self.dtype = jnp.dtype(c.dtype)
        box = np.array([c.box_size] * 3)
        self.metric = periodic(box, dtype=self.dtype)
        self.radii = None
        self.search_radii = None
        if c.polydispersity > 0:
            rng = np.random.default_rng(c.seed + 777)
            rr = c.radius * (1.0 + c.polydispersity
                             * rng.uniform(-1.0, 1.0, c.num_spheres))
            self.radii = jnp.asarray(rr, self.dtype)
            self.search_radius = float(rr.max()) + 0.5 * c.constraint_buffer
            self.search_radii = self.radii + jnp.asarray(
                0.5 * c.constraint_buffer, self.dtype)
        else:
            self.search_radius = c.radius + 0.5 * c.constraint_buffer
        self.grid = make_cell_grid([0, 0, 0], box, 2 * self.search_radius,
                                   (True,) * 3, self.dtype)
        self.pair_capacity = c.pair_capacity_per_body * c.num_spheres
        # 1024 bodies per assembly block. The per-iteration Delassus matvec
        # reads nb * W^2 floats, which argues for small B — but W is set by
        # the MAX per-block active count, whose relative fluctuation grows
        # as blocks shrink (measured: B=512 left W at 2.3x the mean and ran
        # 20% SLOWER than B=1024 at 1M bodies), so B=1024 is the sweet spot
        self.seg_block = 1024
        self.seg_window = max(2048, 8 * self.seg_block)
        # the margin guards against pairs ACTIVATING within one step (its
        # scale is the per-step displacement) — unlike the skin buffer it
        # must not grow with the rebuild period, or wide-skin configs pay
        # for solve slots they never use
        self.active_margin = (c.active_margin if c.active_margin is not None
                              else 0.5 * min(c.constraint_buffer, 0.25))
        # STRIDED active layout: block b's active pairs live at slots
        # [b*W, b*W + count_b) — static window offsets, nothing to search
        # at rebuild (ops/segments.StridedWindows). W is right-sized at init(), adapted between
        # run blocks; total active capacity = nb * W.
        self.nb_blocks = -(-c.num_spheres // self.seg_block)
        self.act_window = 512
        # rows-broad-phase caps, grown by regrow() on overflow; K starts
        # generous (wide skin buffers raise the in-cutoff neighbor count —
        # K=12 overflows at buffer 0.5) and init() right-sizes it DOWN to
        # the measured max occupancy, so the slack costs one init rebuild
        self.rows_k = 20
        self.rows_slack = 1.9
        self.ewald = None
        self.spectral = None
        self.ring_apply = None
        if c.hydro == "rpy_ring":
            from jax.sharding import Mesh
            from mundy_tpu.parallel.ring_rpy import make_ring_rpy_apply
            if mesh is None:
                mesh = Mesh(np.array(jax.devices()), (mesh_axis,))
            d = mesh.shape[mesh_axis]
            assert c.num_spheres % d == 0, \
                "rpy_ring needs num_spheres divisible by the mesh axis"
            self.mesh = mesh
            self.ring_apply = make_ring_rpy_apply(
                mesh, mesh_axis, c.radius, c.viscosity,
                include_self=True, overlap_correction=True)
        if c.hydro == "rpy_spectral":
            # FFT wave sum + density-balanced real-space cutoff (the PVFMM
            # analog path; scales to 1M bodies where the direct k-sum dies).
            # Real space runs on the dense 3D-cell engine — no hydro
            # neighbor matrix (its K-pass build dominates wide cutoffs).
            from mundy_tpu.neighbor.cells3d import make_cell_grid3d
            self.spectral = build_spectral_ewald(
                c.box_size, c.radius, c.viscosity, tol=1e-4,
                n_particles=c.num_spheres, dtype=self.dtype)
            self.se_geom = make_se_geometry_tiles(self.spectral, c.num_spheres)
            self.hydro_cells_grid = make_cell_grid3d(
                [c.box_size] * 3, self.spectral.base.r_cut, c.num_spheres,
                dtype=self.dtype)
        if c.hydro == "rpy_ewald":
            # periodic long-range RPY with its own real-space cutoff (~L/4,
            # balancing k-mode count against real-space pair volume); the
            # hydro neighbor structure is built separately from the tighter
            # constraint search
            r_cut = 0.25 * c.box_size
            self.ewald = build_ewald_rpy(
                c.box_size, c.radius, c.viscosity,
                xi=3.0 / r_cut, r_cut=r_cut, tol=1e-4, dtype=self.dtype)
            self.hydro_search = 0.5 * r_cut
            self.hydro_grid = make_cell_grid(
                [0, 0, 0], np.array([c.box_size] * 3),
                2 * self.hydro_search, (True,) * 3, self.dtype)
        self._step_jit = jax.jit(self._step)

    @property
    def act_capacity(self) -> int:
        """Total active-pair slots of the strided layout (nb blocks x W)."""
        return self.nb_blocks * self.act_window

    def _pair_run_bound(self) -> int:
        """Max pairs per body = the broad phase's neighbor cap (rows path
        caps at rows_k; cell-list path uses max_neighbors)."""
        c = self.config
        n_cells = int(c.box_size // (2 * self.search_radius))
        return (min(c.max_neighbors, self.rows_k) if n_cells >= 5
                else c.max_neighbors)

    def _broad_phase(self, pos):
        c = self.config
        # row-layout broad phase when applicable (gather-free; ~10-30x faster
        # than the cell-list builder at scale), else the general path
        n_cells = int(c.box_size // (2 * self.search_radius))
        if n_cells >= 5:
            nmat = neighbor_matrix_rows(
                pos, float(self.search_radius), (c.box_size,) * 3,
                max_neighbors=min(c.max_neighbors, self.rows_k),
                capacity_slack=self.rows_slack,
                search_radii=self.search_radii,
            )
            clist_ovf = jnp.asarray(False)
        else:
            clist = build_cell_list(pos, self.grid, c.cell_capacity)
            sr = (self.search_radii if self.search_radii is not None
                  else jnp.asarray(self.search_radius, self.dtype))
            nmat = neighbor_matrix(
                pos, clist, sr,
                metric=self.metric, max_neighbors=c.max_neighbors,
                chunk=min(c.chunk, max(256, c.num_spheres)),
            )
            clist_ovf = clist.overflow
        pairs = build_pair_list_ordered(nmat, self.pair_capacity)
        from mundy_tpu.constraints.collision import (body_pair_starts,
                                                     pair_dual_slots)
        starts = body_pair_starts(nmat)
        seg = segment_windows(pairs.i, c.num_spheres, self.seg_block,
                              self.seg_window, body_starts=starts)
        # dual slots feed the block-local (scalar-mobility) Delassus apply;
        # a missing dual means the pair list is asymmetric (broken Newton
        # pairs) — an overflow in every hydro mode, but ONLY for pairs
        # that can reach contact before the next skin rebuild. Pairs
        # within ~1 ulp of the search radius legitimately round the
        # cutoff test differently per direction (pair_dual_slots
        # docstring); they sit at the full buffer separation where
        # gamma = 0 is provable, so they must not raise the sticky flag.
        radius = (self.radii if self.radii is not None
                  else jnp.asarray(c.radius, self.dtype))
        setup_reb = collision_setup_spheres(pos, radius, pairs,
                                            metric=self.metric)
        near = setup_reb.sep0 < jnp.asarray(0.5 * c.constraint_buffer,
                                            self.dtype)
        dual_full, dual_missing = pair_dual_slots(pairs, starts, nmat,
                                                  near=near)
        ovf = (clist_ovf | nmat.overflow | pairs.overflow | seg.overflow
               | dual_missing)
        if self.ewald is not None:
            hcl = build_cell_list(pos, self.hydro_grid, 4 * c.cell_capacity)
            # small chunk: the (chunk, 27*cap, 3) candidate buffers of the
            # wide hydro search otherwise exceed HBM at scale
            hmat = neighbor_matrix(
                pos, hcl, jnp.asarray(self.hydro_search, self.dtype),
                metric=self.metric, max_neighbors=8 * c.max_neighbors,
                chunk=min(4096, max(256, c.num_spheres)),
            )
            ovf = ovf | hcl.overflow | hmat.overflow
        else:
            hmat = nmat
        return nmat, pairs, hmat, seg.starts, dual_full, ovf

    def init(self, key: Optional[Array] = None) -> LCPSpheresState:
        c = self.config
        if key is None:
            key = jax.random.PRNGKey(c.seed)
        kpos, kstate = jax.random.split(key)
        pos = jax.random.uniform(kpos, (c.num_spheres, 3), dtype=self.dtype,
                                 maxval=c.box_size)
        if self.ring_apply is not None:
            # setup-time load balance (the stk::balance RCB role,
            # HP1...neigh_linker.cpp:820): Hilbert-order the particles so
            # each ring shard's contiguous block is spatially local
            from mundy_tpu.parallel.ring_rpy import hilbert_shard_permutation
            perm = hilbert_shard_permutation(np.asarray(pos), [0.0] * 3,
                                             [c.box_size] * 3)
            pos = pos[jnp.asarray(perm)]
        nmat, pairs, hmat, seg_starts, dual_full, ovf = self._broad_phase(pos)
        # Right-size the pair capacity: every BBPGD iteration scatters and
        # gathers over the FULL capacity, so slack is paid
        # 2x per iteration. Measure the real candidate count once at init and
        # shrink to 1.6x that (+margin); the sticky overflow flag catches
        # configs that densify later.
        count = int(jax.device_get(pairs.num_pairs))  # true count (may exceed capacity)
        tight = int(count * 1.3) + 512
        tight = ((tight + 1023) // 1024) * 1024
        resize = tight != self.pair_capacity
        self.pair_capacity = tight
        # Right-size the ROW capacity from measured occupancy: the rows
        # extraction scans (R, 9R) candidate blocks, so its cost goes as
        # R^2 — the default 1.9x mean-occupancy slack pays ~3.6x the
        # perfectly-packed scan. Overflow (clustering growing a row past
        # the tight cap) regrows slack 1.5x and rebuilds.
        if self._refit_rows_slack(pos):
            resize = True
        # Right-size the rows broad phase's K: the extraction runs K select
        # passes over the full candidate blocks, so K = 12 when the densest
        # body has 6 in-cutoff neighbors pays ~5 wasted passes per rebuild. Regrow re-widens K on overflow.
        n_cells = int(c.box_size // (2 * self.search_radius))
        if n_cells >= 5 and not bool(jax.device_get(nmat.overflow)):
            kmax = int(jax.device_get(
                jnp.max(jnp.sum(nmat.mask, axis=1, dtype=jnp.int32))))
            k_tight = max(4, -(-(kmax + 1) // 4) * 4)
            if k_tight < min(c.max_neighbors, self.rows_k):
                self.rows_k = k_tight
                resize = True
        if resize:  # windows need the un-truncated pair list
            nmat, pairs, hmat, seg_starts, dual_full, ovf = self._broad_phase(pos)
        # Right-size the assembly window from the measured per-block maximum
        counts = np.diff(np.append(np.asarray(jax.device_get(seg_starts)),
                                   int(jax.device_get(pairs.num_pairs))))
        w_tight = (int(counts.max() * 1.5) + 511) // 512 * 512
        if w_tight != self.seg_window:
            self.seg_window = w_tight
            nmat, pairs, hmat, seg_starts, dual_full, ovf = self._broad_phase(pos)
        # Size the active window from the measured near-contact per-block
        # maximum (a cold random start is the high-water mark: most close
        # pairs overlap).
        radius = (self.radii if self.radii is not None
                  else jnp.asarray(c.radius, self.dtype))
        setup0 = collision_setup_spheres(pos, radius, pairs,
                                         metric=self.metric)
        act = pairs.mask & (setup0.sep0 < self._dyn_margin(setup0))
        n_act = int(jax.device_get(jnp.sum(act)))
        act_i = np.asarray(jax.device_get(jnp.where(act, pairs.i,
                                                    c.num_spheres)))
        blk = np.bincount(act_i[act_i < c.num_spheres] // self.seg_block,
                          minlength=1)
        # 1.1x slack on a 64 grid: the solve's per-iteration matvec (and
        # the block-Delassus memory) scale with nb * W (resp. nb * W^2), so
        # window slack is paid every iteration — regrow/resize cover growth
        self.act_window = max(64, (int(blk.max() * 1.1) + 63) // 64 * 64)
        return LCPSpheresState(
            pos=pos,
            gamma=jnp.zeros((self.act_capacity,), self.dtype),
            gamma_sel=jnp.full((self.act_capacity,), self.pair_capacity,
                               jnp.int32),
            gamma_full=jnp.zeros((self.pair_capacity,), self.dtype),
            key=kstate,
            step=jnp.asarray(0, jnp.int32),
            nmat=nmat, pairs=pairs, hydro_nmat=hmat,
            seg_starts=seg_starts,
            dual_full=dual_full,
            prev_cum=jnp.zeros((self.pair_capacity,), jnp.int32),
            ref_pos=pos,
            rebuild_count=jnp.asarray(1, jnp.int32),
            lcp_iters=jnp.asarray(0, jnp.int32),
            lcp_iters_max=jnp.asarray(0, jnp.int32),
            lcp_residual=jnp.asarray(0.0, self.dtype),
            lcp_alpha=jnp.asarray(jnp.nan, self.dtype),
            act_count=jnp.asarray(n_act, jnp.int32),
            act_block_max=jnp.asarray(int(blk.max()), jnp.int32),
            overflow=ovf,
        )

    def _refit_rows_slack(self, pos) -> bool:
        """Set rows_slack so the row capacity sits just above the MEASURED
        max row occupancy (host-side bincount over the current positions).
        Returns True when the slack changed (caller rebuilds)."""
        c = self.config
        n_cells = int(c.box_size // (2 * self.search_radius))
        if n_cells < 5:
            return False
        from mundy_tpu.neighbor.rows import make_row_grid
        g = make_row_grid([0, 0, 0], [c.box_size] * 3,
                          2 * self.search_radius, c.num_spheres,
                          capacity_slack=self.rows_slack, dtype=self.dtype,
                          align=8)
        p = np.asarray(jax.device_get(pos))
        p = np.mod(p, c.box_size)
        iy = np.minimum((p[:, 1] // float(g.cell_yz[0])).astype(np.int64),
                        g.ny - 1)
        iz = np.minimum((p[:, 2] // float(g.cell_yz[1])).astype(np.int64),
                        g.nz - 1)
        occ = np.bincount(iy * g.nz + iz, minlength=g.ny * g.nz)
        mean = c.num_spheres / (g.ny * g.nz)
        target_cap = ((int(occ.max() * 1.12) + 6 + 7) // 8) * 8
        slack = max(1.15, (target_cap - 8) / mean)
        if abs(slack - self.rows_slack) / self.rows_slack < 0.05:
            return False
        self.rows_slack = slack
        return True

    def _rebuild(self, state: LCPSpheresState) -> LCPSpheresState:
        nmat, pairs, hmat, seg_starts, dual_full, ovf = self._broad_phase(state.pos)
        # warm-start multipliers survive the rebuild BY PAIR IDENTITY: the
        # re-sorted list scrambles slots exactly when the solve is most
        # expensive (weak #5). Scatter the active multipliers onto the old
        # full list (rebuilds are rare — the per-step path never scatters),
        # remap into the new list, and invalidate the active slot map so
        # the next step warm-starts from the remapped snapshot.
        gfull_old = jnp.zeros((self.pair_capacity,), self.dtype)
        gfull_old = gfull_old.at[state.gamma_sel].set(
            jnp.where(state.gamma_sel < self.pair_capacity, state.gamma, 0.0),
            mode="drop")
        from mundy_tpu.constraints.collision import body_pair_starts
        gamma_full = remap_gamma(state.pairs, gfull_old, pairs,
                                 probes=self._pair_run_bound(),
                                 old_starts=body_pair_starts(state.nmat),
                                 old_nmat=state.nmat)
        return state.replace(nmat=nmat, pairs=pairs, hydro_nmat=hmat,
                             seg_starts=seg_starts,
                             dual_full=dual_full,
                             prev_cum=jnp.zeros_like(state.prev_cum),
                             gamma=jnp.zeros_like(state.gamma),
                             gamma_sel=jnp.full_like(state.gamma_sel,
                                                     self.pair_capacity),
                             gamma_full=gamma_full,
                             ref_pos=state.pos,
                             rebuild_count=state.rebuild_count + 1,
                             overflow=state.overflow | ovf)

    def _mobility(self, pos, nmat):
        """Returns (apply_fn, overflow): `overflow` flags per-step hydro
        data-structure overflow (SE binning rows / 3D cells), which DROPS
        bodies from the mobility sum and must reach state.overflow."""
        c = self.config
        no_ovf = jnp.asarray(False)
        if c.hydro == "none":
            if self.radii is not None:
                inv_drag = (1.0 / (6.0 * _math.pi * c.viscosity
                                   * self.radii))[:, None]
                return (lambda f: inv_drag * f), no_ovf
            return (lambda f: local_drag_mobility(f, c.radius, c.viscosity)), no_ovf
        if c.hydro == "rpy_spectral":
            # bin + build cells once per step: positions are fixed across
            # the O(10-100) mobility applies of the BBPGD solve. Dense
            # gridding + dense 3D-cell real space — pure XLA, runs inside
            # the fused nested-while run program.
            from mundy_tpu.mobility.spectral import se_rpy_apply_cells
            from mundy_tpu.neighbor.cells3d import build_cells3d
            from mundy_tpu.mobility.spectral import se_bin_geom
            pieces = se_bin_geom(self.se_geom, pos, self.dtype)
            cells = build_cells3d(pos, self.hydro_cells_grid)
            # overflow: binning rows (pieces[1]) and cells — both DROP
            # bodies from the hydro sum, so surface them to the caller
            ovf = pieces[1] | cells.overflow
            return (lambda f: se_rpy_apply_cells(
                self.spectral, cells, pos, f, (c.box_size,) * 3,
                self.se_geom, pieces=pieces)[0]), ovf
        if c.hydro == "rpy_ring":
            # dense all-pairs RPY ring-rotated over the mesh; the BBPGD
            # solve calls this every iteration, so each iteration's dots
            # ride the same ICI ring the mobility does
            return (lambda f: self.ring_apply(pos, f)), no_ovf
        if c.hydro == "rpy_ewald":
            return (lambda f: ewald_rpy_apply(self.ewald, pos, f, nmat,
                                              self.metric)), no_ovf
        return (lambda f: rpy_apply_neighbors(
            pos, f, nmat, c.radius, c.viscosity, metric=self.metric,
            overlap_correction=True,
        )), no_ovf

    def _dyn_margin(self, setup) -> Array:
        """Active-set margin = static margin + deepest current overlap.

        Per-step displacements scale with the deepest overlap being
        resolved (a 0.9-deep cold-start contact pushes both bodies ~0.45
        in one constrained step), so a STATIC margin truncates pairs that
        the exact solve would activate — observed as a 2e-2 trajectory
        deviation vs the full-list solve over a 30-step cold relax. Adding
        the deepest overlap makes the cold start activate (nearly) the
        whole buffered list (exact) while steady state pays only the
        near-contact set."""
        sep0 = jnp.where(setup.pairs.mask, setup.sep0,
                         jnp.asarray(jnp.inf, self.dtype))
        deepest = jnp.maximum(-jnp.min(sep0), 0.0)
        return jnp.asarray(self.active_margin, self.dtype) + deepest

    def _inner_step(self, state: LCPSpheresState) -> LCPSpheresState:
        """Constraint assembly + BBPGD + Euler against the skin-buffered pair
        list (separations/normals recomputed from current positions each
        step; stale far pairs simply yield gamma = 0). The reference rebuilds
        its BVH each step — the skin buffer makes that unnecessary without
        missing contacts while displacements stay under skin/2."""
        c = self.config
        pos = state.pos
        pairs = state.pairs
        overflow = state.overflow

        radius = (self.radii if self.radii is not None
                  else jnp.asarray(c.radius, self.dtype))
        setup_full = collision_setup_spheres(pos, radius, pairs,
                                             metric=self.metric)
        # Active-set compaction: the solve's per-iteration gathers scale
        # with slot count, and beyond the margin complementarity pins
        # gamma = 0, so only near-contact pairs enter the iterations. The
        # margin is DYNAMIC — static margin + the deepest current overlap —
        # because per-step displacements scale with the overlap being
        # resolved: a cold start activates (nearly) the whole list, so the
        # truncated solve equals the full solve; steady state shrinks to
        # the near-contact set (traced scalar: no recompiles).
        # STRIDED layout: block b's actives land at [b*W, b*W + count_b),
        # so the assembly's block windows have static offsets — one
        # blocked reduction per D-apply (ops/segments.py).
        # Warm start and the block-local dual map both come out of the
        # compaction as GATHERS into this/last step's cumsum — the
        # inverse-scatter warm map this replaces cost 44 ms/step at 1M
        # (one (C,) scatter); see active_pair_subset_strided.
        from mundy_tpu.constraints.collision import (
            active_pair_subset_strided, make_band_delassus_apply)
        fused_drag = c.hydro == "none"
        act = active_pair_subset_strided(
            setup_full, self._dyn_margin(setup_full), c.num_spheres,
            self.seg_block, self.act_window, state.seg_starts,
            dual_full=state.dual_full if fused_drag else None,
            prev=(state.prev_cum, state.gamma, self.act_window),
            gamma_full=state.gamma_full)
        setup, sel, n_act, block_max = (act.setup, act.sel, act.n_act,
                                        act.block_max)
        gamma0 = act.gamma0
        overflow = overflow | act.overflow

        mobility, hydro_ovf = self._mobility(pos, state.hydro_nmat)
        overflow = overflow | hydro_ovf

        apply_override = None
        if fused_drag:
            # scalar mobility: the Delassus apply runs block-local (one
            # banded half-apply + one (A,) dual gather per iteration —
            # no global (A, 3) velocity gathers; collision.py)
            if self.radii is not None:
                invdrag = 1.0 / (6.0 * _math.pi * c.viscosity * self.radii)
                nsafe = c.num_spheres - 1
                mob_i = invdrag[jnp.minimum(setup.pairs.i, nsafe)]
                mob_j = invdrag[jnp.minimum(setup.pairs.j, nsafe)]
            else:
                mob = 1.0 / (6.0 * _math.pi * c.viscosity * c.radius)
                mob_i = mob_j = jnp.asarray(mob, self.dtype)
            # banded i-side Delassus: the active list is i-sorted, so each
            # body's pairs are contiguous and M[p, q] lives within
            # |p - q| < per-body neighbor cap. Assembly is (k-1) shifted
            # FMAs over (A,) once per step; each BBPGD iteration is
            # ~(k-1)*A band traffic (~40 MB at 1M) + the dual gather —
            # replaces both the (nb, W, W) dense-block assembly (~1.6 GB)
            # and its per-iteration GEMV.
            apply_override = make_band_delassus_apply(
                setup, act.dual, c.dt, self._pair_run_bound(),
                mobility_i=mob_i, mobility_j=mob_j)

        # Brownian drift is a KNOWN velocity: it enters the LCP's constant
        # term so the solve enforces non-penetration of the actual
        # end-of-step positions (without it the noise re-penetrates pairs
        # after every solve and overlap stalls at the per-step drift scale
        # ~sqrt(2 D dt) instead of max_allowable_overlap).
        u_ext = None
        if c.diffusion_coeff > 0:
            # gid-keyed counter stream: noise is a pure function of
            # (key, step, gid) — identical across dtypes (the f32 drift
            # metric needs matched streams) and shard-local when the pair
            # pipeline runs over the slab engine
            u_ext = brownian_velocity_keyed(
                state.key, state.step,
                jnp.arange(c.num_spheres, dtype=jnp.int32),
                jnp.asarray(c.diffusion_coeff, self.dtype),
                c.dt, dtype=self.dtype)

        gamma, vel, res = resolve_collisions(
            setup, mobility, c.num_spheres, c.dt,
            max_allowable_overlap=c.max_allowable_overlap,
            max_iterations=c.max_col_iterations,
            gamma0=gamma0,
            u_ext=u_ext,
            alpha0=state.lcp_alpha,
            apply_override=apply_override,
        )

        if u_ext is not None:
            vel = vel + u_ext

        new_pos = euler_step(pos, vel, jnp.asarray(c.dt, self.dtype), metric=self.metric)
        return state.replace(
            pos=new_pos, gamma=gamma, gamma_sel=sel, prev_cum=act.cum,
            step=state.step + 1,
            lcp_iters=res.num_iters,
            lcp_iters_max=jnp.maximum(state.lcp_iters_max, res.num_iters),
            lcp_residual=res.residual, lcp_alpha=res.alpha,
            act_count=n_act, act_block_max=block_max.astype(jnp.int32),
            overflow=overflow,
        )

    def _step(self, state: LCPSpheresState) -> LCPSpheresState:
        """Single step with skin-triggered rebuild (for one-off stepping)."""
        c = self.config
        disp = self.metric.sep(state.ref_pos, state.pos)
        moved = jnp.max(jnp.sum(disp * disp, axis=-1)) > (0.5 * c.constraint_buffer) ** 2
        state = jax.lax.cond(moved, self._rebuild, lambda s: s, state)
        return self._inner_step(state)

    def step(self, state: LCPSpheresState) -> LCPSpheresState:
        return self._step_jit(state)

    def _run_n(self, state: LCPSpheresState, n_steps) -> LCPSpheresState:
        c = self.config
        target = jnp.asarray(n_steps, jnp.int32)
        skin_sq = jnp.asarray((0.5 * c.constraint_buffer) ** 2, self.dtype)

        def moved(s):
            disp = self.metric.sep(s.ref_pos, s.pos)
            return jnp.max(jnp.sum(disp * disp, axis=-1)) > skin_sq

        # skin trigger computed in the BODY, carried as a flag the conds
        # read (a while cond can't fuse with the body; see _burst)
        def inner_cond(carry):
            s, done, fired = carry
            return jnp.logical_and(done < target, jnp.logical_not(fired))

        def inner_body(carry):
            s, done, _ = carry
            s = self._inner_step(s)
            return s, done + 1, moved(s)

        def outer_body(carry):
            s, done, fired = carry
            # rebuild only when the skin trigger fired (an unconditional
            # entry rebuild would pay the broad phase per program entry
            # instead of per skin violation)
            s = jax.lax.cond(fired, self._rebuild, lambda x: x, s)
            carry = inner_body((s, done, jnp.asarray(False)))
            return jax.lax.while_loop(inner_cond, inner_body, carry)

        state, _, _ = jax.lax.while_loop(
            lambda carry: carry[1] < target, outer_body,
            (state, jnp.asarray(0, jnp.int32), moved(state)),
        )
        return state

    def _burst(self, state: LCPSpheresState, n_steps):
        """Up to n_steps inner steps with NO rebuild branch in the program:
        stops early (done < n_steps) when the skin trigger fires — the
        host then runs the rebuild as its own program and re-enters.

        Why: carrying the conditional rebuild inside the fused while loop
        drags the full pair-list state of the cond's untaken branch through
        every loop iteration. Host-driven cadence pays one program launch
        per burst/rebuild call instead.

        The skin trigger is computed IN THE BODY and carried as a flag the
        cond merely reads: a while cond is a separate XLA computation that
        cannot fuse with the body, so moved() in the cond would re-stream
        pos/ref_pos per iteration; the same reduction in the body fuses
        into the step."""
        target = jnp.asarray(n_steps, jnp.int32)
        skin_sq = jnp.asarray((0.5 * self.config.constraint_buffer) ** 2,
                              self.dtype)

        def moved(s):
            disp = self.metric.sep(s.ref_pos, s.pos)
            return jnp.max(jnp.sum(disp * disp, axis=-1)) > skin_sq

        def cond(carry):
            s, done, fired = carry
            return jnp.logical_and(done < target, jnp.logical_not(fired))

        def body(carry):
            s, done, _ = carry
            s = self._inner_step(s)
            return s, done + 1, moved(s)

        s, done, _ = jax.lax.while_loop(
            cond, body, (state, jnp.asarray(0, jnp.int32), moved(state)))
        return s, done

    def run_block(self, state: LCPSpheresState, n_steps: int,
                  resize: bool = True) -> LCPSpheresState:
        if not hasattr(self, "_burst_jit"):
            self._burst_jit = jax.jit(self._burst)
            self._rebuild_jit = jax.jit(self._rebuild)
        done = 0
        while done < n_steps:
            # one device program runs the rest of the block, or up to the
            # step whose skin check fires
            k = n_steps - done
            state, d = self._burst_jit(state, jnp.asarray(k, jnp.int32))
            d = int(d)
            done += d
            if d < k:
                # skin fired (possibly at entry): rebuild in its own
                # program, then re-enter the burst — same trigger, same
                # ordering as the old fused rebuild-then-step cadence
                state = self._rebuild_jit(state)
        # resize=False: step at the current capacities (a capacity re-fit
        # eagerly recompiles the fused program, ~40-90 s at 1M — callers
        # timing a steady-state window skip it and resize between windows)
        if resize:
            state = self._refit_broad(state)
            state = self._resize_active(state)
        return state

    def _refit_broad(self, state: LCPSpheresState) -> LCPSpheresState:
        """Between blocks: shrink the rows broad phase to the CURRENT state
        — rows_k to the measured max neighbor count (the extraction runs K
        argmin passes, each a full candidate scan, so cold-start slack is
        paid on every rebuild) and rows_slack to the measured max row
        occupancy (scan cost ~ R^2). A cold random start overlaps heavily,
        so init's right-sizing lands well above the steady-state need.
        Shrinks demand TWO consecutive blocks (each refit rebuilds and
        recompiles the fused program)."""
        c = self.config
        n_cells = int(c.box_size // (2 * self.search_radius))
        if n_cells < 5 or bool(jax.device_get(state.overflow)):
            return state
        kmax = int(jax.device_get(
            jnp.max(jnp.sum(state.nmat.mask, axis=1, dtype=jnp.int32))))
        k_tight = max(4, -(-(kmax + 1) // 4) * 4)
        want_k = k_tight < min(c.max_neighbors, self.rows_k)
        slack_old = self.rows_slack
        want_slack = self._refit_rows_slack(state.pos)
        if not (want_k or want_slack):
            self._broad_shrink_streak = 0
            return state
        streak = getattr(self, "_broad_shrink_streak", 0)
        if streak < 1:
            self.rows_slack = slack_old  # defer (hysteresis)
            self._broad_shrink_streak = streak + 1
            return state
        self._broad_shrink_streak = 0
        if want_k:
            self.rows_k = k_tight
        state = self._rebuild(state)
        self.__dict__.pop("_burst_jit", None)
        self._step_jit = jax.jit(self._step)
        self._burst_jit = jax.jit(self._burst)
        self._rebuild_jit = jax.jit(self._rebuild)
        return state

    def _resize_active(self, state: LCPSpheresState) -> LCPSpheresState:
        """Between blocks: re-fit the active window W to the measured
        per-block maximum (a relaxing cold start shrinks it severalfold;
        every BBPGD iteration's gathers and one-hot blocks scale with
        nb * W, so slack is paid per iteration). Runs AFTER a block and
        eagerly compiles the resized program so the next block's timing
        never contains the recompile.

        Hysteresis: growing is immediate, but a shrink must be demanded by
        TWO consecutive blocks — each resize recompiles the fused run
        program, and a count hovering near an alignment boundary would
        otherwise bounce the capacity (and eat a recompile) every block."""
        blk_max = int(jax.device_get(state.act_block_max))
        target_w = max(64, (int(blk_max * 1.1) + 63) // 64 * 64)
        if target_w == self.act_window:
            self._act_shrink_streak = 0
            return state
        if target_w <= self.act_window:
            streak = getattr(self, "_act_shrink_streak", 0)
            # small shrinks wait for two consecutive blocks (recompiles are
            # ~40-60 s); a >25% gap — the cold-start set relaxing — shrinks
            # immediately, the per-iteration cost scales with W^2
            if streak < 1 and target_w > 0.75 * self.act_window:
                self._act_shrink_streak = streak + 1
                return state
        self._act_shrink_streak = 0
        # W changes move every strided slot, so live multipliers are folded
        # into the full-list snapshot (the warm start's fallback source)
        # instead of being copied by slot.
        gfull = state.gamma_full.at[state.gamma_sel].set(
            jnp.where(state.gamma_sel < self.pair_capacity, state.gamma,
                      0.0), mode="drop")
        self.act_window = target_w
        a_cap = self.act_capacity
        gamma = jnp.zeros((a_cap,), self.dtype)
        sel = jnp.full((a_cap,), self.pair_capacity, jnp.int32)
        self.__dict__.pop("_burst_jit", None)
        self._step_jit = jax.jit(self._step)
        state = state.replace(gamma=gamma, gamma_sel=sel, gamma_full=gfull,
                              prev_cum=jnp.zeros_like(state.prev_cum))
        self._burst_jit = jax.jit(self._burst)
        self._rebuild_jit = jax.jit(self._rebuild)
        # 0-step call: populates the jit cache for the new shapes now
        state, _d0 = self._burst_jit(state, jnp.asarray(0, jnp.int32))
        return state

    def regrow(self, state: LCPSpheresState) -> LCPSpheresState:
        """Grow every overflow-bounded capacity of the constraint pipeline
        and rebuild from the state's positions; warm-start multipliers are
        remapped by pair identity into the bigger list (driver/regrow.py)."""
        from mundy_tpu.driver.regrow import grow_int

        c = self.config
        probes = self._pair_run_bound()
        old_pair_capacity = self.pair_capacity
        self.pair_capacity = grow_int(self.pair_capacity, align=1024)
        self.seg_window = grow_int(self.seg_window, align=512)
        self.act_window = grow_int(self.act_window, align=256)
        self.rows_k = grow_int(self.rows_k, align=4)
        self.rows_slack *= 1.5
        c.max_neighbors = grow_int(c.max_neighbors)
        c.cell_capacity = grow_int(c.cell_capacity)
        self.__dict__.pop("_burst_jit", None)
        self.__dict__.pop("_step_jit", None)
        self._step_jit = jax.jit(self._step)
        nmat, pairs, hmat, seg_starts, dual_full, ovf = self._broad_phase(state.pos)
        gfull_old = jnp.zeros((old_pair_capacity,), self.dtype)
        gfull_old = gfull_old.at[state.gamma_sel].set(
            jnp.where(state.gamma_sel < old_pair_capacity, state.gamma, 0.0),
            mode="drop")
        from mundy_tpu.constraints.collision import body_pair_starts
        gamma_full = remap_gamma(state.pairs, gfull_old, pairs, probes=probes,
                                 old_starts=body_pair_starts(state.nmat),
                                 old_nmat=state.nmat)
        return state.replace(
            nmat=nmat, pairs=pairs, hydro_nmat=hmat,
            seg_starts=seg_starts,
            dual_full=dual_full,
            prev_cum=jnp.zeros((self.pair_capacity,), jnp.int32),
            gamma=jnp.zeros((self.act_capacity,), self.dtype),
            gamma_sel=jnp.full((self.act_capacity,), self.pair_capacity,
                               jnp.int32),
            gamma_full=gamma_full,
            ref_pos=state.pos, overflow=ovf)

    def run(self, state: Optional[LCPSpheresState] = None, log=print):
        from mundy_tpu.driver.regrow import run_blocks

        c = self.config
        if state is None:
            state = self.init()

        def status(s, done, tps):
            return (f"step {done}/{c.num_steps}  tps={tps:.2f}  "
                    f"lcp_iters={int(s.lcp_iters)}  "
                    f"residual={float(s.lcp_residual):.2e}  "
                    f"overflow={bool(s.overflow)}")

        return run_blocks(self, state, c.num_steps, c.log_every, log, status)

    def max_overlap(self, state: LCPSpheresState) -> float:
        c = self.config
        clist = build_cell_list(state.pos, self.grid, c.cell_capacity)
        sr = (self.search_radii if self.search_radii is not None
              else jnp.asarray(self.search_radius, self.dtype))
        nmat = neighbor_matrix(state.pos, clist, sr,
                               metric=self.metric, max_neighbors=c.max_neighbors,
                               chunk=min(c.chunk, max(256, c.num_spheres)))
        idx = jnp.minimum(nmat.idx, c.num_spheres - 1)
        sep = self.metric.sep(state.pos[:, None, :], state.pos[idx])
        radius = (self.radii if self.radii is not None
                  else jnp.full((c.num_spheres,), c.radius, self.dtype))
        d = (jnp.linalg.norm(sep, axis=-1)
             - radius[:, None] - radius[idx])
        d = jnp.where(nmat.mask, d, jnp.inf)
        return float(-jnp.min(d))
