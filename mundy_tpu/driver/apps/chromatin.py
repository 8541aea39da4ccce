"""BASELINE config #5 precursor: chromatin-style bead-chain simulation —
the HP1 pipeline (reference `scrap/hp1_mock_reworks/
HP1_mock_rework_agents_text_mesh_neigh_linker.cpp`, SURVEY.md §3.2).

Per step (mirroring the reference time loop `:1377-1524`):
    1. neighbor maintenance (cell list + skin trigger)
    2. KMC crosslinker bind/unbind (`:1449-1456` -> kmc module)
    3. forces: FENE-WCA backbone springs, nonbonded Hertzian contact
       (bonded pairs excluded), crosslinker Hookean springs, spherical
       periphery wall (the level-set collision `:604-760`)
    4. velocities: Brownian (`:761`) + local drag or neighbor-RPY
       hydrodynamics (`:1487-1493`), optional BIE periphery no-slip
       correction
    5. node-Euler update (`:1523`)

Chains are laid out on a Hilbert curve at init (reference
create_hilbert_positions_and_directors usage for chromosome fibers).
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
from mundy_tpu.forces import fenewca_spring_forces, hookean_spring_forces
from mundy_tpu.forces.contact import hertzian_contact_forces
from mundy_tpu.geom import free_space, periodic
from mundy_tpu.kmc import BINDING_STATE, binding_rate_gaussian, crosslinker_kmc_step
from mundy_tpu.math.spacefill import hilbert_positions_and_directors
from mundy_tpu.mobility import (
    build_spectral_ewald,
    local_drag_mobility,
    rpy_apply_neighbors,
)
from mundy_tpu.neighbor import build_cell_list, make_cell_grid, neighbor_matrix


@dataclasses.dataclass
class ChromatinConfig:
    num_chains: int = 4
    beads_per_chain: int = 512
    bead_radius: float = 0.5
    # backbone FENE-WCA (Kremer-Grest), ref FENEWCASprings
    backbone_k: float = 30.0
    backbone_rmax: float = 1.5  # in units of 2*bead_radius at default
    wca_epsilon: float = 1.0
    # nonbonded contact
    youngs_modulus: float = 1000.0
    poissons_ratio: float = 0.3
    # crosslinkers (HP1 dimers): left head bound to its home bead, right head
    # binds/unbinds nearby beads (ref `:177-360`)
    num_crosslinkers: int = 256
    crosslinker_k: float = 10.0
    crosslinker_rest_length: float = 1.5
    binding_rate: float = 10.0  # A prefactor
    unbinding_rate: float = 1.0  # koff
    kt: float = 1.0
    # bead part structure (the reference's heterochromatin/euchromatin
    # split: HP1 binds H beads only, `HP1...neigh_linker.cpp` hp1-h vs
    # hp1-bs searches): the leading `hetero_fraction` of every chain joins
    # part "hetero"; crosslinker homes and binding targets are restricted
    # to `binding_selector` (state/select.py algebra over the bead parts)
    hetero_fraction: float = 1.0
    binding_selector: str = "hetero"
    # confinement: spherical periphery of this radius (0 disables)
    periphery_radius: float = 0.0
    periphery_stiffness: float = 200.0
    viscosity: float = 1.0
    diffusion_coeff: float = 0.1
    # "rpy_periphery" = full RPY + no-slip periphery BIE correction (the
    # reference's fullest pipeline, `HP1...neigh_linker.cpp:1487-1493` +
    # FastDirectPeriphery::compute_surface_forces); needs periphery_radius
    # "rpy_periphery_spectral" = free-space spectral Stokes ambient flow
    # (mobility/freespace.py, O(N log N) on a padded FFT grid — the
    # confined-domain PVFMM role) + the same periphery BIE correction
    hydro: str = "none"  # "none" | "rpy_neighbors" | "rpy_spectral" | "rpy_periphery" | "rpy_periphery_spectral"
    periphery_order: int = 12  # BIE quadrature order (Q = 2(order+1)^2)
    periphery_cache: str = ""  # optional path caching the dense M^-1
    # periodic box edge; 0 = free space. Required for "rpy_spectral" (the
    # FFT spectral-Ewald Stokes path — the at-scale PVFMM-analog mobility,
    # BASELINE config #5)
    box_size: float = 0.0
    dt: float = 1e-4
    num_steps: int = 100
    skin: float = 0.4
    max_neighbors: int = 32
    # dedicated crosslinker candidate search (the reference runs separate
    # searches per interaction class with their own AABB cutoffs,
    # `HP1...neigh_linker.cpp:1436-1444`): candidates out to the radius
    # where the Gaussian binding rate falls to kmc_rate_floor of its peak —
    # the contact-scale search truncates BELOW the binding rest length
    kmc_rate_floor: float = 1e-3
    cell_capacity: int = 16
    chunk: int = 16384
    seed: int = 1234
    dtype: str = "float32"
    log_every: int = 100

    def __validate__(self):
        assert self.hydro in ("none", "rpy_neighbors", "rpy_spectral",
                              "rpy_periphery", "rpy_periphery_spectral"), \
            f"hydro '{self.hydro}' not one of: none, rpy_neighbors, " \
            "rpy_spectral, rpy_periphery, rpy_periphery_spectral"
        if self.hydro == "rpy_spectral":
            assert self.box_size > 0, "rpy_spectral needs a periodic box_size"
        if self.hydro in ("rpy_periphery", "rpy_periphery_spectral"):
            assert self.periphery_radius > 0, \
                f"{self.hydro} needs a periphery_radius confinement"
        assert self.periphery_radius == 0 or self.box_size == 0, \
            "periphery confinement and a periodic box are exclusive"
        assert self.num_crosslinkers >= 0


@pytree_dataclass
class ChromatinState:
    """Crosslinkers live in a state/world.LinkSet — binding state is a link
    field, bind/unbind are mask flips + slot writes on the capacity-bounded
    link table (exactly the reference's LinkData request/process semantics,
    `LinkData.hpp:159-183`, without a mesh-modification cycle):

      xl.indices[:, 0] = home bead (left head, fixed)
      xl.indices[:, 1] = right-head target bead (meaningful iff active)
      xl.active        = the doubly-bound spring exists
      xl.fields["state"] = BINDING_STATE (LEFT_BOUND / DOUBLY_BOUND)
    """

    pos: Array  # (N, 3) beads (N = chains * beads_per_chain)
    xl: object  # LinkSet("beads", "beads") of crosslinkers
    key: Array
    step: Array
    nmat: object
    hydro_nmat: object
    kmc_nmat: object  # crosslinker candidate search (wider cutoff)
    ref_pos: Array
    rebuild_count: Array
    overflow: Array

    # raw-array views of the LinkSet (diagnostics / older callers)
    @property
    def xl_home(self) -> Array:
        return self.xl.indices[:, 0]

    @property
    def xl_state(self) -> Array:
        return self.xl.fields["state"]

    @property
    def xl_bound_to(self) -> Array:
        return jnp.where(self.xl.active, self.xl.indices[:, 1], -1)


class ChromatinSim:
    def __init__(self, config: ChromatinConfig, mesh=None,
                 mesh_axis: str = "shard"):
        """`mesh`: optional device mesh — with hydro == "rpy_spectral" the
        Stokes mobility runs SHARDED over it (parallel/spectral_shard.py:
        per-shard gridding + psum'd grid + slab-evaluated real space), the
        BASELINE #5 'sharded over a slice' mode."""
        self.config = c = config
        validate_config(config)
        self._mesh = mesh
        self._mesh_axis = mesh_axis
        self.sharded_se = None
        self.dtype = jnp.dtype(c.dtype)
        self.N = c.num_chains * c.beads_per_chain
        self.X = c.num_crosslinkers
        # free-space domain sized to hold the chains (confinement optional),
        # or a periodic box when box_size > 0 (the spectral-hydro mode)
        self.periodic = c.box_size > 0
        self.search_radius = c.bead_radius + 0.5 * c.skin
        # crosslinker capture radius: rest length + the Gaussian rate tail
        # (rate/peak >= kmc_rate_floor), skin-buffered like the contact
        # search so the same rebuild trigger keeps candidates valid
        tail = _math.sqrt(2.0 * c.kt * _math.log(1.0 / c.kmc_rate_floor)
                          / max(c.crosslinker_k, 1e-12))
        self.kmc_capture = c.crosslinker_rest_length + tail
        self.kmc_search_radius = 0.5 * (self.kmc_capture + c.skin)
        if self.periodic:
            extent = 0.5 * c.box_size
            self.metric = periodic(np.array([c.box_size] * 3), dtype=self.dtype)
            self.grid = make_cell_grid([0, 0, 0], np.array([c.box_size] * 3),
                                       2 * self.search_radius, (True,) * 3,
                                       self.dtype)
        else:
            extent = self._domain_extent()
            self.metric = free_space(self.dtype)
            self.grid = make_cell_grid(-extent * np.ones(3), extent * np.ones(3),
                                       2 * self.search_radius, (False,) * 3,
                                       self.dtype)
        self.domain = extent
        if self.X > 0:
            kmc_cut = self.kmc_capture + c.skin
            if self.periodic:
                self.kmc_grid = make_cell_grid(
                    [0, 0, 0], np.array([c.box_size] * 3), kmc_cut,
                    (True,) * 3, self.dtype)
            else:
                self.kmc_grid = make_cell_grid(
                    -extent * np.ones(3), extent * np.ones(3), kmc_cut,
                    (False,) * 3, self.dtype)
            # clustering-aware cell capacity: touching-bead chains pack to
            # ~close packing locally regardless of the box-mean density
            d = 2.0 * c.bead_radius
            cell_vol = float(np.prod(np.asarray(self.kmc_grid.cell_size,
                                                np.float64)))
            pack = 0.74 / ((_math.pi / 6.0) * d ** 3) * cell_vol
            cap = int(pack + 6.0 * _math.sqrt(pack + 4.0) + 8.0)
            self.kmc_cell_capacity = min(((cap + 7) // 8) * 8, self.N)
            # per-crosslinker candidate row capacity AFTER the rebuild-time
            # distance compaction (close-packed bound on beads whose centers
            # sit within kmc_cut; the raw 27-cell stencil is 27x cell
            # capacity and is never stored): overflow-flagged and regrown
            # like every other capacity
            in_r = 0.74 * ((kmc_cut + c.bead_radius) / c.bead_radius) ** 3
            self.kmc_K = min(
                ((int(in_r + 6.0 * _math.sqrt(in_r + 4.0) + 8.0) + 7)
                 // 8) * 8, self.N)
        self.inv_drag = 1.0 / (6.0 * _math.pi * c.viscosity * c.bead_radius)
        self.rows_slack = 1.9  # rows-broad-phase slot slack (regrow-grown)
        # contact-search K lives on the SIM, not the config: init() right-
        # sizes it from measured occupancy and regrow() re-widens it, and
        # writing those back into the (caller-owned, possibly shared)
        # config object would couple sims built from the same config
        self.contact_K = c.max_neighbors
        self.cell_capacity = c.cell_capacity
        self.periphery = None
        if c.hydro in ("rpy_periphery", "rpy_periphery_spectral"):
            from mundy_tpu.mobility.periphery import build_sphere_periphery
            self.periphery = build_sphere_periphery(
                c.periphery_order, c.periphery_radius,
                cache_path=c.periphery_cache or None, dtype=self.dtype)
        self.freespace = None
        if c.hydro == "rpy_periphery_spectral":
            # free-space spectral ambient over the confining sphere's
            # bounding box; r_cut from the LOCAL (touching-chain) spacing
            from mundy_tpu.mobility.freespace import (build_freespace_stokes,
                                                      freespace_geometry)
            rp = c.periphery_radius
            r_cut = min(0.5 * rp, 3.5 * 2.0 * c.bead_radius)
            self.freespace = build_freespace_stokes(
                2.0 * rp, c.bead_radius, c.viscosity,
                origin=(-rp, -rp, -rp), extent=2.0 * rp,
                r_cut=r_cut, tol=1e-4, dtype=self.dtype)
            self.fs_geom = freespace_geometry(self.freespace, self.N,
                                              capacity_slack=3.0)
            self.fs_hydro_search = 0.5 * self.freespace.se.base.r_cut
            self.fs_hydro_K = 96
            # dedicated grid: the CONTACT grid's cell edge sits far below
            # r_cut, and neighbor_matrix's 27-cell stencil only reaches one
            # cell — a wide search on a narrow grid silently drops pairs
            self.fs_grid = make_cell_grid(
                -rp * np.ones(3), rp * np.ones(3),
                2.0 * self.fs_hydro_search, (False,) * 3, self.dtype)
            self.fs_cell_capacity = 256
        self.spectral = None
        if c.hydro == "rpy_spectral":
            from mundy_tpu.mobility.spectral import make_se_geometry_tiles
            # r_cut from the LOCAL bead spacing (2r: chains are touching
            # bead strings), not the box-mean spacing — clustered systems
            # otherwise put O(1000) bodies inside the real-space cutoff
            r_cut = min(0.25 * c.box_size, 3.5 * 2.0 * c.bead_radius)
            s2 = _math.sqrt(max(_math.log(1e4), 1.0))
            self.spectral = build_spectral_ewald(
                c.box_size, c.bead_radius, c.viscosity, tol=1e-4,
                xi=s2 / r_cut, r_cut=r_cut, dtype=self.dtype)
            # 3D-TILE gridding (round-4): the (y, z)-column row layout let
            # a chain clustered along x blow the column capacity to the
            # chain length (measured se_R = 1688 at 1M -> 893 ms wave
            # applies); tiles bound occupancy locally on all three axes.
            # Capacity starts at the near-uniform Poisson bound x slack and
            # is right-sized from MEASURED tile occupancy at init.
            self.se_geom = make_se_geometry_tiles(self.spectral, self.N,
                                                  capacity_slack=1.5)
            # real-space correction runs on the dense 3D-cell engine (no
            # neighbor matrix: its K-pass build alone cost ~20 s at 262k
            # with wide hydro cutoffs). Cell capacity from the close-packing
            # bound (touching-bead chains cluster beyond the box mean).
            from mundy_tpu.neighbor.cells3d import make_cell_grid3d
            d = 2.0 * c.bead_radius
            edge = self.spectral.base.r_cut
            pack_cell = 0.74 * (edge / d) ** 3
            cap = int(pack_cell + 6 * _math.sqrt(pack_cell + 4) + 4)
            cap = min(((cap + 7) // 8) * 8, self.N)
            g3 = make_cell_grid3d([c.box_size] * 3, edge, self.N,
                                  dtype=self.dtype)
            self.hydro_cells_grid = g3.replace(capacity=max(g3.capacity, cap))
            self.hydro_split = None  # set by init() from measured skew
            if mesh is not None:
                dmesh = mesh.shape[mesh_axis]
                assert self.N % dmesh == 0, \
                    "sharded spectral hydro needs N divisible by the mesh"
                # built lazily in _make_sharded_se once se_geom is
                # right-sized from measured occupancy (init)

        # backbone connectivity (i, i+1 within each chain)
        bead = np.arange(self.N)
        chain = bead // c.beads_per_chain
        left = bead[:-1]
        ok = chain[:-1] == chain[1:]
        self.bond_i = jnp.asarray(left[ok], jnp.int32)
        self.bond_j = jnp.asarray(left[ok] + 1, jnp.int32)
        # bonded-exclusion table for contact: previous and next bead
        prev = np.where((bead % c.beads_per_chain) > 0, bead - 1, -1)
        nxt = np.where((bead % c.beads_per_chain) < c.beads_per_chain - 1, bead + 1, -1)
        self.exclude = jnp.asarray(np.stack([prev, nxt], 1), jnp.int32)

    def _domain_extent(self) -> float:
        c = self.config
        if c.periphery_radius > 0:
            return c.periphery_radius + 2 * c.bead_radius
        # Hilbert lattice footprint
        s = 2
        while s**3 < c.beads_per_chain:
            s *= 2
        return max(2.0 * s * c.bead_radius * 2, 16 * c.bead_radius) * max(
            1, int(np.ceil(c.num_chains ** (1 / 3)))
        )

    # ------------------------------------------------------------------
    def init(self, key: Optional[Array] = None) -> ChromatinState:
        c = self.config
        if key is None:
            key = jax.random.PRNGKey(c.seed)
        kh, ks = jax.random.split(key)
        spacing = 2.0 * c.bead_radius  # touching beads along the curve
        chains = []
        rng = np.random.default_rng(c.seed)
        # chains on a non-overlapping grid of cells (random placement piles
        # chains on top of each other and overflows every capacity bound)
        n_side = max(int(np.ceil(c.num_chains ** (1.0 / 3.0))), 1)
        cell = 2.0 * self.domain / n_side
        for ci in range(c.num_chains):
            pts, _ = hilbert_positions_and_directors(c.beads_per_chain,
                                                     side_length=spacing)
            pts = pts[: c.beads_per_chain]
            cx = ci % n_side
            cy = (ci // n_side) % n_side
            cz = ci // (n_side * n_side)
            center_cell = (np.array([cx, cy, cz]) + 0.5) * cell - self.domain
            footprint = pts.max(axis=0) - pts.min(axis=0)
            jitter_room = np.maximum(0.5 * (cell - footprint.max()) - spacing, 0.0)
            offset = center_cell + rng.uniform(-1, 1, 3) * 0.5 * jitter_room
            center = pts.mean(axis=0)
            chains.append(pts - center + offset)
        pos = jnp.asarray(np.concatenate(chains), self.dtype)
        if self.periodic:
            # map the centered free-space layout into [0, box) and wrap
            pos = self.metric.wrap(pos + 0.5 * c.box_size)
        if c.periphery_radius > 0:
            # pull everything inside the periphery
            r = jnp.linalg.norm(pos, axis=1, keepdims=True)
            max_r = c.periphery_radius - 2 * c.bead_radius
            scale = jnp.minimum(1.0, max_r / jnp.maximum(jnp.max(r), 1e-6))
            pos = pos * scale

        if self.spectral is not None:
            # right-size the SE tile capacity from the MEASURED initial
            # occupancy (clustered chains beat any density-ratio
            # heuristic); the sticky overflow flag + host regrow catch
            # later densification
            g = self.se_geom
            h = c.box_size / g.G
            p = np.asarray(pos)
            nt1 = g.G // g.m
            it = np.clip((p / (g.m * h)).astype(int), 0, nt1 - 1)
            tile = (it[:, 0] * nt1 + it[:, 1]) * nt1 + it[:, 2]
            occ = int(np.bincount(tile, minlength=nt1 ** 3).max())
            need = ((int(occ * 1.5) + 8 + 7) // 8) * 8
            if need != g.R:
                self.se_geom = g._replace(R=max(need, 8))
            # hydro 3D-cell capacity from MEASURED occupancy too: the
            # real-space pair scan costs ~ capacity^2 per cell, and the
            # close-packing bound in __init__ (cap ~ 72 at r_cut 3.5) is
            # several times the measured clustered max — overflow is
            # flagged per step and regrown, so the tight cap is safe
            g3 = self.hydro_cells_grid
            edge = np.asarray(jax.device_get(g3.edge))
            dims = np.asarray([g3.nx, g3.ny, g3.nz])
            ic = np.clip((p / edge).astype(int), 0, dims - 1)
            cell = (ic[:, 0] * g3.ny + ic[:, 1]) * g3.nz + ic[:, 2]
            counts3 = np.bincount(cell, minlength=dims.prod())
            occ3 = int(counts3.max())
            cap3 = max(8, ((int(occ3 * 1.4) + 4 + 7) // 8) * 8)
            if cap3 < g3.capacity:
                self.hydro_cells_grid = g3.replace(capacity=cap3)
            # density-split real space: clustered chains put the MAX cell
            # occupancy several times the MEAN, and the dense pair scan
            # costs ~ capacity^2 per cell — the split runs the quadratic
            # pass at a low capacity and corrects the few dense cells
            # compactly (cells3d.pair_apply_cells3d_split). The base
            # capacity c_lo comes from a MEASURED-histogram cost model
            # (not a mean heuristic: a 2x-mean cut once classified 17% of
            # 1M-bead cells dense and the compact passes dwarfed the win):
            #   A      ~ n_cells * 27 * c_lo^2        (base pair scan)
            #   B'+C'D ~ DC * 27 * (c_lo*ex + ex*(c_lo+ex))  (dense cells)
            #   scatter ~ 130 * DC * 27 * c_lo        (9 ns/row ~ 120 evals)
            # picked over the 8-aligned grid, split enabled only when the
            # best split beats the no-split cost by >= 20%.
            self.hydro_split = None
            n_cells3 = int(dims.prod())
            cap_now = self.hydro_cells_grid.capacity
            best = (float(n_cells3) * 27.0 * cap_now * cap_now, None)
            for c_lo in range(8, cap_now, 8):
                n_dense = int(np.sum(counts3 > c_lo))
                if n_dense == 0:
                    continue
                ex = max(8, ((int((occ3 - c_lo) * 1.4) + 8 + 7) // 8) * 8)
                dc = max(64, ((int(n_dense * 1.5) + 63) // 64) * 64)
                est = (n_cells3 * 27.0 * c_lo * c_lo
                       + dc * 27.0 * (c_lo * ex + ex * (c_lo + ex))
                       + 130.0 * dc * 27.0 * c_lo)
                if est < best[0]:
                    best = (est, (c_lo, ex, dc))
            no_split = float(n_cells3) * 27.0 * cap_now * cap_now
            if best[1] is not None and best[0] < 0.8 * no_split:
                c_lo, c_ex, dc_cap = best[1]
                self.hydro_split_grid = self.hydro_cells_grid.replace(
                    capacity=c_lo)
                self.hydro_split = (c_ex, dc_cap)
            if self._mesh is not None:
                self._make_sharded_se()

        if self.freespace is not None:
            # same measured-occupancy right-sizing for the free-space
            # padded-grid binning (the Poisson bound is hopeless here: the
            # padded box is mostly empty while the chains are clustered)
            g = self.fs_geom
            hb = self.freespace.se.base.box / g.G
            p = np.asarray(pos) - np.asarray(self.freespace.origin)[None, :]
            nyz = g.G // g.m
            iy = np.clip((p[:, 1] / (g.m * hb)).astype(int), 0, nyz - 1)
            iz = np.clip((p[:, 2] / (g.m * hb)).astype(int), 0, nyz - 1)
            occ = int(np.bincount(iy * nyz + iz, minlength=nyz * nyz).max())
            need = ((int(occ * 1.5) + 8 + 7) // 8) * 8
            if need > g.R:
                self.fs_geom = g._replace(R=need)

        if self.periodic:
            # right-size the contact-rows slack from the MEASURED initial
            # row occupancy: Hilbert-packed chains cluster ~2-3x over the
            # mean (measured 112 vs mean 57 at 32k), so the default 1.9
            # mean-slack overflows on every fresh clustered init and pays
            # a regrow recompile before the first block
            from mundy_tpu.neighbor.rows import make_row_grid
            rg = make_row_grid([0, 0, 0], (c.box_size,) * 3,
                               2.0 * float(self.search_radius), self.N,
                               capacity_slack=self.rows_slack, align=8)
            p = np.asarray(pos)
            iy = np.clip((p[:, 1] / (c.box_size / rg.ny)).astype(int),
                         0, rg.ny - 1)
            iz = np.clip((p[:, 2] / (c.box_size / rg.nz)).astype(int),
                         0, rg.nz - 1)
            occ = int(np.bincount(iy * rg.nz + iz,
                                  minlength=rg.ny * rg.nz).max())
            need = int(occ * 1.3) + 8
            if need > rg.row_capacity:
                mean = self.N / (rg.ny * rg.nz)
                self.rows_slack = max(self.rows_slack, (need - 8) / mean)

        # bead part structure + selector (state/world + state/select): the
        # reference's hp1-h/hp1-bs split — crosslinker homes and targets
        # come from `binding_selector` over the declared parts
        from mundy_tpu.state.select import select
        from mundy_tpu.state.world import EntitySet, LinkSet

        per = c.beads_per_chain
        chain_pos = np.arange(self.N) % per
        hetero = chain_pos < max(1, int(round(c.hetero_fraction * per)))
        beads = EntitySet(
            fields={},
            parts={"hetero": jnp.asarray(hetero),
                   "euchro": jnp.asarray(~hetero),
                   "chain_end": jnp.asarray((chain_pos == 0)
                                            | (chain_pos == per - 1))},
            active=jnp.ones((self.N,), bool),
            capacity=self.N,
        )
        self.beads = beads
        self.bind_allowed = select(beads, c.binding_selector)
        allowed_idx = np.nonzero(np.asarray(self.bind_allowed))[0]
        assert allowed_idx.size > 0, \
            f"binding_selector {c.binding_selector!r} selects no beads"
        home = jnp.asarray(
            allowed_idx[rng.integers(0, allowed_idx.size,
                                     size=max(self.X, 1))][: self.X],
            jnp.int32)
        xl = LinkSet(
            indices=jnp.stack([home, home], axis=1),
            active=jnp.zeros((self.X,), bool),
            fields={"state": jnp.full((self.X,), BINDING_STATE.LEFT_BOUND,
                                      jnp.int32)},
            targets=("beads", "beads"),
        )
        nmat, hmat, kmat, ovf = self._build_nmat(pos, home)
        # Right-size the candidate-row capacities from MEASURED occupancy:
        # the close-packing bound on kmc_K is ~7x the real in-capture count
        # at chromatin density, and every KMC sweep pays X * kmc_K gathers
        # PER STEP (937 ms at 1M with the analytic bound); same for the
        # contact K's per-step (N, K) force gathers. Regrow re-widens on
        # overflow.
        resize = False
        if not bool(jax.device_get(nmat.overflow)):
            kmax = int(jax.device_get(
                jnp.max(jnp.sum(nmat.mask, axis=1, dtype=jnp.int32))))
            tight = max(12, ((int(kmax * 1.6) + 4 + 3) // 4) * 4)
            if tight < self.contact_K:
                self.contact_K = tight
                resize = True
        if self.X > 0 and not bool(jax.device_get(kmat.overflow)):
            kk = int(jax.device_get(
                jnp.max(jnp.sum(kmat.mask, axis=1, dtype=jnp.int32))))
            tightk = max(16, ((int(kk * 1.5) + 8 + 7) // 8) * 8)
            if tightk < self.kmc_K:
                self.kmc_K = tightk
                resize = True
        if resize:
            nmat, hmat, kmat, ovf = self._build_nmat(pos, home)
        return ChromatinState(
            pos=pos, xl=xl,
            key=ks, step=jnp.asarray(0, jnp.int32), nmat=nmat,
            hydro_nmat=hmat, kmc_nmat=kmat, ref_pos=pos,
            rebuild_count=jnp.asarray(1, jnp.int32), overflow=ovf,
        )

    def _build_search(self, pos: Array, search_radius: float,
                      max_neighbors: int, exclude=None):
        """One neighbor search at its own cutoff (the reference runs a
        separate GenNeighborLinkers per interaction class with distinct
        search AABBs, `HP1...neigh_linker.cpp:1436-1444`). Row broad phase
        when the box is wide enough, cell-list otherwise."""
        c = self.config
        n_cells = int((2 * self.domain) // (2 * search_radius))
        rows_ok = False
        if self.periodic and n_cells >= 5:
            from mundy_tpu.neighbor.rows import (make_row_grid,
                                                 rows_extract_feasible)
            n_excl = 0 if exclude is None else exclude.shape[1]
            rg = make_row_grid([0, 0, 0], (c.box_size,) * 3,
                               2.0 * float(search_radius), self.N,
                               capacity_slack=self.rows_slack, align=8)
            # clustered chains can grow R past what EITHER extraction path
            # affords (at 1M the XLA path's single y-plane is 3.6 GB) —
            # those regimes take the cell-list builder below, whose 3D
            # cells bound occupancy locally instead of per full-x column
            rows_ok = rows_extract_feasible(rg, max_neighbors + n_excl)
        if rows_ok:
            # gather-free row broad phase (the cell-list builder costs 10 s
            # at 1M); exclusions applied as a post-filter — the exclusion
            # table is just (prev, next), two lane compares
            from mundy_tpu.neighbor.rows import neighbor_matrix_rows
            nmat = neighbor_matrix_rows(
                pos, float(search_radius), (c.box_size,) * 3,
                max_neighbors=max_neighbors + n_excl,
                capacity_slack=self.rows_slack, grid=rg,
            )
            if exclude is not None:
                excl_hit = jnp.any(
                    nmat.idx[:, :, None] == exclude[:, None, :], axis=-1)
                nmat = nmat._replace(mask=nmat.mask & ~excl_hit,
                                     idx=jnp.where(excl_hit, self.N, nmat.idx))
            return nmat, nmat.overflow
        metric = self.metric if self.periodic else None
        clist = build_cell_list(pos, self.grid, self.cell_capacity)
        nmat = neighbor_matrix(
            pos, clist, jnp.asarray(search_radius, self.dtype),
            metric=metric, max_neighbors=max_neighbors,
            chunk=min(c.chunk, max(256, self.N)), exclude=exclude,
        )
        return nmat, clist.overflow | nmat.overflow

    def _make_sharded_se(self):
        """(Re)build the sharded spectral mobility against the current
        se_geom/cells capacities (the per-shard binning reuses the
        globally right-sized R — a safe bound for any shard's subset)."""
        from mundy_tpu.parallel.spectral_shard import make_sharded_se_rpy_apply

        c = self.config
        self.sharded_se, _sh = make_sharded_se_rpy_apply(
            self._mesh, self._mesh_axis, self.spectral, self.se_geom,
            self.hydro_cells_grid, self.N, (c.box_size,) * 3,
            dtype=self.dtype)

    def _build_kmc_candidates(self, pos: Array, home: Array):
        """Crosslinker candidate search at its own cutoff (the reference
        gives each interaction class its own search AABBs,
        `HP1...neigh_linker.cpp:1436-1444`): the contact-scale search cuts
        off BELOW crosslinker_rest_length, hiding the Gaussian binding
        rate's peak from KMC. Queries only the X home beads against a
        capture-radius cell list (O(X * 27 * cap) gathers, no N-wide
        matrix), then compacted to the kmc_K in-capture slots — the
        bind/unbind sweep re-evaluates these rows EVERY step, so carrying
        the raw 27-cell stencil (27*cap ~ 2600 slots at clustered-chromatin
        occupancy) would cost X*27*cap distance gathers per step instead of
        per rebuild. Cutoff = capture + skin: the skin rebuild trigger
        (max displacement > skin/2, mutual approach <= skin) keeps the
        compacted rows a superset of in-capture partners between rebuilds.
        Returns NeighborMatrix with (X, kmc_K) rows."""
        from mundy_tpu.neighbor.cell_list import (
            NeighborMatrix,
            _compact_rows,
            neighbor_candidates,
        )

        c = self.config
        clist = build_cell_list(pos, self.kmc_grid, self.kmc_cell_capacity)
        cand = neighbor_candidates(pos[home], clist)  # (X, 27*cap)
        # THREE scalar component gathers, never a (..., 3) candidate block:
        # XLA materializes gathers batch-major, so even pos.T[:, idx] lands
        # a (X*27cap, 3) intermediate with a minor axis of 3, which a tiled
        # memory layout pads many-fold. Scalar gathers from (N,) planes keep
        # every intermediate (X, 27cap).
        # The cubic box makes per-component min-image exact.
        ci = jnp.maximum(cand, 0)
        px, py, pz = pos[:, 0], pos[:, 1], pos[:, 2]
        dx = px[ci] - px[home][:, None]
        dy = py[ci] - py[home][:, None]
        dz = pz[ci] - pz[home][:, None]
        if self.periodic:
            box = jnp.asarray(c.box_size, self.dtype)
            dx = dx - box * jnp.round(dx / box)
            dy = dy - box * jnp.round(dy / box)
            dz = dz - box * jnp.round(dz / box)
        d2 = dx * dx + dy * dy + dz * dz
        cut = self.kmc_capture + c.skin
        ok = (cand >= 0) & (cand != home[:, None]) & (d2 < cut * cut)
        idx, mask, count = _compact_rows(cand, ok, self.kmc_K, self.N)
        ovf = clist.overflow | jnp.any(count > self.kmc_K)
        return NeighborMatrix(idx=idx, mask=mask, overflow=ovf), ovf

    def _build_nmat(self, pos: Array, home: Optional[Array] = None):
        c = self.config
        nmat, ovf = self._build_search(pos, self.search_radius,
                                       self.contact_K, self.exclude)
        if self.X > 0:
            kmat, kovf = self._build_kmc_candidates(pos, home)
            ovf = ovf | kovf
        else:
            kmat = nmat
        hmat = nmat
        if self.freespace is not None:
            # dedicated hydro search at the free-space operator's r_cut
            # (the contact nmat's cutoff sits far below it)
            hcl = build_cell_list(pos, self.fs_grid, self.fs_cell_capacity)
            hmat = neighbor_matrix(
                pos, hcl, jnp.asarray(self.fs_hydro_search, self.dtype),
                metric=None, max_neighbors=self.fs_hydro_K,
                chunk=min(c.chunk, max(256, self.N)))
            ovf = ovf | hcl.overflow | hmat.overflow
        return nmat, hmat, kmat, ovf

    # ------------------------------------------------------------------
    def _kmc(self, state: ChromatinState) -> ChromatinState:
        """Crosslinker bind/unbind sweep (HP1 `:1449-1456`)."""
        c = self.config
        if self.X == 0:
            return state
        pos = state.pos
        # candidates from the DEDICATED per-crosslinker search (rows are
        # per-crosslinker, not per-bead): its cutoff covers the Gaussian
        # rate out to the kmc_rate_floor tail, unlike the contact-scale
        # nmat (whose cutoff sits below the rest length)
        cand_idx = jnp.minimum(state.kmc_nmat.idx, self.N - 1)  # (X, K)
        # part-selector restriction (hp1 binds `binding_selector` beads
        # only — the hp1-h vs hp1-bs search split of the reference)
        cand_mask = state.kmc_nmat.mask & self.bind_allowed[cand_idx]
        # THREE scalar component gathers (see _build_kmc_candidates): (X, K)
        # planes from (N,) component arrays keep a wide minor axis, unlike
        # a (..., 3) candidate block. The cubic
        # box makes per-component min-image exact.
        home = state.xl_home
        px, py, pz = pos[:, 0], pos[:, 1], pos[:, 2]
        dx = px[cand_idx] - px[home][:, None]
        dy = py[cand_idx] - py[home][:, None]
        dz = pz[cand_idx] - pz[home][:, None]
        if self.periodic:
            box = jnp.asarray(self.config.box_size, self.dtype)
            dx = dx - box * jnp.round(dx / box)
            dy = dy - box * jnp.round(dy / box)
            dz = dz - box * jnp.round(dz / box)
        dr = jnp.sqrt(dx * dx + dy * dy + dz * dz)
        rates = binding_rate_gaussian(dr, c.crosslinker_k,
                                      c.crosslinker_rest_length, c.kt,
                                      c.binding_rate)
        out = crosslinker_kmc_step(
            state.key, state.step, state.xl.fields["state"],
            state.xl_bound_to, cand_idx, rates, cand_mask,
            koff=jnp.asarray(c.unbinding_rate, self.dtype), dt=c.dt,
            gid=jnp.arange(self.X, dtype=jnp.int32),
        )
        # bind/unbind = mask flips + slot writes on the LinkSet (the
        # LinkData request/process semantics, `LinkData.hpp:159-183`)
        xl = state.xl
        new_idx = xl.indices.at[:, 1].set(
            jnp.where(out.bound_to >= 0, out.bound_to, home))
        xl = xl.replace(indices=new_idx,
                        active=out.state == BINDING_STATE.DOUBLY_BOUND,
                        fields={"state": out.state})
        return state.replace(xl=xl)

    def _forces(self, state: ChromatinState) -> Array:
        c = self.config
        pos = state.pos
        sigma = 2.0 * c.bead_radius
        metric = self.metric if self.periodic else None
        # chain-structured kernel: shifted slices + 2 shifted adds instead
        # of the bond-list scatter (~180 ms at 1M beads, ~90 ns/row);
        # bit-identical per bond
        from mundy_tpu.forces import fenewca_chain_forces
        f = fenewca_chain_forces(
            pos, c.beads_per_chain,
            jnp.asarray(c.backbone_k, self.dtype),
            jnp.asarray(c.backbone_rmax * sigma, self.dtype),
            jnp.asarray(sigma, self.dtype),
            jnp.asarray(c.wca_epsilon, self.dtype),
            metric=metric,
        )
        f = f + hertzian_contact_forces(
            pos, jnp.asarray(c.bead_radius, self.dtype),
            jnp.asarray(c.youngs_modulus, self.dtype),
            jnp.asarray(c.poissons_ratio, self.dtype), state.nmat,
            metric=metric,
        )
        if self.X > 0:
            # active links ARE the doubly-bound springs
            f = f + hookean_spring_forces(
                pos, state.xl.indices[:, 0], state.xl.indices[:, 1],
                jnp.asarray(c.crosslinker_k, self.dtype),
                jnp.asarray(c.crosslinker_rest_length, self.dtype),
                mask=state.xl.active, metric=metric,
            )
        if c.periphery_radius > 0:
            # spherical wall: Hertzian-like push-back when beads poke out
            # (level-set periphery collision, HP1 `:604-760`)
            r = jnp.linalg.norm(pos, axis=1)
            over = jnp.maximum(r + c.bead_radius - c.periphery_radius, 0.0)
            mag = c.periphery_stiffness * over * jnp.sqrt(over)
            nhat = pos / jnp.maximum(r, 1e-12)[:, None]
            f = f - mag[:, None] * nhat
        return f

    def _inner_step(self, state: ChromatinState) -> ChromatinState:
        c = self.config
        state = self._kmc(state)
        f = self._forces(state)
        if c.hydro == "none":
            vel = local_drag_mobility(f, c.bead_radius, c.viscosity)
        elif c.hydro == "rpy_spectral":
            # periodic spectral-Ewald RPY: dense 3D-cell real-space engine
            # + dense-gridding FFT wave sum (the PVFMM-analog at-scale Stokes
            # mobility). Cells + binning rebuilt per step (one sort each).
            if self.sharded_se is not None:
                # BASELINE #5 sharded mode: per-shard gridding + psum'd
                # grid + slab-evaluated real space over the mesh
                vel, se_ovf = self.sharded_se(state.pos, f)
                state = state.replace(overflow=state.overflow | se_ovf)
            else:
                from mundy_tpu.mobility.spectral import se_rpy_apply_cells
                from mundy_tpu.neighbor.cells3d import (build_cells3d,
                                                        build_cells3d_split)
                from mundy_tpu.mobility.spectral import se_bin_geom
                pieces = se_bin_geom(self.se_geom, state.pos, self.dtype)
                if self.hydro_split is not None:
                    c_ex, dc_cap = self.hydro_split
                    cells = build_cells3d_split(
                        state.pos, self.hydro_split_grid, c_ex, dc_cap)
                else:
                    cells = build_cells3d(state.pos, self.hydro_cells_grid)
                vel, se_ovf = se_rpy_apply_cells(
                    self.spectral, cells, state.pos, f, (c.box_size,) * 3,
                    self.se_geom, pieces=pieces)
                # both SE binning rows and 3D cells drop bodies on overflow
                state = state.replace(
                    overflow=state.overflow | cells.overflow | se_ovf)
        elif c.hydro == "rpy_periphery_spectral":
            # free-space spectral ambient (O(N log N) padded-grid FFT) +
            # the same BIE no-slip correction; u at the surface quadrature
            # stays the exact dense sum (O(N * Q), linear in N)
            from mundy_tpu.mobility import no_slip_correction, rpy_flow_at
            from mundy_tpu.mobility.freespace import freespace_rpy_apply
            vel, fs_ovf = freespace_rpy_apply(self.freespace, state.pos, f,
                                              state.hydro_nmat,
                                              geom=self.fs_geom)
            state = state.replace(overflow=state.overflow | fs_ovf)
            u_surf = rpy_flow_at(self.periphery.points, state.pos, f,
                                 c.bead_radius, c.viscosity)
            vel = vel + no_slip_correction(self.periphery, u_surf, state.pos)
        elif c.hydro == "rpy_periphery":
            # the reference's fullest pipeline: all-pairs RPY drift with the
            # no-slip periphery BIE correction — ambient flow evaluated at
            # the quadrature nodes, surface densities q = -M^{-1} u|surf,
            # double-layer correction back at the beads
            # (`HP1...neigh_linker.cpp:1487-1493`, Periphery.hpp:1155,1409)
            from mundy_tpu.mobility import (
                no_slip_correction,
                rpy_apply_dense,
                rpy_flow_at,
            )
            vel = rpy_apply_dense(state.pos, f, c.bead_radius, c.viscosity,
                                  overlap_correction=True)
            u_surf = rpy_flow_at(self.periphery.points, state.pos, f,
                                 c.bead_radius, c.viscosity)
            vel = vel + no_slip_correction(self.periphery, u_surf, state.pos)
        else:
            vel = rpy_apply_neighbors(state.pos, f, state.nmat, c.bead_radius,
                                      c.viscosity, overlap_correction=True)
        if c.diffusion_coeff > 0:
            # gid-keyed counter stream (pure function of key/step/gid):
            # dtype-invariant for the f32 drift metric, shard-local for the
            # slab-sharded chromatin pipeline
            vel = vel + brownian_velocity_keyed(
                state.key, state.step,
                jnp.arange(self.N, dtype=jnp.int32),
                jnp.asarray(c.diffusion_coeff, self.dtype),
                c.dt, dtype=self.dtype)
        new_pos = state.pos + jnp.asarray(c.dt, self.dtype) * vel
        if self.periodic:
            new_pos = self.metric.wrap(new_pos)
        return state.replace(pos=new_pos, step=state.step + 1)

    def _rebuild(self, state: ChromatinState) -> ChromatinState:
        nmat, hmat, kmat, ovf = self._build_nmat(state.pos, state.xl_home)
        return state.replace(nmat=nmat, hydro_nmat=hmat, kmc_nmat=kmat,
                             ref_pos=state.pos,
                             rebuild_count=state.rebuild_count + 1,
                             overflow=state.overflow | ovf)

    def _run_n(self, state: ChromatinState, n_steps: int) -> ChromatinState:
        c = self.config
        target = jnp.asarray(n_steps, jnp.int32)
        skin_sq = jnp.asarray((0.5 * c.skin) ** 2, self.dtype)

        def moved(s):
            disp = s.pos - s.ref_pos
            return jnp.max(jnp.sum(disp * disp, axis=-1)) > skin_sq

        # skin trigger computed in the BODY, carried as a flag the conds
        # read (a while cond can't fuse with the body)
        def inner_cond(carry):
            s, done, fired = carry
            return jnp.logical_and(done < target, jnp.logical_not(fired))

        def inner_body(carry):
            s, done, _ = carry
            s = self._inner_step(s)
            return s, done + 1, moved(s)

        def outer_body(carry):
            s, done, fired = carry
            # rebuild only when the skin trigger fired: an unconditional
            # entry rebuild would (a) pay the broad phase per program entry
            # instead of per skin violation and (b) break the
            # rebuild-cadence parity the sharded step relies on
            # (parallel/chromatin_shard.py runs skin-triggered rebuilds
            # only — extra rebuilds here reorder candidate rows, which
            # changes KMC picks and diverges trajectories)
            s = jax.lax.cond(fired, self._rebuild, lambda x: x, s)
            carry = inner_body((s, done, jnp.asarray(False)))
            return jax.lax.while_loop(inner_cond, inner_body, carry)

        state, _, _ = jax.lax.while_loop(
            lambda carry: carry[1] < target, outer_body,
            (state, jnp.asarray(0, jnp.int32), moved(state)),
        )
        return state

    def run_block(self, state: ChromatinState, n_steps: int) -> ChromatinState:
        # n_steps is traced (used only in comparisons), so one compiled
        # program serves every block size — no recompile per block length
        if not hasattr(self, '_run_jit'):
            self._run_jit = jax.jit(self._run_n)
        return self._run_jit(state, jnp.asarray(n_steps, jnp.int32))

    def regrow(self, state: ChromatinState) -> ChromatinState:
        """Grow every overflow-bounded capacity (contact cells/K, rows
        slack, KMC candidate cells, SE binning rows, hydro 3D cells) and
        rebuild the searches from the state's positions (driver/regrow.py)."""
        from mundy_tpu.driver.regrow import grow_int

        c = self.config
        self.cell_capacity = grow_int(self.cell_capacity)
        self.contact_K = grow_int(self.contact_K)
        self.rows_slack *= 1.5
        if self.X > 0:
            self.kmc_cell_capacity = min(grow_int(self.kmc_cell_capacity),
                                         self.N)
            self.kmc_K = min(grow_int(self.kmc_K), self.N)
        if self.spectral is not None:
            self.se_geom = self.se_geom._replace(
                R=grow_int(self.se_geom.R))
            g3 = self.hydro_cells_grid
            self.hydro_cells_grid = g3.replace(
                capacity=grow_int(g3.capacity))
            if self.hydro_split is not None:
                c_ex, dc_cap = self.hydro_split
                self.hydro_split = (grow_int(c_ex), grow_int(dc_cap))
            if self._mesh is not None:
                self._make_sharded_se()
        self.__dict__.pop("_run_jit", None)
        nmat, hmat, kmat, ovf = self._build_nmat(state.pos, state.xl_home)
        return state.replace(nmat=nmat, hydro_nmat=hmat, kmc_nmat=kmat,
                             ref_pos=state.pos, overflow=ovf)

    def run(self, state: Optional[ChromatinState] = None, log=print):
        from mundy_tpu.driver.regrow import run_blocks

        c = self.config
        if state is None:
            state = self.init()

        def status(s, done, tps):
            bound = (int(jnp.sum(s.xl_state == BINDING_STATE.DOUBLY_BOUND))
                     if self.X else 0)
            return (f"step {done}/{c.num_steps}  tps={tps:.2f}  "
                    f"doubly_bound={bound}/{self.X}  "
                    f"rebuilds={int(s.rebuild_count)}  "
                    f"overflow={bool(s.overflow)}")

        return run_blocks(self, state, c.num_steps, c.log_every, log, status)
