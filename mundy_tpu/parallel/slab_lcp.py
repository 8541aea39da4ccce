"""Sharded LCP spheres on VOLUME-allocated dense rows (SUPERSEDED).

The production sharded LCP engine is `parallel/balanced_lcp.py` — its
COUNT-allocated compact slabs follow clustered density (the reference
re-balances the one production mesh mid-run, `stk::balance::balanceStkMesh`,
`HP1...neigh_linker.cpp:820,1358`), it is what the CLI's `--devices` routes
`lcp_spheres` onto, and it is what `__graft_entry__.dryrun_multichip` gates.
This volume-allocated row-layout variant is retained as the validated
bit-parity reference for the dense-row pair-extraction machinery
(tests/test_parallel_lcp.py) and is NOT a second production path.

The multi-chip re-design of the reference's lcp_spheres driver
(`scrap/lcp_spheres/StkNgpLCP.cpp:705-875` — its device-global BBPGD loop
with implicit global reductions) and its distributed search + ghosting
pattern (`mundy/mesh/src/mundy_mesh/GenNeighborLinkers.hpp:652-741`):

- bodies live in the z-slab row layout of parallel/slab_rows.py (dense
  (ny, nzl, R) rows per shard, one halo z-plane exchanged by `ppermute` —
  the aura/ghosting analog);
- each shard extracts its OWN ordered pair list at rebuild: every contact
  involving a locally-owned body i appears as one (i_slot, j_ext_slot) row,
  duplicated in both directions across the pair (and across shards when the
  pair straddles a slab boundary) — the ordered-duplicate layout that makes
  force assembly one sorted segmented reduction (ops/segments.py) and keeps
  mirrored multipliers exactly equal under BBPGD (identical gradients,
  globally psum'd step sizes);
- the BBPGD solve is the SAME generic solver (math/convex.py) with
  `axis_names`: BB dot products ride `psum`, the convergence residual rides
  `pmax`, so every shard takes the same step and exits on the same
  iteration — the reference's single-device global reductions become ICI
  collectives;
- per solver iteration each shard assembles F = D gamma for its OWN bodies,
  applies the (diagonal local-drag) mobility, exchanges ONE boundary plane
  of velocities with each ring neighbor, and evaluates sdot = -n . (U_i -
  U_j) against local + halo velocities.

Rebuild defaults to the slab-local resort (boundary-plane migrant exchange
+ per-shard sort, slab_local.py) where legal, falling back to the global
psum-all-gather resort; the warm-start gamma restarts at zero on rebuild
(rebuilds are skin-triggered and rare; between rebuilds gamma warm-starts
step to step).
"""

from __future__ import annotations

import math as _math

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from mundy_tpu.dynamics import brownian_velocity_keyed
from mundy_tpu.math.convex import PGDConfig, solve_lcp
from mundy_tpu.neighbor.rows import RowGrid, _roll_image_shift, build_rows, make_row_grid
from mundy_tpu.parallel.slab_local import local_resort_ok, slab_local_resort
from mundy_tpu.ops.segments import SegmentWindows, segment_sum_sorted_blocked


def _ext_slot_planes(ny: int, nzl: int, R: int) -> np.ndarray:
    """(ny, nzl, 9R) int32: flat index into the halo-extended (ny, nzl+2, R)
    block of each candidate lane of each own slot — trace-time constant."""
    y = np.arange(ny)[:, None, None]
    z = np.arange(nzl)[None, :, None]
    r = np.arange(R)[None, None, :]
    planes = []
    for dy in (-1, 0, 1):
        for dz in (-1, 0, 1):
            yy = (y + dy) % ny
            zz = z + 1 + dz  # ext z index
            planes.append(
                np.broadcast_to(yy * (nzl + 2) * R + zz * R + r,
                                (ny, nzl, R)))
    return np.concatenate(planes, axis=-1).astype(np.int32)


def make_slab_lcp_spheres_step(
    mesh: Mesh,
    axis: str,
    n_total: int,
    box_size: float,
    radius: float = 0.5,
    viscosity: float = 1.0,
    diffusion: float = 0.0,
    dt: float = 1e-3,
    constraint_buffer: float = 0.2,
    max_allowable_overlap: float = 1e-5,
    max_col_iterations: int = 10_000,
    max_pairs_per_body: int = 12,
    pair_capacity_per_body: int = 4,
    capacity_slack: float = 1.9,
    seg_block: int = 512,
    dtype=jnp.float32,
    rebuild_mode: str = "auto",
):
    """Returns (init_fn, step_block_fn, grid).

    init_fn(key, pos=None) -> sharded state dict; step_block_fn(state,
    n_steps) -> state (skin-triggered rebuilds fully on-chip).
    """
    d = mesh.shape[axis]
    cutoff = 2.0 * radius + constraint_buffer
    grid = make_row_grid([0, 0, 0], [box_size] * 3, cutoff, n_total,
                         capacity_slack=capacity_slack, dtype=dtype)
    nz = (grid.nz // d) * d
    if nz < d or grid.ny < 5 or nz < 5:
        raise ValueError("box too small for the slab row engine "
                         f"(ny={grid.ny}, nz={nz}, d={d})")
    grid = RowGrid(origin=grid.origin,
                   cell_yz=grid.cell_yz.at[1].set(box_size / nz),
                   ny=grid.ny, nz=nz, row_capacity=grid.row_capacity)
    nzl = nz // d
    R = grid.row_capacity
    ny = grid.ny
    n_slots = ny * nzl * R  # local slots per shard
    K = max_pairs_per_body
    # per-shard ordered pair capacity (each contact appears once per side)
    C = pair_capacity_per_body * max(n_total // d, 1)
    C = ((C + 1023) // 1024) * 1024
    seg_window = ((seg_block * max(K // 2, 2) + 511) // 512) * 512
    inv_drag = 1.0 / (6.0 * _math.pi * viscosity * radius)
    two_r = 2.0 * radius
    cut2 = cutoff * cutoff
    ext_slots = jnp.asarray(_ext_slot_planes(ny, nzl, R))  # (ny, nzl, 9R)
    perm_up = [(i, (i + 1) % d) for i in range(d)]
    perm_dn = [(i, (i - 1) % d) for i in range(d)]
    local_ok = local_resort_ok(d, nzl)
    if rebuild_mode == "auto":
        rebuild_mode = "local" if local_ok else "global"
    if rebuild_mode == "local" and not local_ok:
        raise ValueError(
            f"slab-local rebuild needs >=2 z-planes/slab and >=2 shards; "
            f"got nz={nz} over {d} shards")
    if rebuild_mode not in ("local", "global"):
        raise ValueError(f"unknown rebuild_mode {rebuild_mode!r}")
    ez = None  # set inside (needs dtype-consistent constant)

    def halo_ext(p, shift_wrap: bool):
        """(ny, nzl, R, ...) -> (ny, nzl+2, R, ...): one boundary z-plane
        from each ring neighbor. With shift_wrap, the wrapped planes get the
        global z-image coordinate shift (positions); velocities don't."""
        me = jax.lax.axis_index(axis)
        lo = jax.lax.ppermute(p[:, -1:], axis, perm_up)
        hi = jax.lax.ppermute(p[:, :1], axis, perm_dn)
        if shift_wrap:
            ezv = jnp.zeros((p.shape[-1],), p.dtype).at[2].set(1.0)
            lo = lo + jnp.where(me == 0, -box_size, 0.0).astype(p.dtype) * ezv
            hi = hi + jnp.where(me == d - 1, box_size, 0.0).astype(p.dtype) * ezv
        return jnp.concatenate([lo, p, hi], axis=1)

    def _min_image(sep):
        """3-axis minimum image. z-halo coordinates already carry the global
        wrap shift, so |dz| <= cutoff and the z term is a no-op; x spans the
        box and y wraps across rolled rows, so both need it."""
        return sep - box_size * jnp.round(sep * (1.0 / box_size))

    def _candidate_r2(pos, pos_ext):
        """(ny, nzl, R, 9R) pair distance^2 against the 9-stencil planes
        (y-roll + image shifts on y; z via ext slices), plus the own-slot
        self mask."""
        x = pos_ext[..., 0]
        y = pos_ext[..., 1]
        z = pos_ext[..., 2]
        cxs, cys, czs = [], [], []
        for dy in (-1, 0, 1):
            for dz in (-1, 0, 1):
                cx = x[:, 1 + dz:1 + dz + nzl]
                cy = y[:, 1 + dz:1 + dz + nzl]
                cz = z[:, 1 + dz:1 + dz + nzl]
                if dy != 0:
                    cx = jnp.roll(cx, -dy, axis=0)
                    cy = jnp.roll(cy, -dy, axis=0) + _roll_image_shift(
                        ny, dy, box_size, dtype)[:, None, None]
                    cz = jnp.roll(cz, -dy, axis=0)
                cxs.append(cx)
                cys.append(cy)
                czs.append(cz)
        cx = jnp.concatenate(cxs, axis=-1)  # (ny, nzl, 9R)
        cy = jnp.concatenate(cys, axis=-1)
        cz = jnp.concatenate(czs, axis=-1)
        ox, oy, oz = pos[..., 0], pos[..., 1], pos[..., 2]
        DX = cx[..., None, :] - ox[..., :, None]
        DX = DX - box_size * jnp.round(DX * (1.0 / box_size))
        DY = cy[..., None, :] - oy[..., :, None]
        DZ = cz[..., None, :] - oz[..., :, None]
        return DX * DX + DY * DY + DZ * DZ

    def build_pairs(pos, valid):
        """Per-shard ordered pair list from the current row layout.

        Returns (i_slot (C,), j_ext (C,), pair_mask (C,), win_starts,
        overflow). i_slot indexes the local flat (n_slots,) space (sorted
        ascending by construction); j_ext the halo-extended flat space."""
        pos_ext = halo_ext(pos, True)
        r2 = _candidate_r2(pos, pos_ext)  # (ny, nzl, R, 9R)
        own_slot = jax.lax.broadcasted_iota(jnp.int32, (1, 1, R, 1), 2)
        is_self = ext_slots[..., None, :] == (
            jnp.arange(ny)[:, None, None, None] * (nzl + 2) * R
            + (jnp.arange(nzl)[None, :, None, None] + 1) * R + own_slot)
        hit = (r2 < cut2) & valid[..., None] & ~is_self
        hit_f = hit.reshape(n_slots, 9 * R)
        cand = jnp.broadcast_to(ext_slots[..., None, :],
                                (ny, nzl, R, 9 * R)).reshape(n_slots, 9 * R)
        # front-pack each slot's hits to K lanes (binary search on cumsum)
        from mundy_tpu.neighbor.cell_list import _compact_rows
        idx_k, mask_k, count = _compact_rows(cand, hit_f, K, -1)
        k_overflow = jnp.any(count > K)
        # expand (n_slots, K) -> ordered (C,) pair list (repeat + gather)
        cnt = jnp.minimum(count, K).astype(jnp.int32)
        base = jnp.concatenate([jnp.zeros((1,), jnp.int32),
                                jnp.cumsum(cnt, dtype=jnp.int32)])
        num = base[n_slots]
        ii = jnp.repeat(jnp.arange(n_slots, dtype=jnp.int32), cnt,
                        total_repeat_length=C)
        pos_in = jnp.arange(C, dtype=jnp.int32)
        pvalid = pos_in < num
        ii = jnp.where(pvalid, ii, n_slots)
        ii_safe = jnp.minimum(ii, n_slots - 1)
        lane = jnp.where(pvalid, pos_in - base[ii_safe], 0)
        jj = jnp.where(pvalid, idx_k[ii_safe, lane], 0)
        jj = jnp.maximum(jj, 0)
        overflow = k_overflow | (num > C)
        # segment windows over the sorted i_slot ids
        edges = jnp.minimum(
            jnp.arange(0, (-(-n_slots // seg_block)) * seg_block + 1,
                       seg_block, dtype=jnp.int32), n_slots)
        bounds = jnp.searchsorted(ii, edges).astype(jnp.int32)
        overflow = overflow | jnp.any(
            (bounds[1:] - bounds[:-1]) > seg_window)
        return ii, jj, pvalid, bounds[:-1], overflow

    def local_block(pos, valid, gid, ref_pos, gamma, lcp_iters, overflow,
                    key, n_steps):
        target = n_steps

        def pair_setup(pos, ii, jj, pmask):
            """Per-step signed separations + normals for the (stale,
            skin-buffered) pair list, from CURRENT positions."""
            pos_ext = halo_ext(pos, True).reshape(-1, 3)
            pos_l = pos.reshape(-1, 3)
            pi = pos_l[jnp.minimum(ii, n_slots - 1)]
            pj = pos_ext[jj]
            sep = _min_image(pj - pi)
            d2 = jnp.maximum(jnp.sum(sep * sep, axis=-1), 1e-24)
            dist = jnp.sqrt(d2)
            normals = sep / dist[:, None]
            sep0 = dist - two_r
            return normals, sep0

        def inner_step(carry):
            (pos, valid, gid, ref_pos, gamma, ii, jj, pmask, wstarts,
             lcp_iters, key, step, done) = carry
            normals, sep0 = pair_setup(pos, ii, jj, pmask)
            windows = SegmentWindows(starts=wstarts, block_bodies=seg_block,
                                     window=seg_window,
                                     overflow=jnp.asarray(False))

            def forces_of(g):
                gn = jnp.where(pmask, g, 0.0)[:, None] * normals
                return segment_sum_sorted_blocked(-gn, ii, n_slots, windows)

            def apply_A(g):
                u = inv_drag * forces_of(g)
                u_ext = halo_ext(u.reshape(ny, nzl, R, 3), False).reshape(-1, 3)
                du = u[jnp.minimum(ii, n_slots - 1)] - u_ext[jj]
                sdot = -jnp.sum(normals * du, axis=-1)
                return jnp.asarray(dt, dtype) * sdot

            # Brownian drift is a KNOWN velocity: it enters the LCP's
            # constant term q = sep0 + dt D^T u_b so the solve enforces
            # non-penetration of the actual end-of-step positions (same
            # semantics as resolve_collisions(u_ext=...)).
            u_b = None
            q = sep0
            if diffusion > 0:
                bz = brownian_velocity_keyed(
                    key, step, gid, jnp.asarray(diffusion, dtype), dt,
                    dtype=dtype).reshape(-1, 3)
                u_b = jnp.where(valid.reshape(-1)[:, None], bz, 0.0)
                ub_ext = halo_ext(u_b.reshape(ny, nzl, R, 3),
                                  False).reshape(-1, 3)
                dub = u_b[jnp.minimum(ii, n_slots - 1)] - ub_ext[jj]
                q = sep0 - jnp.asarray(dt, dtype) * jnp.sum(normals * dub,
                                                            axis=-1)

            cfg = PGDConfig(max_iters=max_col_iterations,
                            tol=max_allowable_overlap,
                            bb_rule="alternating",
                            residual="projected_gradient",
                            axis_names=(axis,))
            res = solve_lcp(apply_A, q, x0=gamma, config=cfg, mask=pmask)
            gamma = res.x
            vel = inv_drag * forces_of(gamma)
            if u_b is not None:
                vel = vel + u_b
            new_pos = pos.reshape(-1, 3) + jnp.asarray(dt, dtype) * vel
            new_pos = new_pos - box_size * jnp.floor(new_pos * (1.0 / box_size))
            new_pos = jnp.where(valid.reshape(-1)[:, None], new_pos,
                                pos.reshape(-1, 3)).reshape(ny, nzl, R, 3)
            iters = jnp.full_like(lcp_iters, res.num_iters)
            return (new_pos, valid, gid, ref_pos, gamma, ii, jj, pmask,
                    wstarts, iters, key, step + 1, done + 1)

        def moved(carry):
            pos, valid, _g, ref_pos, *_ = carry
            disp = _min_image(pos - ref_pos)
            d2 = jnp.where(valid, jnp.sum(disp * disp, axis=-1), 0.0)
            return jax.lax.pmax(jnp.max(d2), axis) > \
                (0.5 * constraint_buffer) ** 2

        def rebuild(carry):
            (pos, valid, gid, _ref, gamma, _ii, _jj, _pm, _ws,
             lcp_iters, key, step, done) = carry
            if rebuild_mode == "local":
                new_pos, new_val, new_gid, _, rovf = slab_local_resort(
                    pos, valid, gid, grid, nzl, axis, d)
            else:
                flat_local = jnp.zeros((n_total, 3), dtype)
                idx = jnp.where(valid.reshape(-1), gid.reshape(-1), n_total)
                flat_local = flat_local.at[idx].set(pos.reshape(-1, 3),
                                                    mode="drop")
                flat = jax.lax.psum(flat_local, axis)
                rows = build_rows(flat, jnp.arange(n_total, dtype=jnp.int32),
                                  grid)
                me = jax.lax.axis_index(axis)
                z0 = me * nzl
                new_pos = jax.lax.dynamic_slice_in_dim(rows.pos, z0, nzl,
                                                       axis=1)
                new_val = jax.lax.dynamic_slice_in_dim(rows.valid, z0, nzl,
                                                       axis=1)
                new_gid = jax.lax.dynamic_slice_in_dim(rows.gid, z0, nzl,
                                                       axis=1)
                rovf = rows.overflow
            ii, jj, pmask, wstarts, povf = build_pairs(new_pos, new_val)
            return ((new_pos, new_val, new_gid, new_pos,
                     jnp.zeros((C,), dtype), ii, jj, pmask, wstarts,
                     lcp_iters, key, step, done),
                    rovf | povf)

        def outer_body(carry_ovf):
            carry, ovf = carry_ovf
            carry, rovf = rebuild(carry)
            ovf = ovf | rovf
            carry = inner_step(carry)

            # skin trigger computed in the BODY, carried as a flag the
            # cond reads (a while cond can't fuse with the body and runs
            # its pmax as a separate program)
            def inner_step_flag(cf):
                c, _ = cf
                c = inner_step(c)
                return (c, moved(c))

            carry, _ = jax.lax.while_loop(
                lambda cf: jnp.logical_and(cf[0][12] < target,
                                           jnp.logical_not(cf[1])),
                inner_step_flag, (carry, moved(carry)))
            return (carry, ovf)

        zero_pairs = (jnp.zeros((C,), jnp.int32), jnp.zeros((C,), jnp.int32),
                      jnp.zeros((C,), bool),
                      jnp.zeros((-(-n_slots // seg_block),), jnp.int32))
        carry = (pos, valid, gid, ref_pos, gamma) + zero_pairs + (
            lcp_iters, key, jnp.asarray(0, jnp.int32),
            jnp.asarray(0, jnp.int32))
        (carry, overflow) = jax.lax.while_loop(
            lambda co: co[0][12] < target, outer_body, (carry, overflow))
        (pos, valid, gid, ref_pos, gamma, _ii, _jj, _pm, _ws, lcp_iters,
         _key, _step, _done) = carry
        # pair overflow is per-shard — reduce before the replicated output
        overflow = jax.lax.pmax(overflow.astype(jnp.int32), axis) > 0
        return pos, valid, gid, ref_pos, gamma, lcp_iters, overflow

    step_block = jax.jit(
        jax.shard_map(
            local_block, mesh=mesh,
            in_specs=(P(None, axis), P(None, axis), P(None, axis),
                      P(None, axis), P(axis), P(axis), P(), P(), P()),
            out_specs=(P(None, axis), P(None, axis), P(None, axis),
                       P(None, axis), P(axis), P(axis), P()),
            check_vma=False,
        )
    )

    def init_fn(key, pos=None):
        kp, ks = jax.random.split(key)
        if pos is None:
            pos = jax.random.uniform(kp, (n_total, 3), dtype=dtype,
                                     maxval=box_size)
        pos = jnp.asarray(pos, dtype)
        rows = build_rows(pos, jnp.arange(n_total, dtype=jnp.int32), grid)
        sh = NamedSharding(mesh, P(None, axis))
        shp = NamedSharding(mesh, P(axis))
        return {
            "pos": jax.device_put(np.asarray(rows.pos), sh),
            "valid": jax.device_put(np.asarray(rows.valid), sh),
            "gid": jax.device_put(np.asarray(rows.gid), sh),
            "ref_pos": jax.device_put(np.asarray(rows.pos), sh),
            "gamma": jax.device_put(np.zeros((d * C,), dtype), shp),
            "lcp_iters": jax.device_put(
                np.zeros((d,), np.int32), shp),
            "overflow": jnp.asarray(bool(rows.overflow)),
            "key": ks,
        }

    def step_block_fn(state, n_steps):
        pos, valid, gid, ref, gamma, iters, ovf = step_block(
            state["pos"], state["valid"], state["gid"], state["ref_pos"],
            state["gamma"], state["lcp_iters"], state["overflow"],
            state["key"], jnp.asarray(n_steps, jnp.int32))
        return {**state, "pos": pos, "valid": valid, "gid": gid,
                "ref_pos": ref, "gamma": gamma, "lcp_iters": iters,
                "overflow": ovf}

    return init_fn, step_block_fn, grid
