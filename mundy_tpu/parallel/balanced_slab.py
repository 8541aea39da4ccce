"""Runtime load rebalancing: density-balanced z-slab decomposition.

The stk::balance / RCB role of the reference (`mundy::loadbalance` with
`RcbSettings`, `scrap/hp1_mock_reworks/HP1_mock_rework_agents_text_mesh_
neigh_linker.cpp:820,1358` — re-run DURING the run, not just at setup)
re-designed for SPMD. SPMD shapes are static, so "rebalancing" cannot
resize shard arrays; instead each shard owns a FIXED-capacity compact
particle buffer and the OWNERSHIP MAP — d+1 z-boundaries — is *data*,
recomputed from the measured z-histogram at every skin rebuild:

  - boundaries put ~N/d bodies in every slab regardless of density, so a
    settling granular bed or a collapsing globule never overflows one
    shard's buffer (the uniform-z failure mode: the dense slab exceeds its
    slack while 7 shards sit near-empty);
  - between rebuilds shards step locally: own bodies + a ghost halo (all
    bodies within cutoff+skin of the slab's z-range, owned by the RING
    NEIGHBORS); ghost positions refresh each step by `ppermute`-ing the
    neighbor shards' own buffers and gathering precomputed slots;
  - the rebuild all-gathers positions (the slab_rows "global" resort
    precedent — O(N) comms, amortized over the skin period), recomputes
    boundaries, and repacks own/ghost buffers deterministically (global
    id order), so trajectories are independent of the decomposition.

Capacity contract: per-shard own capacity N_cap and ghost capacity G_cap
are static; `overflow` goes sticky when (a) a slab's body count exceeds
N_cap (can only happen if density shifts WITHIN one skin period faster
than the balance can follow), (b) the ghost halo exceeds G_cap, or (c) a
slab is thinner than cutoff+skin (ghosts would need 2+ ring hops; the
caller should drop d or widen capacity — same class of declared limit as
slab_local's one-plane migration).

This engine is COUNT-allocated (compact buffers) where slab_rows is
VOLUME-allocated (dense rows): clustered densities are exactly where the
row layout's per-cell capacity explodes (PERF.md "route heavily-clustered
broad phases off the row layout"), so the balanced engine is the clustered
complement, not a replacement.
"""

from __future__ import annotations

import math as _math
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
from jax import Array
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from mundy_tpu.forces.contact import effective_youngs, hertzian_pair_force
from mundy_tpu.neighbor import build_cell_list, make_cell_grid, neighbor_matrix


def balanced_bounds(z: Array, valid: Array, d: int, lo: float, hi: float,
                    nbins: int = 256) -> Array:
    """(d+1,) z-boundaries splitting the valid bodies into d ~equal-count
    contiguous slabs: histogram + cumsum + linear interpolation inside the
    quantile bin. jit-safe; replicated inputs give replicated boundaries."""
    dtype = z.dtype
    width = (hi - lo) / nbins
    b = jnp.clip(((z - lo) / width).astype(jnp.int32), 0, nbins - 1)
    hist = jnp.zeros((nbins,), jnp.int32).at[b].add(
        valid.astype(jnp.int32), mode="drop")
    cum = jnp.cumsum(hist)  # inclusive; cum[-1] = N
    n = cum[nbins - 1]
    targets = (jnp.arange(1, d, dtype=dtype) / d) * n.astype(dtype)
    # first bin whose inclusive cumsum reaches the target
    reached = cum[None, :] >= jnp.ceil(targets)[:, None].astype(jnp.int32)
    idx = jnp.argmax(reached, axis=1)
    cum_lo = jnp.where(idx > 0, cum[jnp.maximum(idx - 1, 0)], 0)
    in_bin = jnp.maximum(cum[idx] - cum_lo, 1)
    frac = (targets - cum_lo.astype(dtype)) / in_bin.astype(dtype)
    cuts = lo + (idx.astype(dtype) + jnp.clip(frac, 0.0, 1.0)) * width
    return jnp.concatenate([jnp.asarray([lo], dtype), cuts,
                            jnp.asarray([hi], dtype)])


def uniform_bounds(d: int, lo: float, hi: float, dtype=jnp.float32) -> Array:
    return jnp.linspace(lo, hi, d + 1, dtype=dtype)


def make_balanced_settling_step(
    mesh: Mesh,
    axis: str,
    n_total: int,
    box: tuple,  # (Lx, Ly, Lz) free-space box (floor at z=0)
    radius: float = 0.5,
    youngs: float = 1000.0,
    poisson: float = 0.3,
    viscosity: float = 1.0,
    gravity: float = 5.0,
    wall_spring: float = 1000.0,
    dt: float = 1e-4,
    skin: float = 0.3,
    own_slack: float = 1.5,
    ghost_slack: float = 3.0,
    max_neighbors: int = 24,
    cell_capacity: int = 24,
    balance: str = "balanced",  # "balanced" | "uniform"
    dtype=jnp.float32,
):
    """Overdamped Hertzian spheres settling under gravity in a free box,
    sharded over density-balanced z-slabs. Returns (init_fn, step_block_fn).

    init_fn(pos) -> sharded state dict (pos replicated (N, 3) input).
    step_block_fn(state, n_steps) -> state; skin-triggered rebalance+rebuild
    fully on-chip (nested while).
    """
    d = mesh.shape[axis]
    assert n_total % 1 == 0 and d >= 2
    lx, ly, lz = (float(b) for b in box)
    cutoff = 2.0 * radius + skin
    n_cap = int(_math.ceil(own_slack * n_total / d / 8)) * 8
    g_cap = int(_math.ceil(ghost_slack * n_total / d / 8)) * 8
    m_tot = n_cap + g_cap
    drag = 6.0 * _math.pi * viscosity * radius
    e_eff = effective_youngs(youngs, youngs, poisson, poisson)
    grid = make_cell_grid([0, 0, 0], np.array([lx, ly, lz]), cutoff,
                          (False,) * 3, dtype)
    perm_up = [(i, (i + 1) % d) for i in range(d)]
    perm_dn = [(i, (i - 1) % d) for i in range(d)]

    def _forces(pos_m, valid_m):
        """Forces on ALL m_tot local slots from own+ghost neighbors (only
        the first n_cap own rows are consumed)."""
        p = pos_m
        clist = build_cell_list(p, grid, cell_capacity, valid=valid_m)
        nmat = neighbor_matrix(p, clist, jnp.asarray(cutoff / 2, dtype),
                               max_neighbors=max_neighbors,
                               chunk=min(4096, m_tot))
        idx = jnp.minimum(nmat.idx, m_tot - 1)
        sep = p[idx] - p[:, None, :]
        d2 = jnp.maximum(jnp.sum(sep * sep, axis=-1), 1e-12)
        dist = jnp.sqrt(d2)
        signed = dist - 2.0 * radius
        fmag = hertzian_pair_force(signed, jnp.asarray(0.5 * radius, dtype),
                                   e_eff)
        fvec = -fmag[..., None] * sep / dist[..., None]
        fvec = jnp.where((nmat.mask & valid_m[idx])[..., None], fvec, 0.0)
        f = jnp.sum(fvec, axis=1)
        # walls: floor/ceiling + 4 sides (hertzian springs), gravity on z
        def spring(over):
            return wall_spring * jnp.maximum(over, 0.0) ** 1.5
        f = f.at[:, 2].add(spring(radius - p[:, 2])
                           - spring(p[:, 2] - (lz - radius))
                           - drag * 0.0)
        f = f.at[:, 0].add(spring(radius - p[:, 0])
                           - spring(p[:, 0] - (lx - radius)))
        f = f.at[:, 1].add(spring(radius - p[:, 1])
                           - spring(p[:, 1] - (ly - radius)))
        f = f.at[:, 2].add(-gravity)
        ovf = clist.overflow | nmat.overflow
        return jnp.where(valid_m[:, None], f, 0.0), ovf

    def _repack(pos_all, shard_id):
        """Pack own + ghost buffers for this shard from replicated
        positions. Returns (own_idx, own_valid, ghost_idx, ghost_side,
        ghost_valid, bounds, ovf)."""
        zs = pos_all[:, 2]
        all_valid = jnp.ones((n_total,), bool)
        if balance == "balanced":
            bounds = balanced_bounds(zs, all_valid, d, 0.0, lz)
        else:
            bounds = uniform_bounds(d, 0.0, lz, dtype)
        b_lo = bounds[shard_id]
        b_hi = bounds[shard_id + 1]
        # edge shards absorb out-of-range stragglers (soft walls let z dip
        # slightly below 0 / above lz) so every body has exactly one owner
        above = jnp.where(shard_id == 0, True, zs >= b_lo)
        below = jnp.where(shard_id == d - 1, True, zs < b_hi)
        own = above & below
        # deterministic global-order pack
        cum = jnp.cumsum(own.astype(jnp.int32))
        n_own = cum[n_total - 1]
        slot = jnp.where(own, jnp.minimum(cum - 1, n_cap), n_cap)
        own_idx = jnp.full((n_cap + 1,), n_total, jnp.int32).at[slot].set(
            jnp.arange(n_total, dtype=jnp.int32), mode="drop")[:n_cap]
        own_valid = own_idx < n_total
        ovf = n_own > n_cap
        # ghosts: within cutoff+skin of the range, not own
        margin = cutoff + skin
        gh = (~own) & (zs >= b_lo - margin) & (zs < b_hi + margin)
        gcum = jnp.cumsum(gh.astype(jnp.int32))
        n_gh = gcum[n_total - 1]
        gslot = jnp.where(gh, jnp.minimum(gcum - 1, g_cap), g_cap)
        ghost_idx = jnp.full((g_cap + 1,), n_total, jnp.int32).at[gslot].set(
            jnp.arange(n_total, dtype=jnp.int32), mode="drop")[:g_cap]
        ghost_valid = ghost_idx < n_total
        ovf = ovf | (n_gh > g_cap)
        # every ghost must be owned by a ring neighbor (one hop): slabs
        # thinner than the margin would need 2+ hops
        lo_prev = bounds[jnp.maximum(shard_id - 1, 0)]
        hi_next = bounds[jnp.minimum(shard_id + 2, d)]
        gz = zs[jnp.minimum(ghost_idx, n_total - 1)]
        reach_lo = jnp.where(shard_id > 0, lo_prev,
                             jnp.asarray(0.0, dtype))
        reach_hi = jnp.where(shard_id < d - 1, hi_next,
                             jnp.asarray(lz, dtype))
        hop_ok = (~ghost_valid) | ((gz >= reach_lo) & (gz < reach_hi)
                                   | ((shard_id == d - 1) & (gz >= reach_lo)))
        ovf = ovf | jnp.logical_not(jnp.all(hop_ok))
        return own_idx, own_valid, ghost_idx, ghost_valid, bounds, ovf

    def _ghost_sources(own_idx_all_prev, own_idx_all_next, ghost_idx):
        """Map each ghost's global id to (which neighbor, slot in that
        neighbor's own buffer): ghosts are one ring hop by contract."""
        inv_prev = jnp.full((n_total + 1,), n_cap, jnp.int32).at[
            jnp.minimum(own_idx_all_prev, n_total)].set(
            jnp.arange(n_cap, dtype=jnp.int32), mode="drop")
        inv_next = jnp.full((n_total + 1,), n_cap, jnp.int32).at[
            jnp.minimum(own_idx_all_next, n_total)].set(
            jnp.arange(n_cap, dtype=jnp.int32), mode="drop")
        gi = jnp.minimum(ghost_idx, n_total)
        s_prev = inv_prev[gi]
        s_next = inv_next[gi]
        from_prev = s_prev < n_cap
        slot = jnp.where(from_prev, s_prev, s_next)
        found = from_prev | (s_next < n_cap)
        return from_prev, jnp.minimum(slot, n_cap - 1), found

    def local_block(pos_own, valid_own, gid_own, ghost_pos, ghost_from_prev,
                    ghost_slot, ghost_valid, ref_pos, overflow, n_steps):
        shard_id = jax.lax.axis_index(axis)

        def refresh_ghosts(pos_o, gf_prev, gslot, gvalid):
            from_prev = jax.lax.ppermute(pos_o, axis, perm_up)
            from_next = jax.lax.ppermute(pos_o, axis, perm_dn)
            src = jnp.where(gf_prev[:, None], from_prev[gslot],
                            from_next[gslot])
            return src

        def inner_step(carry):
            (pos_o, valid_o, gid_o, gpos, gf_prev, gslot, gvalid, ref, ovf,
             done) = carry
            gpos = refresh_ghosts(pos_o, gf_prev, gslot, gvalid)
            pos_m = jnp.concatenate([pos_o, gpos], axis=0)
            valid_m = jnp.concatenate([valid_o, gvalid], axis=0)
            f, fovf = _forces(pos_m, valid_m)
            vel = f[:n_cap] / drag
            pos_o = jnp.where(valid_o[:, None],
                              pos_o + jnp.asarray(dt, dtype) * vel, pos_o)
            return (pos_o, valid_o, gid_o, gpos, gf_prev, gslot, gvalid, ref,
                    ovf | fovf, done + 1)

        def moved(carry):
            pos_o, valid_o = carry[0], carry[1]
            ref = carry[7]
            disp = jnp.where(valid_o[:, None], pos_o - ref, 0.0)
            local = jnp.max(jnp.sum(disp * disp, axis=-1))
            return jax.lax.pmax(local, axis) > (0.5 * skin) ** 2

        def rebuild(carry):
            (pos_o, valid_o, gid_o, _gpos, _gfp, _gslot, _gvalid, _ref, ovf,
             done) = carry
            # all-gather via scatter-by-gid + psum (replicated (N, 3))
            contrib = jnp.zeros((n_total, 3), dtype).at[
                jnp.where(valid_o, gid_o, n_total)].set(
                jnp.where(valid_o[:, None], pos_o, 0.0), mode="drop")
            pos_all = jax.lax.psum(contrib, axis)
            own_idx, own_valid, ghost_idx, ghost_valid, _bounds, rovf = (
                _repack(pos_all, shard_id))
            safe = jnp.minimum(own_idx, n_total - 1)
            new_pos = jnp.where(own_valid[:, None], pos_all[safe], 0.0)
            new_gid = jnp.where(own_valid, own_idx, n_total)
            # neighbors' fresh own maps for ghost source slots
            idx_prev = jax.lax.ppermute(own_idx, axis, perm_up)
            idx_next = jax.lax.ppermute(own_idx, axis, perm_dn)
            gf_prev, gslot, found = _ghost_sources(idx_prev, idx_next,
                                                   ghost_idx)
            rovf = rovf | jnp.logical_not(
                jnp.all((~ghost_valid) | found))
            gpos = jnp.where(ghost_valid[:, None],
                             pos_all[jnp.minimum(ghost_idx, n_total - 1)],
                             0.0)
            return (new_pos, own_valid, new_gid, gpos, gf_prev, gslot,
                    ghost_valid, new_pos, ovf | rovf, done)

        def outer_body(carry):
            carry = jax.lax.cond(moved(carry), rebuild, lambda c: c, carry)
            carry = inner_step(carry)

            # skin trigger computed in the BODY, carried as a flag the
            # cond reads (a while cond can't fuse with the body and runs
            # its pmax as a separate program)
            def inner_step_flag(cf):
                c, _ = cf
                c = inner_step(c)
                return (c, moved(c))

            carry, _ = jax.lax.while_loop(
                lambda cf: jnp.logical_and(cf[0][-1] < n_steps,
                                           jnp.logical_not(cf[1])),
                inner_step_flag, (carry, moved(carry)))
            return carry

        carry = (pos_own, valid_own, gid_own, ghost_pos, ghost_from_prev,
                 ghost_slot, ghost_valid, ref_pos,
                 overflow, jnp.asarray(0, jnp.int32))
        carry = jax.lax.while_loop(lambda c: c[-1] < n_steps, outer_body,
                                   carry)
        return (carry[0], carry[1], carry[2], carry[3], carry[4], carry[5],
                carry[6], carry[7], carry[8])

    sharded = NamedSharding(mesh, P(axis))

    def init_fn(pos_all):
        """pos_all: replicated (N, 3). Builds the sharded state."""
        pos_all = jnp.asarray(pos_all, dtype)

        def shard_init(pos_rep):
            shard_id = jax.lax.axis_index(axis)
            own_idx, own_valid, ghost_idx, ghost_valid, _b, ovf = _repack(
                pos_rep, shard_id)
            safe = jnp.minimum(own_idx, n_total - 1)
            pos_o = jnp.where(own_valid[:, None], pos_rep[safe], 0.0)
            gid_o = jnp.where(own_valid, own_idx, n_total)
            idx_prev = jax.lax.ppermute(own_idx, axis, perm_up)
            idx_next = jax.lax.ppermute(own_idx, axis, perm_dn)
            gf_prev, gslot, found = _ghost_sources(idx_prev, idx_next,
                                                   ghost_idx)
            ovf = ovf | jnp.logical_not(jnp.all((~ghost_valid) | found))
            gpos = jnp.where(ghost_valid[:, None],
                             pos_rep[jnp.minimum(ghost_idx, n_total - 1)],
                             0.0)
            return dict(pos=pos_o[None], valid=own_valid[None],
                        gid=gid_o[None], ghost_pos=gpos[None],
                        ghost_from_prev=gf_prev[None],
                        ghost_slot=gslot[None], ghost_valid=ghost_valid[None],
                        ref_pos=pos_o[None], overflow=ovf[None])

        f = jax.jit(jax.shard_map(shard_init, mesh=mesh, in_specs=P(),
                                  out_specs=P(axis)))
        return f(pos_all)

    def step_block_fn(state, n_steps: int):
        def shard_step(pos, valid, gid, gpos, gfp, gslot, gvalid, ref, ovf):
            out = local_block(pos[0], valid[0], gid[0], gpos[0], gfp[0],
                              gslot[0], gvalid[0], ref[0], ovf[0],
                              jnp.asarray(n_steps, jnp.int32))
            return tuple(x[None] for x in out)

        f = jax.jit(jax.shard_map(
            shard_step, mesh=mesh, in_specs=(P(axis),) * 9,
            out_specs=(P(axis),) * 9))
        out = f(state["pos"], state["valid"], state["gid"],
                state["ghost_pos"], state["ghost_from_prev"],
                state["ghost_slot"], state["ghost_valid"], state["ref_pos"],
                state["overflow"])
        keys = ["pos", "valid", "gid", "ghost_pos", "ghost_from_prev",
                "ghost_slot", "ghost_valid", "ref_pos", "overflow"]
        return dict(zip(keys, out))

    def gather_positions(state):
        """Replicated (N, 3) from the sharded state (host-side check)."""
        pos = np.zeros((n_total, 3), np.float64)
        seen = np.zeros((n_total,), np.int64)
        gid = np.asarray(jax.device_get(state["gid"])).reshape(-1)
        val = np.asarray(jax.device_get(state["valid"])).reshape(-1)
        p = np.asarray(jax.device_get(state["pos"])).reshape(-1, 3)
        for k in range(gid.shape[0]):
            if val[k] and gid[k] < n_total:
                pos[gid[k]] = p[k]
                seen[gid[k]] += 1
        return pos, seen

    return init_fn, step_block_fn, gather_positions


def reference_settling_step(n_total, box, radius=0.5, youngs=1000.0,
                            poisson=0.3, viscosity=1.0, gravity=5.0,
                            wall_spring=1000.0, dt=1e-4, skin=0.3,
                            max_neighbors=24, cell_capacity=24,
                            dtype=jnp.float32):
    """Single-device reference of the same physics (no sharding): used by
    tests to validate balanced-slab trajectories."""
    lx, ly, lz = (float(b) for b in box)
    cutoff = 2.0 * radius + skin
    drag = 6.0 * _math.pi * viscosity * radius
    e_eff = effective_youngs(youngs, youngs, poisson, poisson)
    grid = make_cell_grid([0, 0, 0], np.array([lx, ly, lz]), cutoff,
                          (False,) * 3, dtype)

    @jax.jit
    def step(pos):
        clist = build_cell_list(pos, grid, cell_capacity)
        nmat = neighbor_matrix(pos, clist, jnp.asarray(cutoff / 2, dtype),
                               max_neighbors=max_neighbors,
                               chunk=min(4096, n_total))
        idx = jnp.minimum(nmat.idx, n_total - 1)
        sep = pos[idx] - pos[:, None, :]
        d2 = jnp.maximum(jnp.sum(sep * sep, axis=-1), 1e-12)
        dist = jnp.sqrt(d2)
        signed = dist - 2.0 * radius
        fmag = hertzian_pair_force(signed, jnp.asarray(0.5 * radius, dtype),
                                   e_eff)
        fvec = -fmag[..., None] * sep / dist[..., None]
        f = jnp.sum(jnp.where(nmat.mask[..., None], fvec, 0.0), axis=1)

        def spring(over):
            return wall_spring * jnp.maximum(over, 0.0) ** 1.5
        f = f.at[:, 2].add(spring(radius - pos[:, 2])
                           - spring(pos[:, 2] - (lz - radius)))
        f = f.at[:, 0].add(spring(radius - pos[:, 0])
                           - spring(pos[:, 0] - (lx - radius)))
        f = f.at[:, 1].add(spring(radius - pos[:, 1])
                           - spring(pos[:, 1] - (ly - radius)))
        f = f.at[:, 2].add(-gravity)
        return pos + jnp.asarray(dt, dtype) * f / drag, \
            clist.overflow | nmat.overflow

    return step
