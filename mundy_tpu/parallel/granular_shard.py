"""Sharded granular DEM: frictional Hertzian contact over density-balanced
z-slabs with MIGRATING per-contact tangential history.

Closes the round-4 gap "the granular/DEM app has NO multi-chip story": the
reference evaluates frictional-Hertzian contact under MPI like every other
kernel (`scrap/parameter_interface/linkers/src/mundy_linkers/
evaluate_linker_potentials/kernels/SpherocylinderSegmentSpherocylinderSegment
FrictionalHertzianContact.cpp:440-520` dispatched through
`EvaluateLinkerPotentials.hpp`, neighbor linkers ghosted via
`mundy/mesh/src/mundy_mesh/GenNeighborLinkers.hpp:700-741`), with per-contact
history riding the persistent linker entities across rebalances.

JAX form (the `balanced_lcp` slab pattern, extended with history state):

- ownership map = d+1 z-boundaries over the tall settling box [0, 2L],
  recomputed from the measured z-histogram at every rebuild
  (`balanced_bounds`): a settled bed — the granular steady state, and the
  worst case for uniform slabs — keeps ~N/d bodies per shard;
- free-space box (walls, no periodicity): ghosts are bodies within
  cutoff+skin of the slab's z-range (no wrap); the one-hop ring contract is
  checked and flagged as overflow if violated;
- per step: ghost POSITIONS and VELOCITIES refresh via the two ring
  `ppermute`s (the dashpot terms need ghost velocities); forces evaluate
  ROW-WISE on each shard's own (n_cap, K) neighbor rows — each contact
  appears on both owners' rows with mirrored normals, so the two history
  copies evolve as exact negatives and action-reaction holds without any
  cross-shard force exchange;
- per-contact tangential history lives in own-row slots (n_cap, K, 3) and
  MIGRATES: at every rebuild (which may move a body to a different slab and
  reorders every row) the old rows scatter into a global gid-keyed
  (N, K) table — key = neighbor gid + 1, one psum — and the new rows
  re-gather their entries by (gid_i, gid_j) pair identity, the
  distributed form of the single-device `remap_gamma` pattern
  (driver/apps/granular.py:161).

Parity: trajectories match `GranularSim` to summation-order rounding
(tests/test_granular_shard.py runs the f64 leg at ~1e-9 over a settling
window with multiple migrating rebuilds).
"""

from __future__ import annotations

import math as _math

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from mundy_tpu.neighbor import build_cell_list, make_cell_grid, neighbor_matrix
from mundy_tpu.parallel.balanced_slab import balanced_bounds, uniform_bounds

_EPS = 1e-12


def make_granular_slab_step(
    mesh: Mesh,
    axis: str,
    n_total: int,
    box_size: float,
    radius: float = 0.5,
    density: float = 1.0,
    gravity: float = 10.0,
    friction_coeff: float = 0.5,
    normal_spring: float = 5e4,
    normal_damping: float = 20.0,
    tang_spring: float = 2e4,
    tang_damping: float = 10.0,
    wall_spring: float = 5e4,
    dt: float = 1e-4,
    skin: float = 0.3,
    own_slack: float = 1.5,
    ghost_slack: float = 3.0,
    max_neighbors: int = 16,
    cell_capacity: int = 16,
    balance: str = "balanced",  # "balanced" | "uniform"
    dtype=jnp.float32,
):
    """Returns (init_fn, step_block_fn, gather_fn).

    init_fn(pos, vel) -> sharded state dict (replicated (N, 3) inputs);
    step_block_fn(state, n) runs n steps with the single-device app's
    cadence (unconditional rebuild at outer entry + skin-triggered), fully
    on-chip; gather_fn(state) -> (pos (N,3), vel (N,3), overflow) on host.
    """
    d = mesh.shape[axis]
    assert d >= 2
    L = float(box_size)
    H = 2.0 * L  # tall settling box: z in [0, H] (granular.py's extent)
    search_radius = radius + 0.5 * skin
    cutoff = 2.0 * search_radius
    margin = cutoff + 0.5 * skin
    n_cap = int(_math.ceil(own_slack * n_total / d / 8)) * 8
    g_cap = int(_math.ceil(ghost_slack * n_total / d / 8)) * 8
    m_tot = n_cap + g_cap
    K = max_neighbors
    mass = (4.0 / 3.0) * _math.pi * density * radius**3
    m_eff = 0.5 * mass  # equal radii: m_i m_j / (m_i + m_j)
    r_eff = 0.5 * radius
    two_r = 2.0 * radius
    grid = make_cell_grid([0, 0, 0], np.array([L, L, H]), cutoff,
                          (False,) * 3, dtype)
    perm_up = [(i, (i + 1) % d) for i in range(d)]
    perm_dn = [(i, (i - 1) % d) for i in range(d)]

    def _zdist(z, lo, hi):
        """Distance from z to the slab range [lo, hi) — NO wrap (free box)."""
        inside = (z >= lo) & (z < hi)
        return jnp.where(inside, 0.0,
                         jnp.minimum(jnp.abs(lo - z), jnp.abs(z - hi)))

    def _repack(pos_all, shard_id):
        zs = pos_all[:, 2]
        all_valid = jnp.ones((n_total,), bool)
        if balance == "balanced":
            bounds = balanced_bounds(zs, all_valid, d, 0.0, H)
        else:
            bounds = uniform_bounds(d, 0.0, H, dtype)
        b_lo = bounds[shard_id]
        b_hi = bounds[shard_id + 1]
        # top slab owns z == H exactly (clip keeps strays in range)
        zc = jnp.clip(zs, 0.0, H - 1e-6)
        own = (zc >= b_lo) & (zc < b_hi)
        cum = jnp.cumsum(own.astype(jnp.int32))
        n_own = cum[n_total - 1]
        slot = jnp.where(own, jnp.minimum(cum - 1, n_cap), n_cap)
        own_idx = jnp.full((n_cap + 1,), n_total, jnp.int32).at[slot].set(
            jnp.arange(n_total, dtype=jnp.int32), mode="drop")[:n_cap]
        own_valid = own_idx < n_total
        ovf = n_own > n_cap
        gh = (~own) & (_zdist(zc, b_lo, b_hi) < margin)
        gcum = jnp.cumsum(gh.astype(jnp.int32))
        n_gh = gcum[n_total - 1]
        gslot = jnp.where(gh, jnp.minimum(gcum - 1, g_cap), g_cap)
        ghost_idx = jnp.full((g_cap + 1,), n_total, jnp.int32).at[gslot].set(
            jnp.arange(n_total, dtype=jnp.int32), mode="drop")[:g_cap]
        ghost_valid = ghost_idx < n_total
        ovf = ovf | (n_gh > g_cap)
        # one-hop contract: every ghost must live in a ring neighbor's slab
        lo_prev = bounds[(shard_id - 1) % d]
        hi_prev = bounds[(shard_id - 1) % d + 1]
        lo_next = bounds[(shard_id + 1) % d]
        hi_next = bounds[(shard_id + 1) % d + 1]
        gz = jnp.clip(zs[jnp.minimum(ghost_idx, n_total - 1)], 0.0, H - 1e-6)
        in_prev = (gz >= lo_prev) & (gz < hi_prev)
        in_next = (gz >= lo_next) & (gz < hi_next)
        ovf = ovf | jnp.logical_not(
            jnp.all((~ghost_valid) | in_prev | in_next))
        return own_idx, own_valid, ghost_idx, ghost_valid, ovf

    def _ghost_sources(own_idx_prev, own_idx_next, ghost_idx):
        inv_prev = jnp.full((n_total + 1,), n_cap, jnp.int32).at[
            jnp.minimum(own_idx_prev, n_total)].set(
            jnp.arange(n_cap, dtype=jnp.int32), mode="drop")
        inv_next = jnp.full((n_total + 1,), n_cap, jnp.int32).at[
            jnp.minimum(own_idx_next, n_total)].set(
            jnp.arange(n_cap, dtype=jnp.int32), mode="drop")
        gi = jnp.minimum(ghost_idx, n_total)
        s_prev = inv_prev[gi]
        s_next = inv_next[gi]
        from_prev = s_prev < n_cap
        slot = jnp.where(from_prev, s_prev, s_next)
        found = from_prev | (s_next < n_cap)
        return from_prev, jnp.minimum(slot, n_cap - 1), found

    def _wall_gravity(pos_o, vel_o, valid_o):
        """Hertzian-spring walls + gravity (granular.py:_wall_force)."""
        r, k = radius, wall_spring

        def spring(over):
            return k * jnp.maximum(over, 0.0) ** 1.5

        f = jnp.zeros_like(pos_o)
        f = f.at[:, 2].add(spring(r - pos_o[:, 2]))
        f = f.at[:, 2].add(-spring(pos_o[:, 2] - (H - r)))
        for ax in (0, 1):
            f = f.at[:, ax].add(spring(r - pos_o[:, ax]))
            f = f.at[:, ax].add(-spring(pos_o[:, ax] - (L - r)))
        f = f.at[:, 2].add(-mass * gravity)
        return jnp.where(valid_o[:, None], f, 0.0)

    names = ("pos", "vel", "valid", "gid", "gpos", "gf_prev", "gslot",
             "gvalid", "ref_pos", "nmat_idx", "nmat_mask", "ngid", "tang",
             "step", "rebuild_count", "overflow")

    def _search(pos_o, vel_o, own_valid, gid_o, gpos, gvel, ghost_idx,
                ghost_valid):
        """Merged-buffer neighbor rows + per-slot neighbor gids."""
        pos_m = jnp.concatenate([pos_o, gpos], axis=0)
        valid_m = jnp.concatenate([own_valid, ghost_valid], axis=0)
        clist = build_cell_list(pos_m, grid, cell_capacity, valid=valid_m)
        nmat = neighbor_matrix(
            pos_m, clist, jnp.asarray(search_radius, dtype),
            max_neighbors=K, chunk=min(4096, m_tot))
        idxm = nmat.idx[:n_cap]
        maskm = (nmat.mask[:n_cap]
                 & own_valid[:, None]
                 & valid_m[jnp.minimum(idxm, m_tot - 1)])
        gid_m = jnp.concatenate(
            [jnp.where(own_valid, gid_o, n_total),
             jnp.where(ghost_valid, jnp.minimum(ghost_idx, n_total),
                       n_total)], axis=0)
        ngid = jnp.where(maskm, gid_m[jnp.minimum(idxm, m_tot - 1)], n_total)
        return idxm, maskm, ngid, clist.overflow | nmat.overflow

    def _remap_history(gid_o, own_valid, old_ngid, old_tang, new_gid,
                       new_valid, new_ngid):
        """Migrate (n_cap, K, 3) tangential history across a rebuild by
        (gid_i, gid_j) pair identity through a global gid-keyed table:
        scatter own rows to key/value planes, ONE psum each, re-gather by
        the new owner, K x K probe per row. The distributed remap_gamma."""
        row = jnp.where(own_valid, gid_o, n_total)
        key_tab = jnp.zeros((n_total + 1, K), jnp.int32).at[row].set(
            jnp.where(old_ngid < n_total, old_ngid + 1, 0), mode="drop")
        val_tab = jnp.zeros((n_total + 1, K, 3), dtype).at[row].set(
            old_tang, mode="drop")
        key_tab = jax.lax.psum(key_tab, axis)
        val_tab = jax.lax.psum(val_tab, axis)
        gi = jnp.where(new_valid, new_gid, n_total)
        old_k = key_tab[gi]  # (n_cap, K)
        old_v = val_tab[gi]  # (n_cap, K, 3)
        want = jnp.where(new_ngid < n_total, new_ngid + 1, -1)  # (n_cap, K)
        hit = old_k[:, None, :] == want[:, :, None]  # (n_cap, Knew, Kold)
        # HIGHEST: the one-hot remap must carry history exactly (no TF32)
        return jnp.einsum("npq,nqc->npc", hit.astype(dtype), old_v,
                          precision=jax.lax.Precision.HIGHEST)

    def local_block(st, n_steps):
        shard_id = jax.lax.axis_index(axis)

        def refresh_ghosts(val_own, gf_prev, gslot):
            from_prev = jax.lax.ppermute(val_own, axis, perm_up)
            from_next = jax.lax.ppermute(val_own, axis, perm_dn)
            return jnp.where(
                gf_prev.reshape((-1,) + (1,) * (val_own.ndim - 1)),
                from_prev[gslot], from_next[gslot])

        def inner_step(carry):
            st, done = carry
            pos_o, vel_o = st["pos"], st["vel"]
            valid_o = st["valid"]
            gpos = refresh_ghosts(pos_o, st["gf_prev"], st["gslot"])
            gvel = refresh_ghosts(vel_o, st["gf_prev"], st["gslot"])
            pos_m = jnp.concatenate([pos_o, gpos], axis=0)
            vel_m = jnp.concatenate([vel_o, gvel], axis=0)
            idx = jnp.minimum(st["nmat_idx"], m_tot - 1)
            maskm = st["nmat_mask"]
            # frictional Hertzian, row-wise (forces/friction.py formulas;
            # nhat points own -> neighbor, force accumulated on own only —
            # the mirrored row on the neighbor's owner supplies -f)
            sepv = pos_m[idx] - pos_o[:, None, :]
            r2 = jnp.maximum(jnp.sum(sepv * sepv, axis=-1), _EPS)
            rinv = jax.lax.rsqrt(r2)
            dist = r2 * rinv
            nhat = sepv * rinv[..., None]
            signed_sep = dist - two_r
            in_contact = maskm & (signed_sep < 0.0)
            rel = vel_m[idx] - vel_o[:, None, :]
            rel_n = jnp.sum(rel * nhat, axis=-1)[..., None] * nhat
            rel_t = rel - rel_n
            xi = st["tang"] + rel_t * dt
            xi = xi - jnp.sum(xi * nhat, axis=-1)[..., None] * nhat
            xi = jnp.where(in_contact[..., None], xi, 0.0)
            hertz_poly = jnp.sqrt(jnp.maximum(-r_eff * signed_sep, 0.0))
            f_n = hertz_poly[..., None] * (
                normal_spring * signed_sep[..., None] * nhat
                + (m_eff * normal_damping) * rel_n)
            f_t = hertz_poly[..., None] * (
                tang_spring * xi + (m_eff * tang_damping) * rel_t)
            fn_mag = jnp.linalg.norm(f_n, axis=-1)
            ft_mag = jnp.linalg.norm(f_t, axis=-1)
            cap = friction_coeff * fn_mag
            over = ft_mag > cap
            scale = cap / jnp.maximum(ft_mag, _EPS)
            damp_term = (m_eff * tang_damping) * rel_t \
                / jnp.maximum(tang_spring, _EPS)
            xi_rescaled = scale[..., None] * (xi + damp_term) - damp_term
            xi = jnp.where(over[..., None], xi_rescaled, xi)
            f_t = jnp.where(over[..., None], f_t * scale[..., None], f_t)
            f_pair = jnp.where(in_contact[..., None], f_n + f_t, 0.0)
            force = jnp.sum(f_pair, axis=1) + _wall_gravity(pos_o, vel_o,
                                                            valid_o)
            vel_new = vel_o + (dt / mass) * force
            pos_new = pos_o + dt * vel_new
            vel_new = jnp.where(valid_o[:, None], vel_new, 0.0)
            pos_new = jnp.where(valid_o[:, None], pos_new, pos_o)
            st = {**st, "pos": pos_new, "vel": vel_new, "gpos": gpos,
                  "tang": xi, "step": st["step"] + 1}
            return st, done + 1

        def moved(carry):
            st, _ = carry
            disp = st["pos"] - st["ref_pos"]
            d2 = jnp.where(st["valid"], jnp.sum(disp * disp, axis=-1), 0.0)
            return jax.lax.pmax(jnp.max(d2), axis) > (0.5 * skin) ** 2

        def rebuild(carry):
            st, done = carry
            pos_o, vel_o = st["pos"], st["vel"]
            valid_o, gid_o = st["valid"], st["gid"]
            row = jnp.where(valid_o, gid_o, n_total)
            pos_all = jax.lax.psum(
                jnp.zeros((n_total, 3), dtype).at[row].set(
                    jnp.where(valid_o[:, None], pos_o, 0.0), mode="drop"),
                axis)
            vel_all = jax.lax.psum(
                jnp.zeros((n_total, 3), dtype).at[row].set(
                    jnp.where(valid_o[:, None], vel_o, 0.0), mode="drop"),
                axis)
            own_idx, own_valid, ghost_idx, ghost_valid, rovf = _repack(
                pos_all, shard_id)
            safe = jnp.minimum(own_idx, n_total - 1)
            new_pos = jnp.where(own_valid[:, None], pos_all[safe], 0.0)
            new_vel = jnp.where(own_valid[:, None], vel_all[safe], 0.0)
            new_gid = jnp.where(own_valid, own_idx, n_total)
            idx_prev = jax.lax.ppermute(own_idx, axis, perm_up)
            idx_next = jax.lax.ppermute(own_idx, axis, perm_dn)
            gf_prev, gslot, found = _ghost_sources(idx_prev, idx_next,
                                                   ghost_idx)
            rovf = rovf | jnp.logical_not(jnp.all((~ghost_valid) | found))
            gsafe = jnp.minimum(ghost_idx, n_total - 1)
            gpos = jnp.where(ghost_valid[:, None], pos_all[gsafe], 0.0)
            gvel = jnp.where(ghost_valid[:, None], vel_all[gsafe], 0.0)
            idxm, maskm, ngid, sovf = _search(
                new_pos, new_vel, own_valid, new_gid, gpos, gvel,
                ghost_idx, ghost_valid)
            tang = _remap_history(gid_o, valid_o, st["ngid"], st["tang"],
                                  new_gid, own_valid, ngid)
            st = {**st, "pos": new_pos, "vel": new_vel, "valid": own_valid,
                  "gid": new_gid, "gpos": gpos, "gf_prev": gf_prev,
                  "gslot": gslot, "gvalid": ghost_valid,
                  "ref_pos": new_pos, "nmat_idx": idxm, "nmat_mask": maskm,
                  "ngid": ngid, "tang": tang,
                  "rebuild_count": st["rebuild_count"] + 1,
                  "overflow": st["overflow"] | rovf | sovf}
            return st, done

        def outer_body(carry):
            # unconditional rebuild at outer entry — GranularSim._run_n
            # does the same (cadence parity)
            carry = rebuild(carry)
            carry = inner_step(carry)

            # skin trigger computed in the BODY, carried as a flag the
            # cond reads (a while cond can't fuse with the body and runs
            # its pmax as a separate program)
            def inner_step_flag(cf):
                cr, _ = cf
                cr = inner_step(cr)
                return (cr, moved(cr))

            carry, _ = jax.lax.while_loop(
                lambda cf: jnp.logical_and(cf[0][1] < n_steps,
                                           jnp.logical_not(cf[1])),
                inner_step_flag, (carry, moved(carry)))
            return carry

        st, _ = jax.lax.while_loop(lambda cr: cr[1] < n_steps, outer_body,
                                   (st, jnp.asarray(0, jnp.int32)))
        return st

    def init_fn(pos, vel=None):
        pos = jnp.asarray(pos, dtype)
        vel = (jnp.zeros_like(pos) if vel is None
               else jnp.asarray(vel, dtype))

        def shard_init(pos_rep, vel_rep):
            shard_id = jax.lax.axis_index(axis)
            own_idx, own_valid, ghost_idx, ghost_valid, ovf = _repack(
                pos_rep, shard_id)
            safe = jnp.minimum(own_idx, n_total - 1)
            pos_o = jnp.where(own_valid[:, None], pos_rep[safe], 0.0)
            vel_o = jnp.where(own_valid[:, None], vel_rep[safe], 0.0)
            gid_o = jnp.where(own_valid, own_idx, n_total)
            idx_prev = jax.lax.ppermute(own_idx, axis, perm_up)
            idx_next = jax.lax.ppermute(own_idx, axis, perm_dn)
            gf_prev, gslot, found = _ghost_sources(idx_prev, idx_next,
                                                   ghost_idx)
            ovf = ovf | jnp.logical_not(jnp.all((~ghost_valid) | found))
            gsafe = jnp.minimum(ghost_idx, n_total - 1)
            gpos = jnp.where(ghost_valid[:, None], pos_rep[gsafe], 0.0)
            gvel = jnp.where(ghost_valid[:, None], vel_rep[gsafe], 0.0)
            idxm, maskm, ngid, sovf = _search(
                pos_o, vel_o, own_valid, gid_o, gpos, gvel, ghost_idx,
                ghost_valid)
            return dict(
                pos=pos_o, vel=vel_o, valid=own_valid, gid=gid_o, gpos=gpos,
                gf_prev=gf_prev, gslot=gslot, gvalid=ghost_valid,
                ref_pos=pos_o, nmat_idx=idxm, nmat_mask=maskm, ngid=ngid,
                tang=jnp.zeros((n_cap, K, 3), dtype),
                step=jnp.zeros((), jnp.int32),
                rebuild_count=jnp.zeros((), jnp.int32),
                overflow=ovf | sovf)

        out = jax.jit(jax.shard_map(
            lambda p, v: tuple(
                shard_init(p[0], v[0])[k][None] for k in names),
            mesh=mesh, in_specs=(P(), P()),
            out_specs=(P(axis),) * len(names), check_vma=False))(
            pos[None], vel[None])
        return dict(zip(names, out))

    # memoized jitted step programs per n_steps (a fresh jit(shard_map)
    # per call would re-trace every invocation — round-4 advisor finding)
    _step_cache: dict = {}

    def _make_step(n_steps: int):
        def shard_step(*vals):
            st = {k: v[0] for k, v in zip(names, vals)}
            out = local_block(st, jnp.asarray(n_steps, jnp.int32))
            return tuple(out[k][None] for k in names)

        return jax.jit(jax.shard_map(
            shard_step, mesh=mesh, in_specs=(P(axis),) * len(names),
            out_specs=(P(axis),) * len(names), check_vma=False))

    def step_block_fn(state, n_steps: int):
        f = _step_cache.get(n_steps)
        if f is None:
            f = _step_cache[n_steps] = _make_step(n_steps)
        out = f(*[state[k] for k in names])
        return dict(zip(names, out))

    def gather_fn(state):
        """Sharded dict -> (pos (N, 3), vel (N, 3), overflow) on host,
        de-permuted to global gid order."""
        gid = np.asarray(jax.device_get(state["gid"])).reshape(-1)
        valid = gid < n_total
        pos = np.zeros((n_total, 3), np.asarray(
            jax.device_get(state["pos"])).dtype)
        vel = np.zeros_like(pos)
        pos[gid[valid]] = np.asarray(
            jax.device_get(state["pos"])).reshape(-1, 3)[valid]
        vel[gid[valid]] = np.asarray(
            jax.device_get(state["vel"])).reshape(-1, 3)[valid]
        ovf = bool(np.any(np.asarray(jax.device_get(state["overflow"]))))
        return pos, vel, ovf

    return init_fn, step_block_fn, gather_fn
