"""Full-step sharded chromatin: contact + FENE + KMC + springs distributed.

The reference runs the entire HP1 pipeline distributed — search + ghosting
(`GenNeighborLinkers.hpp:652-741`), KMC state changes under parallel-
consistent modification (`LinkData.hpp:159-183`) — while round 2 sharded
only chromatin's spectral-hydro apply. This module distributes the
remaining phases over a device mesh:

- beads are sharded in INDEX blocks of whole chains (FENE bonds never
  cross shards); crosslinkers in index blocks;
- positions are ghost-replicated per step by one all-gather (N * 12 B —
  12 MB at 1M beads, trivially amortized over ICI; the all-gather IS the
  aura/ghost exchange, ungated because chromatin contacts are dense and
  global);
- each shard rebuilds only ITS OWN neighbor rows (neighbor_matrix_query
  against the replicated cell list — identical rows to the single-device
  search) and its own crosslinker candidate rows, evaluates contact forces
  for its own beads, FENE for its own chains, and KMC for its own
  crosslinkers (gid-keyed draws: the stream is a pure function of
  (key, step, gid), so sharded trajectories match single-device ones);
- crosslinker spring forces touch arbitrary beads and are reduced with one
  (N, 3) psum; everything else is shard-local.

Trajectories match the single-device ChromatinSim to summation-order
rounding (crosslinker scatters reduce in a different order); with zero
crosslinkers they are bit-identical.
"""

from __future__ import annotations

import math as _math

import jax
import jax.numpy as jnp
import numpy as np
from jax import Array
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from mundy_tpu.dynamics import brownian_velocity_keyed
from mundy_tpu.forces import hookean_spring_forces
from mundy_tpu.kmc import (BINDING_STATE, binding_rate_gaussian,
                           crosslinker_kmc_step)
from mundy_tpu.neighbor import (build_cell_list, neighbor_matrix_query)


def make_sharded_chromatin_step(mesh: Mesh, axis: str, sim):
    """Build (shard_fn, step_block_fn, gather_fn) for a ChromatinSim.

    Requirements: hydro in ("none", "rpy_spectral", "rpy_periphery").
    With "rpy_spectral" the spectral-Ewald Stokes mobility runs INSIDE the
    same shard_map program (per-shard gridding + one psum'd grid +
    slab-evaluated real space, parallel/spectral_shard.make_se_local_apply),
    so config #5's contact + FENE + KMC + hydro execute as ONE distributed
    step — the reference runs the whole HP1 loop under one MPI world
    (`HP1...neigh_linker.cpp:1377-1524`).

    With "rpy_periphery" (the confined HP1 PRODUCTION config,
    examples/hp1_chromatin.yaml) the full dense-RPY + no-slip BIE pipeline
    distributes — the reference's DistributedPeriphery role
    (`Periphery.hpp` FastDirectPeriphery :1155, compute_surface_forces
    :1409, evaluated under the MPI world):
      - dense RPY drift: each shard evaluates its OWN target-row block
        against all sources (one (N, 3) force all-gather; the N x N/d
        block is one matrix product);
      - ambient flow at the surface quadrature: per-shard partial sums
        over OWN beads, ONE psum;
      - surface densities q = -M^{-1} u|surf: the dense (3Q, 3Q) inverse
        is SHARDED over quadrature row blocks (each shard holds and
        applies only its (3Q/d, 3Q) slab, carried as a sharded state
        entry), one all-gather of the q blocks;
      - the double-layer correction back at the beads is shard-local
        (own targets).

    Also num_chains % d == 0, X % d == 0 (0 ok), non-periodic or periodic
    both supported (the single-device contact search must be on the
    cell-list path for bit-matching rows — confined configs always are).

    Parity: with hydro == "none" trajectories match the single-device app
    bit-identically (zero crosslinkers) or to summation-order rounding;
    with "rpy_spectral" the per-shard grid spread + psum reorders the
    wave-space summation, so parity is to floating-point tolerance.
    """
    c = sim.config
    d = mesh.shape[axis]
    assert c.hydro in ("none", "rpy_spectral", "rpy_periphery"), \
        "sharded step covers the dry, spectral, and confined-BIE pipelines"
    assert c.num_chains % d == 0, "shards own whole chains"
    N, X = sim.N, sim.X
    assert X % d == 0
    Nl, Xl = N // d, max(X // d, 1)
    K = sim.contact_K
    dtype = sim.dtype
    metric = sim.metric if sim.periodic else None
    inv_drag = sim.inv_drag

    se_apply = None
    if c.hydro == "rpy_spectral":
        from mundy_tpu.parallel.spectral_shard import make_se_local_apply
        assert N % d == 0, "spectral hydro shards flat bead blocks"
        # sim.se_geom's R/capacity are right-sized for the FULL N — a safe
        # bound for any shard's subset (see ChromatinSim._make_sharded_se)
        se_apply = make_se_local_apply(
            axis, d, sim.spectral, sim.se_geom, sim.hydro_cells_grid,
            N, (c.box_size,) * 3)

    periph_rb = 0
    if c.hydro == "rpy_periphery":
        assert N % d == 0, "dense RPY shards flat bead blocks"
        _Q3 = 3 * int(sim.periphery.points.shape[0])
        periph_rb = -(-_Q3 // d)  # quadrature GEMV rows per shard

    def _periph_minv_blocks():
        """(d, rb, 3Q) row slabs of M^{-1} — each shard carries only its
        own slab (the DistributedPeriphery surface split)."""
        m = np.asarray(jax.device_get(sim.periphery.m_inv))
        q3 = m.shape[0]
        pad = d * periph_rb - q3
        mp = np.concatenate([m, np.zeros((pad, q3), m.dtype)], axis=0)
        return mp.reshape(d, periph_rb, q3)

    def _periph_apply(shard_id, pos_own, pos_rep, f_own, f_all, minv_blk):
        """Distributed rpy_periphery mobility: dense-RPY own-row block +
        psum'd surface slip + row-sharded M^{-1} GEMV + local double-layer
        correction. Matches ChromatinSim._inner_step's rpy_periphery branch
        to summation-order rounding."""
        from mundy_tpu.mobility.periphery import double_layer_flow
        from mundy_tpu.mobility.rpy import (_rpy_pair_velocity,
                                            rpy_flow_at, rpy_self_mobility)
        a = jnp.asarray(c.bead_radius, dtype)
        chunk = min(1024, Nl)
        n_pad = ((Nl + chunk - 1) // chunk) * chunk
        pos_p = jnp.concatenate(
            [pos_own, jnp.zeros((n_pad - Nl, 3), dtype)], axis=0)
        gid0 = shard_id * Nl

        def one_chunk(start):
            tgt = jax.lax.dynamic_slice_in_dim(pos_p, start, chunk, axis=0)
            rvec = tgt[:, None, :] - pos_rep[None, :, :]
            u = _rpy_pair_velocity(rvec, f_all[None, :, :], a, c.viscosity,
                                   overlap_correction=True)
            me = gid0 + start + jnp.arange(chunk)
            same = me[:, None] == jnp.arange(N)[None, :]
            return jnp.sum(jnp.where(same[..., None], 0.0, u), axis=1)

        starts = jnp.arange(0, n_pad, chunk)
        vel = jax.lax.map(one_chunk, starts).reshape(n_pad, 3)[:Nl]
        vel = vel + rpy_self_mobility(f_own, a, c.viscosity)
        # ambient slip at the quadrature nodes: own-bead partials, one psum
        u_surf = jax.lax.psum(
            rpy_flow_at(sim.periphery.points, pos_own, f_own, a,
                        c.viscosity), axis)
        # sharded GEMV: this shard's row slab of q = -M^{-1} u|surf
        # (HIGHEST precision — a bf16/TF32 product corrupts the no-slip
        # balance, mobility/periphery.surface_densities)
        q_blk = -jnp.dot(minv_blk, u_surf.reshape(-1),
                         precision=jax.lax.Precision.HIGHEST)
        q3 = 3 * sim.periphery.points.shape[0]
        q = jax.lax.all_gather(q_blk, axis, tiled=True)[:q3].reshape(-1, 3)
        return vel + double_layer_flow(sim.periphery, q, pos_own)

    def shard_fn(state):
        """Full ChromatinState -> dict of (d, ...) sharded blocks."""
        def blocks(a, nl):
            return np.asarray(jax.device_get(a)).reshape((d, nl)
                                                         + a.shape[1:])

        # normalize the contact rows to this engine's query width K. The
        # single-device periodic search may be on the rows broad phase
        # (width contact_K + n_excl), so rows may be TRUNCATED here —
        # which is only safe because local_block unconditionally rebuilds
        # at outer entry before the first step. To keep a future cadence
        # change from ever consuming truncated rows, the mask is ZEROED
        # (filaments_shard does the same): stale rows then yield no pairs
        # (loud parity failure) instead of silently dropped neighbors.
        def fit_k(a, fill):
            w = a.shape[1]
            if w == K:
                return a
            if w > K:
                return a[:, :K]
            pad = np.full((a.shape[0], K - w) + a.shape[2:], fill, a.dtype)
            return np.concatenate([np.asarray(a), pad], axis=1)

        nmat_idx = fit_k(np.asarray(jax.device_get(state.nmat.idx)), N)
        nmat_mask = np.zeros((N, K), bool)  # rebuilt at entry (see above)
        out = {
            "pos": blocks(state.pos, Nl),
            "nmat_idx": nmat_idx.reshape((d, Nl, K)),
            "nmat_mask": nmat_mask.reshape((d, Nl, K)),
            "ref_pos": blocks(state.ref_pos, Nl),
            "key": np.broadcast_to(np.asarray(state.key), (d,)
                                   + state.key.shape).copy(),
            "step": np.full((d,), int(state.step), np.int32),
            "rebuild_count": np.full((d,), int(state.rebuild_count),
                                     np.int32),
            "overflow": np.full((d,), bool(state.overflow)),
        }
        if X > 0:
            out.update({
                "xl_home": blocks(state.xl.indices[:, 0], Xl),
                "xl_target": blocks(state.xl.indices[:, 1], Xl),
                "xl_state": blocks(state.xl.fields["state"], Xl),
                "xl_active": blocks(state.xl.active, Xl),
                "kmc_idx": blocks(state.kmc_nmat.idx, Xl),
                "kmc_mask": blocks(state.kmc_nmat.mask, Xl),
            })
        if periph_rb:
            # each shard carries only its (rb, 3Q) slab of M^{-1}
            out["periph_minv"] = _periph_minv_blocks().astype(dtype)
        sharded = NamedSharding(mesh, P(axis))
        return {k: jax.device_put(jnp.asarray(v), sharded)
                for k, v in out.items()}

    def _forces_own(shard_id, pos_rep, pos_own, nmat_idx, nmat_mask):
        """Contact + FENE + periphery for the shard's own beads (Nl, 3)."""
        from mundy_tpu.forces.contact import (effective_youngs,
                                              hertzian_pair_force)

        idx = jnp.minimum(nmat_idx, N - 1)
        pj = pos_rep[idx]
        if metric is None:
            sep = pj - pos_own[:, None, :]
        else:
            sep = metric.sep(pos_own[:, None, :], pj)
        d2 = jnp.maximum(jnp.sum(sep * sep, axis=-1), 1e-24)
        rinv = jax.lax.rsqrt(d2)
        dist = d2 * rinv
        e_eff = effective_youngs(c.youngs_modulus, c.youngs_modulus,
                                 c.poissons_ratio, c.poissons_ratio)
        mag = hertzian_pair_force(dist - 2.0 * c.bead_radius,
                                  jnp.asarray(0.5 * c.bead_radius, dtype),
                                  jnp.asarray(e_eff, dtype))
        w = jnp.where(nmat_mask, -(mag * rinv), 0.0)
        f = jnp.sum(w[..., None] * sep, axis=1)

        # FENE-WCA backbone: shards own whole chains, so the scatter-free
        # chain kernel runs directly on the OWN block (bit-identical to the
        # app's kernel — see test_fenewca_chain_matches_bond_list)
        from mundy_tpu.forces import fenewca_chain_forces
        sigma = 2.0 * c.bead_radius
        f = f + fenewca_chain_forces(
            pos_own, c.beads_per_chain,
            jnp.asarray(c.backbone_k, dtype),
            jnp.asarray(c.backbone_rmax * sigma, dtype),
            jnp.asarray(sigma, dtype),
            jnp.asarray(c.wca_epsilon, dtype),
            metric=metric)

        if c.periphery_radius > 0:
            r = jnp.linalg.norm(pos_own, axis=1)
            over = jnp.maximum(r + c.bead_radius - c.periphery_radius, 0.0)
            pmag = c.periphery_stiffness * over * jnp.sqrt(over)
            nhat = pos_own / jnp.maximum(r, 1e-12)[:, None]
            f = f - pmag[:, None] * nhat
        return f

    def _kmc_own(shard_id, pos_rep, key, step, xl_home, xl_target, xl_state,
                 xl_active, kmc_idx, kmc_mask):
        cand_idx = jnp.minimum(kmc_idx, N - 1)
        cand_mask = kmc_mask & sim.bind_allowed[cand_idx]
        px, py, pz = pos_rep[:, 0], pos_rep[:, 1], pos_rep[:, 2]
        dx = px[cand_idx] - px[xl_home][:, None]
        dy = py[cand_idx] - py[xl_home][:, None]
        dz = pz[cand_idx] - pz[xl_home][:, None]
        if sim.periodic:
            box = jnp.asarray(c.box_size, dtype)
            dx = dx - box * jnp.round(dx / box)
            dy = dy - box * jnp.round(dy / box)
            dz = dz - box * jnp.round(dz / box)
        dr = jnp.sqrt(dx * dx + dy * dy + dz * dz)
        rates = binding_rate_gaussian(dr, c.crosslinker_k,
                                      c.crosslinker_rest_length, c.kt,
                                      c.binding_rate)
        gid = shard_id * Xl + jnp.arange(Xl, dtype=jnp.int32)
        bound_to = jnp.where(xl_active, xl_target, -1)
        out = crosslinker_kmc_step(
            key, step, xl_state, bound_to, cand_idx, rates, cand_mask,
            koff=jnp.asarray(c.unbinding_rate, dtype), dt=c.dt, gid=gid)
        new_target = jnp.where(out.bound_to >= 0, out.bound_to, xl_home)
        return (out.state, new_target,
                out.state == BINDING_STATE.DOUBLY_BOUND)

    def local_block(s, n_steps):
        shard_id = jax.lax.axis_index(axis)
        has_xl = X > 0

        def gather_pos(pos_own):
            return jax.lax.all_gather(pos_own, axis, tiled=True)

        def inner_step(carry):
            st, done = carry
            pos_rep = gather_pos(st["pos"])
            if has_xl:
                xs, xt, xa = _kmc_own(shard_id, pos_rep, st["key"],
                                      st["step"], st["xl_home"],
                                      st["xl_target"], st["xl_state"],
                                      st["xl_active"], st["kmc_idx"],
                                      st["kmc_mask"])
                st = {**st, "xl_state": xs, "xl_target": xt, "xl_active": xa}
            f = _forces_own(shard_id, pos_rep, st["pos"], st["nmat_idx"],
                            st["nmat_mask"])
            if has_xl:
                f_xl = hookean_spring_forces(
                    pos_rep, st["xl_home"], st["xl_target"],
                    jnp.asarray(c.crosslinker_k, dtype),
                    jnp.asarray(c.crosslinker_rest_length, dtype),
                    mask=st["xl_active"], metric=metric)
                f = f + jax.lax.dynamic_slice_in_dim(
                    jax.lax.psum(f_xl, axis), shard_id * Nl, Nl)
            if se_apply is not None:
                # spectral-Ewald Stokes INSIDE the sharded step: reuse the
                # ghosted positions; forces need one all-gather of their own
                f_all = jax.lax.all_gather(f, axis, tiled=True)
                vel, se_ovf = se_apply(st["pos"], f, pos_all=pos_rep,
                                       f_all=f_all)
                st = {**st, "overflow": st["overflow"] | se_ovf}
            elif periph_rb:
                # confined HP1 pipeline: dense RPY + distributed BIE
                f_all = jax.lax.all_gather(f, axis, tiled=True)
                vel = _periph_apply(shard_id, st["pos"], pos_rep, f,
                                    f_all, st["periph_minv"])
            else:
                vel = inv_drag * f
            if c.diffusion_coeff > 0:
                gid = shard_id * Nl + jnp.arange(Nl, dtype=jnp.int32)
                vel = vel + brownian_velocity_keyed(
                    st["key"], st["step"], gid,
                    jnp.asarray(c.diffusion_coeff, dtype), c.dt,
                    dtype=dtype)
            new_pos = st["pos"] + jnp.asarray(c.dt, dtype) * vel
            if sim.periodic:
                new_pos = sim.metric.wrap(new_pos)
            st = {**st, "pos": new_pos, "step": st["step"] + 1}
            return st, done + 1

        def moved(carry):
            st = carry[0]
            # plain diff (not min-image), matching ChromatinSim._run_n's
            # trigger exactly — the rebuild CADENCE must be identical for
            # sharded KMC candidate rows to match the single-device run
            disp = st["pos"] - st["ref_pos"]
            local = jnp.max(jnp.sum(disp * disp, axis=-1))
            return jax.lax.pmax(local, axis) > (0.5 * c.skin) ** 2

        def rebuild(carry):
            st, done = carry
            pos_rep = gather_pos(st["pos"])
            gid = shard_id * Nl + jnp.arange(Nl, dtype=jnp.int32)
            clist = build_cell_list(pos_rep, sim.grid, sim.cell_capacity)
            excl = (jax.lax.dynamic_slice_in_dim(sim.exclude,
                                                 shard_id * Nl, Nl)
                    if sim.exclude is not None else None)
            nmat = neighbor_matrix_query(
                pos_rep, clist, st["pos"], gid,
                jnp.asarray(sim.search_radius, dtype),
                metric=metric, max_neighbors=K,
                chunk=min(c.chunk, max(256, Nl)), exclude=excl)
            ovf = st["overflow"] | clist.overflow | nmat.overflow
            st = {**st, "nmat_idx": nmat.idx, "nmat_mask": nmat.mask,
                  "ref_pos": st["pos"], "overflow": ovf,
                  "rebuild_count": st["rebuild_count"] + 1}
            if has_xl:
                kmat, kovf = sim._build_kmc_candidates(pos_rep,
                                                       st["xl_home"])
                st = {**st, "kmc_idx": kmat.idx, "kmc_mask": kmat.mask,
                      "overflow": st["overflow"] | kovf}
            return st, done

        def outer_body(carry):
            # unconditional rebuild at outer entry — ChromatinSim._run_n
            # does the same (cadence parity, see moved())
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

        s, _ = jax.lax.while_loop(lambda cr: cr[1] < n_steps, outer_body,
                                  (s, jnp.asarray(0, jnp.int32)))
        return s

    # memoize the jitted shard_map per (n_steps, key tuple): a fresh jit
    # wrapper per call re-traces every invocation (round-4 advisor finding
    # on the sibling engines)
    _step_cache: dict = {}

    def _make_step(n_steps: int, keys: tuple):
        def shard_step(*blocks):
            s = {k: b[0] for k, b in zip(keys, blocks)}
            out = local_block(s, jnp.asarray(n_steps, jnp.int32))
            return tuple(out[k][None] for k in keys)

        return jax.jit(jax.shard_map(
            shard_step, mesh=mesh, in_specs=(P(axis),) * len(keys),
            out_specs=(P(axis),) * len(keys)))

    def step_block_fn(state, n_steps: int):
        keys = tuple(sorted(state.keys()))
        f = _step_cache.get((n_steps, keys))
        if f is None:
            f = _step_cache[(n_steps, keys)] = _make_step(n_steps, keys)
        out = f(*[state[k] for k in keys])
        return dict(zip(keys, out))

    def gather_fn(state):
        """Sharded dict -> (pos (N, 3), xl_state, xl_bound_to) on host."""
        pos = np.asarray(jax.device_get(state["pos"])).reshape(N, 3)
        if X > 0:
            xs = np.asarray(jax.device_get(state["xl_state"])).reshape(X)
            xa = np.asarray(jax.device_get(state["xl_active"])).reshape(X)
            xt = np.asarray(jax.device_get(state["xl_target"])).reshape(X)
            bt = np.where(xa, xt, -1)
        else:
            xs = np.zeros(0, np.int32)
            bt = np.zeros(0, np.int32)
        return pos, xs, bt

    return shard_fn, step_block_fn, gather_fn
