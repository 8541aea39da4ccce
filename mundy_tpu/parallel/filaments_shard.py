"""Sharded filaments: rod mechanics + segment contact distributed.

The reference runs the flagella/filament driver (`scrap/Sperm.cpp`,
BASELINE config #4) distributed like every other app — search + ghosting
via `GenNeighborLinkers.hpp:652-741`. This engine is the filaments
counterpart of parallel/chromatin_shard.py:

- shards own WHOLE filaments (F % d == 0): Kirchhoff rod internal forces,
  edge-frame transport, and the RFT mobility never cross shards;
- segment midpoints + half-edges are ghost-replicated per step by one
  (S, 6) all-gather (the aura/ghost exchange — ~2.4 MB at the 2000x50
  benchmark config, trivial over ICI);
- each shard rebuilds only ITS OWN neighbor rows (neighbor_matrix_query
  against the replicated cell list) and evaluates the shared narrow phase
  (driver.apps.filaments.segment_contact_split_forces) for its own
  segments — arithmetically identical to the single-device app;
- Brownian noise is gid-keyed (pure function of (key, step, node gid)),
  so sharded trajectories match single-device ones bit-for-bit when the
  single-device search is on the cell-list path (f64 / narrow boxes);
  with the f32 rows broad phase the pair SET matches but row order
  differs, giving summation-order-level parity.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from mundy_tpu.dynamics import brownian_velocity_keyed
from mundy_tpu.forces.contact import effective_youngs
from mundy_tpu.mech import rod_internal_forces, update_rod_edges
from mundy_tpu.neighbor import build_cell_list, neighbor_matrix_query


def make_sharded_filaments_step(mesh: Mesh, axis: str, sim):
    """Build (shard_fn, step_block_fn, gather_fn) for a FilamentsSim."""
    from mundy_tpu.driver.apps.filaments import (
        rest_curvature_wave,
        rft_velocity,
        segment_contact_split_forces,
    )

    c = sim.config
    d = mesh.shape[axis]
    F, M, E, S = sim.F, sim.M, sim.E, sim.S
    assert F % d == 0, "shards own whole filaments"
    Fl = F // d
    Sl = Fl * E
    K = c.max_neighbors
    dtype = sim.dtype
    metric = sim.metric
    inv_drag = sim.inv_drag
    e_eff = float(effective_youngs(c.youngs_modulus, c.youngs_modulus,
                                   c.poissons_ratio, c.poissons_ratio))

    def shard_fn(state):
        """FilamentsState -> dict of (d, ...) sharded blocks."""
        def blocks(a, nl):
            return np.asarray(jax.device_get(a)).reshape((d, nl)
                                                         + a.shape[1:])

        # normalize contact rows to the query width K (single-device f32
        # configs may be on the rows broad phase with width K + 2; content
        # is irrelevant — local_block rebuilds at outer entry)
        idx = np.asarray(jax.device_get(state.nmat.idx))
        mask = np.asarray(jax.device_get(state.nmat.mask))
        if idx.ndim != 2 or idx.shape[1] != K:
            idx = np.full((S, K), S, np.int32)
            mask = np.zeros((S, K), bool)
        out = {
            "pos": blocks(state.pos, Fl),
            "rod_q": blocks(state.rod.edge_q, Fl),
            "rod_t": blocks(state.rod.tangent, Fl),
            "rod_l": blocks(state.rod.length, Fl),
            "nmat_idx": idx.reshape(d, Sl, K),
            "nmat_mask": mask.reshape(d, Sl, K),
            "ref_pos": blocks(state.ref_pos, Sl),
            "key": np.broadcast_to(np.asarray(state.key), (d,)
                                   + state.key.shape).copy(),
            "step": np.full((d,), int(state.step), np.int32),
            "rebuild_count": np.full((d,), int(state.rebuild_count),
                                     np.int32),
            "overflow": np.full((d,), bool(state.overflow)),
        }
        sharded = NamedSharding(mesh, P(axis))
        return {k: jax.device_put(jnp.asarray(v), sharded)
                for k, v in out.items()}

    def _payload(pos_own):
        """(Sl, 6) [mid, half_edge] from the shard's (Fl, M, 3) nodes."""
        a = pos_own[:, :-1, :].reshape(Sl, 3)
        b = pos_own[:, 1:, :].reshape(Sl, 3)
        return jnp.concatenate([0.5 * (a + b), 0.5 * (b - a)], axis=1)

    def local_block(s, n_steps):
        shard_id = jax.lax.axis_index(axis)

        def gather_payload(pay_own):
            return jax.lax.all_gather(pay_own, axis, tiled=True)

        def inner_step(carry):
            st, done = carry
            from mundy_tpu.mech import RodState
            rod = RodState(edge_q=st["rod_q"], tangent=st["rod_t"],
                           length=st["rod_l"])
            k0 = rest_curvature_wave(st["step"], Fl, E, c.active_amplitude,
                                     c.wave_k, c.wave_omega,
                                     c.segment_length, c.dt, dtype)
            f_rod, tau = rod_internal_forces(
                rod, st["pos"], k0, c.bend_modulus, c.stretch_stiffness,
                c.segment_length)
            pay_own = _payload(st["pos"])
            pay_all = gather_payload(pay_own)
            f_start, f_end = segment_contact_split_forces(
                pay_own, pay_all, st["nmat_idx"], st["nmat_mask"], metric,
                2.0 * c.radius, float(0.5 * c.radius), e_eff)
            node_f = jnp.zeros((Fl, M, 3), dtype)
            node_f = node_f.at[:, :-1, :].add(f_start.reshape(Fl, E, 3))
            node_f = node_f.at[:, 1:, :].add(f_end.reshape(Fl, E, 3))
            f = f_rod + node_f
            vel = rft_velocity(st["pos"], f, inv_drag, c.drag_anisotropy)
            if c.diffusion_coeff > 0:
                gid = (shard_id * Fl * M
                       + jnp.arange(Fl * M, dtype=jnp.int32))
                bv = brownian_velocity_keyed(
                    st["key"], st["step"], gid,
                    jnp.asarray(c.diffusion_coeff, dtype), c.dt,
                    dtype=dtype)
                vel = vel + bv.reshape(Fl, M, 3)
            new_pos = st["pos"] + jnp.asarray(c.dt, dtype) * vel
            new_rod = update_rod_edges(rod, new_pos,
                                       twist_rate=inv_drag * tau, dt=c.dt)
            st = {**st, "pos": new_pos, "rod_q": new_rod.edge_q,
                  "rod_t": new_rod.tangent, "rod_l": new_rod.length,
                  "step": st["step"] + 1}
            return st, done + 1

        def moved(carry):
            st = carry[0]
            mid = _payload(st["pos"])[:, :3]
            disp = metric.sep(st["ref_pos"], mid)
            local = jnp.max(jnp.sum(disp * disp, axis=-1))
            return jax.lax.pmax(local, axis) > (0.5 * c.skin) ** 2

        def rebuild(carry):
            st, done = carry
            pay_own = _payload(st["pos"])
            pay_all = gather_payload(pay_own)
            mid_all = pay_all[:, :3]
            gid = shard_id * Sl + jnp.arange(Sl, dtype=jnp.int32)
            clist = build_cell_list(mid_all, sim.grid, c.cell_capacity)
            excl = jax.lax.dynamic_slice_in_dim(sim.exclude, shard_id * Sl,
                                                Sl)
            nmat = neighbor_matrix_query(
                mid_all, clist, pay_own[:, :3], gid,
                jnp.asarray(sim.search_radius, dtype),
                metric=metric, max_neighbors=K,
                chunk=min(c.chunk, max(256, Sl)), exclude=excl)
            ovf = st["overflow"] | clist.overflow | nmat.overflow
            st = {**st, "nmat_idx": nmat.idx, "nmat_mask": nmat.mask,
                  "ref_pos": pay_own[:, :3], "overflow": ovf,
                  "rebuild_count": st["rebuild_count"] + 1}
            return st, done

        def outer_body(carry):
            # unconditional rebuild at outer entry — FilamentsSim._run_n
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

        s, _ = jax.lax.while_loop(lambda cr: cr[1] < n_steps, outer_body,
                                  (s, jnp.asarray(0, jnp.int32)))
        return s

    # memoize the jitted shard_map per (n_steps, state-key tuple): a fresh
    # jit wrapper per call re-traces every invocation (round-4 advisor
    # finding) — cached, repeat blocks hit the compiled executable.
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
        """Sharded dict -> (pos (F, M, 3), overflow) on host."""
        pos = np.asarray(jax.device_get(state["pos"])).reshape(F, M, 3)
        ovf = bool(np.any(np.asarray(jax.device_get(state["overflow"]))))
        return pos, ovf

    return shard_fn, step_block_fn, gather_fn
