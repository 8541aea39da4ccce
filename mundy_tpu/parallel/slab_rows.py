"""Sharded row-grid engine: z-slab decomposition of the gather-free layout.

Combines the two fastest designs: the dense row engine (neighbor/rows.py,
zero irregular access on the hot path) sharded over a device mesh by z-plane
slabs. Per step each shard:

1. exchanges ONE boundary z-plane with each ring neighbor via `lax.ppermute`
   (the aura/ghosting analog — O(ny * R) halo vs O(N) all-gather);
2. runs the 9-offset pair stencil on its halo-extended local block — y stays
   periodic via jnp.roll, z neighbors become static slices of the extended
   block (min-image metrics fix the wrapped coordinates of the global
   boundary planes);
3. integrates its local particles (gid-keyed Brownian streams: trajectories
   identical to the single-chip row engine).

Rebuild (skin-triggered, decided globally via pmax) has two strategies:

- "global": all-gather the flat positions (psum of an (N, 3) scatter),
  rebuild rows on every shard, slice the local slab. O(N) comms + O(N log N)
  replicated sort per shard — simple, but does not scale past ~10M bodies.
- "local" (default where legal): each shard re-sorts only its own slab.
  Between rebuilds a particle moves < skin/2 < one z-cell, so migrants can
  only come from the slab's two boundary planes; they are packed into
  fixed-capacity buffers (one boundary plane's worth) and exchanged with the
  ring neighbors via `lax.ppermute` — O(ny*R) comms and O(N/d log N/d) sort
  per shard. This is the distributed-search analog of STK's incremental
  ghosting update (`GenNeighborLinkers.hpp:700-741`): only boundary entities
  move ranks. Row contents are identical to the global resort (a row is a
  full x-column of one (y,z) cell, so its members always live in one slab),
  hence trajectories remain bit-identical to the single-chip engine.
"""

from __future__ import annotations

import math as _math

import jax
import jax.numpy as jnp
import numpy as np
from jax import Array
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from mundy_tpu.dynamics import brownian_velocity_keyed
from mundy_tpu.forces.contact import effective_youngs, hertzian_pair_force
from mundy_tpu.geom import periodic
from mundy_tpu.neighbor.rows import (
    RowGrid,
    _roll_image_shift,
    build_rows,
    make_row_grid,
)
from mundy_tpu.parallel.slab_local import local_resort_ok, slab_local_resort


def make_slab_rows_spheres_step(
    mesh: Mesh,
    axis: str,
    n_total: int,
    box_size: float,
    radius: float = 0.5,
    youngs: float = 1000.0,
    poisson: float = 0.3,
    viscosity: float = 1.0,
    diffusion: float = 0.1,
    dt: float = 1e-4,
    skin: float = 0.4,
    capacity_slack: float = 1.9,
    dtype=jnp.float32,
    rebuild_mode: str = "auto",
):
    """Returns (init_fn, step_block_fn).

    init_fn(key) -> state dict of sharded arrays.
    step_block_fn(state, n_steps) -> state: runs n_steps with skin-triggered
    global rebuilds, fully on-chip (nested while inside shard_map).
    """
    d = mesh.shape[axis]
    metric = periodic(np.array([box_size] * 3), dtype=dtype)
    cutoff = 2 * radius + skin
    grid = make_row_grid([0, 0, 0], [box_size] * 3, cutoff, n_total,
                         capacity_slack=capacity_slack, dtype=dtype)
    # make nz divisible by the mesh axis
    nz = (grid.nz // d) * d
    if nz < d:
        raise ValueError("too few z-planes for the mesh axis")
    grid = RowGrid(origin=grid.origin,
                   cell_yz=grid.cell_yz.at[1].set(box_size / nz),
                   ny=grid.ny, nz=nz, row_capacity=grid.row_capacity)
    nzl = nz // d
    R = grid.row_capacity
    ny = grid.ny
    inv_drag = 1.0 / (6.0 * _math.pi * viscosity * radius)
    e_eff = effective_youngs(youngs, youngs, poisson, poisson)
    box = (float(box_size),) * 3

    # slab-local rebuild needs >= 2 planes per slab (so the left-migrant
    # plane iz = z0-1 and the right-migrant plane iz = z0+nzl are distinct
    # cells) and a real ring (d >= 2); otherwise fall back to the global
    # resort, which is equivalent (and cheap) at those sizes.
    local_ok = local_resort_ok(d, nzl)
    if rebuild_mode == "auto":
        rebuild_mode = "local" if local_ok else "global"
    if rebuild_mode == "local" and not local_ok:
        raise ValueError(
            f"slab-local rebuild needs >=2 z-planes/slab and >=2 shards; got "
            f"nz={nz} over {d} shards")
    if rebuild_mode not in ("local", "global"):
        raise ValueError(f"unknown rebuild_mode {rebuild_mode!r}")

    def _forces_local(pos_ext):
        """9-offset stencil on the halo-extended block (ny, nzl+2, R, 3).

        Same fused component-plane kernel as pair_accumulate_central: the
        z halo planes arrive with their global-wrap coordinate shift already
        applied (halo_ext), y wrap is an O(R) pre-shift of rolled rows, and x
        gets a per-pair one-component minimum image. Invalid slots carry
        sentinel positions (build_rows) and self-pairs have sep = 0, so no
        validity mask is needed — identical arithmetic to the single-chip
        row engine, hence identical trajectories."""
        x, y, z = pos_ext[..., 0], pos_ext[..., 1], pos_ext[..., 2]
        cxs, cys, czs = [], [], []
        for dy in (-1, 0, 1):
            for dz in (-1, 0, 1):
                cx = x[:, 1 + dz:1 + dz + nzl]
                cy_ = y[:, 1 + dz:1 + dz + nzl]
                cz = z[:, 1 + dz:1 + dz + nzl]
                if dy != 0:
                    cx = jnp.roll(cx, -dy, axis=0)
                    cy_ = jnp.roll(cy_, -dy, axis=0) + _roll_image_shift(
                        ny, dy, box_size, dtype)[:, None, None]
                    cz = jnp.roll(cz, -dy, axis=0)
                cxs.append(cx)
                cys.append(cy_)
                czs.append(cz)
        cx = jnp.concatenate(cxs, axis=-1)  # (ny, nzl, 9R)
        cy_ = jnp.concatenate(cys, axis=-1)
        cz = jnp.concatenate(czs, axis=-1)
        ox = x[:, 1:1 + nzl]
        oy = y[:, 1:1 + nzl]
        oz = z[:, 1:1 + nzl]
        DX = cx[..., None, :] - ox[..., :, None]
        DX = DX - box_size * jnp.round(DX * (1.0 / box_size))
        DY = cy_[..., None, :] - oy[..., :, None]
        DZ = cz[..., None, :] - oz[..., :, None]
        r2 = jnp.maximum(DX * DX + DY * DY + DZ * DZ, 1e-24)
        rinv = jax.lax.rsqrt(r2)
        dist = r2 * rinv
        mag = hertzian_pair_force(dist - jnp.asarray(2.0 * radius, dtype),
                                  jnp.asarray(0.5 * radius, dtype),
                                  jnp.asarray(e_eff, dtype))
        w = -mag * rinv
        fx = jnp.sum(w * DX, axis=-1)
        fy = jnp.sum(w * DY, axis=-1)
        fz = jnp.sum(w * DZ, axis=-1)
        return jnp.stack([fx, fy, fz], axis=-1)

    def local_block(pos, valid, gid, ref_pos, overflow, key, step0, n_steps):
        """shard_map body: run n_steps with rebuilds. All arrays local
        (ny, nzl, R, ...)."""
        perm_up = [(i, (i + 1) % d) for i in range(d)]
        perm_dn = [(i, (i - 1) % d) for i in range(d)]
        target = n_steps

        def halo_ext(p):
            """One boundary z-plane from each ring neighbor, with the global
            z-wrap coordinate shift applied to the wrapped planes (the shard
            at the box edge sees its neighbor's plane one box away)."""
            me = jax.lax.axis_index(axis)
            lo = jax.lax.ppermute(p[:, -1:], axis, perm_up)  # from left nbr
            hi = jax.lax.ppermute(p[:, :1], axis, perm_dn)  # from right nbr
            ez = jnp.asarray([0.0, 0.0, 1.0], dtype)
            lo = lo + jnp.where(me == 0, -box_size, 0.0).astype(dtype) * ez
            hi = hi + jnp.where(me == d - 1, box_size, 0.0).astype(dtype) * ez
            return jnp.concatenate([lo, p, hi], axis=1)

        def inner_step(carry):
            pos, valid, gid, ref_pos, key, step, done = carry
            pos_ext = halo_ext(pos)
            f = _forces_local(pos_ext)
            vel = inv_drag * f
            if diffusion > 0:
                # gid-keyed streams: each shard generates noise only for the
                # entities it owns (O(local), not O(n_total) per shard)
                bz = brownian_velocity_keyed(
                    key, step, gid, jnp.asarray(diffusion, dtype), dt,
                    dtype=dtype)
                vel = vel + jnp.where(valid[..., None], bz, 0.0)
            # no wrap between rebuilds (neighbor/rows.py): rebuilds wrap
            new_pos = pos + jnp.asarray(dt, dtype) * vel
            new_pos = jnp.where(valid[..., None], new_pos, pos)
            return (new_pos, valid, gid, ref_pos, key, step + 1, done + 1)

        def moved(carry):
            pos, valid, _gid, ref_pos, _key, _step, _done = carry
            disp = metric.sep(ref_pos, pos)
            d2 = jnp.where(valid, jnp.sum(disp * disp, axis=-1), 0.0)
            return jax.lax.pmax(jnp.max(d2), axis) > (0.5 * skin) ** 2

        def rebuild_global(carry, ovf):
            pos, valid, gid, _ref, key, step, done = carry
            # global resort: gather flat positions by gid, rebuild, reslice
            flat_local = jnp.zeros((n_total, 3), dtype)
            idx = jnp.where(valid.reshape(-1), gid.reshape(-1), n_total)
            flat_local = flat_local.at[idx].set(pos.reshape(-1, 3), mode="drop")
            flat = metric.wrap(jax.lax.psum(flat_local, axis))
            rows = build_rows(flat, jnp.arange(n_total, dtype=jnp.int32), grid)
            me = jax.lax.axis_index(axis)
            z0 = me * nzl
            new_pos = jax.lax.dynamic_slice_in_dim(rows.pos, z0, nzl, axis=1)
            new_val = jax.lax.dynamic_slice_in_dim(rows.valid, z0, nzl, axis=1)
            new_gid = jax.lax.dynamic_slice_in_dim(rows.gid, z0, nzl, axis=1)
            return ((new_pos, new_val, new_gid, new_pos, key, step, done),
                    jnp.logical_or(ovf, rows.overflow))

        def rebuild_local(carry, ovf):
            """Slab-local resort (slab_local.py): exchange boundary-plane
            migrants with the ring neighbors, rebuild only the local block.
            Produces exactly the rows the global resort would (same (y,z)
            cell assignment, same within-row x sort)."""
            pos, valid, gid, _ref, key, step, done = carry
            pos = jnp.where(valid[..., None], metric.wrap(pos), pos)
            new_pos, new_val, new_gid, _, ovf = slab_local_resort(
                pos, valid, gid, grid, nzl, axis, d, ovf=ovf)
            return ((new_pos, new_val, new_gid, new_pos, key, step, done),
                    ovf)

        rebuild = (rebuild_local if rebuild_mode == "local"
                   else rebuild_global)

        def outer_body(carry_ovf):
            carry, ovf = carry_ovf
            carry, ovf = rebuild(carry, ovf)
            carry = inner_step(carry)
            # skin trigger computed in the BODY, carried as a flag the cond
            # reads: a while cond can't fuse with the body, so moved() in
            # the cond re-streams positions AND runs its pmax collective as
            # a separate program per iteration
            def inner_step_flag(cf):
                c, _ = cf
                c = inner_step(c)
                return (c, moved(c))

            carry, _ = jax.lax.while_loop(
                lambda cf: jnp.logical_and(cf[0][6] < target,
                                           jnp.logical_not(cf[1])),
                inner_step_flag, (carry, moved(carry)))
            return (carry, ovf)

        # step0 persists across blocks so the gid-keyed noise stream is a
        # pure function of the GLOBAL step index (multi-block CLI runs
        # match a single fused run)
        carry = (pos, valid, gid, ref_pos, key, step0,
                 jnp.asarray(0, jnp.int32))
        (carry, overflow) = jax.lax.while_loop(
            lambda co: co[0][6] < target, outer_body, (carry, overflow))
        pos, valid, gid, ref_pos, _key, step, _done = carry
        # every block starts with a rebuild, so the returned positions can
        # be wrapped for the caller
        pos = jnp.where(valid[..., None], metric.wrap(pos), pos)
        return pos, valid, gid, ref_pos, overflow, step

    step_block = jax.jit(
        jax.shard_map(
            local_block, mesh=mesh,
            in_specs=(P(None, axis), P(None, axis), P(None, axis),
                      P(None, axis), P(), P(), P(), P()),
            out_specs=(P(None, axis), P(None, axis), P(None, axis),
                       P(None, axis), P(), P()),
            check_vma=False,
        )
    )

    def init_fn(key, pos=None, step0: int = 0):
        """`pos` (optional (N, 3)): start from given positions (checkpoint
        resume / parity with a single-device state) — the key is then used
        only for the noise stream, split exactly like SpheresSim.init so
        the same top key yields the same trajectory."""
        kp, ks = jax.random.split(key)
        if pos is None:
            pos = jax.random.uniform(kp, (n_total, 3), dtype=dtype,
                                     maxval=box_size)
        pos = jnp.asarray(pos, dtype)
        rows = build_rows(pos, jnp.arange(n_total, dtype=jnp.int32), grid)
        sh = NamedSharding(mesh, P(None, axis))
        return {
            "pos": jax.device_put(np.asarray(rows.pos), sh),
            "valid": jax.device_put(np.asarray(rows.valid), sh),
            "gid": jax.device_put(np.asarray(rows.gid), sh),
            "ref_pos": jax.device_put(np.asarray(rows.pos), sh),
            "overflow": jnp.asarray(bool(rows.overflow)),
            "key": ks,
            "step": jnp.asarray(step0, jnp.int32),
        }

    def step_block_fn(state, n_steps):
        pos, valid, gid, ref, ovf, step = step_block(
            state["pos"], state["valid"], state["gid"], state["ref_pos"],
            state["overflow"], state["key"],
            state.get("step", jnp.asarray(0, jnp.int32)),
            jnp.asarray(n_steps, jnp.int32))
        return {**state, "pos": pos, "valid": valid, "gid": gid,
                "ref_pos": ref, "overflow": ovf, "step": step}

    return init_fn, step_block_fn, grid
