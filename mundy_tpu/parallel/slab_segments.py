"""Sharded row-engine spherocylinders: z-slab decomposition of the dense
segment-segment narrow phase (BASELINE config #3 over the device mesh).

Extends the slab_rows pattern (spatial domain decomposition + one-plane
ppermute halos, the aura/ghosting analog of GenNeighborLinkers.hpp:700-741)
to oriented bodies: each rod carries an orientation quaternion payload, the
halo exchange ships ONE boundary z-plane of (midpoint, half-edge) per ring
neighbor per step, and the 9-offset candidate stencil feeds the clamped
segment-segment closest-point kernel on component planes
(neighbor/rows._segment_pair_chunk — identical arithmetic to the
single-chip RowRodsSim, hence identical trajectories).

Per step each shard:
1. rotates body axes from local quaternions (O(local)), builds half-edges;
2. exchanges one (ny, 1, R, 6) halo plane (pos + half-edge packed) with each
   ring neighbor via `lax.ppermute`, applying the global z-wrap coordinate
   shift to the wrapped midpoint planes (half-edges are translation
   invariant);
3. runs the full 9-offset segment pair stencil on its halo-extended block —
   every pair is evaluated by BOTH owners, so no partner reductions cross
   shards;
4. integrates its local rods (gid-keyed Brownian translation + rotation
   streams, rigid Euler + quaternion update — the streams make trajectories
   a pure function of (key, step, gid), so they match the single-chip run).

Rebuild (skin-triggered, decided globally via pmax) defaults to the
slab-local resort (boundary-plane migrant exchange via ppermute + per-shard
sort, quaternions riding along as payload channels — slab_local.py) where
legal, falling back to the global psum-gather resort.

ref: the reference's only parallelism is this spatial decomposition + MPI
ghosting (`GenNeighborLinkers.hpp:652-741`); spherocylinder narrow phase =
mundy_linkers SpherocylinderSegment kernels.
"""

from __future__ import annotations

import math as _math

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from mundy_tpu.dynamics import brownian_velocity_keyed, euler_step_rigid
from mundy_tpu.forces.contact import effective_youngs, hertzian_pair_force
from mundy_tpu.geom import periodic
from mundy_tpu.geom.randomize import random_unit_quaternions
from mundy_tpu.math.quaternion import quat_rotate
from mundy_tpu.neighbor.rows import (
    RowGrid,
    _roll_image_shift,
    _segment_pair_chunk,
    build_rows,
    make_row_grid,
)
from mundy_tpu.parallel.slab_local import local_resort_ok, slab_local_resort


def make_slab_rods_step(
    mesh: Mesh,
    axis: str,
    n_total: int,
    box_size: float,
    length: float = 2.0,
    radius: float = 0.25,
    youngs: float = 1000.0,
    poisson: float = 0.3,
    viscosity: float = 1.0,
    diffusion: float = 0.1,
    rot_diffusion: float = 0.1,
    dt: float = 1e-4,
    skin: float = 0.4,
    capacity_slack: float = 1.9,
    dtype=jnp.float32,
    rebuild_mode: str = "auto",
):
    """Returns (init_fn, step_block_fn, grid).

    init_fn(key) -> state dict of z-slab-sharded arrays (pos/quat/valid/gid/
    ref_pos) + replicated (key, overflow). Key splits mirror RowRodsSim.init
    (kp positions, kq quaternions, ks stream key) so the same PRNGKey yields
    the same trajectory as the single-chip engine.
    step_block_fn(state, n_steps) -> state: n_steps with skin-triggered
    global rebuilds, fully on-chip (nested while inside shard_map).
    """
    d = mesh.shape[axis]
    metric = periodic(np.array([box_size] * 3), dtype=dtype)
    cutoff = length + 2 * radius + skin
    grid = make_row_grid([0, 0, 0], [box_size] * 3, cutoff, n_total,
                         capacity_slack=capacity_slack, dtype=dtype)
    if grid.ny < 5 or grid.nz < 5:
        raise ValueError("box too small for the row engine "
                         "(need >= 5 cells per periodic axis)")
    # make nz divisible by the mesh axis (cells shrink toward the cutoff
    # floor is NOT allowed — round down only if the cell stays >= cutoff)
    nz = (grid.nz // d) * d
    if nz < max(d, 5):
        raise ValueError("too few z-planes for the mesh axis")
    grid = RowGrid(origin=grid.origin,
                   cell_yz=grid.cell_yz.at[1].set(box_size / nz),
                   ny=grid.ny, nz=nz, row_capacity=grid.row_capacity)
    nzl = nz // d
    R = grid.row_capacity
    ny = grid.ny
    local_ok = local_resort_ok(d, nzl)
    if rebuild_mode == "auto":
        rebuild_mode = "local" if local_ok else "global"
    if rebuild_mode == "local" and not local_ok:
        raise ValueError(
            f"slab-local rebuild needs >=2 z-planes/slab and >=2 shards; "
            f"got nz={nz} over {d} shards")
    if rebuild_mode not in ("local", "global"):
        raise ValueError(f"unknown rebuild_mode {rebuild_mode!r}")
    half = float(0.5 * length)
    two_r = float(2.0 * radius)
    r_eff = float(0.5 * radius)
    e_eff = float(effective_youngs(youngs, youngs, poisson, poisson))
    a_eff = (0.75 * (0.5 * length + radius) * radius * radius) ** (1.0 / 3.0)
    inv_drag_t = 1.0 / (6.0 * _math.pi * viscosity * a_eff)
    inv_drag_r = 1.0 / (8.0 * _math.pi * viscosity * a_eff**3)
    zhat_np = np.zeros((3,), np.float64)
    zhat_np[2] = 1.0

    def out_fn(s, t, dx, dy, dz, d2, oex, _cex, oey, _cey, oez, _cez):
        # identical arithmetic to RowRodsSim._forces_torques.out_fn
        d2c = jnp.maximum(d2, 1e-24)
        rinv = jax.lax.rsqrt(d2c)
        dist = d2c * rinv
        mag = hertzian_pair_force(dist - two_r, r_eff, e_eff)
        w = -(mag * rinv)
        fx, fy, fz = w * dx, w * dy, w * dz
        u2 = 2.0 * s - 1.0
        rr = radius * rinv
        px = u2 * oex + rr * dx
        py = u2 * oey + rr * dy
        pz = u2 * oez + rr * dz
        return (fx, fy, fz,
                py * fz - pz * fy,
                pz * fx - px * fz,
                px * fy - py * fx)

    def _forces_torques_local(pos_ext, he_ext):
        """Full 9-offset segment stencil on the halo-extended blocks
        (ny, nzl+2, R, 3): y periodic via jnp.roll + image shift, z
        neighbors = static slices of the extended block (halo planes arrive
        with their global-wrap midpoint shift pre-applied), x min-image
        inside the pair kernel. Sentinel slots separate themselves; zeroed
        halo half-edges make sentinel pairs point-point with d2 > cutoff."""
        comp = [pos_ext[..., i] for i in range(3)] + \
               [he_ext[..., i] for i in range(3)]
        cands = [[] for _ in range(6)]
        for dy in (-1, 0, 1):
            for dz in (-1, 0, 1):
                for ci, p in enumerate(comp):
                    w = p[:, 1 + dz:1 + dz + nzl]
                    if dy != 0:
                        w = jnp.roll(w, -dy, axis=0)
                        if ci == 1:  # y coordinate: wrapped rows shift
                            w = w + _roll_image_shift(
                                ny, dy, box_size, dtype)[:, None, None]
                    cands[ci].append(w)
        cx, cy_, cz, cex, cey, cez = (jnp.concatenate(c, axis=-1)
                                      for c in cands)  # (ny, nzl, 9R)
        ox, oy, oz, oex, oey, oez = (p[:, 1:1 + nzl] for p in comp)
        lx_px = (float(box_size), 1.0 / float(box_size))

        # y-chunking: ~28 live (R, 9R) pair planes in the fused kernel
        itemsize = jnp.dtype(dtype).itemsize
        bytes_per_row = 28 * nzl * R * 9 * R * itemsize
        chunk_y = max(1, int(2.5e9 // max(bytes_per_row, 1)))
        own_planes = (ox, oy, oz, oex, oey, oez)
        cand_planes = (cx, cy_, cz, cex, cey, cez)
        if chunk_y >= ny:
            fx, fy, fz, tx, ty, tz = _segment_pair_chunk(
                *own_planes, (oex, oey, oez),
                *cand_planes, (cex, cey, cez),
                out_fn, lx_px)
        else:
            n_chunks = -(-ny // chunk_y)
            ny_pad = n_chunks * chunk_y

            def pad(arr):
                return jnp.pad(arr, [(0, ny_pad - ny)]
                               + [(0, 0)] * (arr.ndim - 1))

            ownp = [pad(p) for p in own_planes]
            candp = [pad(p) for p in cand_planes]

            def chunk(ci):
                y0 = ci * chunk_y
                sl = lambda a: jax.lax.dynamic_slice_in_dim(  # noqa: E731
                    a, y0, chunk_y, 0)
                oc = [sl(p) for p in ownp]
                cc = [sl(p) for p in candp]
                return _segment_pair_chunk(
                    *oc, tuple(oc[3:]), *cc, tuple(cc[3:]), out_fn, lx_px)

            outs = jax.lax.map(chunk, jnp.arange(n_chunks, dtype=jnp.int32))
            fx, fy, fz, tx, ty, tz = (
                ov.reshape((ny_pad, nzl, R))[:ny] for ov in outs)
        return (jnp.stack([fx, fy, fz], axis=-1),
                jnp.stack([tx, ty, tz], axis=-1))

    def local_block(pos, quat, valid, gid, ref_pos, overflow, key, step0,
                    n_steps):
        """shard_map body; all sharded arrays local (ny, nzl, R, ...)."""
        perm_up = [(i, (i + 1) % d) for i in range(d)]
        perm_dn = [(i, (i - 1) % d) for i in range(d)]
        target = n_steps
        zhat = jnp.asarray(zhat_np, dtype)

        def halo_ext(packed):
            """One (ny, 1, R, 6) pos+half-edge plane from each ring
            neighbor, with the global z-wrap shift applied to the wrapped
            MIDPOINT z channel (half-edges are translation invariant)."""
            me = jax.lax.axis_index(axis)
            lo = jax.lax.ppermute(packed[:, -1:], axis, perm_up)
            hi = jax.lax.ppermute(packed[:, :1], axis, perm_dn)
            ez = jnp.zeros((6,), dtype).at[2].set(1.0)
            lo = lo + jnp.where(me == 0, -box_size, 0.0).astype(dtype) * ez
            hi = hi + jnp.where(me == d - 1, box_size,
                                0.0).astype(dtype) * ez
            return jnp.concatenate([lo, packed, hi], axis=1)

        def inner_step(carry):
            pos, quat, valid, gid, ref_pos, key, step, done = carry
            axes = quat_rotate(quat, zhat)
            hedges = half * jnp.where(valid[..., None], axes, 0.0)
            packed = jnp.concatenate([pos, hedges], axis=-1)  # (ny,nzl,R,6)
            ext = halo_ext(packed)
            force, torque = _forces_torques_local(ext[..., :3], ext[..., 3:])
            vel = inv_drag_t * force
            omega = inv_drag_r * torque
            if diffusion > 0:
                vel = vel + brownian_velocity_keyed(
                    key, step, gid, jnp.asarray(diffusion, dtype), dt,
                    dtype=dtype)
            if rot_diffusion > 0:
                krot = jax.random.fold_in(key, 0x5EED)
                omega = omega + brownian_velocity_keyed(
                    krot, step, gid, jnp.asarray(rot_diffusion, dtype), dt,
                    dtype=dtype)
            # no wrap between rebuilds (neighbor/rows.py): rebuilds wrap
            new_pos, new_quat = euler_step_rigid(
                pos, quat, vel, omega, jnp.asarray(dt, dtype))
            new_pos = jnp.where(valid[..., None], new_pos, pos)
            return (new_pos, new_quat, valid, gid, ref_pos, key,
                    step + 1, done + 1)

        def moved(carry):
            pos, _q, valid, _g, ref_pos, _k, _s, _d = carry
            disp = metric.sep(ref_pos, pos)
            d2 = jnp.where(valid, jnp.sum(disp * disp, axis=-1), 0.0)
            return jax.lax.pmax(jnp.max(d2), axis) > (0.5 * skin) ** 2

        def rebuild(carry, ovf):
            pos, quat, valid, gid, _ref, key, step, done = carry
            pos = jnp.where(valid[..., None], metric.wrap(pos), pos)
            ident = jnp.zeros((4,), dtype).at[0].set(1.0)
            if rebuild_mode == "local":
                new_pos, new_val, new_gid, (new_quat,), ovf = \
                    slab_local_resort(pos, valid, gid, grid, nzl, axis, d,
                                      extras=(quat,), extra_fill=(ident,),
                                      ovf=ovf)
                return ((new_pos, new_quat, new_val, new_gid, new_pos, key,
                         step, done), ovf)
            idx = jnp.where(valid.reshape(-1), gid.reshape(-1), n_total)
            flat_p = jnp.zeros((n_total, 3), dtype).at[idx].set(
                pos.reshape(-1, 3), mode="drop")
            flat_q = jnp.zeros((n_total, 4), dtype).at[idx].set(
                quat.reshape(-1, 4), mode="drop")
            flat_p = jax.lax.psum(flat_p, axis)
            flat_q = jax.lax.psum(flat_q, axis)
            rows = build_rows(flat_p, jnp.arange(n_total, dtype=jnp.int32),
                              grid)
            safe = jnp.minimum(rows.gid, n_total - 1)
            qrows = flat_q[safe]
            qrows = jnp.where(rows.valid[..., None], qrows, ident)
            me = jax.lax.axis_index(axis)
            z0 = me * nzl
            sl = lambda a: jax.lax.dynamic_slice_in_dim(a, z0, nzl, axis=1)  # noqa: E731
            return ((sl(rows.pos), sl(qrows), sl(rows.valid), sl(rows.gid),
                     sl(rows.pos), key, step, done),
                    jnp.logical_or(ovf, rows.overflow))

        def outer_body(carry_ovf):
            carry, ovf = carry_ovf
            carry, ovf = rebuild(carry, ovf)
            carry = inner_step(carry)

            # skin trigger computed in the BODY, carried as a flag the
            # cond reads (a while cond can't fuse with the body and runs
            # its pmax as a separate program)
            def inner_step_flag(cf):
                c, _ = cf
                c = inner_step(c)
                return (c, moved(c))

            carry, _ = jax.lax.while_loop(
                lambda cf: jnp.logical_and(cf[0][7] < target,
                                           jnp.logical_not(cf[1])),
                inner_step_flag, (carry, moved(carry)))
            return (carry, ovf)

        # step0 persists across blocks: the gid-keyed noise stream is a
        # pure function of the GLOBAL step index (multi-block CLI runs
        # match a single fused run)
        carry = (pos, quat, valid, gid, ref_pos, key, step0,
                 jnp.asarray(0, jnp.int32))
        (carry, overflow) = jax.lax.while_loop(
            lambda co: co[0][7] < target, outer_body, (carry, overflow))
        pos, quat, valid, gid, ref_pos, _key, step, _done = carry
        # every block starts with a rebuild: wrap the returned positions
        pos = jnp.where(valid[..., None], metric.wrap(pos), pos)
        return pos, quat, valid, gid, ref_pos, overflow, step

    step_block = jax.jit(
        jax.shard_map(
            local_block, mesh=mesh,
            in_specs=(P(None, axis),) * 5 + (P(), P(), P(), P()),
            out_specs=(P(None, axis),) * 5 + (P(), P()),
            check_vma=False,
        )
    )

    def init_fn(key, pos=None, quat=None, step0: int = 0):
        """`pos`/`quat` (optional): start from given state (checkpoint
        resume / parity with RowRodsSim); key splits mirror RowRodsSim.init
        either way, so the same top key yields the same noise stream."""
        kp, kq, ks = jax.random.split(key, 3)
        if pos is None:
            pos = jax.random.uniform(kp, (n_total, 3), dtype=dtype,
                                     maxval=box_size)
        if quat is None:
            quat = random_unit_quaternions(kq, n_total, dtype=dtype)
        pos = jnp.asarray(pos, dtype)
        quat = jnp.asarray(quat, dtype)
        rows = build_rows(pos, jnp.arange(n_total, dtype=jnp.int32), grid)
        safe = jnp.minimum(rows.gid, n_total - 1)
        qrows = jnp.where(rows.valid[..., None], quat[safe],
                          jnp.zeros((4,), dtype).at[0].set(1.0))
        sh = NamedSharding(mesh, P(None, axis))
        return {
            "pos": jax.device_put(np.asarray(rows.pos), sh),
            "quat": jax.device_put(np.asarray(qrows), sh),
            "valid": jax.device_put(np.asarray(rows.valid), sh),
            "gid": jax.device_put(np.asarray(rows.gid), sh),
            "ref_pos": jax.device_put(np.asarray(rows.pos), sh),
            "overflow": jnp.asarray(bool(rows.overflow)),
            "key": ks,
            "step": jnp.asarray(step0, jnp.int32),
        }

    def step_block_fn(state, n_steps):
        pos, quat, valid, gid, ref, ovf, step = step_block(
            state["pos"], state["quat"], state["valid"], state["gid"],
            state["ref_pos"], state["overflow"], state["key"],
            state.get("step", jnp.asarray(0, jnp.int32)),
            jnp.asarray(n_steps, jnp.int32))
        return {**state, "pos": pos, "quat": quat, "valid": valid,
                "gid": gid, "ref_pos": ref, "overflow": ovf, "step": step}

    return init_fn, step_block_fn, grid
