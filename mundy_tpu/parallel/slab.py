"""Slab domain decomposition with ppermute halo exchange + migration.

The JAX form of the reference's MPI spatial decomposition
(SURVEY.md §2.7): entities owned by ranks -> capacity-padded per-shard
particle slots; STK aura/ghosting (`GenNeighborLinkers.hpp:700-741`) ->
fixed-capacity boundary buffers exchanged with mesh neighbors via
`lax.ppermute` over ICI; parallel-consistent migration (`change_entity_owner`)
-> capacity-bounded leaver buffers merged into free slots.

v2 design (1-D slabs along x over mesh axis `axis`):
- each shard owns up to `capacity` particles (active mask);
- halo: particles within `halo_width` of a slab face are copied to the
  neighboring shard (periodic ring), giving each shard every particle that
  can interact with its locals;
- migration: after the position update, particles whose x left the slab are
  handed to the neighbor (one-cell-per-step limit, standard for
  displacement << slab width).

All buffers are static-shape with overflow flags — the same
capacity-bounded contract as the neighbor lists.
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np
from jax import Array


class ShardState(NamedTuple):
    pos: Array  # (C, 3) local particle slots
    active: Array  # (C,) bool
    gid: Array  # (C,) int32 global ids (for RNG / diagnostics)
    overflow: Array  # () bool sticky


def _compact(values: Array, keep: Array, capacity: int, fill=0.0):
    """Pack rows where keep=True into the first slots of a (capacity, ...)
    buffer (order-preserving). Returns (buffer, mask, count)."""
    slot = jnp.cumsum(keep) - 1
    dest = jnp.where(keep & (slot < capacity), slot, capacity)
    out_shape = (capacity,) + values.shape[1:]
    buf = jnp.full(out_shape, fill, values.dtype).at[dest].set(values, mode="drop")
    mask = jnp.zeros((capacity,), bool).at[dest].set(keep, mode="drop")
    return buf, mask, jnp.sum(keep)


def slab_bounds(axis: str, box_x: float, dtype):
    """(lo, hi) of this shard's slab along x."""
    d = jax.lax.axis_size(axis)
    me = jax.lax.axis_index(axis)
    width = box_x / d
    lo = me.astype(dtype) * width
    return lo, lo + width


def halo_exchange(pos: Array, active: Array, axis: str, box_x: float,
                  halo_width: float, halo_capacity: int):
    """Gather neighbor-shard particles near our slab faces.

    Returns (halo_pos (2H, 3), halo_mask (2H,), overflow). Periodic ring:
    the left face of shard 0 borders the right face of shard D-1; positions
    arrive untranslated (min-image metrics handle the wrap).
    """
    dtype = pos.dtype
    lo, hi = slab_bounds(axis, box_x, dtype)
    d = jax.lax.axis_size(axis)

    # particles near our own faces, to send to each neighbor
    near_lo = active & (pos[:, 0] < lo + halo_width)
    near_hi = active & (pos[:, 0] >= hi - halo_width)
    send_left, mask_left, n_left = _compact(pos, near_lo, halo_capacity)
    send_right, mask_right, n_right = _compact(pos, near_hi, halo_capacity)
    overflow = (n_left > halo_capacity) | (n_right > halo_capacity)

    left_perm = [(i, (i - 1) % d) for i in range(d)]
    right_perm = [(i, (i + 1) % d) for i in range(d)]
    # what we send left arrives at our left neighbor; we receive from right
    from_right = jax.lax.ppermute(send_left, axis, left_perm)
    from_right_mask = jax.lax.ppermute(mask_left, axis, left_perm)
    from_left = jax.lax.ppermute(send_right, axis, right_perm)
    from_left_mask = jax.lax.ppermute(mask_right, axis, right_perm)

    halo_pos = jnp.concatenate([from_left, from_right], axis=0)
    halo_mask = jnp.concatenate([from_left_mask, from_right_mask], axis=0)
    return halo_pos, halo_mask, overflow


def migrate(state: ShardState, axis: str, box_x: float) -> ShardState:
    """Hand particles that left the slab to the adjacent shard.

    One-neighbor-per-step migration (valid while per-step displacement <
    slab width, the usual MD contract). Wraps x into the periodic box first.
    """
    dtype = state.pos.dtype
    capacity = state.pos.shape[0]
    d = jax.lax.axis_size(axis)
    lo, hi = slab_bounds(axis, box_x, dtype)

    pos = state.pos.at[:, 0].set(jnp.mod(state.pos[:, 0], box_x))
    # classify by the min-image offset from the slab center — symmetric and
    # wrap-safe (a one-sided comparator can tag a wrapped particle as BOTH
    # going-left and going-right, duplicating it)
    width = hi - lo
    center = 0.5 * (lo + hi)
    delta = pos[:, 0] - center
    delta = delta - box_x * jnp.round(delta / box_x)
    going_left = state.active & (delta < -0.5 * width)
    going_right = state.active & (delta >= 0.5 * width) & ~going_left
    staying = state.active & ~going_left & ~going_right

    mig_cap = capacity // 4  # migration buffer size
    packed = jnp.concatenate([pos, state.gid[:, None].astype(dtype)], axis=1)
    send_l, mask_l, n_l = _compact(packed, going_left, mig_cap)
    send_r, mask_r, n_r = _compact(packed, going_right, mig_cap)
    overflow = state.overflow | (n_l > mig_cap) | (n_r > mig_cap)

    left_perm = [(i, (i - 1) % d) for i in range(d)]
    right_perm = [(i, (i + 1) % d) for i in range(d)]
    recv_from_right = jax.lax.ppermute(send_l, axis, left_perm)
    recv_from_right_m = jax.lax.ppermute(mask_l, axis, left_perm)
    recv_from_left = jax.lax.ppermute(send_r, axis, right_perm)
    recv_from_left_m = jax.lax.ppermute(mask_r, axis, right_perm)

    incoming = jnp.concatenate([recv_from_left, recv_from_right], axis=0)
    incoming_m = jnp.concatenate([recv_from_left_m, recv_from_right_m], axis=0)

    # place incoming into free slots: rank free slots and incoming rows,
    # scatter by matching rank
    free = ~staying
    free_rank = jnp.cumsum(free) - 1  # rank among free slots
    inc_rank = jnp.cumsum(incoming_m) - 1
    n_free_needed = jnp.sum(incoming_m)
    overflow = overflow | (n_free_needed > jnp.sum(free))

    # destination slot of incoming row k = index of the k-th free slot
    slot_of_rank = jnp.full((capacity,), capacity, jnp.int32)
    slot_of_rank = slot_of_rank.at[jnp.where(free, free_rank, capacity)].set(
        jnp.arange(capacity, dtype=jnp.int32), mode="drop")
    dest = jnp.where(incoming_m, slot_of_rank[jnp.minimum(inc_rank, capacity - 1)],
                     capacity)

    new_pos = jnp.where(staying[:, None], pos, 0.0)
    new_gid = jnp.where(staying, state.gid, 0)
    new_active = staying
    new_pos = new_pos.at[dest].set(incoming[:, :3], mode="drop")
    new_gid = new_gid.at[dest].set(incoming[:, 3].astype(jnp.int32), mode="drop")
    new_active = new_active.at[dest].set(incoming_m, mode="drop")
    return ShardState(pos=new_pos, active=new_active, gid=new_gid, overflow=overflow)
