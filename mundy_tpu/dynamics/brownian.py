"""Brownian velocity from counter-based RNG.

ref: ComputeBrownianVelocity SpheresKernel
(`compute_brownian_velocity/kernels/SpheresKernel.cpp:119-123`):
    v += sqrt(2 D / dt) * randn()   per component, Philox(node_gid, counter).
JAX's threefry is the same counter-based construction: fold the step counter
into the key, draw per-particle normals — reproducible and independent of
iteration order or sharding layout.
"""

from __future__ import annotations

import math

import jax
import jax.numpy as jnp
from jax import Array

_SQRT2 = math.sqrt(2.0)


def brownian_velocity(key: Array, step: Array, n: int, diffusion: Array, dt,
                      dtype=jnp.float32) -> Array:
    """(N, 3) Brownian velocities: sqrt(2 D / dt) * N(0,1).

    `diffusion` is scalar or (N,); `step` is folded into the key so each
    timestep draws fresh, reproducible noise (the Philox counter).
    """
    k = jax.random.fold_in(key, step)
    z = jax.random.normal(k, (n, 3), dtype=dtype)
    scale = jnp.sqrt(2.0 * jnp.broadcast_to(diffusion, (n,)) / dt).astype(dtype)
    return scale[:, None] * z


def brownian_velocity_keyed(key: Array, step: Array, gid: Array,
                            diffusion: Array, dt, dtype=jnp.float32) -> Array:
    """(..., 3) Brownian velocities keyed by per-entity global id.

    Same counter-based construction as brownian_velocity, but the stream is
    indexed by (key, step, gid) directly — counters {3*gid, 3*gid+1,
    3*gid+2} into one threefry2x32 call — instead of positions in a
    length-N array. Engines that hold particles in permuted layouts (row
    grid, z-slab shards) get identical noise without a gid gather, and a
    shard only
    ever generates noise for the entities it owns.

    This is 2 hash blocks per entity; a vmap(fold_in) + vmap(normal)
    construction pays ~3. threefry_2x32 pairs its counter words POSITIONALLY (ravel, split
    in half), so the two words of entity e's blocks are laid out as planes:
    count (4, M) with rows (gid, gid, 0, 1) -> block A = (gid, 0), block
    B = (gid, 1) at every position — the stream depends only on (key, step,
    gid), never on where the entity sits in a permuted layout. Normals come
    from the 23-bit inverse-CDF map with a half-ulp center offset so u is
    strictly inside (0, 1) (erf_inv(+-1) = +-inf would otherwise fire every
    ~2^23 draws)."""
    import jax.extend as jex

    kd = jax.random.key_data(jax.random.fold_in(key, step))
    kd = kd.reshape(-1).astype(jnp.uint32)
    g = gid.reshape(-1).astype(jnp.uint32)
    m = g.shape[0]
    counts = jnp.concatenate([g, g, jnp.zeros((m,), jnp.uint32),
                              jnp.ones((m,), jnp.uint32)])
    bits = jex.random.threefry_2x32((kd[0], kd[1]), counts)
    # block A words at rows 0, 2; block B words at rows 1, 3 — use 3 of 4
    w = jnp.stack([bits[0:m], bits[2 * m:3 * m], bits[m:2 * m]], axis=-1)
    u = (w >> 9).astype(jnp.float32) * jnp.float32(2.0 ** -23) + jnp.float32(2.0 ** -24)
    z = jnp.float32(_SQRT2) * jax.lax.erf_inv(2.0 * u - 1.0)
    z = z.reshape(gid.shape + (3,)).astype(dtype)
    scale = jnp.sqrt(2.0 * jnp.broadcast_to(diffusion, gid.shape) / dt).astype(dtype)
    return scale[..., None] * z


def brownian_angular_velocity(key: Array, step: Array, n: int, rot_diffusion: Array,
                              dt, dtype=jnp.float32) -> Array:
    """(N, 3) rotational Brownian angular velocities (distinct stream)."""
    k = jax.random.fold_in(jax.random.fold_in(key, step), 0x5EED)
    z = jax.random.normal(k, (n, 3), dtype=dtype)
    scale = jnp.sqrt(2.0 * jnp.broadcast_to(rot_diffusion, (n,)) / dt).astype(dtype)
    return scale[:, None] * z
