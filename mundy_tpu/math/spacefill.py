"""Space-filling-curve keys and layouts (Morton, Hilbert).

Replaces the reference's `zmort.hpp` float-Morton comparators
(`mundy/math/src/mundy_math/zmort.hpp:167-230`) and recursive Hilbert
generator (`mundy/math/src/mundy_math/Hilbert.hpp:48,90`). Here we sort by
explicit integer keys (XLA has a fast on-device sort) instead of comparator
trees: Morton/Hilbert keys give cache/shard locality for cell lists and for
Hilbert-ordered resharding (the load-balance analog of `stk::balance` RCB).

Keys are uint32 with 10 bits per axis (grid up to 1024³ cells), which covers
any practical cell-list resolution and avoids needing x64.
"""

from __future__ import annotations

import numpy as np
import jax.numpy as jnp
from jax import Array


def _part1by2(x: Array) -> Array:
    """Spread the low 10 bits of x so there are 2 zero bits between each."""
    x = x.astype(jnp.uint32) & 0x3FF
    x = (x | (x << 16)) & jnp.uint32(0x030000FF)
    x = (x | (x << 8)) & jnp.uint32(0x0300F00F)
    x = (x | (x << 4)) & jnp.uint32(0x030C30C3)
    x = (x | (x << 2)) & jnp.uint32(0x09249249)
    return x


def morton_key_3d(ix: Array, iy: Array, iz: Array) -> Array:
    """Interleave three 10-bit cell indices into a 30-bit Morton key."""
    return _part1by2(ix) | (_part1by2(iy) << 1) | (_part1by2(iz) << 2)


def cell_linear_index(ix: Array, iy: Array, iz: Array, dims) -> Array:
    """Plain row-major cell id; cheapest key when locality doesn't matter."""
    nx, ny = dims[0], dims[1]
    return (ix + nx * (iy + ny * iz)).astype(jnp.int32)


def hilbert_key_3d(ix: Array, iy: Array, iz: Array, bits: int = 10) -> Array:
    """3-D Hilbert index of integer coords, vectorized Skilling transform.

    `bits` is static, so the bit loop unrolls at trace time — fully
    jit/vmap-compatible. Returns uint32 keys (bits <= 10).
    """
    if bits > 10:
        raise ValueError("hilbert_key_3d supports at most 10 bits per axis (uint32 keys)")
    x = jnp.stack(
        [jnp.asarray(ix, jnp.uint32), jnp.asarray(iy, jnp.uint32), jnp.asarray(iz, jnp.uint32)],
        axis=0,
    )  # (3, ...)

    # Inverse undo of Skilling's Hilbert transpose: convert coords -> transposed key.
    m = jnp.uint32(1) << (bits - 1)
    q = m
    for _ in range(bits - 1):
        p = q - jnp.uint32(1)
        for i in range(3):
            cond = (x[i] & q) > 0
            if i == 0:
                # exchange with self is a no-op; only the inversion applies
                x = x.at[0].set(jnp.where(cond, x[0] ^ p, x[0]))
            else:
                # if bit set: invert x[0] low bits; else exchange x[0]<->x[i]
                t = (x[0] ^ x[i]) & p
                x_new0 = jnp.where(cond, x[0] ^ p, x[0] ^ t)
                x_newi = jnp.where(cond, x[i], x[i] ^ t)
                x = x.at[0].set(x_new0)
                x = x.at[i].set(x_newi)
        q = q >> 1

    # Gray encode
    x = x.at[1].set(x[1] ^ x[0])
    x = x.at[2].set(x[2] ^ x[1])
    t = jnp.zeros_like(x[0])
    q = m
    for _ in range(bits - 1):
        t = jnp.where((x[2] & q) > 0, t ^ (q - jnp.uint32(1)), t)
        q = q >> 1
    x = x ^ t[None, :]

    # Interleave the transposed bits into a single key, axis 0 most significant.
    key = jnp.zeros_like(x[0])
    for b in range(bits - 1, -1, -1):
        for i in range(3):
            bit = (x[i] >> b) & jnp.uint32(1)
            key = (key << 1) | bit
    return key


def hilbert_positions_and_directors(
    num_points: int,
    orientation=(1.0, 0.0, 0.0),
    side_length: float = 1.0,
):
    """Hilbert-curve lattice positions + unit directors (host-side, numpy).

    Mirrors `create_hilbert_positions_and_directors`
    (`mundy/math/src/mundy_math/Hilbert.hpp:90`): used to initialize chain
    configurations (e.g. chromatin fibers) along a space-filling curve so
    consecutive beads are spatially local. Returns `(positions, directors)`
    with `len(positions) = s³ >= num_points` lattice points and
    `len(directors) = s³ - 1`.

    Host-side setup code (runs once at init), hence plain numpy + recursion.
    """
    if num_points <= 0:
        raise ValueError("num_points must be > 0")
    s = 2
    while s * s * s < num_points:
        s *= 2

    orientation = np.asarray(orientation, dtype=np.float64)
    zhat = np.array([0.0, 0.0, 1.0])
    d1 = orientation / np.linalg.norm(orientation)
    d2 = np.cross(zhat, d1)
    if np.linalg.norm(d2) < 1e-12:  # orientation parallel to z: pick x
        d2 = np.cross(np.array([1.0, 0.0, 0.0]), d1)
    d2 /= np.linalg.norm(d2)
    d3 = np.cross(d1, d2)
    d3 /= np.linalg.norm(d3)

    positions = np.zeros((s * s * s, 3))
    idx = [0]

    def rec(side, pos, dr1, dr2, dr3):
        if side == 1:
            positions[idx[0]] = pos
            idx[0] += 1
            return
        h = side // 2
        pos = pos.copy()
        for dr in (dr1, dr2, dr3):
            stencil = (dr < 0.0).astype(np.float64)
            pos -= h * stencil * dr
        rec(h, pos, dr2, dr3, dr1)
        rec(h, pos + h * dr1, dr3, dr1, dr2)
        rec(h, pos + h * (dr1 + dr2), dr3, dr1, dr2)
        rec(h, pos + h * dr2, -dr1, -dr2, dr3)
        rec(h, pos + h * (dr2 + dr3), -dr1, -dr2, dr3)
        rec(h, pos + h * (dr1 + dr2 + dr3), -dr3, dr1, -dr2)
        rec(h, pos + h * (dr1 + dr3), -dr3, dr1, -dr2)
        rec(h, pos + h * dr3, dr2, -dr3, -dr1)

    rec(s, np.zeros(3), side_length * d1, side_length * d2, side_length * d3)

    directors = positions[1:] - positions[:-1]
    directors /= np.linalg.norm(directors, axis=1, keepdims=True)
    return positions, directors
