"""Field BLAS: masked per-entity array ops.

Replaces `NgpFieldBLAS.hpp:40-523` (+ `impl/NgpFieldBLASImpl.hpp`): fill,
copy, swap, scale, axpy/axpby, product, dot/nrm2/asum/amax/amin with
selector-mask support. Here these are one-liners that XLA fuses into
adjacent kernels — they exist for API parity and for masked-reduction
correctness (padded/unselected entities must not pollute reductions).

Reductions accept optional `axis_names` to span a device mesh (the
`stk::all_reduce_*` analog, `NgpAccessorExpr.hpp:2567-2594`).
"""

from __future__ import annotations

from typing import Optional

import jax
import jax.numpy as jnp
from jax import Array


def _bmask(mask: Optional[Array], x: Array) -> Optional[Array]:
    if mask is None:
        return None
    return mask.reshape(mask.shape + (1,) * (x.ndim - mask.ndim))


def field_fill(x: Array, value, mask: Optional[Array] = None) -> Array:
    if mask is None:
        return jnp.full_like(x, value)
    return jnp.where(_bmask(mask, x), value, x)


def field_copy(dst: Array, src: Array, mask: Optional[Array] = None) -> Array:
    if mask is None:
        return src
    return jnp.where(_bmask(mask, dst), src, dst)


def field_scale(x: Array, alpha, mask: Optional[Array] = None) -> Array:
    out = alpha * x
    return out if mask is None else jnp.where(_bmask(mask, x), out, x)


def field_axpy(alpha, x: Array, y: Array, mask: Optional[Array] = None) -> Array:
    out = alpha * x + y
    return out if mask is None else jnp.where(_bmask(mask, y), out, y)


def field_axpby(alpha, x: Array, beta, y: Array, mask: Optional[Array] = None) -> Array:
    out = alpha * x + beta * y
    return out if mask is None else jnp.where(_bmask(mask, y), out, y)


def field_product(x: Array, y: Array, mask: Optional[Array] = None) -> Array:
    out = x * y
    return out if mask is None else jnp.where(_bmask(mask, x), out, x)


def _reduce(val, axis_names):
    return val if not axis_names else jax.lax.psum(val, axis_names)


def field_dot(x: Array, y: Array, mask: Optional[Array] = None, axis_names=None) -> Array:
    prod = x * y
    if mask is not None:
        prod = jnp.where(_bmask(mask, prod), prod, 0.0)
    return _reduce(jnp.sum(prod), axis_names)


def field_nrm2(x: Array, mask: Optional[Array] = None, axis_names=None) -> Array:
    return jnp.sqrt(field_dot(x, x, mask, axis_names))


def field_asum(x: Array, mask: Optional[Array] = None, axis_names=None) -> Array:
    v = jnp.abs(x)
    if mask is not None:
        v = jnp.where(_bmask(mask, v), v, 0.0)
    return _reduce(jnp.sum(v), axis_names)


def field_amax(x: Array, mask: Optional[Array] = None, axis_names=None) -> Array:
    v = jnp.abs(x)
    if mask is not None:
        v = jnp.where(_bmask(mask, v), v, -jnp.inf)
    out = jnp.max(v)
    return out if not axis_names else jax.lax.pmax(out, axis_names)


def field_amin(x: Array, mask: Optional[Array] = None, axis_names=None) -> Array:
    v = jnp.abs(x)
    if mask is not None:
        v = jnp.where(_bmask(mask, v), v, jnp.inf)
    out = jnp.min(v)
    return out if not axis_names else jax.lax.pmin(out, axis_names)


def field_randomize(key: Array, x: Array, low=0.0, high=1.0,
                    mask: Optional[Array] = None) -> Array:
    """Uniform refill (ref field_randomize, NgpFieldBLAS.hpp:101-175)."""
    r = jax.random.uniform(key, x.shape, dtype=x.dtype, minval=low, maxval=high)
    if mask is None:
        return r
    return jnp.where(_bmask(mask, x), r, x)
