"""Fixed-memory L-BFGS, zero-allocation and vmappable.

Replaces the reference's dlib-style `find_min_using_approximate_derivatives`
(`mundy/math/src/mundy_math/minimize.hpp:43-49`,
`impl/minimize_impl.hpp:132-409`): a no-alloc L-BFGS with line search that the
reference calls *inside device kernels* (e.g. the ellipsoid–ellipsoid distance
minimization, `mundy/geom/src/mundy_geom/distance/EllipsoidEllipsoid.hpp`).

Design: static-shape history buffers + `lax.while_loop`, so one instance
compiles once and `vmap` runs millions of independent minimizations in
lockstep (the per-contact-pair case). Gradients come from `jax.grad` by
default — strictly better than the reference's central differences — with
finite differences available for non-differentiable objectives.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import jax
import jax.numpy as jnp
from jax import Array


class MinimizeResult(NamedTuple):
    x: Array
    f: Array
    num_iters: Array
    converged: Array


def _dot(a, b):
    """f32 inner product at full precision (no TF32)."""
    return jnp.dot(a, b, precision=jax.lax.Precision.HIGHEST)


def _central_differences(f: Callable, eps: float) -> Callable:
    def grad_fn(x):
        n = x.shape[-1]
        eye = jnp.eye(n, dtype=x.dtype) * eps

        def one(i):
            return (f(x + eye[i]) - f(x - eye[i])) / (2 * eps)

        return jax.vmap(one)(jnp.arange(n))

    return grad_fn


def minimize_lbfgs(
    f: Callable[[Array], Array],
    x0: Array,
    max_iters: int = 100,
    memory: int = 8,
    f_delta_tol: float = 1e-7,
    grad_tol: float = 1e-10,
    use_autodiff: bool = True,
    fd_eps: float = 1e-7,
    max_linesearch: int = 20,
) -> MinimizeResult:
    """Minimize scalar `f` over a small parameter vector `x0` (shape (n,)).

    Stopping mirrors the reference's `objective_delta_stop_strategy`
    (`minimize_impl.hpp:194`): stop when |f_k - f_{k-1}| < f_delta_tol, or on
    small gradient, or at max_iters. Line search is backtracking Armijo with a
    static bound (`max_linesearch`), making the whole solve a fixed-shape
    program suitable for vmap over huge batches.
    """
    n = x0.shape[-1]
    dtype = x0.dtype
    m = memory

    grad_fn = jax.grad(f) if use_autodiff else _central_differences(f, fd_eps)

    def value_and_grad(x):
        return f(x), grad_fn(x)

    f0, g0 = value_and_grad(x0)

    # History ring buffers (static shapes).
    S = jnp.zeros((m, n), dtype)
    Y = jnp.zeros((m, n), dtype)
    rho = jnp.zeros((m,), dtype)

    def two_loop(g, S, Y, rho, k):
        """L-BFGS two-loop recursion over the ring buffer; entries with
        rho == 0 (unfilled or skipped updates) are no-ops."""
        q = g
        alphas = jnp.zeros((m,), dtype)

        def bwd(i, carry):
            q, alphas = carry
            idx = (k - 1 - i) % m
            valid = rho[idx] != 0.0
            a = jnp.where(valid, rho[idx] * _dot(S[idx], q), 0.0)
            q = q - a * Y[idx]
            return q, alphas.at[idx].set(a)

        q, alphas = jax.lax.fori_loop(0, m, bwd, (q, alphas))

        # Initial Hessian scaling gamma = s·y / y·y from the newest pair.
        newest = (k - 1) % m
        yy = _dot(Y[newest], Y[newest])
        sy = _dot(S[newest], Y[newest])
        gamma = jnp.where(yy > 0.0, sy / jnp.maximum(yy, 1e-30), 1.0)
        r = gamma * q

        def fwd(i, r):
            idx = (k - m + i) % m
            valid = rho[idx] != 0.0
            b = jnp.where(valid, rho[idx] * _dot(Y[idx], r), 0.0)
            return r + (alphas[idx] - b) * S[idx]

        return jax.lax.fori_loop(0, m, fwd, r)

    def linesearch(x, fx, g, d):
        """Backtracking Armijo: t <- t/2 until sufficient decrease."""
        gd = _dot(g, d)
        c1 = jnp.asarray(1e-4, dtype)

        def body(i, carry):
            t, best_t, done = carry
            f_new = f(x + t * d)
            ok = f_new <= fx + c1 * t * gd
            best_t = jnp.where(jnp.logical_and(ok, jnp.logical_not(done)), t, best_t)
            done = jnp.logical_or(done, ok)
            return t * 0.5, best_t, done

        _t, best_t, done = jax.lax.fori_loop(
            0, max_linesearch, body, (jnp.asarray(1.0, dtype), jnp.asarray(0.0, dtype), False)
        )
        return jnp.where(done, best_t, jnp.asarray(0.0, dtype))

    def cond(state):
        _x, _fx, _g, _S, _Y, _rho, k, done = state
        return jnp.logical_and(jnp.logical_not(done), k < max_iters)

    def body(state):
        x, fx, g, S, Y, rho, k, _done = state
        d = -two_loop(g, S, Y, rho, k)
        # Safeguard: fall back to steepest descent if d isn't a descent dir.
        descent = _dot(g, d) < 0.0
        d = jnp.where(descent, d, -g)

        t = linesearch(x, fx, g, d)
        x_new = x + t * d
        f_new, g_new = value_and_grad(x_new)

        s = x_new - x
        y = g_new - g
        sy = _dot(s, y)
        slot = k % m
        ok = sy > 1e-30  # curvature condition; skip update otherwise
        S = S.at[slot].set(jnp.where(ok, s, S[slot]))
        Y = Y.at[slot].set(jnp.where(ok, y, Y[slot]))
        rho = rho.at[slot].set(jnp.where(ok, 1.0 / jnp.where(ok, sy, 1.0), rho[slot]))

        stalled = t == 0.0
        f_conv = jnp.abs(f_new - fx) < f_delta_tol
        g_conv = jnp.linalg.norm(g_new) < grad_tol
        done = jnp.logical_or(jnp.logical_or(f_conv, g_conv), stalled)
        return (x_new, f_new, g_new, S, Y, rho, k + 1, done)

    init = (x0, f0, g0, S, Y, rho, jnp.asarray(0, jnp.int32), jnp.asarray(False))
    x, fx, g, _S, _Y, _rho, k, done = jax.lax.while_loop(cond, body, init)
    return MinimizeResult(x=x, f=fx, num_iters=k, converged=done)
