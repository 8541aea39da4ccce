"""Convex QP / LCP solvers: projected gradient descent with Barzilai–Borwein
steps (BBPGD), fully jit-compiled and matrix-free.

Replaces the reference solver family in `mundy/math/src/mundy_math/convex.hpp`
(`CQPPProblem:364`, `LCPProblem:402`, `BBStepStrategy:498`, `solve_cqpp:790`,
`solve_lcp:840`, separable spaces `:48-115`, residual policies `:434-495`) and
the hand-rolled device-global BBPGD loop of the LCP collision driver
(`scrap/lcp_spheres/StkNgpLCP.cpp:705-875`).

Design: one `lax.while_loop` whose body evaluates the (user-supplied,
matrix-free) linear operator — for collision resolution that operator is the
Delassus product J·M·Jᵀ expressed as gathers + segment-sums + mobility
matmuls, so the whole solve stays on-chip with zero host round-trips. The
reference's two backends (per-pair in-kernel over `Vector<N>` vs device-wide
over `Kokkos::View`) collapse to one implementation: vmap it for the per-pair
case, call it directly for the global case.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import jax
import jax.numpy as jnp
from jax import Array

from mundy_tpu.core.containers import pytree_dataclass, static_field


@pytree_dataclass
class Space:
    """Separable box space [lo, hi]^n; ±inf encodes one-sided / unconstrained.

    Mirrors `convex::space::{Unconstrained,LowerBound,UpperBound,Bounded}`
    (`convex.hpp:48-115`) — all four are the same clip with infinite bounds.
    """

    lo: Array
    hi: Array

    def project(self, x: Array) -> Array:
        return jnp.clip(x, self.lo, self.hi)


def unconstrained(dtype=jnp.float32) -> Space:
    return Space(jnp.asarray(-jnp.inf, dtype), jnp.asarray(jnp.inf, dtype))


def lower_bound(lo, dtype=None) -> Space:
    lo = jnp.asarray(lo, dtype)
    return Space(lo, jnp.asarray(jnp.inf, lo.dtype))


def upper_bound(hi, dtype=None) -> Space:
    hi = jnp.asarray(hi, dtype)
    return Space(jnp.asarray(-jnp.inf, hi.dtype), hi)


def bounded(lo, hi, dtype=None) -> Space:
    return Space(jnp.asarray(lo, dtype), jnp.asarray(hi, dtype))


@pytree_dataclass
class PGDConfig:
    """Solver controls (mirrors `PGDConfig`, `convex.hpp:520`)."""

    max_iters: int = static_field(default=1000)
    tol: float = static_field(default=1e-8)
    # "bb1" | "bb2" | "alternating" — the reference driver alternates
    # (`StkNgpLCP.cpp:849-860`), convex.hpp's BBStepStrategy is bb1.
    bb_rule: str = static_field(default="alternating")
    # "projected_gradient" (Dai & Fletcher 2005 eq 2.2, LCP-specialized) or
    # "projected_diff" (Mazhar 2015 eq 25) — `convex.hpp:434-495`.
    residual: str = static_field(default="projected_gradient")
    # allreduce axis names for sharded solves (psum/pmax over the mesh);
    # None = single-device reduction semantics.
    axis_names: Optional[tuple] = static_field(default=None)
    # Progress-based exit: stop when `patience` consecutive iterations fail
    # to improve the best residual by at least `min_improve` (relative).
    # BBPGD's residual floors at the dtype's rounding noise — at 1M active
    # constraints in f32 that floor (~3e-5) can sit ABOVE a 1e-5 tol, and
    # without this exit the solve spins to max_iters at a frozen residual.
    # The solve returns the best-residual iterate seen.
    # 60 iterations with zero net improvement is confidently floored (BB
    # non-monotone cycles run ~10-30 iterations; a genuinely converging
    # solve sets a >1%-lower low every few of them), and it bounds the
    # per-solve waste when the floor sits above tol to ~60 iterations.
    patience: int = static_field(default=60)
    min_improve: float = static_field(default=1e-2)


class SolveResult(NamedTuple):
    """Mirrors `SolveResult` (`convex.hpp:528-541`). `alpha` is the final
    BB step size — a converged curvature estimate that callers stepping a
    slowly-varying problem (per-timestep collision solves) can feed back as
    the next solve's `alpha0` to skip the 1/res0 cold-start step."""

    x: Array
    num_iters: Array
    residual: Array
    converged: Array
    alpha: Array = jnp.nan


def _psum(v, cfg: PGDConfig):
    if cfg.axis_names:
        return jax.lax.psum(v, cfg.axis_names)
    return v


def _pmax(v, cfg: PGDConfig):
    if cfg.axis_names:
        return jax.lax.pmax(v, cfg.axis_names)
    return v


def _residual(x: Array, g: Array, space: Space, cfg: PGDConfig, mask: Optional[Array]):
    dtype = x.dtype
    if cfg.residual == "projected_gradient":
        # Dai & Fletcher eq 2.2 generalized to a box: at the active lower
        # bound only a negative gradient violates stationarity (could descend
        # by moving up), at the active upper bound only a positive one; in
        # the interior |g|. Matches the collision driver's
        # |min(sep_new, 0)| at gamma == 0 (`StkNgpLCP.cpp:523-533`).
        tol = jnp.asarray(10 * jnp.finfo(dtype).eps, dtype)
        at_lo = x < space.lo + tol
        at_hi = x > space.hi - tol
        r = jnp.abs(g)
        r = jnp.where(at_lo, jnp.maximum(-g, 0.0), r)
        r = jnp.where(at_hi, jnp.maximum(g, 0.0), r)
    elif cfg.residual == "projected_diff":
        h = jnp.asarray(1e-6, dtype)
        r = jnp.abs(x - space.project(x - h * g)) / h
    else:
        raise ValueError(f"unknown residual policy {cfg.residual!r}")
    if mask is not None:
        r = jnp.where(mask, r, 0.0)
    return _pmax(jnp.max(r, initial=jnp.asarray(0.0, dtype)), cfg)


def solve_cqpp(
    apply_A: Callable[[Array], Array],
    q: Array,
    space: Space,
    x0: Optional[Array] = None,
    config: PGDConfig = PGDConfig(),
    mask: Optional[Array] = None,
    alpha0: Optional[Array] = None,
) -> SolveResult:
    """Minimize 1/2 xᵀAx + qᵀx over the separable box `space`, matrix-free.

    `apply_A` computes A·x (A symmetric positive semidefinite). `mask` (bool,
    same shape as q) restricts the solve to active entries — padded slots of a
    capacity-bounded constraint list stay pinned at space-projected zero so
    padding never affects dot products or residuals.

    Mirrors `solve_cqpp` (`convex.hpp:790-838`): grad = A·x + q, BB step,
    separable projection, L∞ residual, first step size 1/res₀ (Dai & Fletcher
    2005 §5, as in the collision driver `StkNgpLCP.cpp:776`).
    """
    dtype = q.dtype
    if x0 is None:
        x0 = jnp.zeros_like(q)
    x0 = space.project(x0)
    if mask is not None:
        x0 = jnp.where(mask, x0, space.project(jnp.zeros_like(x0)))

    def masked(v):
        return jnp.where(mask, v, 0.0) if mask is not None else v

    g0 = masked(apply_A(x0) + q)
    res0 = _residual(x0, g0, space, config, mask)
    # first step size: 1/res0 (Dai & Fletcher 2005 §5, StkNgpLCP.cpp:776)
    # unless the caller passes a previous solve's converged BB step — after
    # a warm start res0 is small, so 1/res0 over-steps by orders of
    # magnitude and burns iterations recovering
    alpha_init = (jnp.asarray(1.0, dtype)
                  / jnp.maximum(res0, jnp.asarray(config.tol, dtype)))
    if alpha0 is not None:
        a0 = jnp.asarray(alpha0, dtype)
        good = jnp.logical_and(jnp.isfinite(a0), a0 > 0.0)
        alpha_init = jnp.where(good, jnp.minimum(a0, alpha_init), alpha_init)
    alpha0 = alpha_init

    def cond(state):
        (_x, _g, _alpha, _alpha_good, it, res, stalls,
         _xb, _rb, since_best) = state
        keep_going = jnp.logical_and(res >= config.tol, it < config.max_iters)
        keep_going = jnp.logical_and(keep_going, stalls < 2)
        return jnp.logical_and(keep_going, since_best < config.patience)

    def body(state):
        (x, g, alpha, alpha_good, it, _res, stalls,
         x_best, res_best, since_best) = state
        x_new = space.project(x - alpha * g)
        if mask is not None:
            x_new = jnp.where(mask, x_new, x)
        g_new = masked(apply_A(x_new) + q)

        dx = x_new - x
        dg = g_new - g
        dx_dx = _psum(jnp.sum(dx * dx), config)
        dx_dg = _psum(jnp.sum(dx * dg), config)
        dg_dg = _psum(jnp.sum(dg * dg), config)

        if config.bb_rule == "bb1":
            a, b = dx_dx, dx_dg
        elif config.bb_rule == "bb2":
            a, b = dx_dg, dg_dg
        elif config.bb_rule == "alternating":  # as in StkNgpLCP.cpp:849-860
            even = (it % 2) == 1  # matches reference parity after increment
            a = jnp.where(even, dx_dx, dx_dg)
            b = jnp.where(even, dx_dg, dg_dg)
        else:
            raise ValueError(f"unknown bb_rule {config.bb_rule!r}")
        # b == 0 exactly -> inf -> the `bad` guard keeps the previous step.
        # Do NOT floor |b| at some tiny absolute value (the old
        # `b + 1e-12*(|b|<1e-12)` regularization): near convergence a and b
        # are both microscopic but their RATIO is the legitimate curvature,
        # and an absolute floor turned it into clip-floor garbage (observed:
        # alpha pinned at 1e-12 for 5000 iterations while a/b was 0.05).
        b_safe = jnp.where(b == 0, jnp.asarray(1.0, dtype), b)
        alpha_new = jnp.where(b == 0, jnp.asarray(jnp.inf, dtype), a / b_safe)
        # Guard non-positive / non-finite BB ratios (rounding noise in the
        # tail): keep the previous step size rather than poisoning the
        # iteration (reference guards only b, StkNgpLCP.cpp:862-865).
        bad = jnp.logical_not(jnp.logical_and(jnp.isfinite(alpha_new), alpha_new > 0.0))
        alpha_new = jnp.where(bad, alpha, alpha_new)
        # Dai-Fletcher safeguard interval: bounds the step if the operator is
        # indefinite (e.g. neighbor-truncated RPY mobility), preventing the
        # runaway gamma growth an unbounded BB step produces.
        alpha_new = jnp.clip(alpha_new, jnp.asarray(1e-12, dtype), jnp.asarray(1e12, dtype))

        res = _residual(x_new, g_new, space, config, mask)

        # Stall = the iterate stopped moving entirely (alpha*g below the ulp
        # of x, or every driven entry pinned at its bound). A stall with
        # res >= tol can be a FALSE stall from a degraded step size (the BB
        # ratio is noise once dx is in the rounding regime — observed as a
        # warm-started solve exiting at res 4e-2 with alpha ~1e-12 when a
        # converged solve's final alpha was fed back), so the first stall
        # RESETS alpha to the cold-start 1/res rule and keeps going; only a
        # second consecutive stall — genuinely frozen at this precision —
        # exits. Relative to |x| so small-but-real steps don't trip it.
        eps = jnp.asarray(jnp.finfo(dtype).eps, dtype)
        x_dx = _psum(jnp.sum(x_new * x_new), config)
        moved = dx_dx > (16.0 * eps * eps) * x_dx
        stalls = jnp.where(moved, 0, stalls + 1)
        alpha_new = jnp.where(moved, alpha_new,
                              jnp.asarray(1.0, dtype)
                              / jnp.maximum(res, jnp.asarray(config.tol,
                                                             dtype)))
        # Only a step computed from genuine movement is a trustworthy
        # curvature estimate — the returned alpha (callers feed it back as
        # the next warm solve's alpha0) must never be tail noise.
        alpha_good = jnp.where(jnp.logical_and(moved, jnp.logical_not(bad)),
                               alpha_new, alpha_good)
        # Patience bookkeeping: a "best" must beat the previous best by a
        # relative margin (BBPGD is non-monotone, but a healthy solve sets
        # meaningfully lower lows every few dozen iterations; sub-margin
        # drift means the residual has floored at this precision). res is
        # already pmax'd, so sharded solves make identical decisions.
        improved = res < res_best * (1.0 - jnp.asarray(config.min_improve,
                                                       dtype))
        x_best = jnp.where(improved, x_new, x_best)
        res_best = jnp.where(improved, res, res_best)
        since_best = jnp.where(improved, 0, since_best + 1)
        return (x_new, g_new, alpha_new, alpha_good, it + 1, res, stalls,
                x_best, res_best, since_best)

    init = (x0, g0, alpha0, alpha0, jnp.asarray(0, jnp.int32), res0,
            jnp.asarray(0, jnp.int32),
            x0, res0, jnp.asarray(0, jnp.int32))
    (x, _g, _alpha, alpha_good, iters, res, _stalls,
     x_best, res_best, _since) = jax.lax.while_loop(cond, body, init)
    # On a non-converged exit the final iterate can sit on a non-monotone
    # spike; hand back the best-residual iterate instead.
    take_best = res_best < res
    x = jnp.where(take_best, x_best, x)
    res = jnp.where(take_best, res_best, res)
    return SolveResult(x=x, num_iters=iters, residual=res,
                       converged=res < config.tol, alpha=alpha_good)


def solve_lcp(
    apply_A: Callable[[Array], Array],
    q: Array,
    x0: Optional[Array] = None,
    config: PGDConfig = PGDConfig(),
    mask: Optional[Array] = None,
    alpha0: Optional[Array] = None,
) -> SolveResult:
    """Solve the LCP  0 <= x  ⊥  A·x + q >= 0  as a CQPP over R₊ⁿ.

    Mirrors `solve_lcp`/`to_cqpp` (`convex.hpp:425,840`).
    """
    space = lower_bound(jnp.zeros_like(q))
    return solve_cqpp(apply_A, q, space, x0=x0, config=config, mask=mask,
                      alpha0=alpha0)
