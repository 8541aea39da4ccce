"""Assertions.

Replacement for `MUNDY_THROW_REQUIRE` / `MUNDY_THROW_ASSERT`
(reference `mundy/core/src/mundy_core/throw_assert.hpp:119-178`): host-side
checks raise immediately; inside traced code we emit `jax.debug` checks that
are free when disabled and do not break compilation.
"""

from __future__ import annotations

import os
from typing import Any

import jax
import jax.numpy as jnp

# Mirrors the reference's NDEBUG-gated MUNDY_THROW_ASSERT: debug asserts are
# compiled out unless explicitly enabled.
DEBUG_ASSERTS = os.environ.get("MUNDY_TPU_DEBUG", "0") not in ("0", "", "false")


class MundyError(RuntimeError):
    """Framework error with context."""


def require(condition: Any, message: str = "requirement failed") -> None:
    """Host-side requirement (always on). Raises MundyError.

    Must be called with a concrete (non-traced) bool.
    """
    if isinstance(condition, jax.core.Tracer):
        raise MundyError(
            "require() called with a traced value inside jit; "
            "use debug_assert() for traced conditions: " + message
        )
    if not condition:
        raise MundyError(message)


def debug_assert(condition: Any, message: str = "assertion failed") -> None:
    """Traced-value assertion, enabled by MUNDY_TPU_DEBUG=1.

    Uses jax.debug.print on failure (non-fatal, avoids host sync); intended
    for development, compiled out in production like the reference's
    device-side MUNDY_THROW_ASSERT.
    """
    if not DEBUG_ASSERTS:
        return
    ok = jnp.all(jnp.asarray(condition))
    jax.lax.cond(
        ok,
        lambda: None,
        lambda: jax.debug.print("MUNDY_TPU ASSERT FAILED: {m}", m=message),
    )
