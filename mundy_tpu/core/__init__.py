"""Core utilities: pytree containers, assertions, config.

Replacement for MundyCore (reference `mundy/core/`, SURVEY.md §2.1).
The reference's compile-time `aggregate`/`tuple`/`variant` map to registered
dataclass pytrees; `NgpView`/`NgpPool` host-device dual views disappear (JAX
owns one device memory space); `MUNDY_THROW_REQUIRE/ASSERT` become host-side
`require()` plus in-jit `checkify`-style debug assertions.
"""

from mundy_tpu.core.containers import pytree_dataclass, static_field
from mundy_tpu.core.errors import require, debug_assert
from mundy_tpu.core.config import (
    ConfigError,
    validate_config,
    load_yaml,
    config_from_dict,
    config_to_dict,
)

__all__ = [
    "pytree_dataclass",
    "static_field",
    "require",
    "debug_assert",
    "ConfigError",
    "validate_config",
    "load_yaml",
    "config_from_dict",
    "config_to_dict",
]
