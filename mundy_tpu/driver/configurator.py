"""Configurator: YAML -> validated config -> assembled simulation.

Replacement for the reference's Configurator/Driver
(`scrap/parameter_interface/driver/src/mundy_driver/Configurator.hpp:98,
181-208`, `Driver.hpp:96`) and the per-app Teuchos ParameterList plumbing
(`HP1...neigh_linker.cpp:867-1062`): a registry maps app names to
(config schema, simulation class); YAML populates the schema with
unknown-key rejection and numeric coercion (core.config).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

from mundy_tpu.core.config import ConfigError, config_from_dict, load_yaml

# app name -> (config class, sim class); populated lazily to keep imports
# cheap (each app pulls in its own kernel stack)
_REGISTRY: dict = {}


def _registry():
    if _REGISTRY:
        return _REGISTRY
    from mundy_tpu.driver.apps.spheres import SpheresConfig, SpheresSim
    from mundy_tpu.driver.apps.lcp_spheres import LCPSpheresConfig, LCPSpheresSim
    from mundy_tpu.driver.apps.rods import RodsConfig, RodsSim
    from mundy_tpu.driver.apps.filaments import FilamentsConfig, FilamentsSim
    from mundy_tpu.driver.apps.chromatin import ChromatinConfig, ChromatinSim
    from mundy_tpu.driver.apps.granular import GranularConfig, GranularSim

    def make_rods_sim(config):
        """Engine selection for config #3: the gather-free row narrow phase
        (rods_rows.RowRodsSim) when the box admits it, else the (N, K)
        neighbor-matrix engine."""
        if (config.engine == "nmat" or config.shape == "ellipsoid"
                or config.friction):
            # the ellipsoid narrow phase and the frictional-history kernel
            # run per (i, k) slot on the neighbor matrix; the row stencil
            # is segment-specific and carries no per-slot state
            return RodsSim(config)
        cutoff = config.length + 2 * config.radius + config.skin
        feasible = int(config.box_size // cutoff) >= 5
        if config.engine == "rows" or feasible:
            from mundy_tpu.driver.apps.rods_rows import RowRodsSim
            return RowRodsSim(config)
        return RodsSim(config)

    _REGISTRY.update({
        "spheres": (SpheresConfig, SpheresSim),
        "lcp_spheres": (LCPSpheresConfig, LCPSpheresSim),
        "rods": (RodsConfig, make_rods_sim),
        "filaments": (FilamentsConfig, FilamentsSim),
        "chromatin": (ChromatinConfig, ChromatinSim),
        "granular": (GranularConfig, GranularSim),
    })
    return _REGISTRY


def available_apps() -> list:
    return sorted(_registry().keys())


def build_simulation(spec: dict):
    """{"app": name, "params": {...}} -> (config, sim). Raises ConfigError
    with the valid choices on an unknown app."""
    reg = _registry()
    if "app" not in spec:
        raise ConfigError(f"config must name an 'app'; available: {available_apps()}")
    app = spec["app"]
    if app not in reg:
        raise ConfigError(f"unknown app '{app}'; available: {available_apps()}")
    cfg_cls, sim_cls = reg[app]
    params = spec.get("params", {}) or {}
    config = config_from_dict(cfg_cls, params, path=f"{app}.params")
    return config, sim_cls(config)


def build_simulation_from_yaml(path: str, overrides: Optional[dict] = None):
    """Load a YAML app spec, apply dotted-key overrides, build the sim."""
    spec = load_yaml(path)
    if overrides:
        params = dict(spec.get("params", {}) or {})
        for key, value in overrides.items():
            params[key] = value
        spec = {**spec, "params": params}
    return build_simulation(spec)
