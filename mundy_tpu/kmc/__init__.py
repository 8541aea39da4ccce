"""Kinetic Monte Carlo crosslinker binding/unbinding.

Replacement for the reference's crosslinker KMC machinery
(`scrap/hp1_mock_reworks/HP1_mock_rework_agents_text_mesh_neigh_linker.cpp:
177-360` and `scrap/parameter_interface/alens/.../actions_crosslinkers.hpp`).
"""

from mundy_tpu.kmc.crosslinkers import (
    BINDING_STATE,
    binding_rate_gaussian,
    kmc_bind_events,
    kmc_unbind_events,
    crosslinker_kmc_step,
)

__all__ = [
    "BINDING_STATE",
    "binding_rate_gaussian",
    "kmc_bind_events",
    "kmc_unbind_events",
    "crosslinker_kmc_step",
]
