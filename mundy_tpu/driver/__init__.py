"""Drivers/apps: configuration -> assembled simulation -> time loop.

Replacement for the reference's L5/L6 orchestration
(`scrap/parameter_interface/driver/` Configurator/Driver and the hand-written
app drivers in `scrap/hp1_mock_reworks/`, `scrap/lcp_spheres/`): a validated
dataclass config (YAML-loadable) builds a jitted step function + state
pytree; the host loop owns only rebuild decisions, logging, and IO.
"""
