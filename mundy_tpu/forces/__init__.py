"""Force evaluation: pairwise contact potentials + spring networks.

Replacement for the reference's `EvaluateLinkerPotentials`
kernels (`scrap/parameter_interface/linkers/`) and
`compute_constraint_forcing` spring kernels
(`scrap/parameter_interface/constraints/`). Pair forces are evaluated from
the dense neighbor matrix with one-sided per-particle sums (each particle
accumulates its own force over its neighbor row) — deterministic, no atomic
scatter; spring forces use segment-sum over connectivity index arrays.
"""

from mundy_tpu.forces.contact import (
    hertzian_pair_force,
    wca_pair_force,
    contact_forces,
    hertzian_contact_forces,
    wca_contact_forces,
)
from mundy_tpu.forces.springs import (
    hookean_spring_forces,
    fene_spring_forces,
    fenewca_chain_forces,
    fenewca_spring_forces,
    angular_spring_forces,
)

__all__ = [
    "hertzian_pair_force",
    "wca_pair_force",
    "contact_forces",
    "hertzian_contact_forces",
    "wca_contact_forces",
    "hookean_spring_forces",
    "fene_spring_forces",
    "fenewca_chain_forces",
    "fenewca_spring_forces",
    "angular_spring_forces",
]
