"""mundy_tpu — multibody nonlocal dynamics in JAX.

A ground-up JAX/XLA/Pallas re-design of the capabilities of MundyRepo/MuNDy
(C++20 Kokkos/Trilinos-STK; see SURVEY.md):

- particles / rods / filaments with short-range contact (Hertzian, WCA,
  frictional-Hertzian) and LCP-constrained non-penetration solved by
  projected-gradient (BBPGD) methods,
- constraint mechanics (Hookean/FENE/FENE-WCA/angular springs, ball joints,
  Kirchhoff centerline-twist rods, KMC crosslinker binding),
- long-range Stokes hydrodynamics (RPY mobility, boundary-integral periphery
  confinement, Ewald/FMM-style blocked-matmul pipelines),
- periodic / confined domains, Morton/Hilbert-sorted cell-list neighbor search,
- multi-chip execution over a `jax.sharding.Mesh` (spatial domain decomposition
  via sharded structure-of-arrays state; XLA collectives replace MPI).

Layer map (mirrors reference layers, SURVEY.md §1, re-designed for XLA):

    core     -> config, pytree containers, assertions       (ref: mundy/core)
    math     -> quaternions, L-BFGS, BBPGD LCP/QP, SFC keys (ref: mundy/math)
    geom     -> primitives, distances, AABB, periodicity     (ref: mundy/geom)
    mech     -> springs, joints, rods                        (ref: mundy/mech)
    state    -> World SoA state, links, selectors            (ref: mundy/mesh)
    neighbor -> cell-list broad phase, pair lists            (ref: GenNeighborLinkers)
    forces   -> contact + spring force evaluation            (ref: mundy_linkers/constraints)
    mobility -> local drag, RPY, periphery BIE               (ref: mundy_alens)
    constraints -> LCP collision resolution                  (ref: lcp_spheres, convex.hpp)
    kmc      -> crosslinker binding state machines           (ref: actions_crosslinkers)
    dynamics -> integrators, Brownian motion                 (ref: NodeEuler, ComputeBrownianVelocity)
    parallel -> device-mesh sharding, halo exchange          (ref: MPI/STK ghosting)
    io       -> checkpoint/restart, VTK/XYZ output, logging  (ref: mundy_io IOBroker)
    driver   -> YAML config -> Simulation orchestration      (ref: mundy_driver)
"""

__version__ = "0.1.0"

from mundy_tpu import core, math, geom  # noqa: F401
