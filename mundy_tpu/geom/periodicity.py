"""Periodic-box metrics: free-space, orthorhombic, per-axis, triclinic.

Replaces the reference's metric family (`mundy/geom/src/mundy_geom/
periodicity.hpp:155,234,336` — `EuclideanMetric`, `PeriodicMetric`,
`PeriodicMetricX/XY/...`, triclinic fractional machinery — and
`distance/DistanceMetrics.hpp:43-145`). One dataclass covers all of them: a
cell matrix + per-axis periodic mask. The reference's 8 per-axis template
instantiations collapse to a boolean mask (XLA folds the non-periodic lanes).

All ops broadcast over leading batch axes of the points AND of the metric
itself (a sharded per-domain box works transparently).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from jax import Array

from mundy_tpu.core.containers import pytree_dataclass, static_field


@pytree_dataclass
class Metric:
    """cell: (..., 3, 3) column-vector lattice matrix (box vectors in columns);
    inv_cell: its inverse; periodic: (..., 3) bool per-axis flags.

    `diagonal` (static) marks orthorhombic cells: the fractional maps become
    elementwise multiplies. Correctness note: the triclinic einsum path
    MUST run at HIGHEST precision — a reduced-precision matmul (bfloat16 or
    TF32) quantizes every wrapped position to ~box/256 .. box/2048.
    """

    cell: Array
    inv_cell: Array
    periodic: Array
    diagonal: bool = static_field(default=False)

    # ---- fractional coordinate maps (ref periodicity.hpp to/from_fractional)
    def to_fractional(self, p: Array) -> Array:
        if self.diagonal:
            d = jnp.diagonal(self.inv_cell, axis1=-2, axis2=-1)
            return p * d
        return jnp.einsum("...ij,...j->...i", self.inv_cell, p,
                          precision=jax.lax.Precision.HIGHEST)

    def from_fractional(self, f: Array) -> Array:
        if self.diagonal:
            d = jnp.diagonal(self.cell, axis1=-2, axis2=-1)
            return f * d
        return jnp.einsum("...ij,...j->...i", self.cell, f,
                          precision=jax.lax.Precision.HIGHEST)

    def frac_minimum_image(self, f: Array) -> Array:
        """Map fractional components to [-1/2, 1/2) on periodic axes."""
        wrapped = f - jnp.round(f)
        return jnp.where(self.periodic, wrapped, f)

    def frac_wrap_to_unit_cell(self, f: Array) -> Array:
        wrapped = f - jnp.floor(f)
        return jnp.where(self.periodic, wrapped, f)

    # ---- public API (mirrors sep/wrap/shift_image, periodicity.hpp:208-330)
    def sep(self, p1: Array, p2: Array) -> Array:
        """Minimum-image separation vector p2 - p1."""
        return self.from_fractional(self.frac_minimum_image(self.to_fractional(p2 - p1)))

    def wrap(self, p: Array) -> Array:
        """Wrap points into the primary cell."""
        return self.from_fractional(self.frac_wrap_to_unit_cell(self.to_fractional(p)))

    def shift_image(self, p: Array, image: Array) -> Array:
        """Shift a point by integer image counts (..., 3)."""
        return p + self.from_fractional(image.astype(p.dtype))

    def distance(self, p1: Array, p2: Array) -> Array:
        return jnp.linalg.norm(self.sep(p1, p2), axis=-1)


def free_space(dtype=jnp.float32) -> Metric:
    """ref: EuclideanMetric (periodicity.hpp:155) / FreeSpaceMetric."""
    eye = jnp.eye(3, dtype=dtype)
    return Metric(cell=eye, inv_cell=eye, periodic=jnp.zeros(3, bool), diagonal=True)


def periodic(box_lengths, periodic_axes=(True, True, True), dtype=None) -> Metric:
    """Orthorhombic (or per-axis partial) periodic box.

    ref: PeriodicMetric (periodicity.hpp:234) and the per-axis
    PeriodicMetricX/XY/... family (:336+), plus PeriodicScaledSpaceMetric.
    """
    box = jnp.asarray(box_lengths, dtype)
    cell = jnp.zeros(box.shape[:-1] + (3, 3), box.dtype)
    for i in range(3):
        cell = cell.at[..., i, i].set(box[..., i])
    inv = jnp.zeros_like(cell)
    for i in range(3):
        inv = inv.at[..., i, i].set(1.0 / box[..., i])
    return Metric(cell=cell, inv_cell=inv, periodic=jnp.asarray(periodic_axes, bool),
                  diagonal=True)


def triclinic(cell, periodic_axes=(True, True, True)) -> Metric:
    """General triclinic cell (box vectors as columns of `cell`)."""
    cell = jnp.asarray(cell)
    return Metric(
        cell=cell,
        inv_cell=jnp.linalg.inv(cell),
        periodic=jnp.asarray(periodic_axes, bool),
        diagonal=False,
    )
