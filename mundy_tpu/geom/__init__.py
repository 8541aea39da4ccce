"""Geometry layer: primitives, distances, AABBs, periodic metrics.

Replacement for MundyGeom (reference `mundy/geom/`, SURVEY.md
§2.3). Every primitive is a pytree dataclass whose fields are arrays with
leading batch axes (structure-of-arrays), so a `Sphere` IS a batch of spheres
and every distance function is a batched kernel by construction — the
reference's per-entity "view" primitives over mesh fields become slices of
the state pytree.
"""

from mundy_tpu.geom.primitives import (
    Sphere,
    Line,
    LineSegment,
    VSegment,
    Plane,
    Circle3D,
    Ring,
    Spherocylinder,
    SpherocylinderSegment,
    Ellipsoid,
    AABB,
    spherocylinder_endpoints,
)
from mundy_tpu.geom.periodicity import Metric, free_space, periodic, triclinic
from mundy_tpu.geom import distance
from mundy_tpu.geom.distance import (
    distance_point_point,
    distance_point_line,
    distance_point_segment,
    distance_point_plane,
    distance_point_sphere,
    distance_point_ellipsoid,
    distance_line_line,
    distance_line_sphere,
    distance_line_plane,
    distance_segment_segment,
    distance_segment_sphere,
    distance_segment_plane,
    distance_sphere_sphere,
    distance_sphere_ellipsoid,
    distance_plane_sphere,
    distance_plane_plane,
    distance_ellipsoid_ellipsoid,
    distance_circle3d_circle3d,
    distance_sphere_spherocylinder,
    distance_spherocylinder_spherocylinder,
    distance_sphere_scsegment,
    distance_scsegment_scsegment,
    distance_point_vsegment,
    distance_plane_ellipsoid,
    distance_segment_ellipsoid,
    distance_line_ellipsoid,
)
from mundy_tpu.geom.aabb import (
    compute_aabb_sphere,
    compute_aabb_segment,
    compute_aabb_spherocylinder,
    compute_aabb_scsegment,
    compute_aabb_ellipsoid,
    compute_aabb_point,
    compute_bounding_radius_sphere,
    compute_bounding_radius_spherocylinder,
    compute_bounding_radius_ellipsoid,
    compute_obb_sphere,
    compute_obb_spherocylinder,
    compute_obb_ellipsoid,
    aabb_union,
    aabb_inflate,
)
from mundy_tpu.geom.transform import (
    transform_points,
    inverse_transform_points,
    transform_primitive,
    inverse_transform_primitive,
)
from mundy_tpu.geom.randomize import (
    random_points_in_box,
    random_unit_quaternions,
    random_spheres,
    random_spherocylinders,
    random_segments,
    random_ellipsoids,
    random_rings,
)

__all__ = [
    "Sphere", "Line", "LineSegment", "VSegment", "Plane", "Circle3D", "Ring",
    "Spherocylinder", "SpherocylinderSegment", "Ellipsoid", "AABB",
    "spherocylinder_endpoints",
    "Metric", "free_space", "periodic", "triclinic",
    "distance",
    "compute_aabb_sphere", "compute_aabb_segment",
    "compute_aabb_spherocylinder", "compute_aabb_scsegment",
    "compute_aabb_ellipsoid", "compute_aabb_point",
    "compute_bounding_radius_sphere", "compute_bounding_radius_spherocylinder",
    "compute_bounding_radius_ellipsoid", "compute_obb_sphere",
    "compute_obb_spherocylinder", "compute_obb_ellipsoid",
    "aabb_union", "aabb_inflate",
    "transform_points", "inverse_transform_points",
    "transform_primitive", "inverse_transform_primitive",
    "random_points_in_box", "random_unit_quaternions",
    "random_spheres", "random_spherocylinders", "random_segments",
    "random_ellipsoids", "random_rings",
]
