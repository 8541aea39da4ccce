"""State runtime: the Replacement for MundyMesh.

The reference's L3 mesh layer (`mundy/mesh/`, ~28 kLoC — SURVEY.md §2.5) is
an STK distributed unstructured mesh: MetaData/BulkData, bucketed entities,
dynamic field registration, N-ary "link" connectivity, neighbor ghosting, a
fused-expression engine, and field BLAS. Here all of it collapses to a
sharded structure-of-arrays pytree plus index arrays:

| reference                          | here                              |
|------------------------------------|-----------------------------------|
| MetaData/parts/field declarations  | WorldBuilder (host-side)          |
| BulkData + buckets + entities      | EntitySet: dict of (cap, ...) arrays + active mask |
| selectors "(a|b)&!c"               | select() boolean-mask algebra     |
| LinkData COO + CRS mirrors         | LinkSet (COO) + links_to_csr      |
| NgpAccessorExpr fused kernels      | XLA fusion (nothing to write)     |
| NgpFieldBLAS                       | field helpers (thin jnp wrappers) |
| DeclareEntitiesHelper              | WorldBuilder.add_entities         |
| aura/ghosting                      | parallel/ halo exchange           |
"""

from mundy_tpu.state.world import (
    EntitySet,
    LinkSet,
    World,
    WorldBuilder,
    links_to_csr,
)
from mundy_tpu.state.select import select
from mundy_tpu.state.fieldops import (
    field_fill,
    field_copy,
    field_scale,
    field_axpy,
    field_axpby,
    field_product,
    field_dot,
    field_nrm2,
    field_asum,
    field_amax,
    field_amin,
    field_randomize,
)

__all__ = [
    "EntitySet", "LinkSet", "World", "WorldBuilder", "links_to_csr",
    "select",
    "field_fill", "field_copy", "field_scale", "field_axpy", "field_axpby",
    "field_product", "field_dot", "field_nrm2", "field_asum", "field_amax",
    "field_amin", "field_randomize",
]
