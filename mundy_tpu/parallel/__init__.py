"""Multi-chip execution over a jax.sharding.Mesh.

Replacement for the reference's MPI layer (SURVEY.md §2.7): rank
decomposition -> sharded particle arrays; `stk::all_reduce_*` -> psum/pmax;
ghosting/aura -> halo exchange (all-gather of boundary slabs or ppermute
rings); RCB load balance -> Hilbert-key resharding.
"""

from mundy_tpu.parallel.sharded_step import (
    make_sharded_spheres_step,
    make_slab_spheres_step,
)
from mundy_tpu.parallel.slab import ShardState, halo_exchange, migrate, slab_bounds

__all__ = [
    "make_sharded_spheres_step",
    "make_slab_spheres_step",
    "ShardState",
    "halo_exchange",
    "migrate",
    "slab_bounds",
]
