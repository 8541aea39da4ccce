"""Neighbor search: Morton-sorted cell lists + capacity-bounded pair lists.

Replacement for the reference's broad-phase pipeline
(`mundy/mesh/src/mundy_mesh/GenNeighborLinkers.hpp:295-741`): instead of a
GPU BVH (`MORTON_LBVH`) + MPI ghosting + dynamic linker entities, we bin
particles into a dense cell grid (static shapes), read the 27 neighboring
cells per particle, and emit either a dense per-particle neighbor matrix or a
compacted (i, j) pair list with a fixed capacity and an overflow flag — the
capacity-bounded equivalent of dynamic link creation (SURVEY.md §7 "dynamic
topology on a static-shape runtime").
"""

from mundy_tpu.neighbor.cell_list import (
    CellGrid,
    CellList,
    make_cell_grid,
    build_cell_list,
    neighbor_matrix,
    neighbor_matrix_query,
    NeighborMatrix,
    build_pair_list,
    build_pair_list_ordered,
    PairList,
    need_rebuild,
)
from mundy_tpu.neighbor.rows import neighbor_matrix_rows

__all__ = [
    "CellGrid",
    "CellList",
    "make_cell_grid",
    "build_cell_list",
    "neighbor_matrix",
    "neighbor_matrix_query",
    "neighbor_matrix_rows",
    "NeighborMatrix",
    "build_pair_list",
    "build_pair_list_ordered",
    "PairList",
    "need_rebuild",
]
