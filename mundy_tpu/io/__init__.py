"""IO: checkpoint/restart, trajectory output, step telemetry.

Replacement for the reference's IOBroker
(`scrap/parameter_interface/io/src/mundy_io/IOBroker.hpp:64-252`): Exodus
results/restart databases become (a) pytree checkpoints (npz, any state
pytree round-trips losslessly) and (b) VTK/XYZ trajectory writers for
visualization; the rank-gated tps logging (`HP1...neigh_linker.cpp:1496-1546`)
becomes StepLogger.
"""

from mundy_tpu.io.checkpoint import save_checkpoint, load_checkpoint, latest_checkpoint
from mundy_tpu.io.vtk import write_vtk_points, write_xyz
from mundy_tpu.io.telemetry import StepLogger

__all__ = [
    "save_checkpoint",
    "load_checkpoint",
    "latest_checkpoint",
    "write_vtk_points",
    "write_xyz",
    "StepLogger",
]
