"""Utilities: columnar logging, checkpoints, VTU export, profiling.

``TableLogger`` prints aligned iteration rows (rank 0 only under
``torch.distributed``) and can mirror them to CSV; ``save_checkpoint`` /
``load_checkpoint`` write and read named arrays with a JSON sidecar;
``write_vtu`` and ``viz.maybe_export`` write ParaView files; ``GLVis``
streams fields to a running GLVis server (a no-op without one);
``profiling``
keeps a per-phase cost table and writes torch.profiler traces.  Tensors
on any device are accepted and copied to the host.
"""

from . import profiling
from .checkpoint import load_checkpoint, save_checkpoint
from .glvis import GLVis
from .logger import TableLogger
from .vtk import write_vtu

__all__ = ["TableLogger", "save_checkpoint", "load_checkpoint", "write_vtu",
           "GLVis", "profiling"]
