"""Visualization helpers shared by the example programs."""

from __future__ import annotations

from ._host import to_numpy
from .vtk import write_vtu


def maybe_export(enabled: bool, name: str, space, fields: dict):
    """Write <name>.vtu with the given {field: dof_vector} on one space."""
    if not enabled:
        return None
    path = f"{name}.vtu"
    write_vtu(
        path,
        space.mesh,
        {k: to_numpy(v) for k, v in fields.items()},
        {k: space for k in fields},
    )
    print(f"wrote {path}")
    return path
