"""VTU (ParaView) export, the analogue of MFEM's ParaViewDataCollection.

Writes an ASCII .vtu unstructured grid with point data interpolated at the
element corners (linear visualization of arbitrary-order fields, like
MFEM's default refined=0 ParaView export).
"""

from __future__ import annotations

import numpy as np

from ..fespace import FESpace
from ..mesh import Mesh
from ..quadrature import CUBE, SQUARE, TETRAHEDRON, TRIANGLE
from ._host import to_numpy

# VTK cell types; vertex permutations lex -> VTK ordering
_VTK_CELL = {TRIANGLE: (5, [0, 1, 2]), SQUARE: (9, [0, 1, 3, 2]),
             CUBE: (12, [0, 1, 3, 2, 4, 5, 7, 6]),
             TETRAHEDRON: (10, [0, 1, 2, 3])}


def _corner_values(space: FESpace, u: np.ndarray) -> np.ndarray:
    """Field values at mesh vertices, averaged over incident elements."""
    mesh = space.mesh
    geo_nodes = np.array(space.elem.eval(_corner_ref(mesh.geom)))
    u = to_numpy(u)
    idx = np.asarray(space.edof, dtype=np.int64)[:, :, None] + np.arange(
        space.vdim
    ) * space.ndof_scalar
    ue = u[idx]  # [ne, nd, vdim]
    vals = np.einsum("cd,edv->ecv", geo_nodes, ue)  # [ne, nc, vdim]
    out = np.zeros((mesh.num_vertices, space.vdim))
    cnt = np.zeros(mesh.num_vertices)
    np.add.at(out, mesh.elements.astype(np.int64), vals)
    np.add.at(cnt, mesh.elements.astype(np.int64), 1.0)
    return out / cnt[:, None]


def _corner_ref(geom: str) -> np.ndarray:
    if geom == TRIANGLE:
        return np.array([[0.0, 0.0], [1.0, 0.0], [0.0, 1.0]])
    if geom == SQUARE:
        return np.array([[0.0, 0.0], [1.0, 0.0], [0.0, 1.0], [1.0, 1.0]])
    if geom == CUBE:
        pts = []
        for k in (0.0, 1.0):
            for j in (0.0, 1.0):
                for i in (0.0, 1.0):
                    pts.append([i, j, k])
        return np.array(pts)
    if geom == TETRAHEDRON:
        return np.array(
            [[0.0, 0.0, 0.0], [1.0, 0.0, 0.0], [0.0, 1.0, 0.0],
             [0.0, 0.0, 1.0]]
        )
    raise ValueError(geom)


def write_vtu(path: str, mesh: Mesh, fields: dict | None = None,
              spaces: dict | None = None):
    """Write mesh + named point-data fields to ``path`` (.vtu).

    ``fields[name]`` is a dof vector on ``spaces[name]`` (a FESpace).
    """
    fields = fields or {}
    spaces = spaces or {}
    cell_type, perm = _VTK_CELL[mesh.geom]
    ne = mesh.num_elements
    nv = mesh.num_vertices
    nc = mesh.elements.shape[1]
    pts = np.zeros((nv, 3))
    pts[:, : mesh.dim] = mesh.vertices

    lines = []
    a = lines.append
    a('<?xml version="1.0"?>')
    a('<VTKFile type="UnstructuredGrid" version="0.1" '
      'byte_order="LittleEndian">')
    a("<UnstructuredGrid>")
    a(f'<Piece NumberOfPoints="{nv}" NumberOfCells="{ne}">')
    a("<Points>")
    a('<DataArray type="Float64" NumberOfComponents="3" format="ascii">')
    for p in pts:
        a(f"{p[0]:.16g} {p[1]:.16g} {p[2]:.16g}")
    a("</DataArray>")
    a("</Points>")
    a("<Cells>")
    a('<DataArray type="Int32" Name="connectivity" format="ascii">')
    conn = mesh.elements[:, perm]
    for row in conn:
        a(" ".join(str(int(v)) for v in row))
    a("</DataArray>")
    a('<DataArray type="Int32" Name="offsets" format="ascii">')
    a(" ".join(str((i + 1) * nc) for i in range(ne)))
    a("</DataArray>")
    a('<DataArray type="UInt8" Name="types" format="ascii">')
    a(" ".join(str(cell_type) for _ in range(ne)))
    a("</DataArray>")
    a("</Cells>")
    a("<PointData>")
    for name, u in fields.items():
        sp = spaces[name]
        vals = _corner_values(sp, to_numpy(u))
        ncomp = vals.shape[1]
        a(
            f'<DataArray type="Float64" Name="{name}" '
            f'NumberOfComponents="{ncomp}" format="ascii">'
        )
        for row in vals:
            a(" ".join(f"{v:.16g}" for v in row))
        a("</DataArray>")
    a("</PointData>")
    a("</Piece>")
    a("</UnstructuredGrid>")
    a("</VTKFile>")
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")
