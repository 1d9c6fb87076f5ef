"""GLVis live-visualization client.

PyTorch counterpart of ``mfem_ad_tpu.utils.glvis``, byte for byte the same
streams.  Speaks the GLVis socket protocol: connects to a running
``glvis`` server (default localhost:19916) and streams ``solution`` blocks
(MFEM mesh + grid function in MFEM ASCII formats).  Tensors on any device
are copied to the host.

Fields are streamed at their native order.  Order-1 H1 fields are
conforming H1 P1 vertex values; order-p H1 fields on 2D quad and triangle
meshes are conforming H1_2D_Pp grid functions in MFEM's global dof
numbering (edges numbered by first appearance); L2 fields and 3D p >= 2
are order-p L2 grid functions: per-element values at the node lattice of
MFEM's ``L2_T1_*`` (Gauss-Lobatto) elements, exact and rendered the same.

If no server is listening the client is a no-op, so examples can always
construct one.
"""

from __future__ import annotations

import socket

import numpy as np

from ..basis import lobatto_points
from ..fespace import FESpace
from ..mesh import Mesh
from ..quadrature import CUBE, SQUARE, TETRAHEDRON, TRIANGLE
from ._host import to_numpy
from .vtk import _corner_values

_MFEM_GEOM_CODE = {TRIANGLE: 2, SQUARE: 3, TETRAHEDRON: 4, CUBE: 5}
# lex corners -> MFEM counter-clockwise ordering
_MFEM_PERM = {TRIANGLE: [0, 1, 2], SQUARE: [0, 1, 3, 2],
              TETRAHEDRON: [0, 1, 2, 3],
              CUBE: [0, 1, 3, 2, 4, 5, 7, 6]}


def _mfem_l2_nodes(geom: str, p: int) -> np.ndarray:
    """Node lattice of MFEM's ``L2_T1_*`` (Gauss-Lobatto) element of
    order ``p``, in MFEM's local dof order (mfem fe_l2.cpp).

    Quads/hexes: the tensor Lobatto lattice, x fastest — identical to
    this framework's ``RefElement`` lattice.  Triangles: the warped
    barycentric-Lobatto lattice ``(op_i, op_j, op_{p-i-j}) / w`` in the
    (j outer, i inner) loop order.
    """
    if p == 0:
        centers = {SQUARE: [[0.5, 0.5]], CUBE: [[0.5, 0.5, 0.5]],
                   TRIANGLE: [[1 / 3, 1 / 3]],
                   TETRAHEDRON: [[0.25, 0.25, 0.25]]}
        return np.asarray(centers[geom], dtype=np.float64)
    op = lobatto_points(p)
    if geom == SQUARE:
        pts = [(op[i], op[j]) for j in range(p + 1) for i in range(p + 1)]
    elif geom == CUBE:
        pts = [
            (op[i], op[j], op[k])
            for k in range(p + 1)
            for j in range(p + 1)
            for i in range(p + 1)
        ]
    elif geom == TETRAHEDRON:
        # warped barycentric-Lobatto lattice (mfem fe_l2.cpp, tet branch)
        pts = []
        for k in range(p + 1):
            for j in range(p + 1 - k):
                for i in range(p + 1 - k - j):
                    w = op[i] + op[j] + op[k] + op[p - i - j - k]
                    pts.append((op[i] / w, op[j] / w, op[k] / w))
    else:  # TRIANGLE
        pts = []
        for j in range(p + 1):
            for i in range(p + 1 - j):
                w = op[i] + op[j] + op[p - i - j]
                pts.append((op[i] / w, op[j] / w))
    return np.asarray(pts, dtype=np.float64)


def _mesh_ascii(mesh: Mesh) -> str:
    lines = ["MFEM mesh v1.0", "", "dimension", str(mesh.dim), ""]
    lines += ["elements", str(mesh.num_elements)]
    code = _MFEM_GEOM_CODE[mesh.geom]
    perm = _MFEM_PERM[mesh.geom]
    for attr, el in zip(mesh.attributes, mesh.elements):
        lines.append(
            f"{int(attr)} {code} " + " ".join(str(int(el[p])) for p in perm)
        )
    lines += ["", "boundary", str(mesh.bdr_elements.shape[0])]
    bcode = 1 if mesh.dim == 2 else 3
    bperm = [0, 1] if mesh.dim == 2 else [0, 1, 3, 2]
    for attr, be in zip(mesh.bdr_attributes, mesh.bdr_elements):
        lines.append(
            f"{int(attr)} {bcode} " + " ".join(str(int(be[p])) for p in bperm)
        )
    lines += ["", "vertices", str(mesh.num_vertices), str(mesh.dim)]
    for v in mesh.vertices:
        lines.append(" ".join(f"{x:.16g}" for x in v))
    return "\n".join(lines) + "\n"


_MFEM_LOCAL_EDGES = {
    # MFEM Geometry::Constants Edges[][] in MFEM-local vertex numbering
    TRIANGLE: [(0, 1), (1, 2), (2, 0)],
    SQUARE: [(0, 1), (1, 2), (3, 2), (0, 3)],
}
_MFEM_REF_VERTS = {
    TRIANGLE: np.array([[0.0, 0.0], [1.0, 0.0], [0.0, 1.0]]),
    SQUARE: np.array([[0.0, 0.0], [1.0, 0.0], [1.0, 1.0], [0.0, 1.0]]),
}


def _h1_conforming_layout(mesh: Mesh, p: int):
    """MFEM's conforming H1 global dof layout for the mesh AS SERIALIZED
    by ``_mesh_ascii`` (GLVis reconstructs the space from the mesh, so the
    edge enumeration must match MFEM's: edges numbered by FIRST
    APPEARANCE iterating elements in order and local edges in
    Geometry::Constants order, oriented min->max vertex id; global dofs
    = [vertices][edge interiors][element interiors]).

    Returns (n_glob, elem_gids [ne, nj], ref_nodes [nj, 2]): the global
    id and MFEM reference coordinate of every MFEM-local H1 dof, with
    edge-dof reversal applied where the element's local edge direction
    opposes the global one."""
    geom = mesh.geom
    ledges = _MFEM_LOCAL_EDGES[geom]
    refv = _MFEM_REF_VERTS[geom]
    # our lex corners -> the MFEM CCW order _mesh_ascii emits
    mverts = mesh.elements[:, _MFEM_PERM[geom]].astype(np.int64)
    ne = mverts.shape[0]
    nv = mesh.num_vertices
    op = lobatto_points(p)

    edge_index: dict = {}
    for e in range(ne):
        for a, b in ledges:
            key = (min(mverts[e, a], mverts[e, b]),
                   max(mverts[e, a], mverts[e, b]))
            if key not in edge_index:
                edge_index[key] = len(edge_index)
    n_edges = len(edge_index)
    npe = p - 1

    # MFEM-local reference nodes + interior count (MFEM fe.cpp order)
    nodes = [refv[i] for i in range(len(refv))]
    for a, b in ledges:
        for k in range(1, p):
            nodes.append((1 - op[k]) * refv[a] + op[k] * refv[b])
    interior = []
    if geom == SQUARE:
        for j in range(1, p):
            for i in range(1, p):
                interior.append((op[i], op[j]))
    else:
        # warped barycentric-Lobatto interior lattice (H1_TriangleElement)
        for j in range(1, p):
            for i in range(1, p - j):
                w = op[i] + op[j] + op[p - i - j]
                interior.append((op[i] / w, op[j] / w))
    nodes += [np.asarray(q) for q in interior]
    n_int = len(interior)
    ref_nodes = np.asarray(nodes, dtype=np.float64)

    off_int = nv + n_edges * npe
    n_glob = off_int + ne * n_int
    gids = np.empty((ne, ref_nodes.shape[0]), dtype=np.int64)
    gids[:, : len(refv)] = mverts
    col = len(refv)
    for a, b in ledges:
        va, vb = mverts[:, a], mverts[:, b]
        eid = np.array(
            [edge_index[(min(x, y), max(x, y))] for x, y in zip(va, vb)],
            dtype=np.int64,
        )
        for k in range(npe):
            kk = np.where(va < vb, k, npe - 1 - k)
            gids[:, col + k] = nv + eid * npe + kk
        col += npe
    for k in range(n_int):
        gids[:, col + k] = off_int + np.arange(ne) * n_int + k
    return n_glob, gids, ref_nodes


def _h1_conforming_values(space: FESpace, u: np.ndarray):
    """Global conforming-H1 dof values [n_glob, vdim] by evaluating the
    field's element polynomials at MFEM's H1 node locations (exact)."""
    mesh = space.mesh
    p = space.order
    n_glob, gids, ref_nodes = _h1_conforming_layout(mesh, p)
    # MFEM ref coords == this framework's ref coords (same unit domains),
    # but our corner ordering is lex: basis evaluation needs our frame,
    # which is identical — only the corner NUMBERING differs, already
    # handled through _MFEM_PERM in gids.
    phi = space.elem.eval(ref_nodes)  # [nj, nd]
    us = to_numpy(u).reshape(space.vdim, space.ndof_scalar)
    ue = us[:, space.edof]  # [vdim, ne, nd]
    ev = np.einsum("jd,ved->evj", phi, ue)  # [ne, vdim, nj]
    vals = np.zeros((n_glob, space.vdim))
    vals[gids] = ev.transpose(0, 2, 1)  # conforming: shared dofs agree
    return vals


def _gridfunction_ascii(space: FESpace, u: np.ndarray) -> str:
    """MFEM ASCII grid function at the field's NATIVE order.

    p = 1: conforming H1 P1 vertex values.  p >= 2 H1 on 2D meshes: the
    CONFORMING order-p H1 encoding with MFEM's global dof numbering
    (GLVis reconstructs the space from the mesh).  L2
    spaces and 3D p >= 2: the order-p L2 Gauss-Lobatto encoding —
    per-element values at MFEM's ``L2_T1`` node lattice, exact but
    discontinuously encoded (renders identically)."""
    u = to_numpy(u)
    p = space.order
    dim = space.mesh.dim
    if p <= 1 and space.fe_type == "H1":
        fec = f"H1_{dim}D_P1"
        vals = _corner_values(space, u)  # [nv, vdim]
    elif (space.fe_type == "H1" and dim == 2
          and space.mesh.geom in _MFEM_LOCAL_EDGES):
        fec = f"H1_{dim}D_P{p}"
        vals = _h1_conforming_values(space, u)
    else:
        fec = f"L2_T1_{dim}D_P{p}"
        phi = space.elem.eval(_mfem_l2_nodes(space.mesh.geom, p))  # [nj, nd]
        us = u.reshape(space.vdim, space.ndof_scalar)
        ue = us[:, space.edof]  # [vdim, ne, nd]
        vals = np.einsum("jd,ved->evj", phi, ue)  # [ne, vdim, nj]
        vals = vals.transpose(0, 2, 1).reshape(-1, space.vdim)
    lines = [
        "FiniteElementSpace",
        f"FiniteElementCollection: {fec}",
        f"VDim: {space.vdim}",
        "Ordering: 1",
        "",
    ]
    for row in vals:
        lines.append(" ".join(f"{x:.16g}" for x in row))
    return "\n".join(lines) + "\n"


class GLVis:
    """Multi-window GLVis client: ``append`` fields, ``update`` streams
    every one to its own window."""

    def __init__(self, host: str = "localhost", port: int = 19916,
                 w: int = 400, h: int = 350, max_windows: int = 8):
        self.host, self.port = host, port
        self.w, self.h = w, h
        self._fields: list[tuple[FESpace, str, str]] = []
        self._data: list[np.ndarray] = []
        self._enabled = self._probe()

    def _probe(self) -> bool:
        try:
            with socket.create_connection((self.host, self.port), timeout=0.2):
                return True
        except OSError:
            return False

    def append(self, space: FESpace, u, name: str = "", keys: str = "Rjc"):
        self._fields.append((space, name, keys))
        self._data.append(to_numpy(u))
        return len(self._fields) - 1

    def set_data(self, i: int, u):
        self._data[i] = to_numpy(u)

    def update(self):
        if not self._enabled:
            return
        for i, ((space, name, keys), u) in enumerate(
            zip(self._fields, self._data)
        ):
            try:
                with socket.create_connection(
                    (self.host, self.port), timeout=1.0
                ) as s:
                    msg = (
                        "solution\n"
                        + _mesh_ascii(space.mesh)
                        + _gridfunction_ascii(space, u)
                    )
                    if name:
                        msg += f"window_title '{name}'\n"
                    x = (i % 4) * self.w
                    y = (i // 4) * self.h
                    msg += f"window_geometry {x} {y} {self.w} {self.h}\n"
                    if keys:
                        msg += f"keys {keys}\n"
                    s.sendall(msg.encode())
            except OSError:
                self._enabled = False
                return
