"""Meshes as plain arrays: vertices, element connectivity, boundary faces.

Covers the reference's mesh usage: ``Mesh::MakeCartesian2D`` (quad at
ex1.cpp:35/ex4.cpp:78, triangle at ex5.cpp:72), ``UniformRefinement``
(ex1.cpp:40), 3D Cartesian hex meshes, and an MFEM v1.0 mesh-file reader for
``data/sloped_rectangle.mesh``.

Corner ordering is lexicographic within each element (x fastest):
quad = [v00, v10, v01, v11], hex = [v000, v100, v010, v110, v001, ...].
This matches the tensor-product basis node ordering in basis.py, so the
order-1 RefElement *is* the geometry map.  MFEM files (counter-clockwise
ordering) are permuted on read.

Boundary attributes follow MFEM's Cartesian conventions:
2D: bottom=1, right=2, top=3, left=4.
3D: z=0 ->1, y=0 ->2, x=1 ->3, y=1 ->4, x=0 ->5, z=1 ->6.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from .quadrature import (
    CUBE,
    GEOM_DIM,
    N_CORNERS,
    SEGMENT,
    SQUARE,
    TETRAHEDRON,
    TRIANGLE,
)

_FACE_GEOM = {
    SEGMENT: None,
    TRIANGLE: SEGMENT,
    SQUARE: SEGMENT,
    CUBE: SQUARE,
    TETRAHEDRON: TRIANGLE,
}


@dataclass
class Mesh:
    geom: str  # element geometry: TRIANGLE | SQUARE | CUBE
    vertices: np.ndarray  # [nv, dim] float64
    elements: np.ndarray  # [ne, n_corners] int32, lexicographic corners
    attributes: np.ndarray  # [ne] int32
    bdr_elements: np.ndarray  # [nbe, n_face_corners] int32
    bdr_attributes: np.ndarray  # [nbe] int32
    # Structured-grid descriptor for Cartesian quad/hex meshes:
    # ("cart2d", nx, ny, sx, sy) or ("cart3d", nx, ny, nz, sx, sy, sz).
    # Enables lexicographic dof numbering + the slice-based (gather-free)
    # assembly fast path in integrator.py — TPU gathers of scalars are
    # ~100x slower than strided slices.
    structured: tuple | None = field(default=None, compare=False)

    @property
    def dim(self) -> int:
        return GEOM_DIM[self.geom]

    @property
    def uniform_jacobian(self) -> bool:
        """True when every element shares one affine Jacobian (structured
        quad/hex).  Structured TRIANGLE meshes are lexicographic too (the
        fast dof exchange applies) but alternate between two orientations
        with different Jacobians, so element-invariant geometry shortcuts
        must not fire for them."""
        return self.structured is not None and self.geom in (SQUARE, CUBE)

    @property
    def num_elements(self) -> int:
        return self.elements.shape[0]

    @property
    def num_vertices(self) -> int:
        return self.vertices.shape[0]

    @property
    def face_geom(self) -> str:
        return _FACE_GEOM[self.geom]

    def corner_coords(self) -> np.ndarray:
        """[ne, n_corners, dim] coordinates of element corners."""
        return self.vertices[self.elements]

    def bdr_corner_coords(self) -> np.ndarray:
        return self.vertices[self.bdr_elements]

    def max_bdr_attribute(self) -> int:
        return int(self.bdr_attributes.max()) if self.bdr_attributes.size else 0

    def uniform_refine(self, times: int = 1) -> "Mesh":
        m = self
        for _ in range(times):
            if m.structured is not None and m.structured[0] == "cart2d":
                _, nx, ny, sx, sy = m.structured
                m = make_cartesian_2d(2 * nx, 2 * ny, m.geom, sx, sy)
            elif m.structured is not None and m.structured[0] == "cart3d":
                _, nx, ny, nz, sx, sy, sz = m.structured
                m = make_cartesian_3d(2 * nx, 2 * ny, 2 * nz, sx, sy, sz)
            else:
                m = _refine_once(m)
        return m


# ---------------------------------------------------------------------------
# Cartesian constructors (MakeCartesian2D / MakeCartesian3D analogues)
# ---------------------------------------------------------------------------


def make_cartesian_2d(
    nx: int, ny: int, geom: str = SQUARE, sx: float = 1.0, sy: float = 1.0
) -> Mesh:
    xs = np.linspace(0.0, sx, nx + 1)
    ys = np.linspace(0.0, sy, ny + 1)
    X, Y = np.meshgrid(xs, ys, indexing="xy")  # vid = i + j*(nx+1)
    vertices = np.stack([X.ravel(), Y.ravel()], axis=1)

    def vid(i, j):
        return i + j * (nx + 1)

    I, J = np.meshgrid(np.arange(nx), np.arange(ny), indexing="xy")
    I, J = I.ravel(), J.ravel()
    v00, v10 = vid(I, J), vid(I + 1, J)
    v01, v11 = vid(I, J + 1), vid(I + 1, J + 1)

    if geom == SQUARE:
        elements = np.stack([v00, v10, v01, v11], axis=1)
    elif geom == TRIANGLE:
        # split each cell along the SW-NE diagonal: (v00,v10,v11),(v00,v11,v01)
        t0 = np.stack([v00, v10, v11], axis=1)
        t1 = np.stack([v00, v11, v01], axis=1)
        elements = np.concatenate(
            [np.stack([a, b], axis=1) for a, b in [(t0, t1)]], axis=0
        ).reshape(-1, 3)
    else:
        raise ValueError("2D geometry must be SQUARE or TRIANGLE")

    bdr, battr = [], []
    i = np.arange(nx)
    j = np.arange(ny)
    bdr.append(np.stack([vid(i, 0), vid(i + 1, 0)], axis=1))  # bottom
    battr.append(np.full(nx, 1))
    bdr.append(np.stack([vid(nx, j), vid(nx, j + 1)], axis=1))  # right
    battr.append(np.full(ny, 2))
    bdr.append(np.stack([vid(i, ny), vid(i + 1, ny)], axis=1))  # top
    battr.append(np.full(nx, 3))
    bdr.append(np.stack([vid(0, j), vid(0, j + 1)], axis=1))  # left
    battr.append(np.full(ny, 4))

    return Mesh(
        geom=geom,
        vertices=vertices,
        elements=elements.astype(np.int32),
        attributes=np.ones(elements.shape[0], dtype=np.int32),
        bdr_elements=np.concatenate(bdr).astype(np.int32),
        bdr_attributes=np.concatenate(battr).astype(np.int32),
        structured=("cart2d", nx, ny, sx, sy),
    )


def make_cartesian_3d(
    nx: int,
    ny: int,
    nz: int,
    sx: float = 1.0,
    sy: float = 1.0,
    sz: float = 1.0,
    geom: str = CUBE,
) -> Mesh:
    xs = np.linspace(0.0, sx, nx + 1)
    ys = np.linspace(0.0, sy, ny + 1)
    zs = np.linspace(0.0, sz, nz + 1)
    X, Y, Z = np.meshgrid(xs, ys, zs, indexing="ij")
    # vid = i + j*(nx+1) + k*(nx+1)*(ny+1)
    vertices = np.stack(
        [
            np.transpose(X, (2, 1, 0)).ravel(),
            np.transpose(Y, (2, 1, 0)).ravel(),
            np.transpose(Z, (2, 1, 0)).ravel(),
        ],
        axis=1,
    )

    def vid(i, j, k):
        return i + j * (nx + 1) + k * (nx + 1) * (ny + 1)

    I, J, K = np.meshgrid(
        np.arange(nx), np.arange(ny), np.arange(nz), indexing="ij"
    )
    I, J, K = I.ravel(), J.ravel(), K.ravel()
    if geom == CUBE:
        elements = np.stack(
            [
                vid(I, J, K),
                vid(I + 1, J, K),
                vid(I, J + 1, K),
                vid(I + 1, J + 1, K),
                vid(I, J, K + 1),
                vid(I + 1, J, K + 1),
                vid(I, J + 1, K + 1),
                vid(I + 1, J + 1, K + 1),
            ],
            axis=1,
        )
    elif geom == TETRAHEDRON:
        # Kuhn triangulation: 6 tets per cube, all sharing the main
        # diagonal (i,j,k)-(i+1,j+1,k+1); neighbor cubes induce identical
        # face diagonals, so the triangulation is conforming.  Vertex
        # orders are positively oriented (dets verified in tests).
        c = {
            (a, b, d): vid(I + a, J + b, K + d)
            for a in (0, 1) for b in (0, 1) for d in (0, 1)
        }
        kuhn = [
            # walk x,y,z / x,z,y / ... with odd permutations swapped to
            # keep det > 0
            ((0, 0, 0), (1, 0, 0), (1, 1, 0), (1, 1, 1)),
            ((0, 0, 0), (1, 0, 1), (1, 0, 0), (1, 1, 1)),
            ((0, 0, 0), (1, 1, 0), (0, 1, 0), (1, 1, 1)),
            ((0, 0, 0), (0, 1, 0), (0, 1, 1), (1, 1, 1)),
            ((0, 0, 0), (0, 0, 1), (1, 0, 1), (1, 1, 1)),
            ((0, 0, 0), (0, 1, 1), (0, 0, 1), (1, 1, 1)),
        ]
        elements = np.concatenate(
            [np.stack([c[v] for v in t], axis=1) for t in kuhn], axis=0
        )
    else:
        raise ValueError("3D geometry must be CUBE or TETRAHEDRON")

    bdr, battr = [], []

    def quad_face(a, b, c, d, attr, n):
        if geom == TETRAHEDRON:
            # split along the a-d diagonal — the one the Kuhn
            # triangulation induces on every axis-aligned cell face
            bdr.append(np.stack([a, b, d], axis=1))
            bdr.append(np.stack([a, d, c], axis=1))
            battr.append(np.full(2 * n, attr))
            return
        bdr.append(np.stack([a, b, c, d], axis=1))
        battr.append(np.full(n, attr))

    I2, J2 = [g.ravel() for g in np.meshgrid(np.arange(nx), np.arange(ny), indexing="ij")]
    quad_face(vid(I2, J2, 0), vid(I2 + 1, J2, 0), vid(I2, J2 + 1, 0), vid(I2 + 1, J2 + 1, 0), 1, I2.size)
    quad_face(vid(I2, J2, nz), vid(I2 + 1, J2, nz), vid(I2, J2 + 1, nz), vid(I2 + 1, J2 + 1, nz), 6, I2.size)
    I2, K2 = [g.ravel() for g in np.meshgrid(np.arange(nx), np.arange(nz), indexing="ij")]
    quad_face(vid(I2, 0, K2), vid(I2 + 1, 0, K2), vid(I2, 0, K2 + 1), vid(I2 + 1, 0, K2 + 1), 2, I2.size)
    quad_face(vid(I2, ny, K2), vid(I2 + 1, ny, K2), vid(I2, ny, K2 + 1), vid(I2 + 1, ny, K2 + 1), 4, I2.size)
    J2, K2 = [g.ravel() for g in np.meshgrid(np.arange(ny), np.arange(nz), indexing="ij")]
    quad_face(vid(0, J2, K2), vid(0, J2 + 1, K2), vid(0, J2, K2 + 1), vid(0, J2 + 1, K2 + 1), 5, J2.size)
    quad_face(vid(nx, J2, K2), vid(nx, J2 + 1, K2), vid(nx, J2, K2 + 1), vid(nx, J2 + 1, K2 + 1), 3, J2.size)

    return Mesh(
        geom=geom,
        vertices=vertices,
        elements=elements.astype(np.int32),
        attributes=np.ones(elements.shape[0], dtype=np.int32),
        bdr_elements=np.concatenate(bdr).astype(np.int32),
        bdr_attributes=np.concatenate(battr).astype(np.int32),
        structured=(
            ("cart3d", nx, ny, nz, sx, sy, sz) if geom == CUBE else None
        ),
    )


def spatial_sort(m: Mesh) -> Mesh:
    """Reorder elements along a Morton (Z-order) curve of their centroids.

    Unstructured assembly cost on TPU is dominated by the edof gather and
    the valence-transpose scatter (BENCH_SWEEP round 4: 1.95 + 4.65 ms of
    a 4.6/7.0 ms pass at 196k triangles); uniform refinement emits
    children grouped BY CHILD TYPE (4 parent-sized tiles), so consecutive
    elements touch dofs a quarter-mesh apart.  Morton ordering makes
    consecutive elements neighbors, and FESpace's first-touch dof relabel
    (fespace.py) then makes their dof indices near-contiguous — the
    locality the reference gets implicitly from MFEM's ordering
    (ad_intg.hpp:157-199 pays no mesh-dependent penalty).  Structured
    meshes keep their lexicographic order (the slice fast paths depend
    on it)."""
    if m.structured is not None:
        return m
    cen = m.vertices[m.elements].mean(axis=1)  # [ne, dim]
    lo, hi = cen.min(axis=0), cen.max(axis=0)
    span = np.where(hi > lo, hi - lo, 1.0)
    bits = 16 if m.dim == 3 else 24
    q = np.clip(
        ((cen - lo) / span * ((1 << bits) - 1)).astype(np.uint64),
        0, (1 << bits) - 1,
    )

    def interleave(v, d, nd):
        out = np.zeros(v.shape[0], dtype=np.uint64)
        for b in range(bits):
            out |= ((v >> np.uint64(b)) & np.uint64(1)) << np.uint64(
                b * nd + d
            )
        return out

    code = np.zeros(m.num_elements, dtype=np.uint64)
    for d in range(m.dim):
        code |= interleave(q[:, d], d, m.dim)
    perm = np.argsort(code, kind="stable")
    return Mesh(
        geom=m.geom,
        vertices=m.vertices,
        elements=m.elements[perm],
        attributes=m.attributes[perm],
        bdr_elements=m.bdr_elements,
        bdr_attributes=m.bdr_attributes,
        structured=None,
    )


# ---------------------------------------------------------------------------
# Uniform refinement
# ---------------------------------------------------------------------------


def _unique_rows(*groups):
    """Unique sorted rows over concatenated groups.

    Returns (unique_rows, inv_group0, inv_group1, ...): each inverse maps a
    group's rows to indices into unique_rows.  Used to number mesh entities
    (edges/faces) consistently between element and boundary connectivity.
    """
    from .native import unique_rows as _native_unique

    all_rows = np.concatenate(groups, axis=0)
    srt = np.sort(all_rows, axis=1)
    uniq, inv = _native_unique(srt)
    inv = np.asarray(inv).ravel()
    out = [uniq]
    off = 0
    for g in groups:
        out.append(inv[off : off + g.shape[0]])
        off += g.shape[0]
    return tuple(out)


def _refine_once(m: Mesh) -> Mesh:
    nv = m.num_vertices
    if m.geom == TRIANGLE:
        e = m.elements
        edges = np.concatenate(
            [e[:, [0, 1]], e[:, [1, 2]], e[:, [0, 2]]], axis=0
        )
        uniq, inv, binv = _unique_rows(edges, m.bdr_elements)
        mid = nv + inv.reshape(3, -1)  # [3, ne]: m01, m12, m02
        new_v = np.concatenate([m.vertices, m.vertices[uniq].mean(axis=1)])
        a, b, c = e[:, 0], e[:, 1], e[:, 2]
        m01, m12, m02 = mid
        children = np.concatenate(
            [
                np.stack([a, m01, m02], axis=1),
                np.stack([m01, b, m12], axis=1),
                np.stack([m02, m12, c], axis=1),
                np.stack([m01, m12, m02], axis=1),
            ],
            axis=0,
        )
        attrs = np.tile(m.attributes, 4)
        bm = nv + binv
        new_bdr = np.concatenate(
            [
                np.stack([m.bdr_elements[:, 0], bm], axis=1),
                np.stack([bm, m.bdr_elements[:, 1]], axis=1),
            ],
            axis=0,
        )
        new_battr = np.tile(m.bdr_attributes, 2)
    elif m.geom == TETRAHEDRON:
        e = m.elements  # [v0, v1, v2, v3]
        edge_pairs = [(0, 1), (0, 2), (0, 3), (1, 2), (1, 3), (2, 3)]
        bedges = np.concatenate(
            [m.bdr_elements[:, [0, 1]], m.bdr_elements[:, [0, 2]],
             m.bdr_elements[:, [1, 2]]], axis=0,
        )
        edges = np.concatenate([e[:, list(p)] for p in edge_pairs], axis=0)
        uniq, inv, binv = _unique_rows(edges, bedges)
        mid = nv + inv.reshape(6, -1)  # m01, m02, m03, m12, m13, m23
        new_v = np.concatenate([m.vertices, m.vertices[uniq].mean(axis=1)])
        v0, v1, v2, v3 = e.T
        m01, m02, m03, m12, m13, m23 = mid
        # Bey red refinement: 4 corner tets + octahedron split along the
        # m02-m13 diagonal; orders keep children positively oriented
        # (each child det = parent det / 8, verified in tests).
        children = np.concatenate(
            [
                np.stack(t, axis=1)
                for t in [
                    (v0, m01, m02, m03),
                    (m01, v1, m12, m13),
                    (m02, m12, v2, m23),
                    (m03, m13, m23, v3),
                    (m01, m02, m03, m13),
                    (m01, m02, m13, m12),
                    (m02, m03, m13, m23),
                    (m02, m12, m23, m13),
                ]
            ],
            axis=0,
        )
        attrs = np.tile(m.attributes, 8)
        nbe = m.bdr_elements.shape[0]
        bm = (nv + binv).reshape(3, nbe)  # mab, mac, mbc
        a, b, c = m.bdr_elements.T
        mab, mac, mbc = bm
        new_bdr = np.concatenate(
            [
                np.stack([a, mab, mac], axis=1),
                np.stack([mab, b, mbc], axis=1),
                np.stack([mac, mbc, c], axis=1),
                np.stack([mab, mbc, mac], axis=1),
            ],
            axis=0,
        )
        new_battr = np.tile(m.bdr_attributes, 4)
    elif m.geom == SQUARE:
        e = m.elements  # [v00, v10, v01, v11]
        edges = np.concatenate(
            [e[:, [0, 1]], e[:, [2, 3]], e[:, [0, 2]], e[:, [1, 3]]], axis=0
        )
        uniq, inv, binv = _unique_rows(edges, m.bdr_elements)
        ne = e.shape[0]
        mid = nv + inv.reshape(4, ne)  # bottom, top, left, right midpoints
        ctr = nv + uniq.shape[0] + np.arange(ne)
        new_v = np.concatenate(
            [
                m.vertices,
                m.vertices[uniq].mean(axis=1),
                m.vertices[e].mean(axis=1),
            ]
        )
        v00, v10, v01, v11 = e.T
        mb, mt, ml, mr = mid
        children = np.concatenate(
            [
                np.stack([v00, mb, ml, ctr], axis=1),
                np.stack([mb, v10, ctr, mr], axis=1),
                np.stack([ml, ctr, v01, mt], axis=1),
                np.stack([ctr, mr, mt, v11], axis=1),
            ],
            axis=0,
        )
        attrs = np.tile(m.attributes, 4)
        bm = nv + binv
        new_bdr = np.concatenate(
            [
                np.stack([m.bdr_elements[:, 0], bm], axis=1),
                np.stack([bm, m.bdr_elements[:, 1]], axis=1),
            ],
            axis=0,
        )
        new_battr = np.tile(m.bdr_attributes, 2)
    elif m.geom == CUBE:
        e = m.elements  # lex [v000,v100,v010,v110,v001,v101,v011,v111]
        ne = e.shape[0]
        # 12 edges as (lo,hi) lex corner index pairs
        edge_pairs = [
            (0, 1), (2, 3), (4, 5), (6, 7),  # x-edges
            (0, 2), (1, 3), (4, 6), (5, 7),  # y-edges
            (0, 4), (1, 5), (2, 6), (3, 7),  # z-edges
        ]
        be = m.bdr_elements
        nbe = be.shape[0]
        edges = np.concatenate([e[:, list(p)] for p in edge_pairs], axis=0)
        bedges = np.concatenate(
            [be[:, [0, 1]], be[:, [2, 3]], be[:, [0, 2]], be[:, [1, 3]]],
            axis=0,
        )
        uniq_e, inv_e, binv_e = _unique_rows(edges, bedges)
        edge_id = nv + inv_e.reshape(len(edge_pairs), ne)
        bedge_id = nv + binv_e.reshape(4, nbe)  # mab, mcd, mac, mbd
        # 6 faces as lex corner quadruples
        face_quads = [
            (0, 1, 2, 3), (4, 5, 6, 7),  # z=0, z=1
            (0, 1, 4, 5), (2, 3, 6, 7),  # y=0, y=1
            (0, 2, 4, 6), (1, 3, 5, 7),  # x=0, x=1
        ]
        faces = np.concatenate([e[:, list(q)] for q in face_quads], axis=0)
        uniq_f, inv_f, binv_f = _unique_rows(faces, be)
        face_id = nv + uniq_e.shape[0] + inv_f.reshape(len(face_quads), ne)
        ctr = nv + uniq_e.shape[0] + uniq_f.shape[0] + np.arange(ne)
        new_v = np.concatenate(
            [
                m.vertices,
                m.vertices[uniq_e].mean(axis=1),
                m.vertices[uniq_f].mean(axis=1),
                m.vertices[e].mean(axis=1),
            ]
        )
        # 3x3x3 lattice of point ids per element
        lat = np.empty((ne, 3, 3, 3), dtype=np.int64)
        for ci, (i, j, k) in enumerate(
            [(a, b, c) for c in (0, 2) for b in (0, 2) for a in (0, 2)]
        ):
            lat[:, i, j, k] = e[:, ci]
        # x-edges: midpoints at (1, j, k) with (j,k) in lex of corner pairs
        for n_, (j, k) in zip(range(4), [(0, 0), (2, 0), (0, 2), (2, 2)]):
            lat[:, 1, j, k] = edge_id[n_]
        for n_, (i, k) in zip(range(4, 8), [(0, 0), (2, 0), (0, 2), (2, 2)]):
            lat[:, i, 1, k] = edge_id[n_]
        for n_, (i, j) in zip(range(8, 12), [(0, 0), (2, 0), (0, 2), (2, 2)]):
            lat[:, i, j, 1] = edge_id[n_]
        for n_, (axis, pos) in zip(
            range(6), [(2, 0), (2, 2), (1, 0), (1, 2), (0, 0), (0, 2)]
        ):
            idx = [1, 1, 1]
            idx[axis] = pos
            lat[:, idx[0], idx[1], idx[2]] = face_id[n_]
        lat[:, 1, 1, 1] = ctr
        kids = []
        for ck in (0, 1):
            for cj in (0, 1):
                for ci in (0, 1):
                    sub = lat[:, ci : ci + 2, cj : cj + 2, ck : ck + 2]
                    # lex corner order within child
                    kids.append(
                        np.stack(
                            [
                                sub[:, 0, 0, 0], sub[:, 1, 0, 0],
                                sub[:, 0, 1, 0], sub[:, 1, 1, 0],
                                sub[:, 0, 0, 1], sub[:, 1, 0, 1],
                                sub[:, 0, 1, 1], sub[:, 1, 1, 1],
                            ],
                            axis=1,
                        )
                    )
        children = np.concatenate(kids, axis=0)
        attrs = np.tile(m.attributes, 8)
        # boundary quads [a,b,c,d] lex -> 4 children
        mab, mcd, mac, mbd = bedge_id
        fc = nv + uniq_e.shape[0] + binv_f
        new_bdr = np.concatenate(
            [
                np.stack([be[:, 0], mab, mac, fc], axis=1),
                np.stack([mab, be[:, 1], fc, mbd], axis=1),
                np.stack([mac, fc, be[:, 2], mcd], axis=1),
                np.stack([fc, mbd, mcd, be[:, 3]], axis=1),
            ],
            axis=0,
        )
        new_battr = np.tile(m.bdr_attributes, 4)
    else:
        raise ValueError(f"cannot refine geometry {m.geom!r}")

    return Mesh(
        geom=m.geom,
        vertices=new_v,
        elements=children.astype(np.int32),
        attributes=attrs.astype(np.int32),
        bdr_elements=new_bdr.astype(np.int32),
        bdr_attributes=new_battr.astype(np.int32),
    )


# ---------------------------------------------------------------------------
# MFEM v1.0 mesh-file reader (covers data/sloped_rectangle.mesh)
# ---------------------------------------------------------------------------

_MFEM_GEOM = {2: TRIANGLE, 3: SQUARE, 4: TETRAHEDRON, 5: CUBE}
# permutation MFEM (counter-clockwise) -> lexicographic corners
_MFEM_PERM = {
    TRIANGLE: [0, 1, 2],
    SQUARE: [0, 1, 3, 2],
    TETRAHEDRON: [0, 1, 2, 3],
    CUBE: [0, 1, 3, 2, 4, 5, 7, 6],
}
_MFEM_BDR_PERM = {1: [0, 1], 3: [0, 1, 3, 2]}


def read_mfem_mesh(path: str) -> Mesh:
    """Parse an MFEM v1.0 ASCII mesh (straight elements)."""
    with open(path) as f:
        tokens = []
        for line in f:
            line = line.split("#")[0].strip()
            if line:
                tokens.append(line)
    it = iter(tokens)

    def until(section):
        for t in it:
            if t == section:
                return
        raise ValueError(f"section {section!r} not found")

    until("dimension")
    dim = int(next(it))
    until("elements")
    ne = int(next(it))
    elems, attrs, geom = [], [], None
    for _ in range(ne):
        parts = next(it).split()
        attr, gtype = int(parts[0]), int(parts[1])
        geom = _MFEM_GEOM[gtype]
        verts = [int(v) for v in parts[2:]]
        elems.append([verts[i] for i in _MFEM_PERM[geom]])
        attrs.append(attr)
    until("boundary")
    nbe = int(next(it))
    bels, battrs = [], []
    for _ in range(nbe):
        parts = next(it).split()
        attr, gtype = int(parts[0]), int(parts[1])
        verts = [int(v) for v in parts[2:]]
        if gtype in (1, 3):
            verts = [verts[i] for i in _MFEM_BDR_PERM[gtype]]
        bels.append(verts)
        battrs.append(attr)
    until("vertices")
    nv = int(next(it))
    vdim_tok = next(it)
    vdim = int(vdim_tok)
    coords = []
    for _ in range(nv):
        coords.append([float(x) for x in next(it).split()])
    vertices = np.asarray(coords, dtype=np.float64)[:, :dim]

    return Mesh(
        geom=geom,
        vertices=vertices,
        elements=np.asarray(elems, dtype=np.int32),
        attributes=np.asarray(attrs, dtype=np.int32),
        bdr_elements=np.asarray(bels, dtype=np.int32),
        bdr_attributes=np.asarray(battrs, dtype=np.int32),
    )
