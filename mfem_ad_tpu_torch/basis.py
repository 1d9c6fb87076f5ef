"""Reference finite elements: nodal Lagrange bases and their derivatives.

Host-side numpy tabulation (float64).  Shape tables ``phi [nq, nd]`` and
``dphi [nq, nd, dim]`` are constants captured by jitted assembly kernels —
the TPU-native equivalent of MFEM's ``CalcShape``/``CalcDShape`` calls made
per quadrature point inside the reference's element loop
(the reference library's src/ad_intg.hpp:119-154).

Element node sets:
- segment/square/cube: tensor-product Lagrange on Gauss-Lobatto points
  (matches MFEM's default H1 positive-basis node locations).
- triangle: lattice (equispaced barycentric) Lagrange constructed by
  inverting the Dubiner (PKD) orthogonal Vandermonde — well conditioned for
  the moderate orders (p <= ~8) this library targets.
Local node ordering is lexicographic (x fastest); mesh connectivity uses the
same ordering for corners (see mesh.py).
"""

from __future__ import annotations

import functools

import numpy as np

from .quadrature import (
    CUBE,
    GEOM_DIM,
    SEGMENT,
    SQUARE,
    TETRAHEDRON,
    TRIANGLE,
)


# ---------------------------------------------------------------------------
# 1D building blocks
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def lobatto_points(p: int) -> np.ndarray:
    """p+1 Gauss-Lobatto points on [0,1] (endpoints included)."""
    if p == 0:
        return np.array([0.5])
    if p == 1:
        return np.array([0.0, 1.0])
    leg = np.polynomial.legendre.Legendre.basis(p)
    interior = np.sort(leg.deriv().roots())
    return np.concatenate([[-1.0], interior, [1.0]]) / 2.0 + 0.5


def lagrange_eval(nodes: np.ndarray, x: np.ndarray) -> np.ndarray:
    """Values of the Lagrange basis for ``nodes`` at points ``x``: [nx, nn]."""
    nodes = np.asarray(nodes, dtype=np.float64)
    x = np.asarray(x, dtype=np.float64)
    nn = nodes.size
    out = np.ones((x.size, nn))
    for j in range(nn):
        for k in range(nn):
            if k == j:
                continue
            out[:, j] *= (x - nodes[k]) / (nodes[j] - nodes[k])
    return out


def lagrange_deriv(nodes: np.ndarray, x: np.ndarray) -> np.ndarray:
    """Derivatives of the Lagrange basis at ``x``: [nx, nn]."""
    nodes = np.asarray(nodes, dtype=np.float64)
    x = np.asarray(x, dtype=np.float64)
    nn = nodes.size
    out = np.zeros((x.size, nn))
    for j in range(nn):
        for m in range(nn):
            if m == j:
                continue
            term = np.full(x.shape, 1.0 / (nodes[j] - nodes[m]))
            for k in range(nn):
                if k == j or k == m:
                    continue
                term *= (x - nodes[k]) / (nodes[j] - nodes[k])
            out[:, j] += term
    return out


# ---------------------------------------------------------------------------
# Triangle: Dubiner orthogonal basis and lattice Lagrange via Vandermonde
# ---------------------------------------------------------------------------


def _jacobi(n: int, a: float, b: float, x: np.ndarray) -> np.ndarray:
    """Jacobi polynomial P_n^{a,b}(x) by recurrence (vectorized)."""
    x = np.asarray(x, dtype=np.float64)
    if n == 0:
        return np.ones_like(x)
    p0 = np.ones_like(x)
    p1 = 0.5 * (a - b + (a + b + 2.0) * x)
    if n == 1:
        return p1
    for k in range(1, n):
        k1 = k + 1.0
        c = 2.0 * k1 * (k1 + a + b) * (2 * k + a + b)
        A = (2 * k + a + b + 1.0) * (a * a - b * b)
        Bc = (2 * k + a + b) * (2 * k + a + b + 1.0) * (2 * k + a + b + 2.0)
        C = 2.0 * (k + a) * (k + b) * (2 * k + a + b + 2.0)
        p2 = ((A + Bc * x) * p1 - C * p0) / c
        p0, p1 = p1, p2
    return p1


def _jacobi_deriv(n: int, a: float, b: float, x: np.ndarray) -> np.ndarray:
    if n == 0:
        return np.zeros_like(np.asarray(x, dtype=np.float64))
    return 0.5 * (n + a + b + 1.0) * _jacobi(n - 1, a + 1.0, b + 1.0, x)


def _dubiner(i: int, j: int, x: np.ndarray, y: np.ndarray):
    """Dubiner polynomial psi_{ij} and its (x,y)-gradient on the unit triangle.

    psi_{ij}(x,y) = P_i^{0,0}(a) * (1-y)^i * P_j^{2i+1,0}(b),
    a = 2x/(1-y) - 1, b = 2y - 1.  Total degree i+j.  The collapsed-coordinate
    singularity at y=1 cancels; we evaluate the polynomial-safe forms.
    """
    x = np.asarray(x, dtype=np.float64)
    y = np.asarray(y, dtype=np.float64)
    eta = 1.0 - y
    safe = np.where(np.abs(eta) < 1e-14, 1.0, eta)
    a = 2.0 * x / safe - 1.0
    a = np.where(np.abs(eta) < 1e-14, -1.0, a)  # value irrelevant (×0^i)
    b = 2.0 * y - 1.0

    Pi = _jacobi(i, 0.0, 0.0, a)
    dPi = _jacobi_deriv(i, 0.0, 0.0, a)
    Pj = _jacobi(j, 2.0 * i + 1.0, 0.0, b)
    dPj = _jacobi_deriv(j, 2.0 * i + 1.0, 0.0, b)

    eta_i = eta**i
    eta_im1 = eta ** max(i - 1, 0)

    val = Pi * eta_i * Pj
    # d/dx: dPi/da * (2/eta) * eta^i * Pj = 2 dPi eta^{i-1} Pj   (0 for i=0)
    dx = 2.0 * dPi * eta_im1 * Pj if i > 0 else np.zeros_like(val)
    # d/dy: chain rule through a(y), eta^i, b(y)
    if i > 0:
        dy = (
            dPi * (a + 1.0) * eta_im1 * Pj
            - i * Pi * eta_im1 * Pj
            + 2.0 * Pi * eta_i * dPj
        )
    else:
        dy = 2.0 * Pi * eta_i * dPj
    return val, dx, dy


def _dubiner3(i: int, j: int, k: int, x, y, z):
    """3D Dubiner (PKD) polynomial psi_{ijk} and its gradient on the unit
    tetrahedron {x,y,z >= 0, x+y+z <= 1} (Karniadakis-Sherwin collapsed
    coordinates).  Total degree i+j+k; the singular factors at the
    collapsed edges cancel and we evaluate the polynomial-safe forms, as
    in the 2D `_dubiner`.

    psi = P_i^{0,0}(a) u^i  *  P_j^{2i+1,0}(b) v^j  *  P_k^{2i+2j+2,0}(c)
    with u = 1-y-z, v = 1-z, a = 2x/u - 1, b = 2y/v - 1, c = 2z - 1.
    """
    x = np.asarray(x, dtype=np.float64)
    y = np.asarray(y, dtype=np.float64)
    z = np.asarray(z, dtype=np.float64)
    u = 1.0 - y - z
    v = 1.0 - z
    usafe = np.where(np.abs(u) < 1e-14, 1.0, u)
    a = 2.0 * x / usafe - 1.0
    a = np.where(np.abs(u) < 1e-14, -1.0, a)  # value irrelevant (×u^i)
    vsafe = np.where(np.abs(v) < 1e-14, 1.0, v)
    b = 2.0 * y / vsafe - 1.0
    b = np.where(np.abs(v) < 1e-14, -1.0, b)
    c = 2.0 * z - 1.0

    Pi = _jacobi(i, 0.0, 0.0, a)
    dPi = _jacobi_deriv(i, 0.0, 0.0, a)
    Qj = _jacobi(j, 2.0 * i + 1.0, 0.0, b)
    dQj = _jacobi_deriv(j, 2.0 * i + 1.0, 0.0, b)
    Rk = _jacobi(k, 2.0 * (i + j) + 2.0, 0.0, c)
    dRk = _jacobi_deriv(k, 2.0 * (i + j) + 2.0, 0.0, c)

    u_i = u**i
    u_im1 = u ** max(i - 1, 0)
    v_j = v**j
    v_jm1 = v ** max(j - 1, 0)

    F = Pi * u_i
    G = Qj * v_j
    R = Rk
    val = F * G * R

    zero = np.zeros_like(val)
    # polynomial-safe partials of F(x, u) = P_i(a) u^i  (2x/u = 1+a):
    #   F_x = 2 P_i' u^{i-1};  F_u = (i P_i - (1+a) P_i') u^{i-1}
    Fx = 2.0 * dPi * u_im1 if i > 0 else zero
    Fu = (i * Pi - (1.0 + a) * dPi) * u_im1 if i > 0 else zero
    # and of G(y, v) = Q_j(b) v^j  (2y/v = 1+b)
    Gy = 2.0 * dQj * v_jm1 if j > 0 else zero
    Gv = (j * Qj - (1.0 + b) * dQj) * v_jm1 if j > 0 else zero
    Rz = 2.0 * dRk

    # chain rule through u = 1-y-z (du/dy = du/dz = -1), v = 1-z
    dx = Fx * G * R
    dy = -Fu * G * R + F * Gy * R
    dz = -Fu * G * R - F * Gv * R + F * G * Rz
    return val, dx, dy, dz


def _tet_lattice(p: int) -> np.ndarray:
    """Equispaced lattice nodes on the unit tet, lexicographic in (k,j,i)."""
    if p == 0:
        return np.array([[0.25, 0.25, 0.25]])
    pts = []
    for k in range(p + 1):
        for j in range(p + 1 - k):
            for i in range(p + 1 - k - j):
                pts.append((i / p, j / p, k / p))
    return np.array(pts, dtype=np.float64)


def _tri_lattice(p: int) -> np.ndarray:
    """Equispaced lattice nodes on the unit triangle, lexicographic in (j,i)."""
    if p == 0:
        return np.array([[1.0 / 3.0, 1.0 / 3.0]])
    pts = []
    for j in range(p + 1):
        for i in range(p + 1 - j):
            pts.append((i / p, j / p))
    return np.array(pts, dtype=np.float64)


# ---------------------------------------------------------------------------
# Reference element
# ---------------------------------------------------------------------------


class RefElement:
    """Nodal Lagrange element of order ``p`` on reference geometry ``geom``.

    Attributes:
        nodes: [nd, dim] reference coordinates of the Lagrange nodes.
        ndof:  number of local basis functions.
    Methods ``eval(points) -> [np, nd]`` and ``grad(points) -> [np, nd, dim]``
    tabulate values/reference-gradients at arbitrary reference points.
    """

    def __init__(self, geom: str, p: int):
        if p < 0:
            raise ValueError("order must be >= 0")
        self.geom = geom
        self.p = p
        self.dim = GEOM_DIM[geom]
        if geom in (SEGMENT, SQUARE, CUBE):
            pts1d = lobatto_points(p)
            self._pts1d = pts1d
            n1 = pts1d.size
            if geom == SEGMENT:
                self.nodes = pts1d[:, None].copy()
            elif geom == SQUARE:
                X, Y = np.meshgrid(pts1d, pts1d, indexing="ij")
                # lexicographic, x fastest: node = ix + iy*(p+1)
                self.nodes = np.stack(
                    [X.T.ravel(), Y.T.ravel()], axis=1
                )
            else:
                X, Y, Z = np.meshgrid(pts1d, pts1d, pts1d, indexing="ij")
                self.nodes = np.stack(
                    [
                        np.transpose(X, (2, 1, 0)).ravel(),
                        np.transpose(Y, (2, 1, 0)).ravel(),
                        np.transpose(Z, (2, 1, 0)).ravel(),
                    ],
                    axis=1,
                )
        elif geom == TRIANGLE:
            self.nodes = _tri_lattice(p)
            self._tri_setup()
        elif geom == TETRAHEDRON:
            self.nodes = _tet_lattice(p)
            self._tet_setup()
        else:
            raise ValueError(f"unsupported geometry {geom!r}")
        self.ndof = self.nodes.shape[0]

    # -- triangle: invert Dubiner Vandermonde once --
    def _tri_setup(self):
        p = self.p
        idx = [(i, j) for j in range(p + 1) for i in range(p + 1 - j)]
        if p == 0:
            idx = [(0, 0)]
        self._tri_idx = idx
        n = len(idx)
        V = np.zeros((self.nodes.shape[0], n))
        for c, (i, j) in enumerate(idx):
            V[:, c], _, _ = _dubiner(i, j, self.nodes[:, 0], self.nodes[:, 1])
        self._tri_coeff = np.linalg.inv(V)  # [n_modes, n_nodes]

    # -- tetrahedron: invert 3D Dubiner Vandermonde once --
    def _tet_setup(self):
        p = self.p
        idx = [
            (i, j, k)
            for k in range(p + 1)
            for j in range(p + 1 - k)
            for i in range(p + 1 - k - j)
        ]
        if p == 0:
            idx = [(0, 0, 0)]
        self._tet_idx = idx
        n = len(idx)
        V = np.zeros((self.nodes.shape[0], n))
        for c, (i, j, k) in enumerate(idx):
            V[:, c], _, _, _ = _dubiner3(
                i, j, k, self.nodes[:, 0], self.nodes[:, 1], self.nodes[:, 2]
            )
        self._tet_coeff = np.linalg.inv(V)  # [n_modes, n_nodes]

    def eval(self, points: np.ndarray) -> np.ndarray:
        pts = np.atleast_2d(np.asarray(points, dtype=np.float64))
        if self.geom == SEGMENT:
            return lagrange_eval(self._pts1d, pts[:, 0])
        if self.geom == SQUARE:
            vx = lagrange_eval(self._pts1d, pts[:, 0])
            vy = lagrange_eval(self._pts1d, pts[:, 1])
            return np.einsum("qi,qj->qji", vx, vy).reshape(pts.shape[0], -1)
        if self.geom == CUBE:
            vx = lagrange_eval(self._pts1d, pts[:, 0])
            vy = lagrange_eval(self._pts1d, pts[:, 1])
            vz = lagrange_eval(self._pts1d, pts[:, 2])
            return np.einsum("qi,qj,qk->qkji", vx, vy, vz).reshape(
                pts.shape[0], -1
            )
        if self.geom == TRIANGLE:
            n = len(self._tri_idx)
            V = np.zeros((pts.shape[0], n))
            for c, (i, j) in enumerate(self._tri_idx):
                V[:, c], _, _ = _dubiner(i, j, pts[:, 0], pts[:, 1])
            return V @ self._tri_coeff
        if self.geom == TETRAHEDRON:
            n = len(self._tet_idx)
            V = np.zeros((pts.shape[0], n))
            for c, (i, j, k) in enumerate(self._tet_idx):
                V[:, c], _, _, _ = _dubiner3(
                    i, j, k, pts[:, 0], pts[:, 1], pts[:, 2]
                )
            return V @ self._tet_coeff
        raise AssertionError

    def grad(self, points: np.ndarray) -> np.ndarray:
        pts = np.atleast_2d(np.asarray(points, dtype=np.float64))
        nq = pts.shape[0]
        if self.geom == SEGMENT:
            return lagrange_deriv(self._pts1d, pts[:, 0])[:, :, None]
        if self.geom == SQUARE:
            vx = lagrange_eval(self._pts1d, pts[:, 0])
            vy = lagrange_eval(self._pts1d, pts[:, 1])
            dx = lagrange_deriv(self._pts1d, pts[:, 0])
            dy = lagrange_deriv(self._pts1d, pts[:, 1])
            gx = np.einsum("qi,qj->qji", dx, vy).reshape(nq, -1)
            gy = np.einsum("qi,qj->qji", vx, dy).reshape(nq, -1)
            return np.stack([gx, gy], axis=2)
        if self.geom == CUBE:
            vx = lagrange_eval(self._pts1d, pts[:, 0])
            vy = lagrange_eval(self._pts1d, pts[:, 1])
            vz = lagrange_eval(self._pts1d, pts[:, 2])
            dx = lagrange_deriv(self._pts1d, pts[:, 0])
            dy = lagrange_deriv(self._pts1d, pts[:, 1])
            dz = lagrange_deriv(self._pts1d, pts[:, 2])
            gx = np.einsum("qi,qj,qk->qkji", dx, vy, vz).reshape(nq, -1)
            gy = np.einsum("qi,qj,qk->qkji", vx, dy, vz).reshape(nq, -1)
            gz = np.einsum("qi,qj,qk->qkji", vx, vy, dz).reshape(nq, -1)
            return np.stack([gx, gy, gz], axis=2)
        if self.geom == TRIANGLE:
            n = len(self._tri_idx)
            Gx = np.zeros((nq, n))
            Gy = np.zeros((nq, n))
            for c, (i, j) in enumerate(self._tri_idx):
                _, Gx[:, c], Gy[:, c] = _dubiner(i, j, pts[:, 0], pts[:, 1])
            return np.stack(
                [Gx @ self._tri_coeff, Gy @ self._tri_coeff], axis=2
            )
        if self.geom == TETRAHEDRON:
            n = len(self._tet_idx)
            Gx = np.zeros((nq, n))
            Gy = np.zeros((nq, n))
            Gz = np.zeros((nq, n))
            for c, (i, j, k) in enumerate(self._tet_idx):
                _, Gx[:, c], Gy[:, c], Gz[:, c] = _dubiner3(
                    i, j, k, pts[:, 0], pts[:, 1], pts[:, 2]
                )
            return np.stack(
                [
                    Gx @ self._tet_coeff,
                    Gy @ self._tet_coeff,
                    Gz @ self._tet_coeff,
                ],
                axis=2,
            )
        raise AssertionError


@functools.lru_cache(maxsize=None)
def ref_element(geom: str, p: int) -> RefElement:
    return RefElement(geom, p)
