"""Quadrature rules on reference elements.

Host-side (numpy, float64) tabulation; the resulting point/weight arrays are
constants baked into jitted assembly code.

Parity notes (reference = dohyun-cse/mfem-ad):
- The reference delegates to MFEM ``IntRules.Get(geom, order)``; the AD
  integrators default to order ``2*p + 2`` (src/_ad_intg.hpp:104,:312).
- Reference domains: MFEM's reference square/cube is [0,1]^d and the
  reference triangle is {x,y >= 0, x+y <= 1}; we use the same so nodal
  coordinates and rules are directly comparable.
"""

from __future__ import annotations

import functools

import numpy as np

SEGMENT = "segment"
TRIANGLE = "triangle"
SQUARE = "square"
CUBE = "cube"
TETRAHEDRON = "tetrahedron"

# number of element corners per geometry
N_CORNERS = {SEGMENT: 2, TRIANGLE: 3, SQUARE: 4, CUBE: 8, TETRAHEDRON: 4}
GEOM_DIM = {SEGMENT: 1, TRIANGLE: 2, SQUARE: 2, CUBE: 3, TETRAHEDRON: 3}


def gauss_legendre_01(n: int) -> tuple[np.ndarray, np.ndarray]:
    """n-point Gauss-Legendre rule on [0,1] (exact for degree 2n-1)."""
    x, w = np.polynomial.legendre.leggauss(n)
    return (x + 1.0) / 2.0, w / 2.0


def gauss_jacobi(n: int, alpha: float, beta: float) -> tuple[np.ndarray, np.ndarray]:
    """n-point Gauss-Jacobi rule on [-1,1] with weight (1-x)^a (1+x)^b.

    Golub–Welsch on the symmetric Jacobi recurrence.  Used for the collapsed
    (Duffy) triangle rule; no scipy in this environment.
    """
    a, b = float(alpha), float(beta)
    k = np.arange(n, dtype=np.float64)
    # recurrence x p_k = p_{k+1} + A_k p_k + B_k p_{k-1}
    apb = a + b
    A = np.where(
        (2 * k + apb) * (2 * k + apb + 2) == 0.0,
        (b - a) / max(apb + 2.0, 1e-300) if n > 0 else 0.0,
        (b * b - a * a) / np.maximum((2 * k + apb) * (2 * k + apb + 2), 1e-300),
    )
    if apb == 0.0 or apb == -1.0:
        A[0] = (b - a) / (apb + 2.0)
    kk = k[1:]
    B = (
        4.0
        * kk
        * (kk + a)
        * (kk + b)
        * (kk + apb)
        / ((2 * kk + apb) ** 2 * (2 * kk + apb + 1.0) * (2 * kk + apb - 1.0))
    )
    J = np.diag(A) + np.diag(np.sqrt(B), 1) + np.diag(np.sqrt(B), -1)
    x, V = np.linalg.eigh(J)
    mu0 = 2.0 ** (apb + 1.0) * _beta_fn(a + 1.0, b + 1.0)
    w = mu0 * V[0, :] ** 2
    return x, w


def _beta_fn(x: float, y: float) -> float:
    import math

    return math.exp(math.lgamma(x) + math.lgamma(y) - math.lgamma(x + y))


class IntegrationRule:
    """Points [nq, dim] and weights [nq] on a reference geometry."""

    def __init__(self, geom: str, points: np.ndarray, weights: np.ndarray,
                 order: int = 0):
        self.geom = geom
        self.points = np.asarray(points, dtype=np.float64)
        self.weights = np.asarray(weights, dtype=np.float64)
        self.order = order  # polynomial exactness the rule was built for
        if self.points.ndim == 1:
            self.points = self.points[:, None]

    @property
    def npoints(self) -> int:
        return self.points.shape[0]

    def __repr__(self):
        return f"IntegrationRule({self.geom}, nq={self.npoints})"


@functools.lru_cache(maxsize=None)
def get_rule(geom: str, order: int) -> IntegrationRule:
    """A rule on ``geom`` exact for polynomials of total degree ``order``.

    Mirrors MFEM's ``IntRules.Get(geometry, order)`` contract used at
    reference ex4.cpp:104 and src/_ad_intg.hpp:99-105.
    """
    order = max(int(order), 0)
    n1 = order // 2 + 1  # GL exactness 2*n1-1 >= order
    if geom == SEGMENT:
        x, w = gauss_legendre_01(n1)
        return IntegrationRule(geom, x[:, None], w, order=order)
    if geom == SQUARE:
        x, w = gauss_legendre_01(n1)
        X, Y = np.meshgrid(x, x, indexing="ij")
        W = np.outer(w, w)
        pts = np.stack([X.ravel(), Y.ravel()], axis=1)
        return IntegrationRule(geom, pts, W.ravel(), order=order)
    if geom == CUBE:
        x, w = gauss_legendre_01(n1)
        X, Y, Z = np.meshgrid(x, x, x, indexing="ij")
        W = np.einsum("i,j,k->ijk", w, w, w)
        pts = np.stack([X.ravel(), Y.ravel(), Z.ravel()], axis=1)
        return IntegrationRule(geom, pts, W.ravel(), order=order)
    if geom == TRIANGLE:
        # Duffy/collapsed rule: GL in 'a', Gauss-Jacobi(1,0) in 'b'.
        # x = (1+a)(1-b)/4, y = (1+b)/2 maps [-1,1]^2 -> unit triangle; the
        # Jacobian (1-b)/8 is absorbed exactly by the Jacobi weight.
        xa, wa = np.polynomial.legendre.leggauss(n1)
        xb, wb = gauss_jacobi(n1, 1.0, 0.0)
        A, B = np.meshgrid(xa, xb, indexing="ij")
        X = (1.0 + A) * (1.0 - B) / 4.0
        Y = (1.0 + B) / 2.0
        W = np.outer(wa, wb) / 8.0
        pts = np.stack([X.ravel(), Y.ravel()], axis=1)
        return IntegrationRule(geom, pts, W.ravel(), order=order)
    if geom == TETRAHEDRON:
        # Collapsed rule on the unit tet {x,y,z >= 0, x+y+z <= 1}:
        # GL in 'a', Gauss-Jacobi(1,0) in 'b', Gauss-Jacobi(2,0) in 'c';
        # x = (1+a)(1-b)(1-c)/8, y = (1+b)(1-c)/4, z = (1+c)/2 maps
        # [-1,1]^3 -> tet with Jacobian (1-b)(1-c)^2/64, absorbed exactly
        # by the (1-b)/(1-c)^2 Jacobi weights.
        xa, wa = np.polynomial.legendre.leggauss(n1)
        xb, wb = gauss_jacobi(n1, 1.0, 0.0)
        xc, wc = gauss_jacobi(n1, 2.0, 0.0)
        A, B, C = np.meshgrid(xa, xb, xc, indexing="ij")
        X = (1.0 + A) * (1.0 - B) * (1.0 - C) / 8.0
        Y = (1.0 + B) * (1.0 - C) / 4.0
        Z = (1.0 + C) / 2.0
        W = np.einsum("i,j,k->ijk", wa, wb, wc) / 64.0
        pts = np.stack([X.ravel(), Y.ravel(), Z.ravel()], axis=1)
        return IntegrationRule(geom, pts, W.ravel(), order=order)
    raise ValueError(f"unknown geometry {geom!r}")


def default_ad_order(order: int) -> int:
    """Default quadrature order for AD integrators: 2p+2 (_ad_intg.hpp:104)."""
    return 2 * order + 2
