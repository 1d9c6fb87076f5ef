"""Element geometry factors: Jacobians, physical gradients, quadrature weights.

The batched-array equivalent of MFEM's ``ElementTransformation`` calls made
per quadrature point in the reference's hot loop
(``CalcPhysDShape``/``Tr.Weight()``, reference src/ad_intg.hpp:119-154,
:237): everything is tabulated once per (mesh, rule) as dense
``[n_elem, n_qp, ...]`` arrays that jitted assembly kernels consume.

Host-side numpy float64; the isoparametric map uses the order-1 basis on the
lexicographic corner ordering (see mesh.py), i.e. straight/bi-/tri-linear
elements, which covers every mesh the reference uses.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from .basis import ref_element
from .mesh import Mesh
from .quadrature import IntegrationRule


@dataclass
class GeomFactors:
    xq: np.ndarray  # [ne, nq, dim] physical quadrature points
    jac: np.ndarray  # [ne, nq, dim, dim] J[k,m] = dx_k/dxi_m
    detj: np.ndarray  # [ne, nq]
    invj: np.ndarray  # [ne, nq, dim, dim] J^{-1}
    w: np.ndarray  # [ne, nq] detJ * quadrature weight (Tr.Weight()*ip.weight)


def _det_inv(jac: np.ndarray):
    """Closed-form det+inverse for batched 1x1/2x2/3x3 Jacobians — LAPACK
    per-matrix dispatch is the host-setup bottleneck at millions of qps."""
    d = jac.shape[-1]
    if d == 1:
        det = jac[..., 0, 0]
        inv = 1.0 / jac
        return det, inv
    if d == 2:
        a, b = jac[..., 0, 0], jac[..., 0, 1]
        c, e = jac[..., 1, 0], jac[..., 1, 1]
        det = a * e - b * c
        inv = np.empty_like(jac)
        inv[..., 0, 0] = e
        inv[..., 0, 1] = -b
        inv[..., 1, 0] = -c
        inv[..., 1, 1] = a
        inv /= det[..., None, None]
        return det, inv
    if d == 3:
        m = jac
        c00 = m[..., 1, 1] * m[..., 2, 2] - m[..., 1, 2] * m[..., 2, 1]
        c01 = m[..., 1, 2] * m[..., 2, 0] - m[..., 1, 0] * m[..., 2, 2]
        c02 = m[..., 1, 0] * m[..., 2, 1] - m[..., 1, 1] * m[..., 2, 0]
        det = m[..., 0, 0] * c00 + m[..., 0, 1] * c01 + m[..., 0, 2] * c02
        inv = np.empty_like(m)
        inv[..., 0, 0] = c00
        inv[..., 1, 0] = c01
        inv[..., 2, 0] = c02
        inv[..., 0, 1] = m[..., 0, 2] * m[..., 2, 1] - m[..., 0, 1] * m[..., 2, 2]
        inv[..., 1, 1] = m[..., 0, 0] * m[..., 2, 2] - m[..., 0, 2] * m[..., 2, 0]
        inv[..., 2, 1] = m[..., 0, 1] * m[..., 2, 0] - m[..., 0, 0] * m[..., 2, 1]
        inv[..., 0, 2] = m[..., 0, 1] * m[..., 1, 2] - m[..., 0, 2] * m[..., 1, 1]
        inv[..., 1, 2] = m[..., 0, 2] * m[..., 1, 0] - m[..., 0, 0] * m[..., 1, 2]
        inv[..., 2, 2] = m[..., 0, 0] * m[..., 1, 1] - m[..., 0, 1] * m[..., 1, 0]
        inv /= det[..., None, None]
        return det, inv
    return np.linalg.det(jac), np.linalg.inv(jac)


def geom_factors(mesh: Mesh, ir: IntegrationRule) -> GeomFactors:
    geo = ref_element(mesh.geom, 1)
    N = geo.eval(ir.points)  # [nq, nc]
    dN = geo.grad(ir.points)  # [nq, nc, dim]
    corners = mesh.corner_coords()  # [ne, nc, dim]
    ne = corners.shape[0]
    if mesh.uniform_jacobian and ne > 1:
        # uniform Cartesian: every element has the same (affine) Jacobian —
        # compute it once and expose read-only broadcast views
        jac1 = np.einsum("qcm,eck->eqkm", dN, corners[:1])
        # affine map: x = x0 + J xi, so the qp offsets J xi are one small
        # [nq, dim] product shared by all elements — a broadcast add
        # instead of a [ne, nq, dim] einsum (the multi-million-hex
        # LinearForm setup path)
        xq = corners[:, :1, :] + (ir.points @ jac1[0, 0].T)[None, :, :]
        det1, inv1 = _det_inv(jac1)
        if np.any(det1 <= 0):
            raise ValueError("non-positive element Jacobian")
        w1 = det1 * ir.weights[None, :]
        full = (ne,) + jac1.shape[1:]
        return GeomFactors(
            xq=xq,
            jac=np.broadcast_to(jac1, full),
            detj=np.broadcast_to(det1, full[:2]),
            invj=np.broadcast_to(inv1, full),
            w=np.broadcast_to(w1, full[:2]),
        )
    xq = np.einsum("qc,eck->eqk", N, corners, optimize=True)
    jac = np.einsum("qcm,eck->eqkm", dN, corners, optimize=True)
    detj, invj = _det_inv(jac)
    if np.any(detj <= 0):
        raise ValueError("non-positive element Jacobian (inverted element)")
    w = detj * ir.weights[None, :]
    return GeomFactors(xq=xq, jac=jac, detj=detj, invj=invj, w=w)


def phys_dshape(
    mesh: Mesh, ir: IntegrationRule, order: int, gf: GeomFactors | None = None
) -> np.ndarray:
    """Physical-space shape gradients [ne, nq, nd, dim] (CalcPhysDShape)."""
    if gf is None:
        gf = geom_factors(mesh, ir)
    fe = ref_element(mesh.geom, order)
    dphi = fe.grad(ir.points)  # [nq, nd, m] reference gradients
    ne = gf.invj.shape[0]
    if mesh.uniform_jacobian and ne > 1:
        G1 = np.einsum("qdm,eqmk->eqdk", dphi, gf.invj[:1])
        return np.broadcast_to(G1, (ne,) + G1.shape[1:])
    return np.einsum("qdm,eqmk->eqdk", dphi, gf.invj, optimize=True)
