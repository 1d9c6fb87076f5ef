"""ADEval input specification: which FE quantities feed the energy.

Mirrors the reference's compile-time flag enum (src/_ad_intg.hpp:24-66) and
the shape-matrix layout of ``InitInputShapes`` (src/ad_intg.hpp:69-116):
per space the per-qp input segment is laid out as

    [qvalue (1) | value (1) | grad (sdim) | div (1) | curl]

and for vector unknowns (VECTOR, vdim>1) the segment repeats per component,
component-major — so e.g. GRAD|VECTOR in 2D yields
``x[i*dim + j] = d u_i / d x_j``, the layout LinearElasticityEnergy expects
(ad_native.hpp:550-565).

Here the "shape matrix" becomes a dense batched tensor
``B [n_elem, n_qp, n_dof, shapedim]`` built once per (space, rule); the
per-qp input is ``x = B^T u_e`` computed as a batched einsum.
"""

from __future__ import annotations

import enum

import numpy as np

from .fespace import FESpace
from .geometry import GeomFactors, phys_dshape
from .quadrature import IntegrationRule


class ADEval(enum.IntFlag):
    NONE = 0
    QVALUE = 1 << 0  # identity at the quadrature point (QuadratureSpace dof)
    VALUE = 1 << 1
    GRAD = 1 << 2
    DIV = 1 << 3
    CURL = 1 << 4
    HESSIAN = 1 << 5  # declared invalid in the reference (_ad_intg.hpp:45)
    VECTOR = 1 << 6  # vdim > 1 scalar FE
    VECFE = 1 << 7  # vector FE — reference marks "not yet implemented"


def is_valid_adeval(mode: ADEval) -> bool:
    """Validity rules of the reference's isValidADEval (_ad_intg.hpp:52-66):
    HESSIAN is rejected; QVALUE may only be combined with VECTOR."""
    if mode & ADEval.HESSIAN:
        return False
    if mode & ADEval.QVALUE and mode & ~(ADEval.QVALUE | ADEval.VECTOR):
        return False
    return True


def shapedim(mode: ADEval, sdim: int) -> int:
    """Per-component input width (reference InitInputShapes idx[] layout)."""
    n = 0
    if mode & ADEval.QVALUE:
        n += 1
    if mode & ADEval.VALUE:
        n += 1
    if mode & ADEval.GRAD:
        n += sdim
    if mode & ADEval.DIV:
        n += 1
    if mode & ADEval.CURL:
        # 2D scalar-FE curl = the rotated gradient (d/dy, -d/dx) — MFEM's
        # FiniteElement::CalcCurlShape semantics for 2D scalar elements.
        # (3D curl needs Nedelec vector FE: VECFE, which the reference
        # marks not-yet-implemented, _ad_intg.hpp:49 — a gap kept here.)
        if sdim != 2:
            raise NotImplementedError(
                "CURL of a scalar FE is 2D-only (3D curl requires vector "
                "finite elements, VECFE — not-yet-implemented in the "
                "reference either, _ad_intg.hpp:49)"
            )
        n += 2
    return n


def input_width(mode: ADEval, sdim: int, vdim: int) -> int:
    return shapedim(mode, sdim) * vdim


def build_B(
    space: FESpace,
    mode: ADEval,
    ir: IntegrationRule,
    gf: GeomFactors,
) -> np.ndarray:
    """Shape tensor B [ne, nq, nd, shapedim] (CalcInputShapes analogue,
    src/ad_intg.hpp:119-154).  Columns ordered [qvalue, value, grad, div]."""
    if not is_valid_adeval(mode):
        raise ValueError(f"invalid ADEval combination: {mode!r}")
    mesh = space.mesh
    sdim = mesh.dim
    ne = mesh.num_elements
    # uniform Cartesian meshes have element-invariant physical shapes:
    # build B once ([1, nq, nd, sd]); integrator._dedup_elements keeps it
    # shared and the contractions use the B[0] fast forms
    if mesh.uniform_jacobian:
        ne = 1
    nq = ir.npoints
    nd = space.nd
    sd = shapedim(mode, sdim)
    B = np.zeros((ne, nq, nd, sd))
    col = 0
    if mode & ADEval.QVALUE:
        if nd != nq:
            raise ValueError(
                "QVALUE requires a quadrature-point space with nd == nq "
                f"(got nd={nd}, nq={nq})"
            )
        eye = np.eye(nq)
        B[:, :, :, col] = eye[None, :, :]
        col += 1
    need_grad = bool(mode & (ADEval.GRAD | ADEval.DIV | ADEval.CURL))
    if mode & ADEval.VALUE:
        phi = space.elem.eval(ir.points)  # [nq, nd]
        B[:, :, :, col] = phi[None, :, :]
        col += 1
    if need_grad:
        G = phys_dshape(mesh, ir, space.order, gf)[:ne]  # [ne, nq, nd, sdim]
    if mode & ADEval.GRAD:
        B[:, :, :, col : col + sdim] = G
        col += sdim
    if mode & ADEval.DIV:
        # row sums of the gradient shape (reference ad_intg.hpp:140-150)
        B[:, :, :, col] = G.sum(axis=-1)
        col += 1
    if mode & ADEval.CURL:
        # rotated gradient (d phi/dy, -d phi/dx): 2D CalcPhysCurlShape
        B[:, :, :, col] = G[..., 1]
        B[:, :, :, col + 1] = -G[..., 0]
        col += 2
    assert col == sd
    return B
