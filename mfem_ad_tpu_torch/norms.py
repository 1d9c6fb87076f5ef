"""Field norms and errors via quadrature (ComputeL2Error / ComputeL1Error).

Equivalents of the MFEM GridFunction norms the reference relies on for its
correctness checks and stopping rules: ex1.cpp:74 (L2 error vs exact
solution), ex4.cpp:205 / ex5.cpp:197 (L1 norm of the dual-variable
increment).
"""

from __future__ import annotations

import numpy as np

from .fespace import FESpace
from .geometry import geom_factors
from .quadrature import get_rule


def _qp_values(space: FESpace, u, order: int | None):
    if order is None:
        order = 2 * space.order + 4
    ir = get_rule(space.mesh.geom, order)
    gf = geom_factors(space.mesh, ir)
    phi = space.elem.eval(ir.points)  # [nq, nd]
    u = np.asarray(u)
    idx = np.asarray(space.edof, dtype=np.int64)[:, :, None] + np.arange(
        space.vdim
    ) * space.ndof_scalar
    ue = u[idx]  # [ne, nd, vdim]
    vals = np.einsum("qd,edv->eqv", phi, ue)  # [ne, nq, vdim]
    return vals, gf


def l2_error(space: FESpace, u, exact_fn, order: int | None = None) -> float:
    """|| u_h - exact ||_{L2} (GridFunction::ComputeL2Error)."""
    vals, gf = _qp_values(space, u, order)
    ex = np.array([exact_fn(x) for x in gf.xq.reshape(-1, space.mesh.dim)])
    ex = ex.reshape(vals.shape[0], vals.shape[1], space.vdim)
    diff2 = ((vals - ex) ** 2).sum(axis=-1)
    return float(np.sqrt(np.sum(diff2 * gf.w)))


def l2_norm(space: FESpace, u, order: int | None = None) -> float:
    vals, gf = _qp_values(space, u, order)
    return float(np.sqrt(np.sum((vals**2).sum(axis=-1) * gf.w)))


def l1_norm(space: FESpace, u, order: int | None = None) -> float:
    """∫ sum_c |u_c| dx (GridFunction::ComputeL1Error vs zero)."""
    vals, gf = _qp_values(space, u, order)
    return float(np.sum(np.abs(vals).sum(axis=-1) * gf.w))


def l1_error(space: FESpace, u, v, order: int | None = None) -> float:
    return l1_norm(space, np.asarray(u) - np.asarray(v), order)
