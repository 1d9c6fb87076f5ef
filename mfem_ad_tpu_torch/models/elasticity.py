"""Vector linear elasticity (ex3): LinearElasticityEnergy with GRAD|VECTOR
mode, unit body force, clamped on boundary attribute 4 (the left side),
single linear solve.  Structured square/cube meshes."""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from .. import mesh as M
from ..ad import LinearElasticityEnergy
from ..adeval import ADEval
from ..fespace import FESpace
from ..forms import LinearForm, NonlinearForm
from ..solvers import NewtonOptions, newton


@dataclass
class Problem:
    mesh: object
    space: FESpace
    form: NonlinearForm
    rhs: torch.Tensor


def build(
    order: int = 1,
    ref_levels: int = 3,
    lam: float = 1.0,
    mu: float = 1.0,
    n0: int = 10,
    dim: int = 2,
    *,
    device="cuda",
    dtype: torch.dtype = torch.float64,
) -> Problem:
    m = (M.make_cartesian_2d(n0, n0) if dim == 2
         else M.make_cartesian_3d(n0, n0, n0)).uniform_refine(ref_levels)
    fes = FESpace(m, order, vdim=dim)
    nlf = NonlinearForm(fes, device=device, dtype=dtype)
    nlf.add_ad_integrator(
        LinearElasticityEnergy(dim, lam, mu), ADEval.GRAD | ADEval.VECTOR
    )
    # ex3: only boundary attribute 4 (left side) is essential
    ess = np.zeros(m.max_bdr_attribute())
    ess[3] = 1
    nlf.set_essential_bc([ess])
    load = LinearForm(fes, lambda x: np.ones(dim)).assemble()
    load[np.asarray(fes.essential_dofs(ess))] = 0.0
    rhs = torch.as_tensor(load, dtype=dtype, device=nlf.device)
    return Problem(mesh=m, space=fes, form=nlf, rhs=rhs)


def solve(order: int = 1, ref_levels: int = 3, lin_solver: str = "cg",
          dim: int = 2, *, device="cuda", dtype: torch.dtype = torch.float64):
    pb = build(order, ref_levels, dim=dim, device=device, dtype=dtype)
    opts = NewtonOptions(
        abs_tol=1e-10, max_iter=3, lin_solver=lin_solver, lin_tol=1e-14,
        lin_maxiter=20000,
        preconditioner="jacobi" if lin_solver == "cg" else None,
    )
    x0 = torch.zeros(pb.space.ndof, dtype=dtype, device=pb.form.device)
    res = newton(pb.form, x0, b=pb.rhs, opts=opts)
    return res, pb
