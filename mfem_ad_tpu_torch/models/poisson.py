"""Poisson via the AD diffusion energy (ex1).

-Δu = 2π² sin(πx) sin(πy) on [0,1]², u = 0 on the boundary;
exact solution sin(πx) sin(πy).  ``geom`` "square" (quads) or "triangle"
(each cell split along its SW-NE diagonal).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from .. import mesh as M
from ..ad import DiffusionEnergy
from ..adeval import ADEval
from ..fespace import FESpace
from ..forms import LinearForm, NonlinearForm
from ..norms import l2_error
from ..solvers import NewtonOptions, newton


def load_fn(x):
    return 2 * np.pi**2 * np.sin(np.pi * x[0]) * np.sin(np.pi * x[1])


def exact_fn(x):
    return np.sin(np.pi * x[0]) * np.sin(np.pi * x[1])


@dataclass
class Problem:
    mesh: object
    space: FESpace
    form: NonlinearForm
    rhs: torch.Tensor


def build(order: int = 1, ref_levels: int = 1, n0: int = 10,
          geom: str = "square", *, device="cuda",
          dtype: torch.dtype = torch.float64) -> Problem:
    m = M.make_cartesian_2d(n0, n0, geom).uniform_refine(ref_levels)
    fes = FESpace(m, order)
    nlf = NonlinearForm(fes, device=device, dtype=dtype)
    nlf.add_ad_integrator(DiffusionEnergy(m.dim), ADEval.GRAD)
    nlf.set_essential_bc([np.ones(m.max_bdr_attribute())])
    load = LinearForm(fes, load_fn).assemble()
    load[np.asarray(fes.boundary_dofs())] = 0.0
    rhs = torch.as_tensor(load, dtype=dtype, device=nlf.device)
    return Problem(mesh=m, space=fes, form=nlf, rhs=rhs)


def solve(order: int = 1, ref_levels: int = 1, lin_solver: str = "cg",
          n0: int = 10, geom: str = "square", *, device="cuda",
          dtype: torch.dtype = torch.float64):
    pb = build(order, ref_levels, n0, geom, device=device, dtype=dtype)
    opts = NewtonOptions(
        abs_tol=1e-10, max_iter=3, lin_solver=lin_solver, lin_tol=1e-14,
        preconditioner="jacobi" if lin_solver == "cg" else None,
    )
    x0 = torch.zeros(pb.space.ndof, dtype=dtype, device=pb.form.device)
    res = newton(pb.form, x0, b=pb.rhs, opts=opts)
    err = l2_error(pb.space, res.x.cpu().numpy(), exact_fn)
    return res, err, pb
