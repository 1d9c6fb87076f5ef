"""Gradient-constrained obstacle problem by LVPP proximal Galerkin (ex5):
minimize 0.5||grad u||^2 - (f, u) subject to ||grad u|| <= phi(x) =
0.1 + 0.2x + 0.4y, through the Hellinger mirror map on H1(p) x
H1(p-1)^dim spaces over a triangle mesh.

The latent couples across elements, so the Newton direction is the
lumped one (``solvers.lumped_schur_solve``): FGMRES on the alpha-scaled
saddle system under the block-LDU preconditioner, with the hp-GMG on the
primal diffusion block (``_primal_gmg``) and the dense dual-Schur factor
up to ``solvers.SIGMA_DIRECT_MAX`` latent dofs (Woodbury above)."""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from .. import mesh as M
from ..ad import ADFunction, DiffusionEnergy
from ..adeval import ADEval
from ..fespace import FESpace
from ..forms import BlockNonlinearForm, LinearForm, NonlinearForm
from ..integrator import ADBlockIntegrator
from ..multigrid import GMG, PGSchurGMG, build_hp_hierarchy
from ..pg import ADPGFunctional, HellingerEntropy, PGSolver, PGStepSizeRule
from ..quadrature import TRIANGLE
from ..solvers import NewtonOptions


class GradientObstacleEnergy(ADFunction):
    """0.5 ||grad u||^2; input x = grad u."""

    def __init__(self, dim: int):
        super().__init__(dim)

    def energy(self, x, p):
        return 0.5 * torch.dot(x, x)


def load_fn(x):
    return 15.0 * np.sin(np.pi * x[0]) ** 2


def bound_fn(x):
    return 0.1 + 0.2 * x[0] + 0.4 * x[1]


@dataclass
class Problem:
    mesh: object
    primal_space: FESpace
    latent_space: FESpace
    form: BlockNonlinearForm
    rhs: torch.Tensor
    pg: ADPGFunctional


def _primal_gmg(order: int, ref_levels: int, n0: int, *, device="cuda",
                dtype: torch.dtype = torch.float64):
    """hp-GMG on the primal diffusion block of ex5 over every level: the
    order-p space on the structured triangle mesh p-coarsens to P1 on the
    same mesh, then geometric coarsening down to the n0 mesh (triangle
    dof grids are lexicographic, fespace's 'h1t')."""

    def build_fn(n, p):
        m = M.make_cartesian_2d(n, n, TRIANGLE)
        f = NonlinearForm(FESpace(m, p), device=device, dtype=dtype)
        f.add_ad_integrator(DiffusionEnergy(m.dim), ADEval.GRAD)
        f.set_essential_bc([np.ones(m.max_bdr_attribute())])
        return f

    forms = build_hp_hierarchy(build_fn, n0, ref_levels + 1, order)
    return PGSchurGMG(GMG(forms))


def build(order: int = 2, ref_levels: int = 3, n0: int = 10, *,
          device="cuda", dtype: torch.dtype = torch.float64) -> Problem:
    """The LVPP form on n0 x n0 cells, each split into two triangles,
    refined ``ref_levels`` times."""
    if order < 2:
        raise ValueError("ex5 requires order >= 2 (latent H1 space order-1)")
    m = M.make_cartesian_2d(n0, n0, TRIANGLE).uniform_refine(ref_levels)
    dim = m.dim
    primal = FESpace(m, order)
    latent = FESpace(m, order - 1, vdim=dim)

    entropy = HellingerEntropy(dim, bound_fn)
    pg = ADPGFunctional(GradientObstacleEnergy(dim), entropy, latent)

    form = BlockNonlinearForm([primal, latent], device=device, dtype=dtype)
    form.add_domain_integrator(
        ADBlockIntegrator(
            pg,
            [primal, latent],
            [ADEval.GRAD, ADEval.VALUE | ADEval.VECTOR],
            device=device,
            dtype=dtype,
        )
    )
    form.set_essential_bc([np.ones(m.max_bdr_attribute()), None])

    rhs = np.zeros(form.ndof)
    b = LinearForm(primal, load_fn).assemble()
    b[np.asarray(primal.boundary_dofs())] = 0.0
    rhs[: primal.ndof] = b
    return Problem(
        mesh=m, primal_space=primal, latent_space=latent, form=form,
        rhs=torch.as_tensor(rhs, dtype=dtype, device=form.device), pg=pg,
    )


def solve(
    order: int = 2,
    ref_levels: int = 3,
    rule_type: int = PGStepSizeRule.CONSTANT,
    alpha0: float = 1.0,
    max_alpha: float = 1e6,
    ratio: float = 1.0,
    ratio2: float = 1.0,
    lin_solver: str = "schur",
    max_pg_iter: int = 100,
    tol: float = 1e-8,
    verbose: bool = False,
    n0: int = 10,
    lin_maxiter: int = 2000,
    gmg: bool = True,
    lin_tol: float = 1e-10,
    newton_abs_tol: float = 1e-11,
    *,
    device="cuda",
    dtype: torch.dtype = torch.float64,
):
    """Build the problem and run the LVPP loop from zero; returns
    (PGResult, Problem)."""
    pb = build(order, ref_levels, n0=n0, device=device, dtype=dtype)
    rule = PGStepSizeRule(rule_type, alpha0, max_alpha, ratio, ratio2)
    precond = None
    if lin_solver == "schur" and gmg:
        precond = _primal_gmg(order, ref_levels, n0, device=device,
                              dtype=dtype).as_preconditioner()
    elif lin_solver not in ("dense", "schur"):
        precond = "jacobi"
    nopts = NewtonOptions(
        # every direction error dpsi puts dpsi/alpha of noise into lambda,
        # whose L1 increment is the stopping test: the directions must be
        # tight (lin_tol 1e-10), which the LDU-FGMRES makes cheap
        abs_tol=newton_abs_tol, rel_tol=0.0, max_iter=20,
        lin_solver=lin_solver, lin_tol=lin_tol, lin_maxiter=lin_maxiter,
        preconditioner=precond,
    )
    solver = PGSolver(
        pb.form, rule, latent_block=1, latent_space=pb.latent_space,
        newton_opts=nopts, max_iter=max_pg_iter, tol=tol, verbose=verbose,
        # bounded-budget Krylov directions can stagnate Newton just above
        # abs_tol; accept and let the PG loop correct
        newton_accept=1e-5,
    )
    x0 = torch.zeros(pb.form.ndof, dtype=dtype, device=pb.form.device)
    res = solver.solve(x0, pb.rhs)
    return res, pb
