"""Obstacle problem by LVPP proximal Galerkin (ex4): minimize
0.5||grad u||^2 - (f, u) subject to 0 <= u <= 0.5, through the
Fermi-Dirac mirror map on mixed H1(p+1) x L2(p-1) spaces, with the outer
PG loop and its lambda-increment stopping rule.

The default solver is the exact Schur elimination of the L2 latent with
CG on the condensed primal system, preconditioned by the alpha-shifted
hp-GMG on the primal diffusion block (``_primal_gmg``).  On tetrahedra
(``dim=3, geom="tet"``) there is no dof grid for the GMG, and the
condensed CG takes its Jacobi diagonal."""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from .. import mesh as M
from ..ad import ADFunction, DiffusionEnergy
from ..adeval import ADEval
from ..fespace import L2, FESpace
from ..forms import BlockNonlinearForm, LinearForm, NonlinearForm
from ..integrator import ADBlockIntegrator
from ..multigrid import GMG, PGSchurGMG, build_hp_hierarchy
from ..pg import ADPGFunctional, FermiDiracEntropy, PGSolver, PGStepSizeRule
from ..quadrature import TETRAHEDRON
from ..solvers import NewtonOptions


class ObstacleEnergy(ADFunction):
    """0.5 ||grad u||^2; input x = [u, grad u]."""

    def __init__(self, dim: int):
        super().__init__(dim + 1)

    def energy(self, x, p):
        g = x[1:]
        return 0.5 * torch.dot(g, g)


def load_fn(x):
    return 2 * np.pi**2 * np.sin(np.pi * x[0]) * np.sin(np.pi * x[1])


def load_fn_3d(x):
    return (3 * np.pi**2 * np.sin(np.pi * x[0]) * np.sin(np.pi * x[1])
            * np.sin(np.pi * x[2]))


@dataclass
class Problem:
    mesh: object
    primal_space: FESpace
    latent_space: FESpace
    form: BlockNonlinearForm
    rhs: torch.Tensor
    pg: ADPGFunctional
    ir_order: int


def build(order: int = 2, ref_levels: int = 3, n0: int = 10,
          lower: float = 0.0, upper: float = 0.5, dim: int = 2,
          geom: str | None = None, *, device="cuda",
          dtype: torch.dtype = torch.float64) -> Problem:
    """The LVPP obstacle form on n0 x n0 (x n0) cells refined
    ``ref_levels`` times; dim 3 runs on hexes, or with ``geom="tet"`` on
    Kuhn-split tetrahedra (Bey refinement)."""
    if dim == 3:
        g = TETRAHEDRON if geom in ("tet", TETRAHEDRON) else None
        m = (M.make_cartesian_3d(n0, n0, n0, geom=g) if g
             else M.make_cartesian_3d(n0, n0, n0))
    else:
        m = M.make_cartesian_2d(n0, n0)
    m = m.uniform_refine(ref_levels)
    h1 = FESpace(m, order + 1)
    l2 = FESpace(m, order - 1, L2)

    entropy = FermiDiracEntropy(lower, upper)
    pg = ADPGFunctional(ObstacleEnergy(m.dim), entropy, l2)

    form = BlockNonlinearForm([h1, l2], device=device, dtype=dtype)
    ir_order = 3 * order + 3
    form.add_domain_integrator(
        ADBlockIntegrator(
            pg,
            [h1, l2],
            [ADEval.VALUE | ADEval.GRAD, ADEval.VALUE],
            ir_order=ir_order,
            device=device,
            dtype=dtype,
        )
    )
    form.set_essential_bc([np.ones(m.max_bdr_attribute()), None])

    rhs = np.zeros(form.ndof)
    b = LinearForm(h1, load_fn_3d if m.dim == 3 else load_fn).assemble()
    b[np.asarray(h1.boundary_dofs())] = 0.0
    rhs[: h1.ndof] = b
    return Problem(
        mesh=m, primal_space=h1, latent_space=l2, form=form,
        rhs=torch.as_tensor(rhs, dtype=dtype, device=form.device), pg=pg,
        ir_order=ir_order,
    )


def build_dofpg(*args, **kwargs):
    raise NotImplementedError(
        "build_dofpg: the dof-level PG variant (dof_pg) is not ported yet "
        "(ROADMAP A5)"
    )


def solve_dofpg(*args, **kwargs):
    raise NotImplementedError(
        "solve_dofpg: the dof-level PG variant (dof_pg) is not ported yet "
        "(ROADMAP A5)"
    )


def _primal_gmg(order: int, ref_levels: int, n0: int, dim: int = 2, *,
                device="cuda", dtype: torch.dtype = torch.float64):
    """hp-GMG on the primal diffusion block (H1(order+1)): the order-p
    fine level p-coarsens to Q1, then geometric coarsening to the n0 mesh.
    The Schur direction shifts it by the reaction diagonal
    (``PGSchurGMG``)."""

    def build_fn(n, p):
        m = (M.make_cartesian_3d(n, n, n) if dim == 3
             else M.make_cartesian_2d(n, n))
        f = NonlinearForm(FESpace(m, p), device=device, dtype=dtype)
        f.add_ad_integrator(DiffusionEnergy(m.dim), ADEval.GRAD)
        f.set_essential_bc([np.ones(m.max_bdr_attribute())])
        return f

    forms = build_hp_hierarchy(build_fn, n0, ref_levels + 1, order + 1)
    return PGSchurGMG(GMG(forms))


def solve(
    order: int = 2,
    ref_levels: int = 3,
    rule_type: int = PGStepSizeRule.CONSTANT,
    alpha0: float = 1.0,
    max_alpha: float = 1e4,
    ratio: float = 1.0,
    ratio2: float = 1.0,
    lin_solver: str = "schur",
    max_pg_iter: int = 100,
    tol: float = 1e-10,
    verbose: bool = False,
    n0: int = 10,
    gmg: bool = True,
    lin_maxiter: int = 2000,
    dim: int = 2,
    geom: str | None = None,
    *,
    device="cuda",
    dtype: torch.dtype = torch.float64,
):
    """Build the problem and run the LVPP loop from zero; returns
    (PGResult, Problem)."""
    pb = build(order, ref_levels, n0=n0, dim=dim, geom=geom, device=device,
               dtype=dtype)
    rule = PGStepSizeRule(rule_type, alpha0, max_alpha, ratio, ratio2)
    precond = None
    if lin_solver == "schur" and gmg and geom is None:
        precond = _primal_gmg(order, ref_levels, n0, dim=dim, device=device,
                              dtype=dtype).as_preconditioner()
    elif lin_solver not in ("dense", "schur"):
        precond = "jacobi"
    nopts = NewtonOptions(
        abs_tol=1e-9, rel_tol=0.0, max_iter=20, lin_solver=lin_solver,
        lin_tol=1e-13, lin_maxiter=lin_maxiter, preconditioner=precond,
    )
    solver = PGSolver(
        pb.form, rule, latent_block=1, latent_space=pb.latent_space,
        newton_opts=nopts, max_iter=max_pg_iter, tol=tol, verbose=verbose,
        # Krylov directions can stagnate Newton just above abs_tol (1e-9);
        # accept and let the PG loop correct
        newton_accept=1e-5,
    )
    x0 = torch.zeros(pb.form.ndof, dtype=dtype, device=pb.form.device)
    res = solver.solve(x0, pb.rhs)
    return res, pb
