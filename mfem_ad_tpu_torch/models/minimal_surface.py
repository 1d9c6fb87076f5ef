"""Minimal surface with eps-continuation (ex2): energy
sqrt(1 + |grad u|^2) + eps |grad u|^2 on the unit square, Dirichlet data
r cos(2 theta) about the domain center, eps halved over the continuation
passes of a Newton solve.  eps is a runtime field parameter, so one
integrator serves every pass."""

from __future__ import annotations

import time
from dataclasses import dataclass

import numpy as np
import torch

from .. import mesh as M
from ..ad import ADFunction
from ..adeval import ADEval
from ..coefficients import ScalarFieldCoefficient
from ..fespace import FESpace
from ..forms import NonlinearForm
from ..solvers import NewtonOptions, newton


class MinimalSurfaceEnergy(ADFunction):
    """sqrt(1 + |g|^2) + eps |g|^2, eps a runtime field."""

    def __init__(self, dim: int):
        super().__init__(dim)
        self.add_parameter("eps", ScalarFieldCoefficient("eps"))

    def energy(self, g, p):
        h1 = torch.dot(g, g)
        return torch.sqrt(h1 + 1.0) + p["eps"][0] * h1


def bdry_fn(x):
    theta = np.arctan2(x[1] - 0.5, x[0] - 0.5)
    r = np.sqrt((x[0] - 0.5) ** 2 + (x[1] - 0.5) ** 2)
    return r * np.cos(2 * theta)


@dataclass
class Problem:
    mesh: object
    space: FESpace
    form: NonlinearForm
    x0: torch.Tensor


@dataclass
class Pass:
    """One continuation pass: its eps, Newton iterations, the area
    (energy at eps = 0) of the result, whether Newton converged, the
    Krylov iterations per Newton step and the wall time in seconds."""

    eps: float
    iterations: int
    area: float
    converged: bool
    lin_iters: list
    seconds: float


def build(order: int = 1, ref_levels: int = 3, n0: int = 10, *, device="cuda",
          dtype: torch.dtype = torch.float64) -> Problem:
    m = M.make_cartesian_2d(n0, n0).uniform_refine(ref_levels)
    fes = FESpace(m, order)
    nlf = NonlinearForm(fes, device=device, dtype=dtype)
    nlf.add_ad_integrator(MinimalSurfaceEnergy(m.dim), ADEval.GRAD)
    nlf.set_essential_bc([np.ones(m.max_bdr_attribute())])
    x0 = fes.project_bdr(np.zeros(fes.ndof), bdry_fn)
    return Problem(mesh=m, space=fes, form=nlf,
                   x0=torch.as_tensor(x0, dtype=dtype, device=nlf.device))


def solve(
    order: int = 1,
    ref_levels: int = 3,
    continuation_steps: int = 30,
    eps0: float = 0.5,
    lin_solver: str = "cg",
    verbose: bool = False,
    n0: int = 10,
    *,
    device="cuda",
    dtype: torch.dtype = torch.float64,
):
    """The eps-continuation loop, Newton abs/rel tol 1e-10; returns
    (x, history of ``Pass``, problem)."""
    pb = build(order, ref_levels, n0, device=device, dtype=dtype)
    opts = NewtonOptions(
        abs_tol=1e-10, rel_tol=1e-10, max_iter=100, lin_solver=lin_solver,
        lin_tol=1e-14,
        preconditioner="jacobi" if lin_solver in ("cg", "minres") else None,
    )
    x = pb.x0
    eps = eps0
    history = []
    for i in range(continuation_steps):
        sync = torch.cuda.synchronize if x.is_cuda else (lambda: None)
        sync()
        t0 = time.perf_counter()
        res = newton(pb.form, x, fields={"eps": eps}, opts=opts)
        x = res.x
        area = float(pb.form.energy(x, {"eps": 0.0}))
        sync()
        h = Pass(eps, res.iterations, area, res.converged, res.lin_iters,
                 time.perf_counter() - t0)
        history.append(h)
        if verbose:
            print(f"pass {i + 1:2d}: eps={eps:.3e} newton_its={h.iterations} "
                  f"lin_its={h.lin_iters} area={h.area:.9f} "
                  f"converged={h.converged} wall={h.seconds:.3f} s",
                  flush=True)
        eps *= 0.5
    return x, history, pb
