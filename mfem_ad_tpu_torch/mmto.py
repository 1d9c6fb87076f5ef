"""Topology optimization by SiMPL mirror descent.

PyTorch counterpart of ``mfem_ad_tpu.mmto``:

- ``SIMPFunction``            SIMP interpolation sum_i E_i x_i^p;
- ``ParametrizedElasticity``  an elasticity energy whose moduli a design
                              field rho scales by rho_min + (1 - rho_min)
                              rho^p;
- the design sensitivity      rho enters the energy as a runtime field,
                              so dC/drho = -2 dE/drho (self-adjoint
                              compliance) is ``torch.func.grad`` of the
                              assembled energy with respect to the rho
                              dof vector;
- ``SiMPLTopopt``             mirror descent in the Fermi-Dirac latent
                              psi, rho = sigmoid(psi + c), c bisected to
                              meet the volume fraction;
- ``build_cantilever``        the clamped cantilever under a tip load.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch
from torch.func import grad

from . import mesh as M
from .ad import ADFunction, admax, admin
from .adeval import ADEval
from .coefficients import GridFunctionCoefficient
from .fespace import L2, FESpace
from .forms import LinearForm, NonlinearForm
from .geometry import geom_factors
from .quadrature import get_rule
from .solvers import cg
from .utils import profiling


class SIMPFunction(ADFunction):
    """SIMP material interpolation: sum_i E_i x_i^p."""

    def __init__(self, E, simp_exp: float):
        E = np.atleast_1d(np.asarray(E, dtype=np.float64))
        super().__init__(E.size)
        self.E = torch.as_tensor(E)
        self.p = simp_exp

    def energy(self, x, p):
        return torch.sum(self.E.to(x) * x**self.p)


class ParametrizedElasticity(ADFunction):
    """Elasticity energy with SIMP-interpolated moduli of a design field.

    Input x = flattened grad u (component-major, as
    ``LinearElasticityEnergy``); the density rho is a runtime field on its
    own design space, so the energy, residual, Jacobian and the design
    sensitivity are all differentiable in rho.  s(rho) = rho_min + (1 -
    rho_min) rho^simp_exp scales both lambda and mu.

    rho is clamped to [0, 1] by ``admin(admax(rho, 0), 1)``, whose
    derivative is 1/2 where rho is exactly 0 or 1, as the JAX package's
    ``jnp.clip`` has it (``torch.clamp`` passes all of it): rho =
    sigmoid(psi + c) is exactly 1.0 in f64 once psi + c > ~36.7, and such
    saturated stiff elements carry the largest sensitivities, which
    normalize the mirror-descent step.
    """

    def __init__(self, dim: int, design_space: FESpace, lam: float,
                 mu: float, simp_exp: float = 3.0, rho_min: float = 1e-3):
        super().__init__(dim * dim)
        self.dim = dim
        self.lam0, self.mu0 = lam, mu
        self.simp_exp = simp_exp
        self.rho_min = rho_min
        self.add_parameter("rho", GridFunctionCoefficient(design_space, "rho"))

    def energy(self, gradu, p):
        d = self.dim
        rho = admin(admax(p["rho"][0], 0.0), 1.0)
        s = self.rho_min + (1.0 - self.rho_min) * rho**self.simp_exp
        G = gradu.reshape(d, d)
        div = sum(G[i, i] for i in range(d))
        sym = 0.5 * (G + G.T)
        return s * (0.5 * self.lam0 * div * div
                    + self.mu0 * torch.sum(sym * sym))


@dataclass
class TopoptResult:
    rho: object
    u: object
    compliance_history: list = field(default_factory=list)
    volume_history: list = field(default_factory=list)
    # per iteration: CG iterations of the state solve and its relative
    # residual ||K u - f|| / ||f||
    cg_iterations: list = field(default_factory=list)
    state_residuals: list = field(default_factory=list)


class SiMPLTopopt:
    """SiMPL mirror-descent topology optimization.

    min_rho C(rho) = f.u(rho)  s.t.  K(rho) u = f,  mean(rho) = vol_frac,
    0 <= rho <= 1, by Fermi-Dirac mirror descent: the latent psi steps
    along -dC/drho normalized by its largest entry, rho = sigmoid(psi + c)
    with c bisected to meet the volume constraint.  The state solve is
    Jacobi-CG on the matrix-free Jacobian, warm-started from the last u.
    Profiling phases: ``topopt/state``, ``topopt/sensitivity``,
    ``topopt/volume``.
    """

    def __init__(
        self,
        state_form: NonlinearForm,
        design_space: FESpace,
        rhs,
        vol_frac: float = 0.4,
        step: float = 10.0,
        lin_tol: float = 1e-10,
        lin_maxiter: int = 5000,
    ):
        self.form = state_form
        self.design_space = design_space
        dev, dt = state_form.device, state_form.dtype
        self.rhs = torch.as_tensor(rhs, dtype=dt, device=dev)
        self.vol_frac = vol_frac
        self.step = step
        self.lin_tol = lin_tol
        self.lin_maxiter = lin_maxiter
        # dof "volume" weights of the design space (integral of phi_j)
        sp = design_space
        ir = get_rule(sp.mesh.geom, 2 * sp.order + 2)
        gfac = geom_factors(sp.mesh, ir)
        wj = np.einsum("eq,qd->ed", gfac.w, sp.elem.eval(ir.points))
        w = np.zeros(sp.ndof)
        np.add.at(w, np.asarray(sp.edof, dtype=np.int64), wj)
        self.dof_volume = torch.as_tensor(w, dtype=dt, device=dev)
        self.total_volume = float(w.sum())

    def _solve_state(self, rho, u0):
        """(u, CG iterations, relative residual) of K(rho) u = f (linear
        elasticity: one Newton step from zero)."""
        st = self.form.grad_state(torch.zeros_like(u0), {"rho": rho})
        d = torch.abs(self.form.grad_diag(st))
        dsafe = torch.where(d < 1e-30, 1.0, d)
        mv = lambda v: self.form.grad_mult(st, v)  # noqa: E731
        u, its = cg(mv, self.rhs, x0=u0, M=lambda v: v / dsafe,
                    tol=self.lin_tol, maxiter=self.lin_maxiter)
        res = float(torch.linalg.vector_norm(mv(u) - self.rhs)
                    / torch.linalg.vector_norm(self.rhs))
        return u, its, res

    def sensitivity(self, u, rho):
        """dC/drho = -2 dE/drho at the state u."""
        return -2.0 * grad(lambda r: self.form.energy(u, {"rho": r}))(rho)

    def _volume(self, rho) -> float:
        return float(self.dof_volume @ rho) / self.total_volume

    def _project_volume(self, psi):
        """Bisect the sigmoid shift so that mean(rho) = vol_frac."""
        lo, hi = -40.0, 40.0
        target = self.vol_frac
        for _ in range(60):
            mid = 0.5 * (lo + hi)
            if self._volume(torch.sigmoid(psi + mid)) > target:
                hi = mid
            else:
                lo = mid
        c = 0.5 * (lo + hi)
        return psi + c, torch.sigmoid(psi + c)

    def solve(self, max_iter: int = 30, tol: float = 1e-4,
              verbose: bool = False) -> TopoptResult:
        dev, dt = self.form.device, self.form.dtype
        psi = torch.zeros(self.design_space.ndof, dtype=dt, device=dev)
        psi, rho = self._project_volume(psi)
        u = torch.zeros(self.form.ndof, dtype=dt, device=dev)
        out = TopoptResult(rho=rho, u=u)
        prev_c = np.inf
        for it in range(max_iter):
            with profiling.phase("topopt/state", sync=u):
                u, its, res = self._solve_state(rho, u)
            c = float(self.rhs @ u)
            with profiling.phase("topopt/sensitivity", sync=psi):
                g = self.sensitivity(u, rho)
                # mirror-descent step in the latent variable (normalized)
                psi = psi - self.step * (g / (g.abs().max() + 1e-30))
            with profiling.phase("topopt/volume"):
                psi, rho = self._project_volume(psi)
            out.compliance_history.append(c)
            out.volume_history.append(self._volume(rho))
            out.cg_iterations.append(its)
            out.state_residuals.append(res)
            if verbose:
                print(f"topopt it {it+1:3d}: compliance={c:.6e} "
                      f"vol={out.volume_history[-1]:.4f}")
            if abs(prev_c - c) < tol * abs(c):
                break
            prev_c = c
        out.rho, out.u = rho, u
        return out


def build_cantilever(nx: int = 24, ny: int = 12, order: int = 1,
                     lam: float = 1.0, mu: float = 1.0,
                     simp_exp: float = 3.0, *, device="cuda",
                     dtype: torch.dtype = torch.float64):
    """The classic cantilever on [0, 2] x [0, 1]: clamped left edge, a
    narrow downward load at the middle of the right edge.  Returns (form,
    design space, load vector, mesh, displacement space)."""
    m = M.make_cartesian_2d(nx, ny, sx=2.0, sy=1.0)
    dim = 2
    disp = FESpace(m, order, vdim=dim)
    design = FESpace(m, 0, L2)
    energy = ParametrizedElasticity(dim, design, lam, mu, simp_exp)
    form = NonlinearForm(disp, device=device, dtype=dtype)
    form.add_ad_integrator(energy, ADEval.GRAD | ADEval.VECTOR)
    ess = np.zeros(m.max_bdr_attribute())
    ess[3] = 1  # left edge (attribute 4)
    form.set_essential_bc([ess])

    def load(x):
        w = np.exp(-((x[0] - 2.0) ** 2 + (x[1] - 0.5) ** 2) / 0.01)
        return np.array([0.0, -w])

    b = LinearForm(disp, load).assemble()
    b[np.asarray(disp.essential_dofs(ess))] = 0.0
    return (form, design, torch.as_tensor(b, dtype=dtype, device=device), m,
            disp)
