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
- ``build_cantilever``        the clamped cantilever under a tip load;
- ``PDEFilter``,              MFEM ex37's density-filtered SiMPL: the PDE
  ``FilteredSiMPL``           filter -eps^2 lap rho~ + rho~ = sigmoid(psi)
                              and its adjoint, a SIMP state on the
                              filtered density, the L2 latent psi and a
                              volume taken at the quadrature points; the
                              state and both filter solves are GMG-CG
                              (``models.topopt.build_ex37`` builds it).
"""

from __future__ import annotations

import math
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
from .multigrid import GMG
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

    ``clamp=False`` reads rho as it is, as MFEM ex37's SIMP coefficient
    reads its filtered density.
    """

    def __init__(self, dim: int, design_space: FESpace, lam: float,
                 mu: float, simp_exp: float = 3.0, rho_min: float = 1e-3,
                 clamp: bool = True):
        super().__init__(dim * dim)
        self.dim = dim
        self.lam0, self.mu0 = lam, mu
        self.simp_exp = simp_exp
        self.rho_min = rho_min
        self.clamp = clamp
        self.add_parameter("rho", GridFunctionCoefficient(design_space, "rho"))

    def energy(self, gradu, p):
        d = self.dim
        rho = p["rho"][0]
        if self.clamp:
            rho = admin(admax(rho, 0.0), 1.0)
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
    # per iteration: the CG iterations of the filter and of the adjoint
    # filter solve (a pair; FilteredSiMPL only) and the bisection steps of
    # the volume projection
    filter_cg_iterations: list = field(default_factory=list)
    bisection_steps: list = field(default_factory=list)


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

    BISECTION_STEPS = 60

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
        for _ in range(self.BISECTION_STEPS):
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
            with profiling.phase("topopt/volume", sync=psi):
                psi, rho = self._project_volume(psi)
            out.compliance_history.append(c)
            out.volume_history.append(self._volume(rho))
            out.cg_iterations.append(its)
            out.state_residuals.append(res)
            out.bisection_steps.append(self.BISECTION_STEPS)
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


class PDEFilter(ADFunction):
    """The PDE filter of a density as an energy of x = (rho~, grad rho~):
    eps^2/2 |grad rho~|^2 + rho~^2/2 - sigmoid(psi) rho~, the latent psi a
    runtime field on ``latent_space``.  Its minimizer over H1 solves
    -eps^2 lap rho~ + rho~ = sigmoid(psi) with natural (Neumann)
    conditions, the filter of MFEM ex37.  Without ``latent_space`` the
    last term is left out: the operator alone, with the same Hessian (the
    coarse levels of the filter's GMG)."""

    def __init__(self, dim: int, eps: float, latent_space=None):
        super().__init__(1 + dim)
        self.dim = dim
        self.eps2 = eps * eps
        if latent_space is not None:
            self.add_parameter("psi",
                               GridFunctionCoefficient(latent_space, "psi"))

    def energy(self, x, p):
        g2 = sum(x[1 + i] * x[1 + i] for i in range(self.dim))
        e = 0.5 * self.eps2 * g2 + 0.5 * x[0] * x[0]
        if "psi" in p:
            e = e - torch.sigmoid(p["psi"][0]) * x[0]
        return e


class FilteredSiMPL:
    """Density-filtered SiMPL topology optimization, MFEM ex37's loop
    (Keith and Surowiec's entropic mirror descent):

        min C = f.u  s.t.  -div(r(rho~) C eps(u)) = f,
        -eps^2 lap rho~ + rho~ = rho = sigmoid(psi),  int rho = theta |Omega|,
        r(rho~) = rho_0 + rho~^3 (1 - rho_0),

    psi in L2 (``latent_space``), evaluated at the quadrature points.
    Design iteration k (from 1):

    1. filter solve: rho~ from sigmoid(psi) (``topopt/filter``);
    2. the state GMG re-linearized on every level at rho~ injected
       (``topopt/gmg_refresh``), then the state solve (``topopt/state``);
    3. the sensitivity dC/drho~ = -2 dE/drho~ of the assembled state
       energy (``topopt/sensitivity``) and the adjoint filter solve for w
       with it as right-hand side (``topopt/adjoint``);
    4. the mirror step psi <- psi - alpha_k G, G the L2 projection of w on
       the latent space, alpha_k = k alpha;
    5. the volume projection: a shift c bisected on ex37's bracket
       logit(theta) -+ max|psi| until it is narrower than ``proj_tol``,
       psi <- psi + c (``topopt/volume``).

    Every phase synchronises the card on exit.  The state and both filter
    solves are CG from zero to ``lin_tol`` relative, under ``state_gmg``
    (its finest form carries ``ParametrizedElasticity`` on the design
    field "rho", a scalar H1 field on the state's lattice) and
    ``filter_gmg`` (its finest form carries ``PDEFilter`` with the latent
    field "psi"; the filter's operator does not change, so the caller
    linearizes that hierarchy once).
    """

    def __init__(self, state_gmg: GMG, filter_gmg: GMG, rhs,
                 latent_space: FESpace, vol_frac: float = 0.5,
                 alpha: float = 1.0, lin_tol: float = 1e-8,
                 lin_maxiter: int = 2000, proj_tol: float = 1e-12):
        self.state_gmg, self.filter_gmg = state_gmg, filter_gmg
        self.form, self.filter_form = state_gmg.forms[0], filter_gmg.forms[0]
        dev, dt = self.form.device, self.form.dtype
        self.rhs = torch.as_tensor(rhs, dtype=dt, device=dev)
        self.latent_space = latent_space
        self.vol_frac, self.alpha = vol_frac, alpha
        self.lin_tol, self.lin_maxiter = lin_tol, lin_maxiter
        self.proj_tol = proj_tol
        # the filter's points carry the latent's integrals: its values
        # phi [nq, nd_l] there, the weights w [1 | ne, nq] and the inverse
        # of each cell's latent mass matrix [1 | ne, nd_l, nd_l]
        self._fintg = self.filter_form.integrators[0]
        self.wq = self._fintg.tables["w"]
        self.phi = torch.as_tensor(
            latent_space.elem.eval(self._fintg.ir.points), dtype=dt,
            device=dev)
        mass = torch.einsum("eq,qa,qb->eab", self.wq, self.phi, self.phi)
        self.mass_inv = torch.linalg.inv(mass)
        self.total_volume = float(self.wq.sum()) * (
            self.form.spaces[0].mesh.num_elements
            if self.wq.shape[0] == 1 else 1)
        self._zf = torch.zeros(self.filter_form.ndof, dtype=dt, device=dev)

    # -- the pieces of a design iteration ------------------------------
    def filter_rhs(self, psi):
        """(sigmoid(psi), v) for every filter dof v."""
        return -self.filter_form.mult(self._zf, {"psi": psi})

    def filter_solve(self, b):
        """(rho~ or w, CG iterations) of the filter operator against b."""
        st = self.filter_gmg.states[0]
        return cg(lambda v: self.filter_form.grad_mult(st, v), b,
                  M=self.filter_gmg, tol=self.lin_tol,
                  maxiter=self.lin_maxiter)

    def refresh(self, rho_f):
        """Every state level linearized at ``rho_f`` injected."""
        self.state_gmg.set_fields(self.state_gmg.inject_field("rho", rho_f))

    def state_solve(self):
        """(u, CG iterations) of K(rho~) u = f at the last ``refresh``."""
        st = self.state_gmg.states[0]
        return cg(lambda v: self.form.grad_mult(st, v), self.rhs,
                  M=self.state_gmg, tol=self.lin_tol,
                  maxiter=self.lin_maxiter)

    def sensitivity(self, u, rho_f):
        """dC/drho~ = -2 dE/drho~, a dual vector on the filter's space."""
        return -2.0 * grad(lambda r: self.form.energy(u, {"rho": r}))(rho_f)

    def latent_gradient(self, w):
        """G, the L2 projection of the filter-space field w on the latent
        space: per cell M^-1 (w, phi)."""
        wq = self._fintg.x_qp([w])[..., 0]             # [ne, nq]
        b = (wq * self.wq) @ self.phi                    # [ne, nd_l]
        return (self.mass_inv @ b.unsqueeze(-1)).reshape(-1)

    def _psi_qp(self, psi):
        return psi.reshape(-1, self.phi.shape[1]) @ self.phi.T

    def _sigmoid_integral(self, psi_qp, c: float) -> float:
        return float((torch.sigmoid(psi_qp + c) * self.wq).sum())

    def volume(self, psi) -> float:
        """int sigmoid(psi) at the quadrature points."""
        return self._sigmoid_integral(self._psi_qp(psi), 0.0)

    def project(self, psi):
        """(psi + c, bisection steps) with int sigmoid(psi + c) = theta
        |Omega|."""
        mid0 = math.log(self.vol_frac / (1.0 - self.vol_frac))
        r = float(psi.abs().max())
        lo, hi = mid0 - r, mid0 + r
        target = self.vol_frac * self.total_volume
        psi_qp = self._psi_qp(psi)
        steps = 0
        while hi - lo > self.proj_tol:
            mid = 0.5 * (lo + hi)
            if self._sigmoid_integral(psi_qp, mid) > target:
                hi = mid
            else:
                lo = mid
            steps += 1
        return psi + 0.5 * (lo + hi), steps

    def solve(self, max_iter: int = 5, callback=None,
              verbose: bool = False) -> TopoptResult:
        """``max_iter`` design iterations from psi = logit(theta), rho =
        theta.  ``callback(k, psi, rho_f, u, w, psi_next)`` sees every
        iteration's iterates.  The result's ``rho`` is the last filtered
        density."""
        dev, dt = self.form.device, self.form.dtype
        psi = torch.full((self.latent_space.ndof,),
                         math.log(self.vol_frac / (1.0 - self.vol_frac)),
                         dtype=dt, device=dev)
        out = TopoptResult(rho=None, u=None)
        for k in range(1, max_iter + 1):
            with profiling.phase("topopt/filter", sync=psi):
                rho_f, its_f = self.filter_solve(self.filter_rhs(psi))
            with profiling.phase("topopt/gmg_refresh", sync=rho_f):
                self.refresh(rho_f)
            with profiling.phase("topopt/state", sync=rho_f):
                u, its = self.state_solve()
            c = float(self.rhs @ u)
            with profiling.phase("topopt/sensitivity", sync=u):
                g = self.sensitivity(u, rho_f)
            with profiling.phase("topopt/adjoint", sync=u):
                w, its_a = self.filter_solve(g)
            psi_next = psi - (k * self.alpha) * self.latent_gradient(w)
            with profiling.phase("topopt/volume", sync=psi):
                psi_next, steps = self.project(psi_next)
            if callback is not None:
                callback(k, psi, rho_f, u, w, psi_next)
            psi = psi_next
            out.compliance_history.append(c)
            out.volume_history.append(self.volume(psi) / self.total_volume)
            out.cg_iterations.append(its)
            out.filter_cg_iterations.append((its_f, its_a))
            out.bisection_steps.append(steps)
            if verbose:
                print(f"ex37 it {k:3d}: compliance={c:.6e} "
                      f"vol={out.volume_history[-1]:.6f} state CG {its} "
                      f"filter CG {its_f}+{its_a} bisection {steps}")
        out.rho, out.u = rho_f, u
        return out
