"""Traffic kind ``newton_solve``: back-to-back Newton solves of the
neo-Hookean configuration, each from zero to ``rel_tol``, with CG
preconditioned by the nonlinear geometric multigrid that set-up builds.

The load is ex3's body force (1, 1) times ``load_scale``, each solve's
magnitude jittered by the seed within ``load_jitter``: every seed does the
same work (6 Newton steps) on loads that differ.  Other directions are not
drawn: under pushing loads (-1, +-1) Newton's first steps from zero sit on
the edge of the line search's acceptance at 512^2, and some solves stop on
the stall exit (PERF.md).

A unit is one solve.  The output check evaluates the plain reference's
residual at every solve's displacement: ||r(x)|| / ||b||, and the largest
|x| on the clamped edge, which must be 0.  The control runs the same
solves in float32, the program's own lower-precision path.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from mfem_ad_tpu_torch import mesh as M
from mfem_ad_tpu_torch import solvers
from mfem_ad_tpu_torch.ad import NeoHookeanEnergy
from mfem_ad_tpu_torch.adeval import ADEval
from mfem_ad_tpu_torch.fespace import FESpace
from mfem_ad_tpu_torch.forms import NonlinearForm
from mfem_ad_tpu_torch.multigrid import GMG, build_hierarchy

from harness import worst

LEFT = 3  # boundary attribute 4 of the Cartesian mesh: the edge x = 0


class Traffic:
    def __init__(self, cfg: dict, params: dict, device, ref,
                 control: bool = False):
        self.cfg, self.params, self.ref = cfg, params, ref
        self.device = torch.device(device)
        self.dtype = torch.float32 if control else getattr(
            torch, cfg["precision"]["newton_solve"])
        lam, mu = cfg["lambda"], cfg["mu"]
        dtype = self.dtype

        def level(n):
            m = M.make_cartesian_2d(n, n)
            f = NonlinearForm(FESpace(m, 1, vdim=2), device=device,
                              dtype=dtype)
            f.add_ad_integrator(NeoHookeanEnergy(2, lam, mu),
                                ADEval.GRAD | ADEval.VECTOR)
            ess = np.zeros(m.max_bdr_attribute())
            ess[LEFT] = 1
            f.set_essential_bc([ess])
            return f

        g = cfg["gmg"]
        forms = build_hierarchy(level, g["coarse_n"], g["levels"])
        self.form = forms[0]
        self.gmg = GMG(forms, nonlinear=True)
        p = params["newton"]
        self.opts = solvers.NewtonOptions(
            abs_tol=0.0, rel_tol=p["rel_tol"], max_iter=p["max_iter"],
            lin_solver="cg", lin_tol=p["lin_tol"],
            lin_maxiter=p["lin_maxiter"],
            # float32 CG never reaches lin_tol: the control keeps the
            # solver's default floor exit instead of running lin_maxiter
            lin_stall_window=200 if control else None,
            preconditioner=self.gmg.as_preconditioner())
        self.kept, self.failed, self.rec = [], 0, None
        self.need_units, self.slice_units = 1, 1

    def inputs(self, seed: int, seconds: float):
        """A pool of ``load_pool`` loads, magnitudes from the seed."""
        self.kept, self.failed = [], 0
        gen = torch.Generator(device=self.device).manual_seed(seed)
        p = self.params
        jit = 1.0 + p["load_jitter"] * (2.0 * torch.rand(
            p["load_pool"], generator=gen, dtype=torch.float64,
            device=self.device) - 1.0)
        self.loads = [self.ref.body_load(
            self.cfg["n"], [p["load_scale"] * j, p["load_scale"] * j],
            self.device).to(self.dtype) for j in jit.tolist()]

    def _zero(self):
        return torch.zeros(self.form.ndof, dtype=self.dtype,
                           device=self.device)

    def warm(self):
        """One Newton step with two CG iterations: every shape of a solve
        (residual, GMG refresh and coarse inverse, V-cycle, line search)."""
        opts = solvers.NewtonOptions(**{**vars(self.opts), "max_iter": 1,
                                        "lin_maxiter": 2})
        solvers.newton(self.form, self._zero(), self.loads[0], opts=opts)

    def unit(self, k: int) -> float:
        b = self.loads[k % len(self.loads)]
        res = solvers.newton(self.form, self._zero(), b, opts=self.opts)
        self.kept.append((b, res.x))
        self.failed += not res.converged
        if self.rec is not None:
            for li in res.lin_iters:
                self.rec.count("cg_per_direction", li)
        return 1.0

    def instrument(self, rec, spans):
        """Spans of the finest-level V-cycles and the CG counts."""
        self.rec = rec
        self.gmg.vcycle = spans.wrap(self.gmg.vcycle, "vcycle0",
                                     lambda lvl, *a, **k: lvl == 0)

    def uninstrument(self):
        self.rec = None
        self.gmg.__dict__.pop("vcycle", None)

    def slice(self):
        """The profiled slice: the first Newton step of a solve under the
        first load (a whole solve's trace takes minutes to reduce)."""
        opts = solvers.NewtonOptions(**{**vars(self.opts), "max_iter": 1})
        return solvers.newton(self.form, self._zero(), self.loads[0],
                              opts=opts)

    def release(self):
        del self.form, self.gmg, self.opts

    def check(self, limits: dict) -> list:
        """The reference's structures are built here, after the window."""
        grid = self.ref.Grid(self.cfg, self.device)
        worst_rel, worst_clamp = 0.0, 0.0
        for b, x in self.kept:
            b = b.to(torch.float64)
            r = self.ref.residual(grid, x, b, self.cfg["lambda"],
                                  self.cfg["mu"])
            rel = float(torch.linalg.vector_norm(r)
                        / torch.linalg.vector_norm(b))
            clamp = float(x[grid.clamped].abs().max())
            worst_rel, worst_clamp = worst(worst_rel, rel), worst(
                worst_clamp, clamp)
        return [("residual_rel", worst_rel, limits["residual_rel"]),
                ("clamped_max", worst_clamp, limits["clamped_max"])]
