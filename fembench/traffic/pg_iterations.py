"""Traffic kind ``pg_iterations``: the first PG iterations of the LVPP
obstacle problem (ex4), each unit from the initial state x = 0, as
``models.obstacle.solve`` configures ``pg.PGSolver``: Newton with the
exact Schur elimination of the L2 latent, CG preconditioned by the
alpha-shifted hp-GMG that set-up builds.  The seed draws each unit's load
amplitude from a narrow band around ex4's.

A unit is ``pg_iters`` PG iterations (``tol`` 0).  The output check
evaluates the plain reference's residual of every iteration's subproblem
at the iterate the program returned for it (kept on the host, so that the
device's peak does not grow with the number of units in the window): the
first from the start (psi_k = 0), each later one with the latent of the
iterate before it, as the program froze it.  The control runs the same units in float32, the
program's own lower-precision path.
"""

from __future__ import annotations

import numpy as np
import torch

from mfem_ad_tpu_torch import mesh as M
from mfem_ad_tpu_torch import pg
from mfem_ad_tpu_torch.ad import DiffusionEnergy
from mfem_ad_tpu_torch.adeval import ADEval
from mfem_ad_tpu_torch.fespace import FESpace
from mfem_ad_tpu_torch.forms import NonlinearForm
from mfem_ad_tpu_torch.models import obstacle
from mfem_ad_tpu_torch.multigrid import GMG, PGSchurGMG, build_hp_hierarchy
from mfem_ad_tpu_torch.solvers import NewtonOptions

from harness import worst


class Traffic:
    def __init__(self, cfg: dict, params: dict, device, ref,
                 control: bool = False):
        self.cfg, self.params, self.ref = cfg, params, ref
        self.device = torch.device(device)
        dtype = self.dtype = torch.float32 if control else getattr(
            torch, cfg["precision"]["pg_iterations"])
        order, refs, n0 = cfg["order"], cfg["ref_levels"], cfg["n0"]
        self.pb = obstacle.build(order, refs, n0=n0, lower=cfg["lower"],
                                 upper=cfg["upper"], device=device,
                                 dtype=dtype)

        def level(n, p):
            m = M.make_cartesian_2d(n, n)
            f = NonlinearForm(FESpace(m, p), device=device, dtype=dtype)
            f.add_ad_integrator(DiffusionEnergy(2), ADEval.GRAD)
            f.set_essential_bc([np.ones(m.max_bdr_attribute())])
            return f

        self.pre = PGSchurGMG(GMG(build_hp_hierarchy(
            level, n0, refs + 1, order + 1)))
        r = cfg["rule"]
        self.rule = pg.PGStepSizeRule(pg.PGStepSizeRule.EXP, r["alpha0"],
                                      r["max_alpha"], r["ratio"], 1.0)
        p = params["newton"]
        self.nopts = NewtonOptions(
            abs_tol=p["abs_tol"], rel_tol=0.0, max_iter=p["max_iter"],
            lin_solver="schur", lin_tol=p["lin_tol"],
            lin_maxiter=p["lin_maxiter"],
            preconditioner=self.pre.as_preconditioner())
        self.iters = cfg["pg_iterations"]
        self.accept = params["newton_accept"]
        self.kept, self.failed, self.rec = [], 0, None
        self.need_units, self.slice_units = 1, 1

    def inputs(self, seed: int, seconds: float):
        """A pool of loads: ex4's load times amplitudes drawn from the
        seed in [1 - spread, 1 + spread]."""
        self.kept, self.failed = [], 0
        gen = torch.Generator(device=self.device).manual_seed(seed)
        u = torch.rand(self.params["load_pool"], generator=gen,
                       dtype=torch.float64, device=self.device).tolist()
        s = self.params["amplitude_spread"]
        cfg = self.cfg
        self.loads = [b.to(self.dtype) for b in self.ref.loads(
            cfg["n0"] * 2 ** cfg["ref_levels"], cfg["order"],
            cfg["quadrature_points_per_axis"],
            [1.0 + s * (2.0 * v - 1.0) for v in u], self.device)]

    def _zero(self):
        return torch.zeros(self.pb.form.ndof, dtype=self.dtype,
                           device=self.device)

    def _solver(self, iters, nopts, accept):
        return pg.PGSolver(self.pb.form, self.rule, latent_block=1,
                           latent_space=self.pb.latent_space,
                           newton_opts=nopts, max_iter=iters, tol=0.0,
                           newton_accept=accept)

    def warm(self):
        """Two PG iterations of one Newton step of three CG iterations
        each: every shape of a unit (Schur arrays, shifted V-cycle, CG,
        line search, the latent's L1 norm)."""
        nopts = NewtonOptions(**{**vars(self.nopts), "max_iter": 1,
                                 "lin_maxiter": 3})
        self._solver(2, nopts, float("inf")).solve(self._zero(),
                                                   self.loads[0])

    def unit(self, k: int) -> float:
        xs = []
        res = self._solver(self.iters, self.nopts, self.accept).solve(
            self._zero(), self.loads[k % len(self.loads)],
            callback=lambda it, x, lam: xs.append(x.to("cpu")))
        self.kept.append((k, xs))
        self.failed += len(xs) < self.iters
        if self.rec is not None:
            for n in res.newton_iters:
                self.rec.count("newton_per_pg_iter", n)
        return float(len(xs))

    def instrument(self, rec, spans):
        """Spans of the finest-level shifted V-cycles; the Schur CG count
        of every Newton direction, from the results ``pg`` gets."""
        self.rec = rec
        gmg = self.pre.gmg
        gmg.vcycle = spans.wrap(gmg.vcycle, "vcycle0",
                                lambda lvl, *a, **k: lvl == 0)
        newton = pg.newton

        def counted(*args, **kwargs):
            res = newton(*args, **kwargs)
            for li in res.lin_iters:
                rec.count("cg_per_direction", li)
            return res

        pg.newton = counted
        self._restore = lambda: setattr(pg, "newton", newton)

    def uninstrument(self):
        restore = getattr(self, "_restore", None)
        if restore is not None:
            restore()

    def slice(self):
        """The profiled slice: the first Newton step of PG iteration 1."""
        lat = self.pb.form.offsets[1]
        fields = {"alpha": self.rule.get(0),
                  "latent_k0": self._zero()[lat:]}
        nopts = NewtonOptions(**{**vars(self.nopts), "max_iter": 1})
        return pg.newton(self.pb.form, self._zero(), self.loads[0], fields,
                         nopts)

    def release(self):
        self.uninstrument()
        del self.pb, self.pre, self.nopts

    def check(self, limits: dict) -> list:
        """The reference's spaces are built here, after the window."""
        cfg = self.cfg
        sp = self.ref.Spaces(cfg["n0"] * 2 ** cfg["ref_levels"],
                             cfg["order"], cfg["quadrature_points_per_axis"],
                             self.device)
        r = cfg["rule"]
        worst_r, missing = 0.0, 0
        for k, xs in self.kept:
            b = self.loads[k % len(self.loads)].to(torch.float64)
            psi_k = torch.zeros(sp.nl, dtype=torch.float64,
                                device=self.device)
            for it, x in enumerate(xs):
                x = x.to(self.device)
                alpha = min(r["alpha0"] * r["ratio"] ** it, r["max_alpha"])
                res = self.ref.residual(sp, x, psi_k, alpha, b, cfg["lower"],
                                        cfg["upper"])
                worst_r = worst(worst_r,
                                float(torch.linalg.vector_norm(res)))
                psi_k = x[sp.nh:]
            missing += self.iters - len(xs)
        return [("residual", worst_r, limits["residual"]),
                ("iterations_missing", float(missing),
                 limits["iterations_missing"])]
