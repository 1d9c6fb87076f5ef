"""Traffic kind ``ldu_pg_iterations``: the first PG iterations of the
gradient-constrained obstacle problem (ex5), each unit from the initial
state x = 0, as ``models.gradient_obstacle.solve`` configures
``pg.PGSolver``: Newton with the lumped direction of the H1 latent,
FGMRES on the alpha-scaled saddle system under the block-LDU
preconditioner with the dense dual-Schur factor (``solvers._ldu_fgmres``
in its "direct" mode), beside the hp-GMG that set-up builds
(``gradient_obstacle._primal_gmg``).  The seed draws each unit's load
amplitude from a narrow band around ex5's.

A unit is ``pg_iters`` PG iterations (``tol`` 0).  It starts with
``reset_sigma()``, so that every unit builds K and Sigma^-1 at the first
alpha, as a new solve does.  The output check evaluates the plain
reference's residual of every iteration's subproblem at the iterate the
program returned for it (kept on the host, so that the device's peak does
not grow with the number of units in the window): the first from the
start (psi_k = 0), each later one with the latent of the iterate before
it, as the program froze it.  The control runs the same units with the
form in float32.
"""

from __future__ import annotations

import torch

from mfem_ad_tpu_torch import pg, solvers
from mfem_ad_tpu_torch.models import gradient_obstacle
from mfem_ad_tpu_torch.solvers import NewtonOptions
from mfem_ad_tpu_torch.utils import profiling

from harness import worst

# the counters of the direction's PGSchurGMG that a unit reports
_COUNTERS = ("ldu_applies", "ldu_a_cg_iters", "ldu_sigma_cg_iters",
             "sigma_builds", "sigma_refreshes")
_SIGMA_PHASES = ("ldu/sigma_K", "ldu/sigma_refresh")


def _sigma_seconds() -> float:
    t = profiling.cost_table()
    return sum(t[k].total_s for k in _SIGMA_PHASES if k in t)


class Traffic:
    def __init__(self, cfg: dict, params: dict, device, ref,
                 control: bool = False):
        self.cfg, self.params, self.ref = cfg, params, ref
        self.device = torch.device(device)
        dtype = self.dtype = torch.float32 if control else getattr(
            torch, cfg["precision"]["ldu_pg_iterations"])
        order, refs, n0 = cfg["order"], cfg["ref_levels"], cfg["n0"]
        self.pb = gradient_obstacle.build(order, refs, n0=n0, device=device,
                                          dtype=dtype)
        self.pre = gradient_obstacle._primal_gmg(order, refs, n0,
                                                 device=device, dtype=dtype)
        r = cfg["rule"]
        self.rule = pg.PGStepSizeRule(pg.PGStepSizeRule.EXP, r["alpha0"],
                                      r["max_alpha"], r["ratio"], 1.0)
        p = params["newton"]
        self.nopts = NewtonOptions(
            abs_tol=p["abs_tol"], rel_tol=0.0, max_iter=p["max_iter"],
            lin_solver="schur", lin_tol=p["lin_tol"],
            lin_maxiter=p["lin_maxiter"], sigma_direct=p["sigma_direct"],
            preconditioner=self.pre.as_preconditioner())
        self.iters = cfg["pg_iterations"]
        self.accept = params["newton_accept"]
        self.kept, self.failed, self.rec = [], 0, None
        self.need_units, self.slice_units = 1, 1

    def inputs(self, seed: int, seconds: float):
        """A pool of loads: ex5's load times amplitudes drawn from the
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

    def _solver(self, nopts, accept):
        return pg.PGSolver(self.pb.form, self.rule, latent_block=1,
                           latent_space=self.pb.latent_space,
                           newton_opts=nopts, max_iter=self.iters, tol=0.0,
                           newton_accept=accept)

    def warm(self):
        """The unit's PG iterations of one Newton step of three FGMRES
        iterations each, from a dropped factor: every shape of a unit
        (K's build, Sigma's refresh at the fourth alpha, the LDU apply,
        FGMRES, line search, the latent's L1 norm)."""
        nopts = NewtonOptions(**{**vars(self.nopts), "max_iter": 1,
                                 "lin_maxiter": 3})
        self.pre.reset_sigma()
        self._solver(nopts, float("inf")).solve(self._zero(), self.loads[0])

    def unit(self, k: int) -> float:
        xs = []
        before = self._counters() if self.rec is not None else None
        self.pre.reset_sigma()
        res = self._solver(self.nopts, self.accept).solve(
            self._zero(), self.loads[k % len(self.loads)],
            callback=lambda it, x, lam: xs.append(x.to("cpu")))
        self.kept.append((k, xs))
        self.failed += len(xs) < self.iters
        if self.rec is not None:
            for n in res.newton_iters:
                self.rec.count("newton_per_pg_iter", n)
            for name, a, b in zip(_COUNTERS + ("sigma_factor_s",), before,
                                  self._counters()):
                self.rec.count(name, b - a)
        return float(len(xs))

    def _counters(self):
        return tuple(getattr(self.pre, c) for c in _COUNTERS) + (
            _sigma_seconds(),)

    def instrument(self, rec, spans):
        """CUDA-event spans of every LDU apply; the FGMRES count of every
        Newton direction, from the results ``pg`` gets; the direction's
        counters and the seconds of K's builds and Sigma's refreshes (the
        synchronised phases ``ldu/sigma_K``, ``ldu/sigma_refresh``), per
        unit."""
        self.rec = rec
        apply, newton = solvers.ldu_apply, pg.newton
        solvers.ldu_apply = spans.wrap(apply, "ldu_apply")

        def counted(*args, **kwargs):
            res = newton(*args, **kwargs)
            for li in res.lin_iters:
                rec.count("fgmres_per_direction", li)
            return res

        pg.newton = counted

        def restore():
            solvers.ldu_apply = apply
            pg.newton = newton

        self._restore = restore

    def uninstrument(self):
        restore = getattr(self, "_restore", None)
        if restore is not None:
            restore()

    def slice(self):
        """The profiled slice: the first Newton step of PG iteration 1,
        from a dropped factor."""
        lat = self.pb.form.offsets[1]
        fields = {"alpha": self.rule.get(0),
                  "latent_k0": self._zero()[lat:]}
        nopts = NewtonOptions(**{**vars(self.nopts), "max_iter": 1})
        self.pre.reset_sigma()
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
                res = self.ref.residual(sp, x, psi_k, alpha, b)
                worst_r = worst(worst_r,
                                float(torch.linalg.vector_norm(res)))
                psi_k = x[sp.nh:]
            missing += self.iters - len(xs)
        return [("residual", worst_r, limits["residual"]),
                ("iterations_missing", float(missing),
                 limits["iterations_missing"])]
