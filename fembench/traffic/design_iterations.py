"""Traffic kind ``design_iterations``: the first design iterations of MFEM
ex37's density-filtered SiMPL topology optimization, each unit from the
initial design (psi = logit(theta)), as ``models.topopt.build_ex37``
configures ``mmto.FilteredSiMPL``: the PDE filter and its adjoint by CG
under a scalar hp-GMG, the SIMP state by CG under a vector hp-GMG whose
every level set-up builds once and each design iteration re-linearizes at
the injected filtered density, the L2 latent's mirror step and the
volume's bisection.  The seed draws each unit's load amplitude from a
narrow band around ex37's.

A unit is ``design_iterations`` design iterations; it fails where a CG
solve of it stops at its iteration cap.  The output check evaluates the
plain reference at every iteration of every unit, at the iterates the
program returned (kept on the host, so that the device's peak does not
grow with the number of units): the filter's, the state's and the adjoint
filter's relative residuals, and the next latent from the program's w by
the reference's own projection, against the program's.  The control runs
the same units in float32.
"""

from __future__ import annotations

import math

import torch

from mfem_ad_tpu_torch.models import topopt
from mfem_ad_tpu_torch.utils import profiling

from harness import worst

# the program's synchronised phases that the per-layer metrics read
_PHASES = ("topopt/gmg_refresh", "topopt/filter", "topopt/adjoint",
           "topopt/volume")


def _phases():
    t = profiling.cost_table()
    return {k: (t[k].total_s, t[k].count) if k in t else (0.0, 0)
            for k in _PHASES}


class Traffic:
    def __init__(self, cfg: dict, params: dict, device, ref,
                 control: bool = False):
        self.cfg, self.params, self.ref = cfg, params, ref
        self.device = torch.device(device)
        self.dtype = torch.float32 if control else getattr(
            torch, cfg["precision"]["design_iterations"])
        nq = cfg["quadrature_points_per_axis"]
        self.pb = topopt.build_ex37(
            cfg["ref_levels"], cfg["order"], alpha=cfg["alpha"],
            eps=cfg["filter_radius"], vol_frac=cfg["volume_fraction"],
            rho_min=cfg["rho_min"], lam=cfg["lambda"], mu=cfg["mu"],
            lin_tol=cfg["lin_tol"], lin_maxiter=cfg["lin_maxiter"],
            proj_tol=cfg["proj_tol"], coarse_ny=cfg["gmg"]["coarse_ny"],
            ir_order=2 * nq - 2, device=device, dtype=self.dtype)
        self.opt = self.pb.opt
        self.iters = cfg["design_iterations"]
        self.kept, self.failed, self.rec = [], 0, None
        self.need_units, self.slice_units = 1, 1

    def inputs(self, seed: int, seconds: float):
        """A pool of loads: ex37's times amplitudes drawn from the seed in
        [1 - spread, 1 + spread]."""
        self.kept, self.failed = [], 0
        gen = torch.Generator(device=self.device).manual_seed(seed)
        u = torch.rand(self.params["load_pool"], generator=gen,
                       dtype=torch.float64, device=self.device).tolist()
        s = self.params["amplitude_spread"]
        self.amps = [1.0 + s * (2.0 * v - 1.0) for v in u]
        self.loads = [a * self.pb.load for a in self.amps]

    def warm(self):
        """One design iteration of two CG iterations a solve: every shape
        of a unit (both GMGs' V-cycle graphs, the refresh, the
        sensitivity, the projection)."""
        maxiter, self.opt.lin_maxiter = self.opt.lin_maxiter, 2
        try:
            self.opt.rhs = self.loads[0]
            self.opt.solve(1)
        finally:
            self.opt.lin_maxiter = maxiter

    def unit(self, k: int) -> float:
        xs = []
        before = _phases() if self.rec is not None else None
        self.opt.rhs = self.loads[k % len(self.loads)]
        res = self.opt.solve(self.iters, callback=lambda it, psi, rho, u, w,
                             psi_next: xs.append(tuple(
                                 t.to("cpu") for t in (rho, u, w, psi_next))))
        self.kept.append((k, xs))
        cap = self.opt.lin_maxiter
        self.failed += len(xs) < self.iters or any(
            n >= cap for n in res.cg_iterations) or any(
            max(p) >= cap for p in res.filter_cg_iterations)
        if self.rec is not None:
            after = _phases()
            d = {k: (after[k][0] - before[k][0], after[k][1] - before[k][1])
                 for k in _PHASES}
            for n in res.cg_iterations:
                self.rec.count("state_cg_per_iter", n)
            self.rec.count("gmg_refresh_s", d["topopt/gmg_refresh"][0])
            self.rec.count("gmg_refreshes", d["topopt/gmg_refresh"][1])
            self.rec.count("filter_solve_s", d["topopt/filter"][0]
                           + d["topopt/adjoint"][0])
            self.rec.count("design_iterations", len(res.cg_iterations))
            self.rec.count("projection_s", d["topopt/volume"][0])
            self.rec.count("projections", d["topopt/volume"][1])
        return 1.0

    def instrument(self, rec, spans):
        """The counts of every unit from its result, and the seconds of
        the program's synchronised phases (``topopt/gmg_refresh``,
        ``topopt/filter`` + ``topopt/adjoint``, ``topopt/volume``)."""
        self.rec = rec

    def uninstrument(self):
        self.rec = None

    def slice(self):
        """The profiled slice: design iteration 1 under the first load."""
        self.opt.rhs = self.loads[0]
        return self.opt.solve(1)

    def release(self):
        del self.pb, self.opt

    def check(self, limits: dict) -> list:
        """The reference's spaces are built here, after the window."""
        cfg, ref = self.cfg, self.ref
        sp = ref.Spaces(2 ** cfg["ref_levels"], cfg["order"],
                        cfg["quadrature_points_per_axis"], self.device)
        loads = ref.loads(sp, self.amps)
        lam, mu, rho0 = cfg["lambda"], cfg["mu"], cfg["rho_min"]
        eps, theta = cfg["filter_radius"], cfg["volume_fraction"]
        worst_f = worst_s = worst_a = worst_step = 0.0
        missing = 0
        f64 = torch.float64
        for k, xs in self.kept:
            b = loads[k % len(loads)]
            psi = torch.full((sp.nl,), math.log(theta / (1.0 - theta)),
                             dtype=f64, device=self.device)
            for it, x in enumerate(xs, 1):
                rho, u, w, psi_next = (t.to(self.device, f64) for t in x)
                lf = ref.filter_load(sp, psi)
                worst_f = worst(worst_f, ref.relative(
                    ref.filter_residual(sp, rho, lf, eps), lf))
                worst_s = worst(worst_s, ref.relative(ref.state_residual(
                    sp, u, rho, b, lam, mu, rho0), b))
                g = ref.sensitivity(sp, u, rho, lam, mu, rho0)
                worst_a = worst(worst_a, ref.relative(
                    ref.filter_residual(sp, w, g, eps), g))
                want = ref.next_latent(sp, psi, w, it * cfg["alpha"], theta)
                worst_step = worst(worst_step, float(
                    (psi_next - want).abs().max() / (want - psi).abs().max()))
                psi = psi_next
            missing += self.iters - len(xs)
        return [("state_residual", worst_s, limits["state_residual"]),
                ("filter_residual", worst_f, limits["filter_residual"]),
                ("adjoint_residual", worst_a, limits["adjoint_residual"]),
                ("step", worst_step, limits["step"]),
                ("iterations_missing", float(missing),
                 limits["iterations_missing"])]
