"""Port parity, the options of ``newton``.

Each option of ``NewtonOptions`` that changes the iteration, against
``mfem_ad_tpu.solvers.newton`` on the same problem in f64:

- ``damping=0.5``: the half step converges linearly, in the reference's
  number of iterations and to its iterate (1e-10 relative);
- ``stall_iters=None``: on a singular system with no solution Newton runs
  to ``max_iter`` instead of stopping at the floor, as the reference does;
- a callable ``preconditioner(form, state) -> M`` for MINRES: called once
  per Newton step, the reference's iterations and iterate;
- ``verbose=True``: one line per residual evaluation, in the reference's
  format;
- ``preconditioner="jacobi"`` on the dof-PG obstacle where the mirror map
  saturates: the same scaling as the reference's, whose E*'' rounds to
  exactly 0 there while the port's keeps values near 1e-23 (the port
  takes every diagonal entry at or below eps * max|d| as zero).

The problem: 0.5 g.g + 0.25 (g.g)^2 over H1 Q2 on 3x3 quads, u = 0 on the
boundary, load 1 + x y; the singular one: diffusion on 4x4 Q1 with no
essential dofs and a load of nonzero mean.
"""

import re

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import mfem_ad_tpu.ad as jad
from mfem_ad_tpu import mesh as JM
from mfem_ad_tpu import solvers as JS
from mfem_ad_tpu.adeval import ADEval as JADEval
from mfem_ad_tpu.fespace import FESpace as JFESpace
from mfem_ad_tpu.forms import LinearForm as JLinearForm
from mfem_ad_tpu.forms import NonlinearForm as JNonlinearForm
from mfem_ad_tpu.models import obstacle as jobs
from mfem_ad_tpu_torch import ad as pad
from mfem_ad_tpu_torch import mesh as PM
from mfem_ad_tpu_torch import solvers as PS
from mfem_ad_tpu_torch.adeval import ADEval as PADEval
from mfem_ad_tpu_torch.fespace import FESpace as PFESpace
from mfem_ad_tpu_torch.forms import LinearForm as PLinearForm
from mfem_ad_tpu_torch.forms import NonlinearForm as PNonlinearForm
from mfem_ad_tpu_torch.models import obstacle as pobs

F64 = torch.float64


class JQuartic(jad.ADFunction):
    def __init__(self):
        super().__init__(2)

    def energy(self, g, p):
        gg = g[0] * g[0] + g[1] * g[1]
        return 0.5 * gg + 0.25 * gg * gg


class PQuartic(pad.ADFunction):
    def __init__(self):
        super().__init__(2)

    def energy(self, g, p):
        gg = g[0] * g[0] + g[1] * g[1]
        return 0.5 * gg + 0.25 * gg * gg


def _problem(pkg, singular=False):
    """(form, load) of the quartic problem, or of the singular one."""
    if pkg == "jax":
        M, FES, Form, LF, Ev, kw = (JM, JFESpace, JNonlinearForm,
                                    JLinearForm, JADEval, {})
        energy = jad.DiffusionEnergy(2) if singular else JQuartic()
    else:
        M, FES, Form, LF, Ev, kw = (PM, PFESpace, PNonlinearForm,
                                    PLinearForm, PADEval, {"device": "cpu"})
        energy = pad.DiffusionEnergy(2) if singular else PQuartic()
    n, order = (4, 1) if singular else (3, 2)
    m = M.make_cartesian_2d(n, n)
    fes = FES(m, order)
    form = Form(fes, **kw)
    form.add_ad_integrator(energy, Ev.GRAD)
    if not singular:
        form.set_essential_bc([np.ones(m.max_bdr_attribute())])
    load = np.asarray(LF(fes, lambda x: 1.0 + x[0] * x[1]).assemble())
    load = np.where(np.asarray(form.ess_mask), 0.0, load)
    return form, load


def _solve(pkg, opts, singular=False):
    form, load = _problem(pkg, singular)
    if pkg == "jax":
        return JS.newton(form, jnp.zeros(form.ndof), b=jnp.asarray(load),
                         opts=JS.NewtonOptions(**opts))
    return PS.newton(form, torch.zeros(form.ndof, dtype=F64),
                     b=torch.as_tensor(load), opts=PS.NewtonOptions(**opts))


def _rel(actual, ref):
    actual, ref = np.asarray(actual), np.asarray(ref)
    return np.abs(actual - ref).max() / max(np.abs(ref).max(), 1e-300)


def _shifted_jacobi(xp):
    """A callable preconditioner, 1 / (|diag J| + 1), for ``xp`` = jnp or
    torch; counts its calls."""

    def make(form, state):
        make.calls += 1
        d = xp.abs(form.grad_diag(state)) + 1.0
        return lambda v: v / d

    make.calls = 0
    return make


BASE = dict(abs_tol=1e-11, rel_tol=1e-12, max_iter=20, lin_solver="dense")


def test_newton_damping_matches_jax():
    opts = dict(BASE, damping=0.5, max_iter=80)
    j, p = _solve("jax", opts), _solve("torch", opts)
    full = _solve("torch", BASE)
    assert j.converged and p.converged and full.converged
    # the half step contracts by about 2 per iteration: many more steps
    assert p.iterations == j.iterations >= 3 * full.iterations
    assert _rel(p.x.numpy(), j.x) <= 1e-10
    assert _rel(p.x.numpy(), full.x.numpy()) <= 1e-10


@pytest.mark.parametrize("stall_iters", [2, None])
def test_newton_stall_iters_matches_jax(stall_iters):
    opts = dict(abs_tol=1e-12, max_iter=6, lin_solver="dense",
                stall_iters=stall_iters)
    j, p = _solve("jax", opts, True), _solve("torch", opts, True)
    # no solution (the load has a nonzero mean): Newton floors
    assert not j.converged and not p.converged
    assert p.iterations == j.iterations
    if stall_iters is None:
        assert p.iterations == 6  # ran to max_iter
    else:
        assert p.iterations < 6  # stopped at the floor
    assert _rel(p.history, j.history) <= 1e-10
    assert _rel(p.x.numpy(), j.x) <= 1e-10


def test_newton_callable_preconditioner_matches_jax():
    jprec, pprec = _shifted_jacobi(jnp), _shifted_jacobi(torch)
    kw = dict(BASE, lin_solver="minres", lin_tol=1e-13)
    j = _solve("jax", dict(kw, preconditioner=jprec))
    p = _solve("torch", dict(kw, preconditioner=pprec))
    assert j.converged and p.converged
    assert p.iterations == j.iterations >= 3
    assert pprec.calls == jprec.calls == p.iterations
    assert _rel(p.x.numpy(), j.x) <= 1e-10


def test_newton_verbose_matches_jax(capsys):
    opts = dict(BASE, verbose=True)
    j = _solve("jax", opts)
    jlines = capsys.readouterr().out.splitlines()
    p = _solve("torch", opts)
    plines = capsys.readouterr().out.splitlines()
    assert len(plines) == len(jlines) == len(p.history) == len(j.history)
    pat = re.compile(r"^  newton it +(\d+): \|\|r\|\| = (\S+)$")
    for it, (pl, jl) in enumerate(zip(plines, jlines)):
        pm, jm = pat.match(pl), pat.match(jl)
        assert pm and jm and int(pm[1]) == int(jm[1]) == it
        assert float(pm[2]) == float(f"{p.history[it]:.6e}")
    assert _solve("torch", BASE).history == p.history
    assert capsys.readouterr().out == ""


def test_jacobi_matches_jax_where_the_mirror_saturates():
    """The dof-PG obstacle (order 1, 4x4 cells) at psi = 100 on every
    other dual dof: scale * psi = 50, where JAX's E*'' is exactly 0 and
    the port's 0.25 exp(-50); both preconditioners take 1 there."""
    kw = dict(order=1, ref_levels=0, n0=4)
    jpb, ppb = jobs.build_dofpg(**kw), pobs.build_dofpg(**kw, device="cpu")
    rng = np.random.default_rng(4)
    nu = ppb.primal_space.ndof
    x = np.concatenate([0.1 * rng.standard_normal(nu),
                        rng.standard_normal(ppb.latent_space.ndof)])
    x[nu::2] = 100.0
    psik = 0.1 * rng.standard_normal(ppb.latent_space.ndof)
    v = rng.standard_normal(ppb.form.ndof)
    jf = {"alpha": jnp.asarray(1.0), "latent_k0": jnp.asarray(psik)}
    pf = {"alpha": 1.0, "latent_k0": torch.as_tensor(psik)}
    jst = jpb.form.grad_state(jnp.asarray(x), jf)
    pst = ppb.form.grad_state(torch.as_tensor(x), pf)
    d = ppb.form.grad_diag(pst)[nu::2].abs()
    assert float(d.max()) < 1e-20 and float(d.min()) > 1e-30
    jm = np.asarray(JS._make_precond(jpb.form, jst, "jacobi")(jnp.asarray(v)))
    pm = PS._make_precond(ppb.form, pst, "jacobi")(torch.as_tensor(v))
    np.testing.assert_allclose(pm.numpy(), jm, rtol=1e-12, atol=0)

