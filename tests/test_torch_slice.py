"""Port parity, the whole slice: ex3 (linear elasticity) and a neo-Hookean
Newton–CG solve against the JAX package, and the ex1 (Poisson) MMS
convergence rates of the port, in f64 on meshes of at most 8x8 elements."""

import functools

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
from mfem_ad_tpu.models import elasticity as jex3
from mfem_ad_tpu_torch import ad as pad
from mfem_ad_tpu_torch import mesh as PM
from mfem_ad_tpu_torch import solvers as PS
from mfem_ad_tpu_torch.adeval import ADEval as PADEval
from mfem_ad_tpu_torch.fespace import FESpace as PFESpace
from mfem_ad_tpu_torch.forms import LinearForm as PLinearForm
from mfem_ad_tpu_torch.forms import NonlinearForm as PNonlinearForm
from mfem_ad_tpu_torch.models import elasticity as pex3
from mfem_ad_tpu_torch.models import poisson as pex1

F64 = torch.float64


def _rel_l2(a, ref):
    a, ref = np.asarray(a), np.asarray(ref)
    return np.linalg.norm(a - ref) / np.linalg.norm(ref)


def _ex3_opts(mod):
    # the options of models.elasticity.solve in both packages
    return mod.NewtonOptions(
        abs_tol=1e-10, max_iter=3, lin_solver="cg", lin_tol=1e-14,
        lin_maxiter=20000, preconditioner="jacobi",
    )


def test_ex3_solution_matches_jax():
    """ex3 on 8x8 Q1 elements: solutions within 1e-8 relative L2
    (BASELINE.md:24-25)."""
    jpb = jex3.build(order=1, ref_levels=0, n0=8)
    ppb = pex3.build(order=1, ref_levels=0, n0=8, device="cpu")
    np.testing.assert_allclose(ppb.rhs.numpy(), np.asarray(jpb.rhs),
                               rtol=1e-14, atol=1e-16)
    assert np.array_equal(ppb.form.ess_mask.numpy(),
                          np.asarray(jpb.form.ess_mask))
    jres = JS.newton(jpb.form, jnp.zeros(jpb.space.ndof), b=jpb.rhs,
                     opts=_ex3_opts(JS))
    pres = PS.newton(ppb.form, torch.zeros(ppb.space.ndof, dtype=F64),
                     b=ppb.rhs, opts=_ex3_opts(PS))
    assert jres.converged and pres.converged
    assert _rel_l2(pres.x.numpy(), jres.x) <= 1e-8


def test_ex3_model_solve_runs_and_converges():
    res, pb = pex3.solve(order=1, ref_levels=0, device="cpu")
    assert res.converged and res.lin_iters and res.history[-1] <= 1e-10
    assert pb.mesh.num_elements == 100


@functools.lru_cache(maxsize=None)
def _mms_errors(order):
    return [pex1.solve(order=order, ref_levels=0, n0=n, device="cpu")[1]
            for n in (4, 8)]


@pytest.mark.parametrize("order", [1, 2, 3])
def test_ex1_mms_rate(order):
    """L2 error rate h^(p+1): 2.00/3.00/4.00 for p=1/2/3 (4x4 -> 8x8)."""
    e4, e8 = _mms_errors(order)
    assert abs(np.log2(e4 / e8) - (order + 1)) < 0.05, (e4, e8)


NH_SCALE = 0.05  # body-force scale: max |grad u| ~ 0.1 on this problem


def _neohookean_ex3(pkg, n):
    """ex3's boundary conditions and load (clamped left side, body force
    NH_SCALE * (1, 1)) with a neo-Hookean energy on an n x n Q1 mesh."""
    if pkg == "jax":
        m = JM.make_cartesian_2d(n, n)
        fes = JFESpace(m, 1, vdim=2)
        form = JNonlinearForm(fes)
        form.add_ad_integrator(jad.NeoHookeanEnergy(2, 1.0, 1.0),
                               JADEval.GRAD | JADEval.VECTOR)
        load_form = JLinearForm
    else:
        m = PM.make_cartesian_2d(n, n)
        fes = PFESpace(m, 1, vdim=2)
        form = PNonlinearForm(fes, device="cpu")
        form.add_ad_integrator(pad.NeoHookeanEnergy(2, 1.0, 1.0),
                               PADEval.GRAD | PADEval.VECTOR)
        load_form = PLinearForm
    ess = np.zeros(m.max_bdr_attribute())
    ess[3] = 1
    form.set_essential_bc([ess])
    load = NH_SCALE * load_form(fes, lambda x: np.ones(2)).assemble()
    load[np.asarray(fes.essential_dofs(ess))] = 0.0
    return form, fes, load


def _nh_opts(mod):
    return mod.NewtonOptions(
        abs_tol=1e-12, rel_tol=1e-10, max_iter=6, lin_solver="cg",
        lin_tol=1e-10, lin_maxiter=20000, preconditioner="jacobi",
    )


def test_neohookean_newton_cg_history_matches_jax():
    jform, jfes, jload = _neohookean_ex3("jax", 8)
    pform, pfes, pload = _neohookean_ex3("torch", 8)
    jres = JS.newton(jform, jnp.zeros(jfes.ndof), b=jnp.asarray(jload),
                     opts=_nh_opts(JS))
    pres = PS.newton(pform, torch.zeros(pfes.ndof, dtype=F64),
                     b=torch.as_tensor(pload), opts=_nh_opts(PS))
    assert pres.converged and jres.converged
    assert len(pres.history) == len(jres.history) >= 3
    # Each residual norm to 1e-8 relative, plus what the previous inexact
    # CG direction admits (lin_tol of the previous norm: the two packages'
    # CG iterates differ in rounding); entries past the stopping threshold
    # only need to be past it in both.
    opts = _nh_opts(PS)
    stop = opts.rel_tol * jres.history[0]
    hist = list(zip(pres.history, jres.history))
    assert pres.history[0] == pytest.approx(jres.history[0], rel=1e-12)
    for (hp, hj), (_, hprev) in zip(hist[1:], hist[:-1]):
        if hj > stop:
            tol = 1e-8 * hj + 10 * opts.lin_tol * hprev
            assert abs(hp - hj) <= tol, (pres.history, jres.history)
        else:
            assert hp <= stop
    assert _rel_l2(pres.x.numpy(), jres.x) <= 1e-8
    g = pform.integrators[0].x_qp([pres.x])
    F = g + torch.tensor([1.0, 0.0, 0.0, 1.0], dtype=F64)
    assert torch.all(F[..., 0] * F[..., 3] - F[..., 1] * F[..., 2] > 0)
