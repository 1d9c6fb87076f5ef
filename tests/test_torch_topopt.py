"""Port parity, SiMPL topology optimization: ``mfem_ad_tpu_torch.mmto`` and
``examples.topopt``.

Against ``mfem_ad_tpu`` on the same problems, f64, CPU:

- ``SIMPFunction`` and ``ParametrizedElasticity``: values and gradients
  per point (1e-12), with rho inside (0, 1) and exactly at 0 and 1;
- the design sensitivity -2 dE/drho of the assembled energy at a (u, rho)
  whose rho holds entries of exactly 0.0 and 1.0, against JAX's: the
  port's clamp passes half the gradient at a tie, as ``jnp.clip`` does;
  a ``torch.clamp`` version disagrees there;
- the cantilever's load vector and essential dofs, ``dof_volume`` and
  ``_project_volume``;
- the 12x6 cantilever (``vol_frac=0.5``, ``step=5.0``, ``max_iter=30``),
  run through ``topopt.main``: JAX stops at iteration 26 with 4 elements
  at exactly rho = 1.0, so the run goes past the first tie.  Iteration
  count and saturated set equal; compliance history and rho to 1e-9
  relative: both state solves are the same Jacobi-CG run to lin_tol 1e-10,
  so the iterates agree to rounding (observed: 4e-12 and 3e-11 after 26
  steps); 1e-9 keeps a margin of 30x over that and is still 100x below a
  one-step divergence such as a tie decided differently;
- ``topopt.main``'s summary line equals the one JAX's example prints for
  the same run.

The JAX run happens once, in a module fixture.
"""

import io
from contextlib import redirect_stdout

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mfem_ad_tpu import mmto as jm
from mfem_ad_tpu_torch import mmto as pm
from mfem_ad_tpu_torch.examples import topopt

F64 = torch.float64
DEV = "cpu"
TOL_PT = 1e-12  # per-point values and gradients
TOL_TRAJ = 1e-9  # the 26-step trajectory (see the module docstring)
KW = dict(nx=12, ny=6)


def rel(a, b) -> float:
    a, b = np.asarray(a), np.asarray(b)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-300))


def _t(a):
    return torch.as_tensor(np.asarray(a), dtype=F64)


@pytest.fixture(scope="module")
def jax_run():
    form, design, b, m, disp = jm.build_cantilever(**KW)
    opt = jm.SiMPLTopopt(form, design, b, vol_frac=0.5, step=5.0)
    return opt, opt.solve(max_iter=30)


@pytest.fixture(scope="module")
def port_run():
    buf = io.StringIO()
    with redirect_stdout(buf):
        res, opt = topopt.main(["-nx", "12", "-ny", "6", "-mi", "30",
                                "--device", DEV])
    return opt, res, buf.getvalue()


def test_simp_function_matches_jax():
    E, p = [1.0, 0.5, 2.0], 3.0
    jf, pf = jm.SIMPFunction(E, p), pm.SIMPFunction(E, p)
    x = np.array([0.3, 0.9, 0.0])
    assert float(pf.energy(_t(x), {})) == pytest.approx(
        float(jf.energy(jnp.asarray(x), {})), rel=TOL_PT)
    g = torch.func.grad(lambda v: pf.energy(v, {}))(_t(x))
    assert rel(g, jax.grad(lambda v: jf.energy(v, {}))(jnp.asarray(x))) \
        <= TOL_PT


@pytest.mark.parametrize("r", [0.37, 0.0, 1.0])
def test_parametrized_elasticity_matches_jax(r):
    """Energy, d/d(grad u) and d/drho per point; at rho = 0 and 1 the
    clamp's tie."""
    jd = jm.build_cantilever(nx=2, ny=1)[1]
    pd = pm.build_cantilever(nx=2, ny=1, device=DEV)[1]
    je = jm.ParametrizedElasticity(2, jd, 1.0, 0.7)
    pe = pm.ParametrizedElasticity(2, pd, 1.0, 0.7)
    x = np.random.default_rng(3).standard_normal(4)

    def jfun(v, rho):
        return je.energy(v, {"rho": jnp.asarray([rho])})

    def pfun(v, rho):
        return pe.energy(v, {"rho": rho.reshape(1)})

    jx, jr = jnp.asarray(x), jnp.asarray(r)
    px, pr = _t(x), _t(r)
    assert float(pfun(px, pr)) == pytest.approx(float(jfun(jx, jr)),
                                                rel=TOL_PT)
    assert rel(torch.func.grad(pfun)(px, pr),
               jax.grad(jfun)(jx, jr)) <= TOL_PT
    assert float(torch.func.grad(pfun, argnums=1)(px, pr)) == \
        pytest.approx(float(jax.grad(jfun, argnums=1)(jx, jr)), rel=TOL_PT,
                      abs=1e-300)


def test_sensitivity_matches_jax_at_ties():
    """-2 dE/drho of the assembled energy where rho is exactly 0.0 and 1.0
    in some elements; a plain ``torch.clamp`` gives twice the value at
    rho = 1."""
    jform, jd, jb, _, _ = jm.build_cantilever(**KW)
    pform, pd, pb, _, _ = pm.build_cantilever(**KW, device=DEV)
    rng = np.random.default_rng(5)
    rho = rng.uniform(0.0, 1.0, pd.ndof)
    rho[::5], rho[1::7] = 1.0, 0.0
    u = 0.1 * rng.standard_normal(pform.ndof)
    jsens = -2.0 * jax.grad(
        lambda r: jform.energy(jnp.asarray(u), {"rho": r}))(jnp.asarray(rho))
    opt = pm.SiMPLTopopt(pform, pd, pb, vol_frac=0.5, step=5.0)
    psens = opt.sensitivity(_t(u), _t(rho))
    assert rel(psens, jsens) <= TOL_PT

    class Clamped(pm.ParametrizedElasticity):
        def energy(self, gradu, p):
            rho = torch.clamp(p["rho"][0], 0.0, 1.0)
            s = self.rho_min + (1.0 - self.rho_min) * rho**self.simp_exp
            G = gradu.reshape(2, 2)
            sym = 0.5 * (G + G.T)
            return s * (0.5 * self.lam0 * (G[0, 0] + G[1, 1]) ** 2
                        + self.mu0 * torch.sum(sym * sym))

    intg = pform.integrators[0]
    f = intg.f
    intg.f = Clamped(2, pd, f.lam0, f.mu0, f.simp_exp, f.rho_min)
    try:
        csens = opt.sensitivity(_t(u), _t(rho))
    finally:
        intg.f = f
    ones = rho == 1.0
    np.testing.assert_allclose(csens.numpy()[ones], 2 * psens.numpy()[ones],
                               rtol=1e-12)
    assert rel(csens.numpy()[~ones], psens.numpy()[~ones]) <= TOL_PT


def test_cantilever_tables_and_volume_match_jax(jax_run):
    jopt, _ = jax_run
    pform, pd, pb, pmesh, pdisp = pm.build_cantilever(**KW, device=DEV)
    _, _, jb, _, jdisp = jm.build_cantilever(**KW)
    assert rel(pb, jb) <= 1e-14
    np.testing.assert_array_equal(pform.ess_mask.numpy(),
                                  np.asarray(jopt.form.ess_mask))
    popt = pm.SiMPLTopopt(pform, pd, pb, vol_frac=0.5, step=5.0)
    assert rel(popt.dof_volume, jopt.dof_volume) <= 1e-14
    assert popt.total_volume == pytest.approx(jopt.total_volume, rel=1e-14)
    psi = np.random.default_rng(9).standard_normal(pd.ndof)
    jpsi, jrho = jopt._project_volume(jnp.asarray(psi))
    ppsi, prho = popt._project_volume(_t(psi))
    assert rel(ppsi, jpsi) <= 1e-12 and rel(prho, jrho) <= 1e-12
    assert popt._volume(prho) == pytest.approx(0.5, abs=1e-12)


def test_cantilever_trajectory_matches_jax(jax_run, port_run):
    _, jres = jax_run
    _, pres, _ = port_run
    jc, pc = jres.compliance_history, pres.compliance_history
    assert len(pc) == len(jc) == 26
    assert rel(pc, jc) <= TOL_TRAJ
    assert rel(pres.volume_history, jres.volume_history) <= TOL_TRAJ
    jrho, prho = np.asarray(jres.rho), pres.rho.numpy()
    assert int((jrho == 1.0).sum()) == 4
    np.testing.assert_array_equal(prho == 1.0, jrho == 1.0)
    assert rel(prho, jrho) <= TOL_TRAJ
    assert rel(pres.u.numpy(), jres.u) <= TOL_TRAJ
    # JAX's slow test's assertions
    assert pc[-1] < 0.9 * pc[0]
    assert abs(pres.volume_history[-1] - 0.5) < 1e-3
    assert prho.min() >= -1e-9 and prho.max() <= 1 + 1e-9
    # every state solve reached lin_tol (the residual carries rounding)
    assert len(pres.cg_iterations) == len(pc)
    assert max(pres.state_residuals) <= 1e-9


def test_topopt_main_prints_jax_summary(jax_run, port_run):
    """``examples/topopt.py``'s summary line, formatted from JAX's run."""
    _, jres = jax_run
    _, _, out = port_run
    rho = np.asarray(jres.rho)
    line = (f"topopt finished: compliance {jres.compliance_history[-1]:.6e} "
            f"({len(jres.compliance_history)} its), "
            f"volume fraction {jres.volume_history[-1]:.4f} "
            f"(target 0.5), rho in [{rho.min():.3f}, {rho.max():.3f}]")
    assert line in out.splitlines()
    assert out.count("topopt it ") == 26
