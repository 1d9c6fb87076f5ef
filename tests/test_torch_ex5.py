"""Port parity, the gradient-constrained obstacle (ex5), the outer loop:
``PGSolver`` on ``models.gradient_obstacle`` and ``examples.ex5``.

Against ``mfem_ad_tpu``, f64, CPU, trajectories to 1e-8 relative and
iteration counts equal:

- ``PGSolver`` on ex5's form at order 2, ref 0, n0 4, EXP a0 1 ratio 2,
  5 iterations with ``tol=0``, both with JAX's default options (the
  LDU-FGMRES direction with the hp-GMG and the dense dual-Schur factor):
  the lambda per iteration and its L1 diff, Newton and FGMRES counts
  (from the verbose lines), x;
- ``ex5.main(["--device", "cpu", "-r", "0", "--solver", "dense", ...])``
  (n0 10) run to lambda diff < 1e-8 against JAX's run, with the checks of
  JAX's ``test_gradient_obstacle_lvpp_regression``.

``tests/test_torch_gradient_obstacle.py`` holds the single directions.
"""

import re

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import mfem_ad_tpu.pg as jpg
from mfem_ad_tpu import solvers as JS
from mfem_ad_tpu.models import gradient_obstacle as jgo
from mfem_ad_tpu_torch import pg as ppg
from mfem_ad_tpu_torch import solvers as PS
from mfem_ad_tpu_torch.examples import ex5
from mfem_ad_tpu_torch.geometry import geom_factors, phys_dshape
from mfem_ad_tpu_torch.models import gradient_obstacle as pgo
from mfem_ad_tpu_torch.quadrature import get_rule

F64 = torch.float64
TOL_DIR = 1e-8
PB_KW = dict(order=2, ref_levels=0, n0=4)
PG_ITERS = 5


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch thread for this module: under the test workers'
    contention torch's multithreaded CPU LAPACK (the SVD of
    ``dense_solve``'s ``pinv`` fallback above all) runs up to 10x slower
    than alone; one thread computes the same and keeps the module near
    its time alone."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def rel(a, b) -> float:
    a, b = np.asarray(a), np.asarray(b)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


PG_LINE = re.compile(r"PG it (\d+): .* lin=(\d+) ")


def _pg_run(pkg, go, S, capsys, **kw):
    pb = go.build(**PB_KW, **kw)
    precond = go._primal_gmg(2, 0, 4, **kw).as_preconditioner()
    opts = S.NewtonOptions(abs_tol=1e-11, rel_tol=0.0, max_iter=20,
                           lin_solver="schur", lin_tol=1e-10,
                           lin_maxiter=2000, preconditioner=precond)
    rule = pkg.PGStepSizeRule(pkg.PGStepSizeRule.EXP, 1.0, 1e6, 2.0)
    solver = pkg.PGSolver(pb.form, rule, latent_block=1,
                          latent_space=pb.latent_space, newton_opts=opts,
                          max_iter=PG_ITERS, tol=0.0, newton_accept=1e-5,
                          verbose=True)
    x0 = (jnp.zeros(pb.form.ndof) if not kw
          else torch.zeros(pb.form.ndof, dtype=F64))
    lams = []
    res = solver.solve(x0, pb.rhs,
                       callback=lambda it, x, lam: lams.append(np.array(lam)))
    lin = [int(m[2]) for m in PG_LINE.finditer(capsys.readouterr().out)]
    return res, lams, lin


def test_pg_solver_matches_jax(capsys):
    """PGSolver on ex5's form, 5 iterations with tol=0, JAX's default
    options (its chunked driver takes the LDU-FGMRES)."""
    jres, jlams, jlin = _pg_run(jpg, jgo, JS, capsys)
    pres, plams, plin = _pg_run(ppg, pgo, PS, capsys, device="cpu")
    assert pres.iterations == jres.iterations == PG_ITERS
    assert pres.newton_iters == jres.newton_iters
    assert len(plin) == PG_ITERS and plin == jlin
    for a, b in zip(plams, jlams):
        assert rel(a, b) <= TOL_DIR
    assert pres.lambda_diff == pytest.approx(jres.lambda_diff, rel=TOL_DIR)
    assert rel(pres.x.numpy(), jres.x) <= TOL_DIR


def test_ex5_main_dense_matches_jax():
    """ex5's main at ref 0 (n0 10) with the dense solver, run to lambda
    diff < 1e-8, against JAX's run; the JAX regression test's checks:
    the integrated violation of ||grad u|| <= phi under 0.08 ||phi|| and
    the mirror map within phi pointwise."""
    res, pb = ex5.main(["--device", "cpu", "-r", "0", "--solver", "dense",
                        "-rule", "2", "-a0", "1", "-ar", "2"])
    jres, _ = jgo.solve(order=2, ref_levels=0, rule_type=2, alpha0=1.0,
                        ratio=2.0, lin_solver="dense")
    assert res.converged and jres.converged
    assert res.iterations == jres.iterations
    assert res.newton_iters == jres.newton_iters
    x = res.x.numpy()
    assert rel(x, jres.x) <= TOL_DIR
    sp, lsp = pb.primal_space, pb.latent_space
    u, psi = x[:sp.ndof], x[sp.ndof:]
    ir = get_rule(sp.mesh.geom, 2 * sp.order)
    gfac = geom_factors(sp.mesh, ir)
    G = phys_dshape(sp.mesh, ir, sp.order)
    gnorm = np.linalg.norm(np.einsum("eqdk,ed->eqk", G,
                                     u[np.asarray(sp.edof)]), axis=-1)
    bound = pgo.bound_fn(np.moveaxis(gfac.xq, -1, 0))
    viol = np.sqrt((np.maximum(gnorm - bound, 0) ** 2 * gfac.w).sum())
    assert viol / np.sqrt((bound ** 2 * gfac.w).sum()) < 0.08
    phi = lsp.elem.eval(ir.points)
    idx = (np.asarray(lsp.edof)[:, :, None]
           + np.arange(lsp.vdim) * lsp.ndof_scalar)
    psiq = np.einsum("qd,edv->eqv", phi, psi[idx])
    mnorm = bound ** 2 * np.linalg.norm(psiq, axis=-1) / np.sqrt(
        1 + bound ** 2 * (psiq ** 2).sum(-1))
    assert (mnorm <= bound * (1 + 1e-9)).all()
