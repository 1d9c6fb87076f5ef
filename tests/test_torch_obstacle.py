"""Port parity, the LVPP outer loop: ``mfem_ad_tpu_torch.pg.PGSolver``,
``models.obstacle`` and ``examples.ex4``.

Against ``mfem_ad_tpu`` on the same problem, f64, CPU:

- ``PGSolver`` on the obstacle (order 1, ref 0, n0 4, EXP alpha0 0.1
  ratio 2, ``tol=0``, 6 iterations) with the dense solver and with the
  Schur direction + GMG, against JAX's with the same options: lambda per
  iteration, the lambda-diff trajectory, Newton iterations and x (1e-8).
  The JAX package has two drivers of the Schur direction, the one-shot
  ``_schur_solve_traced`` (``lin_chunk=None``) and the chunked one (the
  default); the one-shot one is the algorithm, and the port is held to
  both;
- the port's ``PGSolver(resume=True)`` resuming a checkpoint that JAX's
  ``PGSolver`` wrote, against JAX's uninterrupted run;
- a 3D obstacle on hexes (port only): Schur + GMG against dense;
- ``ex4.main(["--device", "cpu", ...])``.

The JAX runs happen once, in a module fixture; no 3D JAX solve runs.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import mfem_ad_tpu.pg as jpg
from mfem_ad_tpu import solvers as JS
from mfem_ad_tpu.models import obstacle as jobs
from mfem_ad_tpu.norms import l1_norm as jl1
from mfem_ad_tpu_torch import pg as ppg
from mfem_ad_tpu_torch import solvers as PS
from mfem_ad_tpu_torch.examples import ex4
from mfem_ad_tpu_torch.models import obstacle as pobs
from mfem_ad_tpu_torch.norms import l1_norm as pl1

F64 = torch.float64
DEV = "cpu"
TOL_TRAJ = 1e-8  # trajectories: PG iterates


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


PG_KW = dict(order=1, ref_levels=0, n0=4)
PG_ITERS = 6


def _pg_options(pkg, obs, lin_solver, lin_chunk="default", device=None):
    """The options of ``obstacle.solve`` with ``tol=0`` and 6 iterations."""
    kw = {} if device is None else {"device": device}
    pb = obs.build(**PG_KW, **kw)
    precond = None
    if lin_solver == "schur":
        precond = obs._primal_gmg(1, 0, 4, **kw).as_preconditioner()
    nkw = dict(abs_tol=1e-9, rel_tol=0.0, max_iter=20, lin_solver=lin_solver,
               lin_tol=1e-13, lin_maxiter=2000, preconditioner=precond)
    if lin_chunk != "default":
        nkw["lin_chunk"] = lin_chunk
    rule = pkg.PGStepSizeRule(pkg.PGStepSizeRule.EXP, 0.1, 1e4, 2.0)
    return pb, rule, pkg.PGSolver, nkw


def _run_pg(pkg, obs, lin_solver, lin_chunk="default", device=None,
            max_iter=PG_ITERS, checkpoint_path=None, resume=False):
    pb, rule, Solver, nkw = _pg_options(pkg, obs, lin_solver, lin_chunk,
                                        device)
    S = JS if pkg is jpg else PS
    lams = []
    solver = Solver(pb.form, rule, latent_block=1,
                    latent_space=pb.latent_space,
                    newton_opts=S.NewtonOptions(**nkw), max_iter=max_iter,
                    tol=0.0, newton_accept=1e-5,
                    checkpoint_path=checkpoint_path)
    x0 = (jnp.zeros(pb.form.ndof) if pkg is jpg
          else torch.zeros(pb.form.ndof, dtype=F64))
    res = solver.solve(x0, pb.rhs, resume=resume,
                       callback=lambda it, x, lam: lams.append(
                           np.array(lam)))
    return res, pb, lams


def _lam_diffs(l1, space, lams):
    return [l1(space, b - a) for a, b in zip(lams, lams[1:])]


@pytest.fixture(scope="module")
def pg_runs():
    return {
        "jax_dense": _run_pg(jpg, jobs, "dense"),
        "jax_schur": _run_pg(jpg, jobs, "schur", lin_chunk=None),
        "jax_schur_chunked": _run_pg(jpg, jobs, "schur"),
        "port_dense": _run_pg(ppg, pobs, "dense", device=DEV),
        "port_schur": _run_pg(ppg, pobs, "schur", device=DEV),
    }


@pytest.mark.parametrize("port,ref", [
    ("port_dense", "jax_dense"),
    ("port_schur", "jax_schur"),
    ("port_schur", "jax_schur_chunked"),
])
def test_pg_solver_trajectory_matches_jax(pg_runs, port, ref):
    pres, ppb, plams = pg_runs[port]
    jres, jpb, jlams = pg_runs[ref]
    assert pres.iterations == jres.iterations == PG_ITERS
    assert not pres.converged and not jres.converged  # tol = 0
    assert pres.newton_iters == jres.newton_iters
    assert len(plams) == len(jlams) == PG_ITERS
    for a, b in zip(plams, jlams):
        assert rel(a, b) <= TOL_TRAJ
    pdiff = _lam_diffs(pl1, ppb.latent_space, plams)
    jdiff = _lam_diffs(jl1, jpb.latent_space, jlams)
    np.testing.assert_allclose(pdiff, jdiff, rtol=TOL_TRAJ)
    assert pres.lambda_diff == pytest.approx(pdiff[-1], rel=1e-14)
    assert rel(pres.x.numpy(), jres.x) <= TOL_TRAJ


def test_pg_resumes_a_jax_checkpoint(pg_runs, tmp_path):
    """JAX's PGSolver writes a checkpoint after 3 iterations; the port's
    resumes it and ends where JAX's uninterrupted 6 iterations end."""
    ckpt = str(tmp_path / "pg_ckpt")
    part, _, _ = _run_pg(jpg, jobs, "dense", max_iter=3,
                         checkpoint_path=ckpt)
    assert part.iterations == 3
    res, pb, lams = _run_pg(ppg, pobs, "dense", device=DEV,
                            checkpoint_path=ckpt, resume=True)
    full, _, jlams = pg_runs["jax_dense"]
    assert res.iterations == PG_ITERS and len(lams) == PG_ITERS - 3
    assert res.newton_iters == full.newton_iters[3:]
    for a, b in zip(lams, jlams[3:]):
        assert rel(a, b) <= TOL_TRAJ
    assert rel(res.x.numpy(), full.x) <= TOL_TRAJ


def test_obstacle_3d_schur_matches_dense():
    """The obstacle on 3^3 hexes (H1 Q2 + L2 Q0), port only: 3 PG
    iterations with the Schur direction + hp-GMG against the dense
    solver."""
    kw = dict(order=1, ref_levels=0, n0=3, dim=3, max_pg_iter=3, tol=0.0,
              rule_type=ppg.PGStepSizeRule.EXP, alpha0=0.1, ratio=2.0,
              device=DEV)
    rs, pb = pobs.solve(lin_solver="schur", **kw)
    rd, _ = pobs.solve(lin_solver="dense", **kw)
    assert rs.iterations == rd.iterations == 3
    assert rs.newton_iters == rd.newton_iters
    nu = pb.primal_space.ndof
    assert rel(rs.x[:nu].numpy(), rd.x[:nu].numpy()) <= TOL_TRAJ
    u = rs.x[:nu]
    assert float(u.min()) > -1e-8 and float(u.max()) < 0.5 + 3e-2


def test_ex4_main_runs_on_the_cpu(capsys):
    """ex4 at order 1 on its 10x10 mesh, dense solver, to convergence."""
    res, pb = ex4.main(["--device", "cpu", "-o", "1", "-r", "0",
                        "-rule", "2", "-a0", "0.1", "-ar", "2",
                        "--solver", "dense"])
    out = capsys.readouterr().out
    assert res.converged
    assert f"PG converged in {res.iterations} iterations" in out
    assert "u range: [" in out
    u = res.x[: pb.primal_space.ndof]
    # on a 10x10 mesh the bound's overshoot is O(h) interpolation error of
    # the saturated mirror map on the contact set (0.5071 here)
    assert float(u.min()) > -1e-8 and float(u.max()) < 0.5 + 3e-2
