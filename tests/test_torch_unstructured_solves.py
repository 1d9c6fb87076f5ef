"""Port parity, solves on unstructured meshes: Poisson MMS rates on Kuhn
tets at p = 1, 2 with JAX's thresholds, ``elasticity.solve(geom="tet")``
and the obstacle on tets at ``test_tet_obstacle_lvpp``'s size, against
``mfem_ad_tpu`` in f64 on the CPU (relative 1e-8).

These are the slowest cases of ``tests/test_torch_unstructured.py``, kept
in a file of their own: four tests, so pytest-xdist's load-by-file
scheduler, which queues files by test count, starts them after the larger
files.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from mfem_ad_tpu import mesh as JM
from mfem_ad_tpu import solvers as JS
from mfem_ad_tpu.ad import DiffusionEnergy as JDiffusion
from mfem_ad_tpu.adeval import ADEval as JADEval
from mfem_ad_tpu.fespace import FESpace as JFESpace
from mfem_ad_tpu.forms import LinearForm as JLinearForm
from mfem_ad_tpu.forms import NonlinearForm as JNonlinearForm
from mfem_ad_tpu.models import elasticity as jel
from mfem_ad_tpu.models import obstacle as jobs
from mfem_ad_tpu.norms import l2_error as jl2
from mfem_ad_tpu.pg import PGSolver as JPGSolver
from mfem_ad_tpu.pg import PGStepSizeRule
from mfem_ad_tpu_torch import mesh as PM
from mfem_ad_tpu_torch import solvers as PS
from mfem_ad_tpu_torch.ad import DiffusionEnergy as PDiffusion
from mfem_ad_tpu_torch.adeval import ADEval as PADEval
from mfem_ad_tpu_torch.fespace import FESpace as PFESpace
from mfem_ad_tpu_torch.forms import LinearForm as PLinearForm
from mfem_ad_tpu_torch.forms import NonlinearForm as PNonlinearForm
from mfem_ad_tpu_torch.models import elasticity as pel
from mfem_ad_tpu_torch.models import obstacle as pobs
from mfem_ad_tpu_torch.norms import l2_error as pl2
from mfem_ad_tpu_torch.pg import PGSolver as PPGSolver
from mfem_ad_tpu_torch.quadrature import TETRAHEDRON

F64 = torch.float64
TOL_SOLVE = 1e-8  # solves and trajectories


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
    return float(np.abs(a - b).max() / np.abs(b).max())


def _t(a):
    return torch.as_tensor(np.asarray(a), dtype=F64)


def _tet_poisson_error(pkg, n, p):
    """JAX's ``tests/test_tet.py`` problem: -lap u = f on a Kuhn tet mesh,
    Dirichlet data from the exact solution, Jacobi-CG Newton."""
    M, FES, NLF, LF, Diff, l2, S = pkg

    def exact(x):
        return (np.sin(np.pi * x[0]) * np.sin(np.pi * x[1])
                * np.sin(np.pi * x[2]))

    def load(x):
        return 3 * np.pi**2 * exact(x)

    m = M.make_cartesian_3d(n, n, n, geom=TETRAHEDRON)
    fes = FES(m, p)
    kw = {} if pkg is JPKG else {"device": "cpu"}
    nlf = NLF(fes, **kw)
    nlf.add_ad_integrator(Diff(3), JADEval.GRAD if pkg is JPKG
                          else PADEval.GRAD)
    nlf.set_essential_bc([np.ones(m.max_bdr_attribute())])
    b = LF(fes, load).assemble()
    b[np.asarray(fes.boundary_dofs())] = 0.0
    x0 = fes.project_bdr(np.zeros(fes.ndof), exact)
    opts = S.NewtonOptions(abs_tol=1e-12, max_iter=3, lin_solver="cg",
                           lin_tol=1e-14, preconditioner="jacobi")
    if pkg is JPKG:
        res = S.newton(nlf, jnp.asarray(x0), b=jnp.asarray(b), opts=opts)
    else:
        res = S.newton(nlf, _t(x0), b=_t(b), opts=opts)
    assert res.converged
    return l2(fes, np.asarray(res.x), exact)


JPKG = (JM, JFESpace, JNonlinearForm, JLinearForm, JDiffusion, jl2, JS)
PPKG = (PM, PFESpace, PNonlinearForm, PLinearForm, PDiffusion, pl2, PS)


@pytest.mark.parametrize("p,ns,min_rate", [(1, (4, 8), 1.7),
                                           (2, (2, 4), 2.6)])
def test_tet_poisson_mms_rate(p, ns, min_rate):
    """L2 rate on tets with JAX's thresholds (``tests/test_tet.py``), the
    errors equal to JAX's."""
    errs = []
    for n in ns:
        e = _tet_poisson_error(PPKG, n, p)
        assert abs(e - _tet_poisson_error(JPKG, n, p)) <= TOL_SOLVE * e
        errs.append(e)
    assert np.log2(errs[0] / errs[1]) > min_rate


def test_elasticity_tet_matches_jax():
    """ex3 on a Kuhn tet mesh (vdim 3, GRAD|VECTOR) against JAX's."""
    res, pb = pel.solve(order=1, ref_levels=0, dim=3, geom="tet",
                        lin_solver="dense", device="cpu")
    jres, _ = jel.solve(order=1, ref_levels=0, dim=3, geom="tet",
                          lin_solver="dense")
    assert res.converged and jres.converged
    assert pb.mesh.geom == TETRAHEDRON and pb.form.integrators[0].pullback
    assert rel(res.x.numpy(), jres.x) <= TOL_SOLVE


def test_obstacle_tet_matches_jax():
    """ex4's LVPP loop on tets at ``test_tet_obstacle_lvpp``'s size
    (dense inner solves) against JAX's: iterations, Newton counts, x; and
    the test's bounds."""
    runs = {}
    for name, obs, Solver, S, kw in (
            ("jax", jobs, JPGSolver, JS, {}),
            ("port", pobs, PPGSolver, PS, {"device": "cpu"})):
        pb = obs.build(order=1, ref_levels=1, n0=2, dim=3, geom="tet", **kw)
        rule = PGStepSizeRule(PGStepSizeRule.EXP, 0.1, 1e4, 2.0, 1.0)
        solver = Solver(pb.form, rule, latent_block=1,
                        latent_space=pb.latent_space,
                        newton_opts=S.NewtonOptions(abs_tol=1e-9, max_iter=20,
                                                    lin_solver="dense"),
                        max_iter=40, tol=1e-6)
        x0 = (jnp.zeros(pb.form.ndof) if name == "jax"
              else torch.zeros(pb.form.ndof, dtype=F64))
        runs[name] = (solver.solve(x0, pb.rhs), pb)
    (res, pb), (jres, _) = runs["port"], runs["jax"]
    assert res.converged and jres.converged
    assert res.iterations == jres.iterations
    assert res.newton_iters == jres.newton_iters
    x = res.x.numpy()
    assert rel(x, np.asarray(jres.x)) <= TOL_SOLVE
    nu = pb.primal_space.ndof
    u = x[:nu]
    assert u.min() > -1e-8 and 0.49 < u.max() < 0.5 + 0.06
    mirror = 0.5 / (1.0 + np.exp(-0.5 * x[nu:]))
    assert mirror.min() >= 0.0 and mirror.max() <= 0.5
