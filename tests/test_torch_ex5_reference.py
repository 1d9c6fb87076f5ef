"""The port's ex5 against the benchmark's plain reference
(``fembench/reference/gradient-obstacle-ex5.py``), f64, CPU:

- at order 2, ref 0, n0 4 (131 dofs: H1 P2 + H1 P1^2 on 32 triangles),
  at seeded random u, psi, psi_k, alpha and load amplitude: the block
  residual and ``grad_mult`` equal the reference's R and its
  ``torch.func.jvp`` to 1e-12 relative (float64 rounding over 131 dofs;
  float32 would miss it by orders of magnitude), and the load vectors
  agree;
- at ref 1, n0 4, PG iteration 1 through ``PGSolver`` on the sigma-direct
  LDU-FGMRES path, as the benchmark cell runs it: the reference's residual
  at the returned iterate is under the cell's ``residual`` limit;
- the direction's counters on ``PGSchurGMG``: one LDU apply per FGMRES
  iteration, one K build per ``reset_sigma()``.
"""

import functools
import importlib.util
import json
import os

import pytest
import torch

from mfem_ad_tpu_torch import pg as ppg
from mfem_ad_tpu_torch import solvers as PS
from mfem_ad_tpu_torch.models import gradient_obstacle as pgo

F64 = torch.float64
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CELL = "gradient-obstacle-ex5.pg4"
TOL = 1e-12


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch thread: the dense f32 inverses of the sigma-direct factor
    run in torch's CPU LAPACK, which spins under the test workers'
    contention."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@functools.lru_cache(maxsize=None)
def _ref():
    path = os.path.join(ROOT, "fembench", "reference",
                        "gradient-obstacle-ex5.py")
    spec = importlib.util.spec_from_file_location("ref_ex5", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _json(kind, name):
    with open(os.path.join(ROOT, "fembench", kind, f"{name}.json")) as fh:
        return json.load(fh)


def rel(a, b) -> float:
    return float(torch.linalg.vector_norm(a - b)
                 / torch.linalg.vector_norm(b))


def test_residual_and_jacobian_match_reference():
    ref = _ref()
    pb = pgo.build(2, 0, n0=4, device="cpu")
    sp = ref.Spaces(4, 2, 4, "cpu")
    assert (sp.nh, sp.ndof) == (pb.primal_space.ndof, pb.form.ndof) == (
        81, 131)
    g = torch.Generator().manual_seed(5)
    amp = 1.0 + 0.02 * float(torch.rand((), generator=g, dtype=F64))
    alpha = 0.5 + 8.0 * float(torch.rand((), generator=g, dtype=F64))
    ess = pb.form.ess_mask
    x = torch.where(ess, 0.0, 0.3 * torch.randn(sp.ndof, generator=g,
                                                dtype=F64))
    psi_k = 0.5 * torch.randn(sp.nl, generator=g, dtype=F64)
    v = torch.where(ess, 0.0, torch.randn(sp.ndof, generator=g, dtype=F64))
    b = ref.loads(4, 2, 4, [amp], "cpu")[0]
    assert rel(b, amp * pb.rhs) <= TOL
    fields = {"alpha": alpha, "latent_k0": psi_k}
    r = PS._residual(pb.form, x, amp * pb.rhs, fields)
    jv = pb.form.grad_mult(pb.form.grad_state(x, fields), v)
    r_ref, jv_ref = torch.func.jvp(
        lambda y: ref.residual(sp, y, psi_k, alpha, b), (x,), (v,))
    assert rel(r, r_ref) <= TOL
    assert rel(jv, jv_ref) <= TOL


@functools.lru_cache(maxsize=None)
def _pg_runs():
    """Two runs of PG iteration 1 at ref 1, n0 4 with the cell's Newton
    settings and alpha, each after ``reset_sigma()`` on one kept hierarchy;
    the FGMRES count of every direction, the counters after each run."""
    cfg = _json("configs", "gradient-obstacle-ex5")
    p = _json("workloads", CELL)["params"]
    pb = pgo.build(2, 1, n0=4, device="cpu")
    pre = pgo._primal_gmg(2, 1, 4, device="cpu")
    n = p["newton"]
    opts = PS.NewtonOptions(
        abs_tol=n["abs_tol"], rel_tol=0.0, max_iter=n["max_iter"],
        lin_solver="schur", lin_tol=n["lin_tol"],
        lin_maxiter=n["lin_maxiter"], sigma_direct=n["sigma_direct"],
        preconditioner=pre.as_preconditioner())
    r = cfg["rule"]
    rule = ppg.PGStepSizeRule(ppg.PGStepSizeRule.EXP, r["alpha0"],
                              r["max_alpha"], r["ratio"])
    lin, runs = [], []
    newton = ppg.newton

    def counted(*args, **kwargs):
        res = newton(*args, **kwargs)
        lin.extend(res.lin_iters)
        return res

    ppg.newton = counted
    try:
        for _ in range(2):
            pre.reset_sigma()
            res = ppg.PGSolver(
                pb.form, rule, latent_block=1, latent_space=pb.latent_space,
                newton_opts=opts, max_iter=1, tol=0.0,
                newton_accept=p["newton_accept"]).solve(
                    torch.zeros(pb.form.ndof, dtype=F64), pb.rhs)
            runs.append((res, list(lin), {
                c: getattr(pre, c) for c in (
                    "ldu_applies", "ldu_a_cg_iters", "ldu_sigma_cg_iters",
                    "sigma_builds", "sigma_refreshes")}))
    finally:
        ppg.newton = newton
    return r["alpha0"], runs


def test_pg_iteration_under_the_cells_limit():
    ref = _ref()
    alpha, runs = _pg_runs()
    res = runs[0][0]
    assert res.iterations == 1 and res.x.dtype == F64
    sp = ref.Spaces(8, 2, 4, "cpu")
    b = ref.loads(8, 2, 4, [1.0], "cpu")[0]
    r = ref.residual(sp, res.x, torch.zeros(sp.nl, dtype=F64), alpha, b)
    limit = _json("workloads", CELL)["limits"]["residual"]
    assert float(torch.linalg.vector_norm(r)) <= limit


def test_ldu_counters():
    """One LDU apply per FGMRES iteration; K built once per
    ``reset_sigma()`` and the factor refreshed with it; the inner CGs
    counted; a run after ``reset_sigma()`` repeats the first exactly."""
    _, runs = _pg_runs()
    for k, (_, lin, c) in enumerate(runs, start=1):
        assert lin and c["ldu_applies"] == sum(lin)
        assert c["sigma_builds"] == c["sigma_refreshes"] == k
        assert c["ldu_a_cg_iters"] >= 2 * c["ldu_applies"]
        assert c["ldu_sigma_cg_iters"] >= c["ldu_applies"]
    (first, lin1, _), (second, lin2, _) = runs
    assert lin2 == lin1 + lin1
    assert torch.equal(first.x, second.x)
