"""Port parity, the dof-level PG variant: ``mfem_ad_tpu_torch.dof_pg``,
``models.obstacle.build_dofpg`` / ``solve_dofpg`` and ex4's ``--dof-pg``.

Against ``mfem_ad_tpu`` on the same problems, f64, CPU:

- ``_nodal_weights`` and the ``wn`` tables on quads and triangles;
- energy, residual, ``grad_mult``, ``grad_diag`` and the assembled
  Jacobian of a ``BlockNonlinearForm`` holding a ``DofPGIntegrator``, to
  1e-10 relative: the scalar Fermi-Dirac pair, the vdim-2 Simplex pair
  and the grid-function upper bound (``tests/test_pg.py``'s three
  forms), at random states where nothing saturates;
- the golden checks inside the port, to 1e-9: ``torch.func.jacfwd`` of
  ``mult`` equals ``assemble_dense``, the gradient of ``energy`` equals
  ``mult``, ``diag(A)`` equals ``grad_diag``;
- the port's integrator on JAX's tables (``convert.tables_from_numpy``)
  equals the one it builds itself;
- ``solve_dofpg`` at JAX's slow test's settings, and ex4's ``main`` with
  ``--dof-pg --spatial-bound``.

What the solves can be held to.  Where the mirror map saturates, E*''
falls to 1e-20 and below at the nodes on the contact set and on the
boundary, and the dense Jacobian's condition number reaches 1e21 (JAX's
own E*'' rounds to exactly 0 above x ~ 37, where its LU is singular and
it takes the least-squares direction; the port keeps the true value).
The dual iterate psi at those nodes is then set by rounding, differently
by each LAPACK, and so are the lambda increments there, while u and the
mirror image E*'(psi) are determined.  Equal in both: the PG and Newton
counts, ex4's iteration and u-range lines; to 1e-8 (relative l2): u and
the mirror image at every PG iteration, and the first lambda increment.
The final lambda diffs (near 1e-6 or 1e-7, at the floor of the saturated
nodes' rounding) are below the PG tolerance in both at the same
iteration; their values are rounding (ex4's moved 5% between one and
eight torch threads on the same host), so they are held to within 25%.
"""

import importlib.util
import io
import os
import re
import sys
from contextlib import redirect_stdout

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import mfem_ad_tpu.pg as jpg
from mfem_ad_tpu import mesh as JM
from mfem_ad_tpu.ad import ADFunction as JADFunction
from mfem_ad_tpu.adeval import ADEval as JADEval
from mfem_ad_tpu.coefficients import GridFunctionCoefficient as JGF
from mfem_ad_tpu.dof_pg import DofPGIntegrator as JDofPG
from mfem_ad_tpu.dof_pg import _nodal_weights as j_nodal_weights
from mfem_ad_tpu.fespace import L2 as JL2
from mfem_ad_tpu.fespace import FESpace as JFESpace
from mfem_ad_tpu.forms import BlockNonlinearForm as JBlockForm
from mfem_ad_tpu.models import obstacle as jobs
from mfem_ad_tpu.norms import l1_norm as jl1
from mfem_ad_tpu_torch import mesh as PM
from mfem_ad_tpu_torch import pg as ppg
from mfem_ad_tpu_torch.ad import ADFunction as PADFunction
from mfem_ad_tpu_torch.adeval import ADEval as PADEval
from mfem_ad_tpu_torch.coefficients import GridFunctionCoefficient as PGF
from mfem_ad_tpu_torch.convert import tables_from_numpy
from mfem_ad_tpu_torch.dof_pg import DofPGIntegrator as PDofPG
from mfem_ad_tpu_torch.dof_pg import _nodal_weights as p_nodal_weights
from mfem_ad_tpu_torch.examples import ex4
from mfem_ad_tpu_torch.fespace import L2 as PL2
from mfem_ad_tpu_torch.fespace import FESpace as PFESpace
from mfem_ad_tpu_torch.forms import BlockNonlinearForm as PBlockForm
from mfem_ad_tpu_torch.models import obstacle as pobs
from mfem_ad_tpu_torch.norms import l1_norm as pl1
from mfem_ad_tpu_torch.quadrature import SQUARE, TRIANGLE

F64 = torch.float64
DEV = "cpu"
TOL_OP = 1e-10  # single operations against JAX
TOL_GOLDEN = 1e-9  # the golden checks inside the port (JAX's test's)
TOL_TRAJ = 1e-8  # determined quantities of the solves


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
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-300))


def rel_l2(a, b) -> float:
    a, b = np.asarray(a), np.asarray(b)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def _t(a):
    return torch.as_tensor(np.asarray(a), dtype=F64)


class JGradObj(JADFunction):
    def energy(self, x, p):
        g = x[1:]
        return 0.5 * jnp.dot(g, g)


class PGradObj(PADFunction):
    def energy(self, x, p):
        g = x[1:]
        return 0.5 * torch.dot(g, g)


class JValObj(JADFunction):
    def energy(self, x, p):
        return 0.5 * jnp.dot(x, x)


class PValObj(PADFunction):
    def energy(self, x, p):
        return 0.5 * torch.dot(x, x)


# (mesh geometry, primal order, vdim, entropy, bound field)
CASES = {
    "fermi_dirac": (SQUARE, 2, 1, "fd", False),
    "simplex_vdim2": (SQUARE, 2, 2, "simplex", False),
    "gf_bound": (SQUARE, 2, 1, "fd", True),
    "fermi_dirac_tri": (TRIANGLE, 2, 1, "fd", False),
}


def _build(case, pkg, tables=None):
    """(form, integrator, fields, ndof) of one case in one package, from
    the same seeded numbers."""
    geom, order, vdim, ent, gf = CASES[case]
    jax_side = pkg == "jax"
    M, FES, L2, Form = ((JM, JFESpace, JL2, JBlockForm) if jax_side
                        else (PM, PFESpace, PL2, PBlockForm))
    E, A, GF = (jpg, JADEval, JGF) if jax_side else (ppg, PADEval, PGF)
    m = M.make_cartesian_2d(2, 2, geom)
    h1 = FES(m, order, vdim=vdim)
    dual = FES(m, order, L2, vdim=vdim)
    fields = {}
    if ent == "simplex":
        entropy = E.SimplexEntropy(2, 1.0)
        obj = JValObj(2) if jax_side else PValObj(2)
        mode = A.VALUE | A.VECTOR
    else:
        upper = 0.5
        if gf:
            bspace = FES(m, 1)
            upper = GF(bspace, "ub_field")
            fields["ub_field"] = bspace.project(lambda x: 0.3 + 0.2 * x[0])
        entropy = E.FermiDiracEntropy(0.0, upper)
        obj = JGradObj(3) if jax_side else PGradObj(3)
        mode = A.VALUE | A.GRAD
    kw = {} if jax_side else {"device": DEV}
    if tables is not None:
        kw["tables"] = tables
    intg = (JDofPG if jax_side else PDofPG)(obj, [h1], [mode], [dual],
                                            [entropy], **kw)
    form = Form([h1, dual], **({} if jax_side else {"device": DEV}))
    form.add_domain_integrator(intg)
    rng = np.random.default_rng(7)
    u = 0.3 * rng.standard_normal(form.ndof)
    fields["alpha"] = 0.7
    fields["latent_k0"] = 0.1 * rng.standard_normal(dual.ndof)
    v = rng.standard_normal(form.ndof)
    conv = jnp.asarray if jax_side else _t
    fields = {k: conv(f) for k, f in fields.items()}
    return form, intg, fields, conv(u), conv(v)


@pytest.mark.parametrize("geom", [SQUARE, TRIANGLE])
def test_nodal_weights_and_wn_match_jax(geom):
    jf, ji, *_ = _build("fermi_dirac" if geom == SQUARE
                        else "fermi_dirac_tri", "jax")
    pf, pi, *_ = _build("fermi_dirac" if geom == SQUARE
                        else "fermi_dirac_tri", "port")
    np.testing.assert_allclose(p_nodal_weights(pi.primal_spaces[0]),
                               j_nodal_weights(ji.primal_spaces[0]),
                               rtol=1e-14, atol=1e-16)
    assert rel(pi.tables["wn"][0], ji.tables["wn"][0]) <= 1e-14
    for key in ("edof_p", "edof_d"):
        np.testing.assert_array_equal(pi.tables[key][0].numpy(),
                                      np.asarray(ji.tables[key][0]))


@pytest.mark.parametrize("case", ["fermi_dirac", "simplex_vdim2",
                                  "gf_bound"])
def test_operators_match_jax(case):
    jf, ji, jfl, ju, jv = _build(case, "jax")
    pf, pi, pfl, pu, pv = _build(case, "port")
    assert float(pf.energy(pu, pfl)) == pytest.approx(
        float(jf.energy(ju, jfl)), rel=TOL_OP)
    assert rel(pf.mult(pu, pfl), jf.mult(ju, jfl)) <= TOL_OP
    js, ps = jf.grad_state(ju, jfl), pf.grad_state(pu, pfl)
    assert rel(pf.grad_mult(ps, pv), jf.grad_mult(js, jv)) <= TOL_OP
    assert rel(pf.grad_diag(ps), jf.grad_diag(js)) <= TOL_OP
    assert rel(pf.assemble_dense(ps), jf.assemble_dense(js)) <= TOL_OP
    if case == "gf_bound":  # the bound really varies across the nodes
        ub = pi._entropy_params_nodes(0, pfl)["upper"]
        assert float(ub.max() - ub.min()) > 0.1


@pytest.mark.parametrize("case", ["fermi_dirac", "simplex_vdim2",
                                  "gf_bound"])
def test_golden_checks_in_the_port(case):
    """JAX's ``test_dof_pg_jacobian_golden`` and
    ``test_dof_pg_vector_pair_and_field_bounds``, run on the port."""
    form, _, fields, u, v = _build(case, "port")
    J = torch.func.jacfwd(lambda x: form.mult(x, fields))(u)
    st = form.grad_state(u, fields)
    A = form.assemble_dense(st)
    assert rel(A, J) <= TOL_GOLDEN
    assert rel(form.grad_mult(st, v), A @ v) <= TOL_GOLDEN
    g = torch.func.grad(lambda x: form.energy(x, fields))(u)
    assert rel(form.mult(u, fields), g) <= TOL_GOLDEN
    assert rel(form.grad_diag(st), torch.diagonal(A)) <= TOL_GOLDEN


def test_port_integrator_on_jax_tables():
    """JAX's tables (with a grid-function bound: static and efield leaves)
    through ``tables_from_numpy`` give the port's own operators."""
    jf, ji, *_ = _build("gf_bound", "jax")
    tables = tables_from_numpy(jax.tree_util.tree_map(np.asarray, ji.tables),
                               DEV, F64)
    assert set(tables) == {"inner", "wn", "edof_p", "edof_d", "static",
                           "efield"}
    ff, fi, fl, fu, fv = _build("gf_bound", "port", tables=tables)
    pf, pi, pfl, pu, pv = _build("gf_bound", "port")
    assert fi.tables["efield"][0]["upper"][1].shape == \
        pi.tables["efield"][0]["upper"][1].shape
    assert rel(ff.mult(fu, fl), pf.mult(pu, pfl)) <= 1e-14
    fs, ps = ff.grad_state(fu, fl), pf.grad_state(pu, pfl)
    assert rel(ff.grad_mult(fs, fv), pf.grad_mult(ps, pv)) <= 1e-14
    assert rel(ff.assemble_dense(fs), pf.assemble_dense(ps)) <= 1e-14


def test_named_refusals():
    m = PM.make_cartesian_2d(2, 2)
    h1, h1v = PFESpace(m, 2), PFESpace(m, 2, vdim=2)
    fd = ppg.FermiDiracEntropy(0.0, 0.5)
    mode = PADEval.VALUE | PADEval.GRAD
    with pytest.raises(ValueError, match="same dof count"):
        PDofPG(PGradObj(3), [h1], [mode], [PFESpace(m, 1, PL2)], [fd],
               device=DEV)
    with pytest.raises(ValueError, match="vdim must match"):
        PDofPG(PGradObj(3), [h1], [mode], [PFESpace(m, 2, PL2, vdim=2)],
               [fd], device=DEV)
    with pytest.raises(ValueError, match="n_input=1"):
        PDofPG(PValObj(2), [h1v], [PADEval.VALUE | PADEval.VECTOR],
               [PFESpace(m, 2, PL2, vdim=2)], [fd], device=DEV)


# JAX's test_dof_pg_obstacle_spatial_bound_converges
SLOW_KW = dict(order=1, ref_levels=0, n0=6, max_pg_iter=80, tol=1e-6,
               spatial_bound=True, rule_type=jpg.PGStepSizeRule.EXP,
               alpha0=1.0, ratio=1.4, max_alpha=30.0, lin_solver="dense")


def _recorded(monkeypatch, mod, log):
    """``mod.PGSolver.solve`` with a callback that keeps (x, lam) of every
    PG iteration."""
    solve = mod.PGSolver.solve

    def recording(self, x0, rhs, fields=None, callback=None, resume=False):
        return solve(self, x0, rhs, fields,
                     callback=lambda it, x, lam: log.append(
                         (np.array(x), np.array(lam))),
                     resume=resume)

    monkeypatch.setattr(mod.PGSolver, "solve", recording)


def test_solve_dofpg_matches_jax(monkeypatch):
    jlog, plog = [], []
    _recorded(monkeypatch, jpg, jlog)
    _recorded(monkeypatch, ppg, plog)
    jres, jpb = jobs.solve_dofpg(**SLOW_KW)
    res, pb = pobs.solve_dofpg(device=DEV, **SLOW_KW)
    # JAX's slow test's assertions, on the port
    assert res.converged, (res.iterations, res.lambda_diff)
    nu = pb.primal_space.ndof
    u = res.x[:nu].numpy()
    ub = 0.3 + 0.2 * np.asarray(pb.primal_space.node_coords)[:, 0]
    assert u.min() > -1e-8 and np.all(u <= ub + 1e-8)
    assert np.any(u > ub - 1e-3)
    # against JAX's run
    assert jres.converged and res.iterations == jres.iterations
    assert res.newton_iters == jres.newton_iters
    assert len(plog) == len(jlog) == res.iterations
    intg = pb.form.integrators[0]
    fields = {"ub_field": _t(PFESpace(pb.mesh, 1).project(
        lambda x: 0.3 + 0.2 * x[0]))}
    p = intg._entropy_params_nodes(0, fields)
    s = p["upper"] - p["lower"]

    def mirror(x):
        psi = intg._gather_pair(0, _t(x[nu:]), dual=True)
        return (p["lower"] + s * torch.sigmoid(s * psi)).numpy()

    for (xp, _), (xj, _) in zip(plog, jlog):
        assert rel_l2(xp[:nu], xj[:nu]) <= TOL_TRAJ
        assert rel_l2(mirror(xp), mirror(xj)) <= TOL_TRAJ
    ls = pb.latent_space
    pdiff = [pl1(ls, b[1] - a[1]) for a, b in zip(plog, plog[1:])]
    jdiff = [jl1(jpb.latent_space, b[1] - a[1]) for a, b in zip(jlog,
                                                                 jlog[1:])]
    assert pdiff[0] == pytest.approx(jdiff[0], rel=TOL_TRAJ)
    assert res.lambda_diff == pytest.approx(pdiff[-1], rel=1e-14)
    assert res.lambda_diff == pytest.approx(jres.lambda_diff, rel=0.25)
    assert rel_l2(res.x[:nu].numpy(), np.asarray(jres.x[:nu])) <= TOL_TRAJ


def _jax_ex4():
    path = os.path.join(os.path.dirname(__file__), "..", "examples",
                        "ex4.py")
    spec = importlib.util.spec_from_file_location("jax_ex4", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


SUMMARY = re.compile(r"PG converged in (\d+) iterations, final lambda diff "
                     r"(\S+)\n(u range: .*)\n")


def test_ex4_dof_pg_main_prints_jax_summary(monkeypatch):
    """ex4 --dof-pg --spatial-bound at order 0 on its 10x10 mesh with the
    dense solver: the same iteration count and u-range line as JAX's
    ``examples/ex4.py``, the final lambda diff within 25%."""
    flags = ["--dof-pg", "--spatial-bound", "-o", "0", "-r", "0",
             "--solver", "dense", "-rule", "2", "-a0", "1", "-ar", "2",
             "-ma", "30"]
    out = {}
    monkeypatch.setattr(sys, "argv", ["ex4"] + flags)
    for name, run in (("jax", _jax_ex4().main),
                      ("port", lambda: ex4.main(flags + ["--device", DEV]))):
        buf = io.StringIO()
        with redirect_stdout(buf):
            run()
        out[name] = SUMMARY.search(buf.getvalue())
    j, p = out["jax"], out["port"]
    assert p is not None and j is not None
    assert p[1] == j[1] and p[3] == j[3]
    assert "(bounds [0, 0.3 + 0.2 x])" in p[3]
    assert float(p[2]) == pytest.approx(float(j[2]), rel=0.25)
