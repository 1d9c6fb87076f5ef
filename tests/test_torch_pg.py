"""Port parity, the PG / LVPP layer (``mfem_ad_tpu_torch.pg`` and the
Schur direction of ``solvers``).

Against ``mfem_ad_tpu`` on the same numpy-seeded inputs, f64, CPU:

- the step-size rules; the four entropies' values, gradients and Hessians,
  at large |psi| too; both PG functionals;
- one Schur direction at a fixed LVPP state, with Jacobi and with the
  shifted hp-GMG, against JAX's one-shot ``_schur_solve_traced`` (1e-10)
  and the CG iteration count of its chunked driver, and against
  ``dense_solve`` on the same state;
- the refusals, by name.

The outer loop (``PGSolver``, ``models.obstacle``, ex4) is in
``tests/test_torch_obstacle.py``.  Each JAX reference runs once, in a
module fixture.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import mfem_ad_tpu.ad as jad
import mfem_ad_tpu.pg as jpg
from mfem_ad_tpu import solvers as JS
from mfem_ad_tpu.models import obstacle as jobs
from mfem_ad_tpu_torch import ad as pad
from mfem_ad_tpu_torch import pg as ppg
from mfem_ad_tpu_torch import solvers as PS
from mfem_ad_tpu_torch.forms import BlockNonlinearForm as PBlockForm
from mfem_ad_tpu_torch.models import obstacle as pobs
from mfem_ad_tpu_torch.models import poisson as ppoisson

F64 = torch.float64
DEV = "cpu"
TOL_OP = 1e-10  # single operations: entropies, functionals, one direction


def t(a):
    return torch.as_tensor(np.asarray(a), dtype=F64)


def rel(a, b) -> float:
    a, b = np.asarray(a), np.asarray(b)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


# ---------------------------------------------------------------------------
# step rules, entropies, functionals
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("rule", [
    (0, 2.0), (1, 1.0, 1e6, 2.0), (2, 0.1, 1e4, 2.0), (3, 1.0, 1e8, 2.0, 2.0),
])
def test_step_size_rules_match_jax(rule):
    jr, pr = jpg.PGStepSizeRule(*rule), ppg.PGStepSizeRule(*rule)
    for it in (0, 1, 3, 7, 9):  # 2.0 ** (2.0 ** 10) overflows (both)
        assert pr.get(it) == jr.get(it)
    with pytest.raises(ValueError, match="invalid rule type"):
        ppg.PGStepSizeRule(7).get(0)


ENTROPIES = {
    # name -> (constructor args, parameters, points); the points reach
    # |psi| = 800 where the mirror maps saturate
    "fermi_dirac": (("FermiDiracEntropy", 0.0, 0.5),
                    {"lower": [0.0], "upper": [0.5]},
                    [[-800.0], [-60.0], [-3.0], [0.0], [1e-3], [3.0], [45.0],
                     [60.0], [800.0]]),
    "fermi_dirac_box": (("FermiDiracEntropy", -1.0, 2.0),
                        {"lower": [-1.0], "upper": [2.0]},
                        [[-50.0], [-0.3], [0.7], [20.0]]),
    "shannon_lower": (("ShannonEntropy", 1.0, 1),
                      {"bound": [1.0]}, [[-40.0], [0.3], [30.0]]),
    "shannon_upper": (("ShannonEntropy", 0.5, -1),
                      {"bound": [0.5]}, [[-30.0], [0.3], [40.0]]),
    "hellinger": (("HellingerEntropy", 2, 0.7), {"bound": [0.7]},
                  [[3.0, -4.0], [0.0, 0.0], [800.0, -600.0]]),
    "simplex": (("SimplexEntropy", 3, 1.0), {"bound": [1.0]},
                [[1000.0, 999.0, -5.0], [0.1, 0.2, 0.3], [-800.0, 0.0, 2.0]]),
}


@pytest.mark.parametrize("name", list(ENTROPIES))
def test_entropy_value_gradient_hessian_match_jax(name):
    """Value, gradient and Hessian of each entropy against JAX's, to 1e-10
    relative to the largest entry at that point, with an absolute floor of
    1e-14: where Fermi-Dirac saturates, JAX's Hessian sigmoid(x)(1 -
    sigmoid(x)) loses its relative accuracy to cancellation (absolute
    error ~1e-16) and rounds to 0 above x ~ 37, while the port's branches
    keep the true value (checked against the closed form below)."""
    (cls, *args), params, points = ENTROPIES[name]
    je, pe = getattr(jpg, cls)(*args), getattr(ppg, cls)(*args)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    pp = {k: t(v) for k, v in params.items()}
    jvgh = jax.jit(je.value_grad_hess)
    for x in points:
        jv, jg, jh = jvgh(jnp.asarray(x), jp)
        pv, pgr, ph = pe.value_grad_hess(t(x), pp)
        for got, ref in ((pv, jv), (pgr, jg), (ph, jh)):
            ref = np.asarray(ref)
            got = got.detach().numpy()
            assert np.all(np.isfinite(got)), (name, x)
            scale = max(np.abs(ref).max(), 1e-300)
            assert np.abs(got - ref).max() <= TOL_OP * scale + 1e-14, (
                name, x, got, ref)


def test_fermi_dirac_hessian_stays_positive_where_torch_softplus_cuts():
    """``torch.nn.functional.softplus`` is linear above 20, which would
    zero E*'' there; the port's softplus keeps the true value."""
    e = ppg.FermiDiracEntropy(0.0, 1.0)
    p = {"lower": t([0.0]), "upper": t([1.0])}
    for x in (25.0, 30.0, 45.0):
        h = float(e.hessian(t([x]), p)[0, 0])
        assert h == pytest.approx(np.exp(-x) / (1 + np.exp(-x)) ** 2,
                                  rel=1e-10)


class _JQuad(jad.ADFunction):
    def energy(self, x, p):
        return x[0] ** 2 + x[1] * x[2] + 0.5 * x[2] ** 2


class _PQuad(pad.ADFunction):
    def energy(self, x, p):
        return x[0] ** 2 + x[1] * x[2] + 0.5 * x[2] ** 2


@pytest.mark.parametrize("cls", ["ADPGFunctional", "ADLambdaPGFunctional"])
def test_pg_functionals_match_jax(cls):
    """Fermi-Dirac on x[0] and Hellinger on x[1:3] (primal_idx [0, 1]):
    value, gradient and Hessian at seeded points."""
    def build(pkg, quad):
        ents = [pkg.FermiDiracEntropy(0.0, 1.0),
                pkg.HellingerEntropy(2, 0.7)]
        return getattr(pkg, cls)(quad(3), ents, None, primal_idx=[0, 1])

    jf, pf = build(jpg, _JQuad), build(ppg, _PQuad)
    assert pf.n_input == jf.n_input == 6
    assert pf.dual_idx == [3, 4] and sorted(pf.params) == sorted(jf.params)
    rng = np.random.default_rng(3)
    jvgh = jax.jit(jf.value_grad_hess)
    for _ in range(4):
        x = rng.standard_normal(6) * 3.0
        params = {"alpha": [0.37], "latent_k0": [rng.standard_normal()],
                  "latent_k1": rng.standard_normal(2),
                  "entropy0_lower": [0.0], "entropy0_upper": [1.0],
                  "entropy1_bound": [0.7]}
        jv, jg, jh = jvgh(
            jnp.asarray(x), {k: jnp.asarray(v) for k, v in params.items()})
        pv, pgr, ph = pf.value_grad_hess(
            t(x), {k: t(v) for k, v in params.items()})
        for got, ref in ((pv, jv), (pgr, jg), (ph, jh)):
            assert rel(got.detach().numpy(), ref) <= TOL_OP


# ---------------------------------------------------------------------------
# one Schur direction at a fixed state
# ---------------------------------------------------------------------------


def _fixed_state(pkg_obs, tens, gmg_pkg):
    """The order-2 obstacle on 4x4 quads (H1 Q3 + L2 Q1) at a seeded
    state: returns (problem, fields, x, state, r, hp-GMG preconditioner)."""
    kw = {} if pkg_obs is jobs else {"device": DEV}
    pb = pkg_obs.build(order=2, ref_levels=0, n0=4, **kw)
    rng = np.random.default_rng(11)
    nu, nl = pb.primal_space.ndof, pb.latent_space.ndof
    x = np.concatenate([0.2 * rng.random(nu), 4.0 * rng.standard_normal(nl)])
    x[:nu][np.asarray(pb.primal_space.boundary_dofs())] = 0.0
    fields = {"alpha": tens(0.8), "latent_k0": tens(rng.standard_normal(nl))}
    form = pb.form
    r = form.mult(tens(x), fields) - pb.rhs
    r = r * (1.0 - tens(np.asarray(form.ess_mask, dtype=float)))
    state = form.grad_state(tens(x), fields)
    fp = pkg_obs._primal_gmg(2, 0, 4, **kw)
    return pb, fields, x, state, r, fp


@pytest.fixture(scope="module")
def schur_direction():
    """JAX's one-shot and chunked Schur directions (Jacobi and shifted
    GMG) and the port's, at the same state, plus the port's dense
    solve."""
    jpb, jfields, x, jstate, jr, jfp = _fixed_state(jobs, jnp.asarray, None)
    form = jpb.form
    out = {}
    for label, fp in (("jacobi", None), ("gmg", jfp)):
        pdata = jfp.fused_pdata() if fp is not None else ()
        fn = jax.jit(lambda tb, ess, st, r, pd: JS._schur_solve_traced(
            form, tb, ess, st, r, 1e-13, 2000, fp=fp, pdata=pd))
        one_shot = np.asarray(fn(form._tables(), form.ess_mask, jstate, jr,
                                 pdata))
        opts = JS.NewtonOptions(lin_tol=1e-13, lin_maxiter=2000)
        chunked, its = JS._schur_dir_chunked(
            form, opts, fp, jnp.asarray(x), jpb.rhs, jfields, pdata)
        out[label] = {"jax": one_shot, "jax_chunked": np.asarray(chunked),
                      "jax_its": its}
    ppb, _, _, pstate, pr, pfp = _fixed_state(pobs, t, None)
    for label, fp in (("jacobi", None), ("gmg", pfp)):
        dx, its = PS.schur_solve(ppb.form, pstate, pr, 1e-13, 2000, fp=fp)
        out[label].update(port=dx.numpy(), port_its=its)
    A = ppb.form.assemble_dense(pstate)
    out["dense"] = PS.dense_solve(A, pr).numpy()
    return out


@pytest.mark.parametrize("label", ["jacobi", "gmg"])
def test_schur_direction_matches_jax_and_dense(schur_direction, label):
    d = schur_direction[label]
    assert rel(d["port"], d["jax"]) <= TOL_OP
    assert rel(d["port"], d["jax_chunked"]) <= TOL_OP
    assert d["port_its"] == d["jax_its"] > 0
    # the latent blocks carry a 1e-6 relative shift; one refinement pass
    # against the true Jacobian leaves an O(1e-12) direction error here
    assert rel(d["port"], schur_direction["dense"]) <= 1e-8
    if label == "gmg":
        assert d["port_its"] < schur_direction["jacobi"]["port_its"]


# ---------------------------------------------------------------------------
# refusals
# ---------------------------------------------------------------------------


def test_schur_and_obstacle_refusals_are_named():
    opts = PS.NewtonOptions(lin_solver="schur")
    pb1 = ppoisson.build(order=1, ref_levels=0, n0=2, device=DEV)
    with pytest.raises(ValueError, match="2-block"):
        PS.newton(pb1.form, torch.zeros(pb1.form.ndof, dtype=F64), opts=opts)

    pb = pobs.build(order=1, ref_levels=0, n0=2, device=DEV)

    class NoBlocks:  # a form without element-block access
        offsets, ess_mask = pb.form.offsets, pb.form.ess_mask

    with pytest.raises(ValueError, match="element-block access"):
        PS.newton(NoBlocks(), torch.zeros(pb.form.ndof, dtype=F64),
                  opts=opts)
    mask = pb.form.ess_mask.clone()
    mask[-1] = True
    pb.form.set_essential_dofs(mask.numpy())
    with pytest.raises(ValueError, match="no essential dofs on the latent"):
        PS.newton(pb.form, torch.zeros(pb.form.ndof, dtype=F64),
                  fields={"alpha": 1.0,
                          "latent_k0": torch.zeros(pb.latent_space.ndof)},
                  opts=opts)
    with pytest.raises(ValueError, match="2-block"):
        PS.make_pg_schur_solver(latent_block=0)(pb.form, None, None)

    # an H1 latent takes the lumped direction (ex5), not the exact
    # elimination
    h1 = pb.primal_space
    form = PBlockForm([h1, h1], device=DEV)
    with pytest.raises(ValueError, match="lumped_schur_solve"):
        PS.schur_solve(form, None, None, 1e-12, 10)

    # tets are ported: the obstacle builds on them
    tet = pobs.build(order=1, ref_levels=0, n0=2, dim=3, geom="tet",
                     device=DEV)
    assert tet.mesh.geom == "tetrahedron"
    # so is the dof-level PG variant (its parity: tests/test_torch_dof_pg.py)
    dpb = pobs.build_dofpg(order=1, ref_levels=0, n0=2, device=DEV)
    assert dpb.latent_space.fe_type == "L2" and dpb.latent_space.order == 2
    gmg = pobs._primal_gmg(1, 0, 2, device=DEV)
    with pytest.raises(ValueError, match="only serves the Schur"):
        gmg.as_preconditioner()(pb.form, None)
    # a plain GMG is no preconditioner of the condensed system
    with pytest.raises(ValueError, match="takes a multigrid.PGSchurGMG"):
        PS.schur_solve(pb.form, None, None, 1e-12, 10, fp=gmg.gmg)
