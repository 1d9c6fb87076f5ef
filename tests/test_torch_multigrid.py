"""Port parity, geometric multigrid (``mfem_ad_tpu_torch.multigrid``).

The same problems are built in both packages in f64 on the CPU and fed the
same numpy-seeded inputs; the port is held to ``mfem_ad_tpu.multigrid``:

- the 1-D transfers ``_up1d``/``_down1d``/``_down1d_sq`` for factors 2
  and 3, in 2D and 3D, at vdim 1 and 2 (1e-10 relative);
- prolong/restrict adjointness (factor 2 and factor 3);
- the V-cycle on p1 Poisson (16 -> 8 -> 4), vdim-2 elasticity and the hp
  hierarchy Q3 -> Q1 (1e-10 relative);
- ``shift_data`` (the shifted V-cycle, its shifts and coarse inverse) and
  ``inject``;
- GMG-CG at 32^2: the residual and the iteration count equal JAX's, and
  Jacobi-CG at the same budget is far off;
- Newton with the GMG preconditioner: linear Poisson and the steep
  minimal surface with ``nonlinear=True``, iterates within 1e-8;
- ``PGBlockGMG``'s application on an LVPP saddle state;
- the refreshed coarse matrix (``assemble_dense``) equals the coarse
  form's matvec on the unit vectors, the JAX package's construction;
- ``refresh``, ``set_fine`` and ``shift_data`` write the level data into
  the tensors that a V-cycle's CUDA graph reads, and on the CPU the
  V-cycle runs eagerly (the graphs themselves: ``test_torch_gmg_graph``);
- a Newton direction linearizes each level once, to the bits of
  ``refresh`` then ``set_fine``.

The JAX reference of each case runs once, in a module fixture.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import mfem_ad_tpu.ad as jad
from mfem_ad_tpu import mesh as JM
from mfem_ad_tpu import multigrid as JMG
from mfem_ad_tpu import solvers as JS
from mfem_ad_tpu.adeval import ADEval as JADEval
from mfem_ad_tpu.fespace import FESpace as JFESpace
from mfem_ad_tpu.forms import LinearForm as JLinearForm
from mfem_ad_tpu.forms import NonlinearForm as JNonlinearForm
from mfem_ad_tpu.models import minimal_surface as jms
from mfem_ad_tpu.models import obstacle as jobs
from mfem_ad_tpu_torch import ad as pad
from mfem_ad_tpu_torch import mesh as PM
from mfem_ad_tpu_torch import multigrid as PMG
from mfem_ad_tpu_torch import solvers as PS
from mfem_ad_tpu_torch.adeval import ADEval as PADEval
from mfem_ad_tpu_torch.fespace import FESpace as PFESpace
from mfem_ad_tpu_torch.forms import LinearForm as PLinearForm
from mfem_ad_tpu_torch.forms import NonlinearForm as PNonlinearForm
from mfem_ad_tpu_torch.models import minimal_surface as pms
from mfem_ad_tpu_torch.models import obstacle as pobs

F64 = torch.float64
DEV = "cpu"
TOL_OP = 1e-10    # single operations: transfers, V-cycles
TOL_TRAJ = 1e-8   # trajectories: Newton iterates


def t(a):
    return torch.as_tensor(np.asarray(a), dtype=F64)


def rel(a, b) -> float:
    a, b = np.asarray(a), np.asarray(b)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


# -- the same forms in both packages -------------------------------------


def _diffusion(pkg, n, order=1, dim=2):
    M, FES, NLF, ad, ADE = pkg
    m = M.make_cartesian_3d(n, n, n) if dim == 3 else M.make_cartesian_2d(n, n)
    fes = FES(m, order)
    f = NLF(fes, device=DEV) if M is PM else NLF(fes)
    f.add_ad_integrator(ad.DiffusionEnergy(dim), ADE.GRAD)
    f.set_essential_bc([np.ones(m.max_bdr_attribute())])
    return f


def _elasticity(pkg, n):
    M, FES, NLF, ad, ADE = pkg
    m = M.make_cartesian_2d(n, n)
    fes = FES(m, 1, vdim=2)
    f = NLF(fes, device=DEV) if M is PM else NLF(fes)
    f.add_ad_integrator(ad.LinearElasticityEnergy(2, 1.0, 1.0),
                        ADE.GRAD | ADE.VECTOR)
    f.set_essential_bc([np.array([1, 0, 0, 0])])
    return f


def _minsurf(pkg, n):
    M, FES, NLF, ad, ADE = pkg
    energy = (pms if M is PM else jms).MinimalSurfaceEnergy(2)
    m = M.make_cartesian_2d(n, n)
    fes = FES(m, 1)
    f = NLF(fes, device=DEV) if M is PM else NLF(fes)
    f.add_ad_integrator(energy, ADE.GRAD)
    f.set_essential_bc([np.ones(m.max_bdr_attribute())])
    return f


JAXPKG = (JM, JFESpace, JNonlinearForm, jad, JADEval)
PORT = (PM, PFESpace, PNonlinearForm, pad, PADEval)

HIERARCHIES = {
    # name -> (form builder, hierarchy): p1 Poisson 16 -> 8 -> 4, vdim-2
    # elasticity 16 -> 8 -> 4, and hp Q3@8 -> Q1@8 -> Q1@4
    "poisson_p1": (lambda pkg, n: _diffusion(pkg, n), ("h", 4, 3)),
    "elasticity_vdim2": (_elasticity, ("h", 4, 3)),
    "hp_q3_q1": (lambda pkg, n, p: _diffusion(pkg, n, p), ("hp", 4, 2, 3)),
}


def _hierarchy(pkg, name):
    build, spec = HIERARCHIES[name]
    mg = JMG if pkg is JAXPKG else PMG
    if spec[0] == "h":
        return mg.build_hierarchy(lambda n: build(pkg, n), *spec[1:])
    return mg.build_hp_hierarchy(lambda n, p: build(pkg, n, p), *spec[1:])


def _rhs(form, seed):
    rng = np.random.default_rng(seed)
    b = rng.standard_normal(form.ndof)
    b[np.asarray(form.ess_mask)] = 0.0
    return b


# ---------------------------------------------------------------------------
# transfers
# ---------------------------------------------------------------------------

TRANSFERS = ("_up1d", "_down1d", "_down1d_sq")


TRANSFER_CASES = [(fn, p, dim, vdim) for fn in TRANSFERS for p in (2, 3)
                  for dim in (2, 3) for vdim in (1, 2)]


def _transfer_input(p, dim, vdim):
    rng = np.random.default_rng(10 * p + dim + vdim)
    n = 3 * p + 1  # p(Nc - 1) + 1 with Nc = 4: valid for up and down
    return rng.standard_normal((vdim,) + (n,) * dim)


@pytest.fixture(scope="module")
def jax_transfers():
    """Every case's JAX transfers along every axis, in one jitted call."""
    inputs = {c: _transfer_input(*c[1:]) for c in TRANSFER_CASES}

    def run(arrays):
        return {c: [getattr(JMG, c[0])(a, ax, c[1])
                    for ax in range(1, c[2] + 1)]
                for c, a in arrays.items()}

    out = jax.jit(run)({c: jnp.asarray(a) for c, a in inputs.items()})
    return inputs, out


@pytest.mark.parametrize("fn", TRANSFERS)
@pytest.mark.parametrize("p", [2, 3])
@pytest.mark.parametrize("dim", [2, 3])
@pytest.mark.parametrize("vdim", [1, 2])
def test_transfers_match_jax(jax_transfers, fn, p, dim, vdim):
    inputs, refs = jax_transfers
    a = inputs[(fn, p, dim, vdim)]
    for axis, ref in zip(range(1, dim + 1), refs[(fn, p, dim, vdim)]):
        got = getattr(PMG, fn)(t(a), axis, p).numpy()
        assert got.shape == ref.shape
        assert rel(got, np.asarray(ref)) <= TOL_OP, (fn, axis)


@pytest.mark.parametrize("name", ["poisson_p1", "hp_q3_q1"])
def test_prolong_restrict_adjoint(name):
    forms = _hierarchy(PORT, name)
    gmg = PMG.GMG(forms)
    nf, nc = forms[0].ndof, forms[1].ndof
    rng = np.random.default_rng(0)
    uc = torch.where(forms[1].ess_mask, 0.0, t(rng.standard_normal(nc)))
    rf = torch.where(forms[0].ess_mask, 0.0, t(rng.standard_normal(nf)))
    lhs = float(torch.dot(gmg.prolong(0, uc), rf))
    rhs = float(torch.dot(uc, gmg.restrict(0, rf)))
    assert abs(lhs - rhs) <= 1e-12 * abs(rhs)


# ---------------------------------------------------------------------------
# V-cycle, shift_data, inject
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def vcycles():
    """JAX and port V-cycles of each hierarchy on one right-hand side, plus
    the shifted V-cycle's data and injection on the p1 Poisson one."""
    out = {}
    for name in HIERARCHIES:
        jg = JMG.GMG(_hierarchy(JAXPKG, name))
        pg = PMG.GMG(_hierarchy(PORT, name))
        b = _rhs(pg.forms[0], 1)
        jv = jax.jit(lambda d, b, s=None: jg.vcycle_pure(d, 0, b, s))
        out[name] = (np.asarray(jv(jg.pdata(), jnp.asarray(b))),
                     pg(t(b)).numpy(), pg)
        if name == "poisson_p1":
            rng = np.random.default_rng(5)
            dshift = np.abs(rng.standard_normal(pg.forms[0].ndof)) * 30.0
            sj = jax.jit(jg.shift_data)(jg.pdata(), jnp.asarray(dshift))
            sp = pg.shift_data(t(dshift))
            yj = np.asarray(jv(jg.pdata(), jnp.asarray(b), sj))
            yp = pg.vcycle(0, t(b), sp).numpy()
            x = rng.standard_normal(pg.forms[0].ndof)
            inj = (np.asarray(jg.inject(0, jnp.asarray(x))),
                   pg.inject(0, t(x)).numpy())
            out["shift"] = (sj, sp, yj, yp, inj)
    return out


@pytest.mark.parametrize("name", list(HIERARCHIES))
def test_vcycle_matches_jax(vcycles, name):
    ref, got, gmg = vcycles[name]
    assert rel(got, ref) <= TOL_OP
    if name == "hp_q3_q1":
        assert gmg.factors == [3, 2]


def test_shift_data_and_inject_match_jax(vcycles):
    sj, sp, yj, yp, (ij, ip) = vcycles["shift"]
    assert len(sp["shifts"]) == len(sj["shifts"]) == 3
    for a, b in zip(sp["shifts"], sj["shifts"]):
        assert rel(a.numpy(), b) <= TOL_OP
    # the JAX package inverts the shifted coarse matrix by Gauss-Jordan
    # without pivoting, the port by LU (torch.linalg.inv)
    assert rel(sp["coarse_inv"].numpy(), sj["coarse_inv"]) <= TOL_OP
    assert rel(yp, yj) <= TOL_OP
    assert np.array_equal(ip, ij)


def test_refreshed_coarse_matrix_is_the_matvec_on_unit_vectors():
    """``GMG.refresh`` assembles the coarse matrix densely; the JAX package
    builds it from the coarse form's matvec on the unit vectors.  Both
    give the same matrix, essential rows and columns included."""
    forms = PMG.build_hierarchy(lambda n: _minsurf(PORT, n), 4, 2)
    gmg = PMG.GMG(forms, fields={"eps": 1e-3}, nonlinear=True)
    fes = forms[0].spaces[0]
    x = t(fes.project_bdr(np.zeros(fes.ndof), _minsurf_bdry))
    gmg.refresh(x, {"eps": 1e-3})
    fc = forms[-1]
    eye = torch.eye(fc.ndof, dtype=F64)
    cols = torch.stack([fc.grad_mult(gmg.states[-1], e) for e in eye])
    A = gmg.coarse_A
    assert float((A - cols.T).abs().max()) <= 1e-13 * float(A.abs().max())
    assert float((gmg.coarse_inv @ A - eye).abs().max()) <= 1e-12


def _level_ptrs(gmg, sdata=None):
    return [t.data_ptr() for t in gmg._read_by_vcycle(sdata)]


def test_level_data_is_written_in_place():
    """A nonlinear refresh, the Newton state of ``set_fine`` and each
    ``shift_data`` land in the same tensors, with the values a GMG built
    afresh at that data has; the caller's state is copied, not kept."""
    fields = {"eps": 1e-3}
    forms = PMG.build_hierarchy(lambda n: _minsurf(PORT, n), 4, 2)
    gmg = PMG.GMG(forms, fields=fields, nonlinear=True)
    ptrs = _level_ptrs(gmg)
    fes = forms[0].spaces[0]
    x = t(fes.project_bdr(np.zeros(fes.ndof), _minsurf_bdry))
    gmg.refresh(x, fields)
    fresh = PMG.GMG(forms, fields=fields, x_levels=[x, gmg.inject(0, x)])
    assert _level_ptrs(gmg) == ptrs
    for lvl in range(2):
        assert torch.equal(gmg.states[lvl][0].planes,
                           fresh.states[lvl][0].planes)
        assert torch.equal(gmg.diags[lvl], fresh.diags[lvl])
    assert torch.equal(gmg.coarse_inv, fresh.coarse_inv)

    state = forms[0].grad_state(0.5 * x, fields)
    diag = forms[0].grad_diag(state)
    gmg.set_fine(state, diag)
    assert _level_ptrs(gmg) == ptrs
    assert torch.equal(gmg.states[0][0].planes, state[0].planes)
    assert gmg.states[0][0].planes.data_ptr() != state[0].planes.data_ptr()
    assert torch.equal(gmg.diags[0], diag)

    rng = np.random.default_rng(7)
    d1, d2 = (t(30.0 * np.abs(rng.standard_normal(fes.ndof)))
              for _ in range(2))
    s1 = gmg.shift_data(d1)
    sptrs = _level_ptrs(gmg, s1)
    s2 = gmg.shift_data(d2)
    assert _level_ptrs(gmg, s2) == sptrs
    ref = fresh.shift_data(d2)
    for a, b in zip(s2["shifts"], ref["shifts"]):
        assert torch.equal(a, b)
    assert torch.equal(s2["coarse_inv"], ref["coarse_inv"])


@pytest.mark.parametrize("levels", [2, 1])
def test_newton_direction_linearizes_each_level_once(monkeypatch, levels):
    """In one Newton direction with a nonlinear GMG, level 0's Newton
    state is computed once (by the direction) and its diagonal once (by
    ``newton_precond``); every level's state and diagonal and the coarse
    inverse equal, bitwise, those of ``refresh`` at the iterate followed
    by ``set_fine`` with the form's state and diagonal."""
    fields = {"eps": 1e-3}
    forms = PMG.build_hierarchy(lambda n: _minsurf(PORT, n), 4, levels)
    gmg, ref = (PMG.GMG(forms, fields=fields, nonlinear=True)
                for _ in range(2))
    fine = forms[0]
    fes = fine.spaces[0]
    x = t(fes.project_bdr(np.zeros(fes.ndof), _minsurf_bdry))
    calls = []
    for name in ("grad_state", "grad_diag"):
        real = getattr(fine, name)
        monkeypatch.setattr(fine, name, lambda *a, _r=real, _n=name, **k:
                            calls.append(_n) or _r(*a, **k))
    opts = PS.NewtonOptions(lin_solver="cg", lin_maxiter=3,
                            preconditioner=gmg.as_preconditioner())
    PS._direction(fine, x, torch.zeros_like(x), fields, opts)
    assert sorted(calls) == ["grad_diag", "grad_state"]
    monkeypatch.undo()
    state = fine.grad_state(x, fields)
    ref.refresh(x, fields)
    ref.set_fine(state, fine.grad_diag(state))
    for lvl in range(levels):
        assert torch.equal(gmg.states[lvl][0].planes,
                           ref.states[lvl][0].planes)
        assert torch.equal(gmg.diags[lvl], ref.diags[lvl])
    assert torch.equal(gmg.coarse_inv, ref.coarse_inv)


def test_vcycle_runs_eagerly_on_the_cpu(vcycles):
    """No graph is captured off the card; every V-cycle from level 0 is
    counted as an eager one."""
    _, _, gmg = vcycles["poisson_p1"]
    calls = gmg.eager_calls
    b = t(_rhs(gmg.forms[0], 3))
    assert torch.equal(gmg.vcycle(0, b), gmg._vcycle(0, b))
    gmg.vcycle(1, gmg.restrict(0, b))
    assert (gmg.captures, gmg.replays) == (0, 0)
    assert gmg.eager_calls == calls + 1 >= 2


# ---------------------------------------------------------------------------
# GMG-CG and Newton with GMG
# ---------------------------------------------------------------------------


def _jax_cg_iterations(mv, b, M, tol, maxiter):
    """(x, iterations) of ``mfem_ad_tpu.solvers.cg`` (which returns x
    only), through its own loop body."""
    norm_b = jnp.linalg.norm(b)
    bn = b / norm_b
    body, cond = JS._pcg_kernel(mv, M, tol**2, min(200, maxiter))
    out = jax.lax.while_loop(
        cond, body, JS._pcg_init(mv, M, bn, jnp.zeros_like(b), maxiter))
    return out[0] * norm_b, int(out[4])


def test_gmg_cg_32_matches_jax_and_beats_jacobi():
    """GMG-CG at 32^2 p1 Poisson: the residual and iteration count of the
    reference's; Jacobi-CG at the same budget is far off."""
    jf = JMG.build_hierarchy(lambda n: _diffusion(JAXPKG, n), 8, 3)
    pf = PMG.build_hierarchy(lambda n: _diffusion(PORT, n), 8, 3)
    b = _rhs(pf[0], 1)
    js = jf[0].grad_state(jnp.zeros(jf[0].ndof))
    ps = pf[0].grad_state(torch.zeros(pf[0].ndof, dtype=F64))
    jmv = lambda v: jf[0].grad_mult(js, v)  # noqa: E731
    pmv = lambda v: pf[0].grad_mult(ps, v)  # noqa: E731
    xj, kj = _jax_cg_iterations(jmv, jnp.asarray(b), JMG.GMG(jf), 1e-10, 12)
    xp, kp = PS.cg(pmv, t(b), M=PMG.GMG(pf), tol=1e-10, maxiter=12)
    rj = float(jnp.linalg.norm(jnp.asarray(b) - jmv(xj)) / np.linalg.norm(b))
    rp = float(torch.linalg.vector_norm(t(b) - pmv(xp)) / np.linalg.norm(b))
    assert kp == kj and kp <= 12
    assert rp < 1e-10 and rj < 1e-10
    assert rel(xp.numpy(), np.asarray(xj)) <= TOL_OP
    d = torch.abs(pf[0].grad_diag(ps))
    x_jac, _ = PS.cg(pmv, t(b), M=lambda r: r / d, tol=1e-30, maxiter=12)
    r_jac = float(torch.linalg.vector_norm(t(b) - pmv(x_jac))
                  / np.linalg.norm(b))
    assert r_jac > 1e-3


def _poisson_load(x):
    return 2 * np.pi**2 * np.sin(np.pi * x[0]) * np.sin(np.pi * x[1])


def _minsurf_bdry(x):
    theta = np.arctan2(x[1] - 0.5, x[0] - 0.5)
    r = np.sqrt((x[0] - 0.5) ** 2 + (x[1] - 0.5) ** 2)
    return 4.0 * r * np.cos(2 * theta)


@pytest.fixture(scope="module")
def gmg_newton():
    """Newton with the GMG preconditioner in both packages: linear Poisson
    (16^2, 3 levels) and the steep minimal surface (16^2, 3 levels,
    eps 1e-3, ``nonlinear=True``)."""
    out = {}
    for name in ("poisson", "minsurf"):
        runs = []
        for pkg, mg, S, tens in ((JAXPKG, JMG, JS, jnp.asarray),
                                 (PORT, PMG, PS, t)):
            if name == "poisson":
                forms = mg.build_hierarchy(lambda n: _diffusion(pkg, n), 4, 3)
                fes = forms[0].spaces[0]
                LF = JLinearForm if pkg is JAXPKG else PLinearForm
                bv = LF(fes, _poisson_load).assemble()
                bv[np.asarray(fes.boundary_dofs())] = 0.0
                x0, b, fields = np.zeros(fes.ndof), tens(bv), {}
                gmg = mg.GMG(forms)
                opts = dict(abs_tol=1e-10, max_iter=2, lin_tol=1e-13,
                            lin_maxiter=20)
            else:
                forms = mg.build_hierarchy(lambda n: _minsurf(pkg, n), 4, 3)
                fes = forms[0].spaces[0]
                x0 = fes.project_bdr(np.zeros(fes.ndof), _minsurf_bdry)
                b, fields = None, {"eps": tens(1e-3)}
                gmg = mg.GMG(forms, fields=fields, nonlinear=True)
                opts = dict(abs_tol=1e-10, rel_tol=0.0, max_iter=30,
                            lin_tol=1e-12, lin_maxiter=25)
            res = S.newton(forms[0], tens(x0), b=b, fields=fields,
                           opts=S.NewtonOptions(
                               lin_solver="cg",
                               preconditioner=gmg.as_preconditioner(),
                               **opts))
            runs.append(res)
        out[name] = runs
    return out


@pytest.mark.parametrize("name", ["poisson", "minsurf"])
def test_newton_with_gmg_matches_jax(gmg_newton, name):
    jres, pres = gmg_newton[name]
    assert pres.converged and jres.converged
    assert pres.iterations == jres.iterations
    if name == "poisson":
        assert pres.iterations == 1
    np.testing.assert_allclose(pres.history, jres.history, rtol=1e-6,
                               atol=1e-12)
    assert rel(pres.x.numpy(), np.asarray(jres.x)) <= TOL_TRAJ
    # GMG-CG per Newton step is short and mesh independent
    assert all(k <= 25 for k in pres.lin_iters)


# ---------------------------------------------------------------------------
# PGBlockGMG
# ---------------------------------------------------------------------------


def test_pg_block_gmg_application_matches_jax():
    """The block preconditioner [V-cycle on the primal block, |diag|^-1 on
    the latent] of the LVPP saddle Jacobian at a fixed state."""
    outs = []
    for pkg, mg, obs, tens in ((JAXPKG, JMG, jobs, jnp.asarray),
                               (PORT, PMG, pobs, t)):
        kw = {} if pkg is JAXPKG else {"device": DEV}
        pb = obs.build(order=1, ref_levels=0, n0=8, **kw)
        gmg = mg.GMG(mg.build_hierarchy(
            lambda n: _diffusion(pkg, n, 2), 4, 2))
        pgp = mg.PGBlockGMG(gmg, pb.form, latent_block=1)
        rng = np.random.default_rng(4)
        fields = {"alpha": tens(0.3),
                  "latent_k0": tens(rng.standard_normal(pb.latent_space.ndof))}
        x = 0.1 * rng.standard_normal(pb.form.ndof)
        state = pb.form.grad_state(tens(x), fields)
        r = _rhs(pb.form, 6)
        M = pgp.as_preconditioner()(pb.form, state)
        if pkg is JAXPKG:
            M = jax.jit(M)
        outs.append(np.asarray(M(tens(r))))
    assert rel(outs[1], outs[0]) <= TOL_OP
