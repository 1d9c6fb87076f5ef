"""Port parity, dense assembly and the direct and MINRES solvers.

Against the JAX package on the same seeded inputs in f64:

- ``element_matrices`` through the blocked W0 GEMM at 2D p2 vector, 3D p1
  vector and 3D p2 vector neo-Hookean (1e-12 relative), and the W0 GEMM
  against the per-qp einsum;
- ``assemble_dense`` of a one-block form and of a two-block saddle form
  (H1 Q2 u, L2 Q1 psi) with essential dofs, and ``set_essential_dofs``;
- ``solvers.minres`` against ``mfem_ad_tpu.solvers.minres`` on symmetric
  indefinite systems (with and without an SPD preconditioner, converged
  and cut at ``maxiter``);
- ``newton`` with ``lin_solver="dense"`` and ``"minres"`` on the saddle
  form, and the minimum-norm fallback of the dense solve on singular
  systems (an exactly singular matrix, and pure-Neumann diffusion).
"""

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
from mfem_ad_tpu.forms import BlockNonlinearForm as JBlockForm
from mfem_ad_tpu.forms import LinearForm as JLinearForm
from mfem_ad_tpu.forms import NonlinearForm as JNonlinearForm
from mfem_ad_tpu.integrator import ADBlockIntegrator as JIntegrator
from mfem_ad_tpu_torch import ad as pad
from mfem_ad_tpu_torch import mesh as PM
from mfem_ad_tpu_torch import solvers as PS
from mfem_ad_tpu_torch.adeval import ADEval as PADEval
from mfem_ad_tpu_torch.fespace import FESpace as PFESpace
from mfem_ad_tpu_torch.forms import BlockNonlinearForm as PBlockForm
from mfem_ad_tpu_torch.forms import LinearForm as PLinearForm
from mfem_ad_tpu_torch.forms import NonlinearForm as PNonlinearForm
from mfem_ad_tpu_torch.integrator import ADBlockIntegrator as PIntegrator
from mfem_ad_tpu_torch.integrator import _elmat_from_h

F64 = torch.float64


def _rel(actual, ref):
    actual, ref = np.asarray(actual), np.asarray(ref)
    return np.abs(actual - ref).max() / max(np.abs(ref).max(), 1e-300)


# ---------------------------------------------------------------------------
# element_matrices through W0
# ---------------------------------------------------------------------------

W0_CASES = {"2d_p2": (2, 2, (3, 3)), "3d_p1": (3, 1, (2, 2, 2)),
            "3d_p2": (3, 2, (2, 1, 1))}


@functools.lru_cache(maxsize=None)
def _w0_pair(case):
    dim, order, dims = W0_CASES[case]
    jm = JM.make_cartesian_2d(*dims) if dim == 2 else JM.make_cartesian_3d(
        *dims)
    pm = PM.make_cartesian_2d(*dims) if dim == 2 else PM.make_cartesian_3d(
        *dims)
    ji = JIntegrator(jad.NeoHookeanEnergy(dim, 1.3, 0.7),
                     [JFESpace(jm, order, vdim=dim)],
                     [JADEval.GRAD | JADEval.VECTOR])
    pi = PIntegrator(pad.NeoHookeanEnergy(dim, 1.3, 0.7),
                     [PFESpace(pm, order, vdim=dim)],
                     [PADEval.GRAD | PADEval.VECTOR], device="cpu")
    rng = np.random.default_rng(3)
    u = (0.05 / max(dims)) * rng.standard_normal(ji.spaces[0].ndof)
    return ji, pi, u


@pytest.mark.parametrize("case", list(W0_CASES))
def test_element_matrices_w0_matches_jax(case):
    ji, pi, u = _w0_pair(case)
    assert "0_0" in pi.tables["W0"]  # the W0 GEMM serves
    A_j = ji.element_matrices(ji.hess_state([jnp.asarray(u)]), 0, 0)
    Hq = pi.hess_state([torch.as_tensor(u)], sym=True)
    A_p = pi.element_matrices(Hq, 0, 0)
    nde = pi.vdim[0] * pi.nd[0]
    assert tuple(A_p.shape) == (pi.mesh.num_elements, nde, nde)
    assert _rel(A_p.numpy(), A_j) <= 1e-12
    # the same blocks from the per-qp B H B^T einsum
    H = Hq.full()
    v, sd = pi.vdim[0], pi.sd[0]
    H6 = H.reshape(H.shape[0], pi.nq, v, sd, v, sd)
    B = pi.tables["B"][0][0]
    A_e = _elmat_from_h(B, B, H6).reshape(A_p.shape)
    assert _rel(A_p.numpy(), A_e.numpy()) <= 1e-13


# ---------------------------------------------------------------------------
# assemble_dense and essential dofs
# ---------------------------------------------------------------------------


class JSaddle(jad.ADFunction):
    """0.5 g.g + 0.25 (g.g)^2 + psi g0 - 0.5 psi^2 over (grad u, psi)."""

    def __init__(self):
        super().__init__(3)

    def energy(self, x, p):
        gg = x[0] * x[0] + x[1] * x[1]
        return 0.5 * gg + 0.25 * gg * gg + x[2] * x[0] - 0.5 * x[2] * x[2]


class PSaddle(pad.ADFunction):
    def __init__(self):
        super().__init__(3)

    def energy(self, x, p):
        gg = x[0] * x[0] + x[1] * x[1]
        return 0.5 * gg + 0.25 * gg * gg + x[2] * x[0] - 0.5 * x[2] * x[2]


def _saddle(pkg):
    """A two-block (H1 Q2 u, L2 Q1 psi) indefinite form on 3x3 quads,
    u = 0 on the boundary, and a load on u."""
    if pkg == "jax":
        M, FES, Form, Intg, LF, E, Ev = (JM, JFESpace, JBlockForm,
                                         JIntegrator, JLinearForm, JSaddle,
                                         JADEval)
        kw = {}
    else:
        M, FES, Form, Intg, LF, E, Ev = (PM, PFESpace, PBlockForm,
                                         PIntegrator, PLinearForm, PSaddle,
                                         PADEval)
        kw = {"device": "cpu"}
    m = M.make_cartesian_2d(3, 3)
    su, sp = FES(m, 2), FES(m, 1, fe_type="L2")
    form = Form([su, sp], **kw)
    form.add_domain_integrator(Intg(E(), [su, sp], [Ev.GRAD, Ev.VALUE],
                                    **kw))
    form.set_essential_bc([np.ones(m.max_bdr_attribute()), None])
    load = np.concatenate([
        LF(su, lambda x: 1.0 + x[0] * x[1]).assemble(), np.zeros(sp.ndof)])
    load[np.asarray(form.ess_mask)] = 0.0
    return form, load


def _state(form, seed):
    rng = np.random.default_rng(seed)
    return np.where(np.asarray(form.ess_mask), 0.0,
                    0.5 * rng.standard_normal(form.ndof))


def test_assemble_dense_two_block_matches_jax():
    jform, _ = _saddle("jax")
    pform, _ = _saddle("torch")
    x = _state(jform, 5)
    A_j = jform.assemble_dense(jform.grad_state(jnp.asarray(x)))
    A_p = pform.assemble_dense(pform.grad_state(torch.as_tensor(x)))
    assert isinstance(A_p, torch.Tensor) and A_p.dtype == F64
    assert _rel(A_p.numpy(), A_j) <= 1e-12
    ess = pform.ess_mask.numpy()
    assert np.all(A_p.numpy()[ess][:, ess] == np.eye(ess.sum()))
    # indefinite: the psi block contributes negative eigenvalues
    ev = np.linalg.eigvalsh(A_p.numpy())
    assert ev.min() < 0 < ev.max()


@pytest.mark.parametrize("case", ["3d_p2", "2d_p2"])
def test_assemble_dense_equals_grad_mult(case):
    """The dense Jacobian times a vector is the matrix-free action, with
    the same elimination (vector neo-Hookean, clamped boundary)."""
    _, pi, u = _w0_pair(case)
    form = PNonlinearForm(pi.spaces[0], device="cpu")
    form.add_domain_integrator(pi)
    form.set_essential_bc([np.ones(pi.mesh.max_bdr_attribute())])
    state = form.grad_state(torch.as_tensor(u))
    A = form.assemble_dense(state)
    rng = np.random.default_rng(8)
    for _ in range(4):
        v = torch.as_tensor(rng.standard_normal(form.ndof))
        ref = form.grad_mult(state, v)
        assert _rel((A @ v).numpy(), ref.numpy()) <= 1e-12


def test_set_essential_dofs_matches_jax():
    jform, _ = _saddle("jax")
    pform, _ = _saddle("torch")
    for form in (jform, pform):
        form.set_essential_dofs(np.array([0, 3]), space=1)
    assert np.array_equal(pform.ess_mask.numpy(), np.asarray(jform.ess_mask))
    assert pform.ess_mask.numpy()[jform.offsets[1] + 3]
    mask = np.zeros(pform.ndof, dtype=bool)
    mask[[1, 7]] = True
    for form in (jform, pform):
        form.set_essential_dofs(mask)
    assert np.array_equal(pform.ess_mask.numpy(), mask)
    assert np.array_equal(np.asarray(jform.ess_mask), mask)


# ---------------------------------------------------------------------------
# MINRES
# ---------------------------------------------------------------------------


def _indefinite(n, seed):
    rng = np.random.default_rng(seed)
    Q, _ = np.linalg.qr(rng.standard_normal((n, n)))
    ev = np.concatenate([np.linspace(1.0, 20.0, n // 2),
                         -np.linspace(0.5, 10.0, n - n // 2)])
    A = (Q * ev) @ Q.T
    return 0.5 * (A + A.T), rng.standard_normal(n)


@pytest.mark.parametrize("precond", [False, True])
@pytest.mark.parametrize("maxiter", [7, 400])
def test_minres_matches_jax(precond, maxiter):
    A, b = _indefinite(40, 2)
    d = 1.0 + np.arange(40) / 40.0  # SPD diagonal preconditioner
    Aj, At = jnp.asarray(A), torch.as_tensor(A)
    Mj = (lambda v: v / jnp.asarray(d)) if precond else None
    Mt = (lambda v: v / torch.as_tensor(d)) if precond else None
    xj = JS.minres(lambda v: Aj @ v, jnp.asarray(b), M=Mj, tol=1e-12,
                   maxiter=maxiter)
    xt, its = PS.minres(lambda v: At @ v, torch.as_tensor(b), M=Mt,
                        tol=1e-12, maxiter=maxiter)
    assert _rel(xt.numpy(), xj) <= 1e-10
    if maxiter == 7:
        assert its == 7
    else:
        assert 7 < its < maxiter
        assert np.linalg.norm(A @ xt.numpy() - b) <= 1e-10 * np.linalg.norm(b)


def test_minres_floor_exit_matches_jax():
    """A slowly converging indefinite system (a shifted 1D Laplacian,
    n = 200): with a 5-iteration window the floor exit stops both packages
    at the same iterate, long before the tolerance; without the exit
    MINRES runs to it."""
    n = 200
    A = (2 * np.eye(n) - np.eye(n, k=1) - np.eye(n, k=-1)) * (n + 1) ** 2
    A -= 1000.0 * np.eye(n)
    b = np.random.default_rng(4).standard_normal(n)
    At = torch.as_tensor(A)
    xj = JS.minres(lambda v: jnp.asarray(A) @ v, jnp.asarray(b), tol=1e-12,
                   maxiter=2000, stall_window=5)
    xt, its = PS.minres(lambda v: At @ v, torch.as_tensor(b), tol=1e-12,
                        maxiter=2000, stall_window=5)
    assert its < n and its % 5 == 0
    assert np.linalg.norm(A @ xt.numpy() - b) > 1e-3 * np.linalg.norm(b)
    assert _rel(xt.numpy(), xj) <= 1e-10
    x, its = PS.minres(lambda v: At @ v, torch.as_tensor(b), tol=1e-12,
                       maxiter=2000, stall_window=None)
    assert np.linalg.norm(A @ x.numpy() - b) <= 1e-11 * np.linalg.norm(b)


# ---------------------------------------------------------------------------
# Newton with the dense and MINRES directions
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("lin_solver", ["dense", "minres"])
def test_newton_saddle_matches_jax(lin_solver):
    jform, load = _saddle("jax")
    pform, _ = _saddle("torch")
    kw = dict(abs_tol=1e-11, rel_tol=1e-12, max_iter=20, lin_tol=1e-13,
              lin_solver=lin_solver,
              preconditioner="jacobi" if lin_solver == "minres" else None)
    jres = JS.newton(jform, jnp.zeros(jform.ndof), b=jnp.asarray(load),
                     opts=JS.NewtonOptions(**kw))
    pres = PS.newton(pform, torch.zeros(pform.ndof, dtype=F64),
                     b=torch.as_tensor(load), opts=PS.NewtonOptions(**kw))
    assert jres.converged and pres.converged
    assert pres.iterations == jres.iterations >= 3
    assert _rel(pres.x.numpy(), jres.x) <= 1e-10
    assert len(pres.lin_iters) == (pres.iterations
                                   if lin_solver == "minres" else 0)


def test_newton_callable_lin_solver():
    """A callable direction (here: the dense solve) gives the dense path's
    iterates."""
    pform, load = _saddle("torch")
    kw = dict(abs_tol=1e-11, rel_tol=1e-12, max_iter=20)
    b = torch.as_tensor(load)
    x0 = torch.zeros(pform.ndof, dtype=F64)
    seen = []

    def direct(form, state, r):
        seen.append(r.shape)
        return PS.dense_solve(form.assemble_dense(state), r)

    a = PS.newton(pform, x0, b=b, opts=PS.NewtonOptions(lin_solver=direct,
                                                        **kw))
    d = PS.newton(pform, x0, b=b, opts=PS.NewtonOptions(lin_solver="dense",
                                                        **kw))
    assert a.converged and a.iterations == d.iterations == len(seen)
    assert torch.equal(a.x, d.x)


def test_dense_solve_min_norm_fallback_on_singular_matrix():
    A = np.diag([2.0, 1.0, 0.0, 0.0])
    A[0, 1] = A[1, 0] = 0.5
    r = np.array([1.0, -2.0, 3.0, 0.5])
    c = PS.dense_solve(torch.as_tensor(A), torch.as_tensor(r))
    ref = np.linalg.lstsq(A, r, rcond=1e-10)[0]
    assert np.all(np.isfinite(c.numpy()))
    np.testing.assert_allclose(c.numpy(), ref, rtol=0, atol=1e-14)
    assert c.numpy()[2] == 0.0 and c.numpy()[3] == 0.0  # minimum norm


def _neumann(pkg):
    """Diffusion with no essential dofs: J is singular (constants)."""
    if pkg == "jax":
        m = JM.make_cartesian_2d(4, 4)
        fes = JFESpace(m, 1)
        form = JNonlinearForm(fes)
        form.add_ad_integrator(jad.DiffusionEnergy(2), JADEval.GRAD)
        return form, JLinearForm(fes, lambda x: 1.0 + x[0]).assemble()
    m = PM.make_cartesian_2d(4, 4)
    fes = PFESpace(m, 1)
    form = PNonlinearForm(fes, device="cpu")
    form.add_ad_integrator(pad.DiffusionEnergy(2), PADEval.GRAD)
    return form, PLinearForm(fes, lambda x: 1.0 + x[0]).assemble()


def test_newton_dense_min_norm_on_singular_system_matches_jax():
    jform, load = _neumann("jax")
    pform, _ = _neumann("torch")
    kw = dict(abs_tol=1e-12, max_iter=5, lin_solver="dense")
    jres = JS.newton(jform, jnp.zeros(jform.ndof), b=jnp.asarray(load),
                     opts=JS.NewtonOptions(**kw))
    pres = PS.newton(pform, torch.zeros(pform.ndof, dtype=F64),
                     b=torch.as_tensor(load), opts=PS.NewtonOptions(**kw))
    # the load has a nonzero mean: no solution, Newton floors
    assert not pres.converged and not jres.converged
    assert pres.iterations == jres.iterations
    x = pres.x.numpy()
    assert np.all(np.isfinite(x)) and abs(x.mean()) <= 1e-10 * np.abs(x).max()
    assert _rel(x, jres.x) <= 1e-10
