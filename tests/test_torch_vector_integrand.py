"""Port parity, vector integrands (``ADVectorFunction``) and GMRES.

The three checks of tests/test_vector_integrand.py, each against the JAX
package on the same seeded inputs in f64:

- residual, Newton state (dF/dx, nonsymmetric), matrix-free action and the
  two-stage element Jacobians of a quasilinear flux F(g) = (1 + |g|^2) g +
  A g (A strictly upper triangular, built with numpy and handed to both
  packages) on 4x4 Q2, to 1e-12 relative; the dense Jacobian, scattered
  from the element matrices here, against jacfwd of JAX's residual;
- Newton with ``lin_solver="gmres"`` on the 6x6 Q1 problem: converged, and
  each iterate against the reference's to 1e-10;
- the refusals: no scalar energy, a mismatched ``n_output``, and both
  kernel routes naming the reason.

Plus ``solvers.gmres`` against ``mfem_ad_tpu.solvers.gmres`` on small
nonsymmetric systems, with and without restarts and a preconditioner.
"""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mfem_ad_tpu import fespace as jfespace
from mfem_ad_tpu import mesh as JM
from mfem_ad_tpu import solvers as JS
from mfem_ad_tpu.ad import ADVectorFunction as JVectorFunction
from mfem_ad_tpu.adeval import ADEval as JADEval
from mfem_ad_tpu.forms import LinearForm as JLinearForm
from mfem_ad_tpu.forms import NonlinearForm as JNonlinearForm
from mfem_ad_tpu.integrator import ADBlockIntegrator as JIntegrator
from mfem_ad_tpu_torch import mesh as PM
from mfem_ad_tpu_torch import solvers as PS
from mfem_ad_tpu_torch.ad import ADVectorFunction as PVectorFunction
from mfem_ad_tpu_torch.adeval import ADEval as PADEval
from mfem_ad_tpu_torch.fespace import FESpace as PFESpace
from mfem_ad_tpu_torch.forms import LinearForm as PLinearForm
from mfem_ad_tpu_torch.forms import NonlinearForm as PNonlinearForm
from mfem_ad_tpu_torch.integrator import ADBlockIntegrator as PIntegrator

F64 = torch.float64


def _flux_matrix(dim):
    return np.triu(np.ones((dim, dim)), 1) * 0.3  # strictly upper


class JaxFlux(JVectorFunction):
    """F(g) = (1 + |g|^2) g + A g: a quasilinear diffusion flux whose
    Jacobian dF/dg is not symmetric."""

    def __init__(self, dim: int):
        super().__init__(dim, dim)
        self.A = _flux_matrix(dim)

    def function(self, g, p):
        A = jnp.asarray(self.A, dtype=g.dtype)
        return (1.0 + jnp.dot(g, g)) * g + A @ g


class TorchFlux(PVectorFunction):
    """The same flux in PyTorch."""

    def __init__(self, dim: int):
        super().__init__(dim, dim)
        self.A = _flux_matrix(dim)

    def function(self, g, p):
        A = torch.as_tensor(self.A, dtype=g.dtype, device=g.device)
        return (1.0 + torch.dot(g, g)) * g + A @ g


def _rel(actual, ref):
    actual, ref = np.asarray(actual), np.asarray(ref)
    return np.abs(actual - ref).max() / np.abs(ref).max()


@functools.lru_cache(maxsize=None)
def _problem():
    """JAX and port integrators on 4x4 Q2, a seeded state and direction."""
    ji = JIntegrator(JaxFlux(2), [jfespace.FESpace(JM.make_cartesian_2d(4, 4),
                                                   order=2)], [JADEval.GRAD])
    pi = PIntegrator(TorchFlux(2), [PFESpace(PM.make_cartesian_2d(4, 4),
                                             order=2)],
                     [PADEval.GRAD], device="cpu", dtype=F64)
    rng = np.random.default_rng(0)
    u = 0.3 * rng.standard_normal(ji.spaces[0].ndof)
    v = np.random.default_rng(1).standard_normal(u.shape[0])
    return ji, pi, u, v


def _t(a):
    return torch.as_tensor(np.asarray(a), dtype=F64)


def test_vector_integrand_residual_state_and_action_match_jax():
    ji, pi, u, v = _problem()
    r_j = np.asarray(ji.residual([jnp.asarray(u)])[0])
    assert np.abs(r_j).max() > 0
    assert _rel(pi.residual([_t(u)])[0], r_j) <= 1e-12
    H_j = ji.hess_state([jnp.asarray(u)])
    H_p = pi.hess_state([_t(u)], sym=True)  # never packed: full dF/dx
    assert isinstance(H_p, torch.Tensor) and H_p.shape == H_j.shape
    assert _rel(H_p, H_j) <= 1e-12
    H_np = np.asarray(H_j)
    assert np.abs(H_np - np.swapaxes(H_np, -1, -2)).max() > 1e-3
    y_j = ji.hess_mult(H_j, [jnp.asarray(v)])[0]
    assert _rel(pi.hess_mult(H_p, [_t(v)])[0], y_j) <= 1e-12


def test_vector_integrand_element_jacobians_assemble_the_golden_jacobian():
    ji, pi, u, _ = _problem()
    A_j = np.asarray(ji.element_matrices(ji.hess_state([jnp.asarray(u)]),
                                         0, 0))
    A_p = pi.element_jacobians([_t(u)])  # auto takes two-stage
    assert _rel(A_p, A_j) <= 1e-12
    assert torch.equal(A_p, pi.element_jacobians([_t(u)],
                                                 route="two_stage"))
    # scatter the element matrices into the dense Jacobian
    edof = pi.tables["edof"][0].numpy()
    n = u.shape[0]
    J = np.zeros((n, n))
    for e, dofs in enumerate(edof):
        J[np.ix_(dofs, dofs)] += A_p[e].numpy()
    J_ad = np.asarray(jax.jacfwd(lambda w: ji.residual([w])[0])(
        jnp.asarray(u)))
    assert _rel(J, J_ad) <= 1e-12
    assert np.abs(J_ad - J_ad.T).max() > 1e-6 * np.abs(J_ad).max()


def _newton_problem(pkg):
    if pkg == "jax":
        m = JM.make_cartesian_2d(6, 6)
        fes = jfespace.FESpace(m, order=1)
        form = JNonlinearForm(fes)
        form.add_domain_integrator(JIntegrator(JaxFlux(2), [fes],
                                               [JADEval.GRAD]))
        load = JLinearForm(fes, lambda x: np.sin(np.pi * x[0])).assemble()
    else:
        m = PM.make_cartesian_2d(6, 6)
        fes = PFESpace(m, order=1)
        form = PNonlinearForm(fes, device="cpu", dtype=F64)
        form.add_domain_integrator(PIntegrator(TorchFlux(2), [fes],
                                               [PADEval.GRAD], device="cpu",
                                               dtype=F64))
        load = PLinearForm(fes, lambda x: np.sin(np.pi * x[0])).assemble()
    form.set_essential_bc([np.ones(m.max_bdr_attribute())])
    load = np.asarray(load).copy()
    load[np.asarray(fes.boundary_dofs())] = 0.0
    return form, fes, load


def test_vector_integrand_newton_gmres_matches_jax():
    jform, jfes, jload = _newton_problem("jax")
    pform, pfes, pload = _newton_problem("torch")
    kw = dict(abs_tol=1e-11, max_iter=20, lin_solver="gmres", lin_tol=1e-13)
    jres = JS.newton(jform, jnp.zeros(jfes.ndof), b=jnp.asarray(jload),
                     opts=JS.NewtonOptions(**kw))
    # the reference's iterates, one Newton step at a time
    ref_x = []
    for k in range(1, jres.iterations + 1):
        rk = JS.newton(jform, jnp.zeros(jfes.ndof), b=jnp.asarray(jload),
                       opts=JS.NewtonOptions(**{**kw, "max_iter": k}))
        ref_x.append(np.asarray(rk.x))
    pres = PS.newton(pform, torch.zeros(pfes.ndof, dtype=F64),
                     b=_t(pload), opts=PS.NewtonOptions(**kw))
    assert pres.converged and jres.converged
    assert pres.iterations == jres.iterations >= 2
    rn = (pform.mult(pres.x) - _t(pload)).numpy()
    assert np.linalg.norm(rn) < 1e-10
    for k, xr in enumerate(ref_x, start=1):
        pk = PS.newton(pform, torch.zeros(pfes.ndof, dtype=F64),
                       b=_t(pload),
                       opts=PS.NewtonOptions(**{**kw, "max_iter": k}))
        assert _rel(pk.x, xr) <= 1e-10, k
    assert _rel(pres.x, jres.x) <= 1e-10


def test_vector_integrand_refusals(monkeypatch):
    fes = PFESpace(PM.make_cartesian_2d(2, 2), order=1)
    intg = PIntegrator(TorchFlux(2), [fes], [PADEval.GRAD], device="cpu",
                       dtype=F64)
    u = torch.zeros(fes.ndof, dtype=F64)
    with pytest.raises(ValueError, match="no scalar energy"):
        intg.energy([u])
    bad = PVectorFunction(2, 3, fn=lambda x, p: torch.zeros(3))
    with pytest.raises(ValueError, match="n_output"):
        PIntegrator(bad, [fes], [PADEval.GRAD], device="cpu")
    # the kernel routes name the reason, even with tables taken for CUDA
    monkeypatch.setattr(PIntegrator, "_tables_on_cuda", lambda self: True)
    for route in ("kernel", "kernel_ad"):
        assert "vector integrands" in intg.route_refusal(route)
    for route in ("kernel", "kernel_ad"):
        with pytest.raises(ValueError, match="vector integrands"):
            intg.element_jacobians([u], route=route)
    assert torch.equal(intg.element_jacobians([u]),
                       intg.element_jacobians([u], route="two_stage"))


# ---------------------------------------------------------------------------
# GMRES against the reference
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n,restart,precond", [
    (40, 50, False), (40, 8, False), (40, 8, True), (25, 3, True),
])
def test_gmres_matches_jax(n, restart, precond):
    rng = np.random.default_rng(n + restart)
    A = np.eye(n) * 4.0 + rng.standard_normal((n, n)) / np.sqrt(n)
    A += np.triu(rng.standard_normal((n, n)), 1) * 0.5  # nonsymmetric
    b = rng.standard_normal(n)
    d = np.diag(A).copy()
    kw = dict(tol=1e-12, maxiter=200, restart=restart)
    x_j = JS.gmres(lambda v: jnp.asarray(A) @ v, jnp.asarray(b),
                   M=(lambda v: v / jnp.asarray(d)) if precond else None,
                   **kw)
    At, dt = _t(A), _t(d)
    x_p, its = PS.gmres(lambda v: At @ v, _t(b),
                        M=(lambda v: v / dt) if precond else None, **kw)
    assert _rel(x_p, x_j) <= 1e-10
    assert np.linalg.norm(A @ x_p.numpy() - b) <= 1e-9 * np.linalg.norm(b)
    assert 0 < its <= 200


def test_gmres_exact_start_and_zero_rhs_stay_finite():
    A = _t(np.diag([1.0, 2.0, 3.0]) + np.triu(np.ones((3, 3)), 1))
    b = _t([1.0, 2.0, 3.0])
    x_exact = torch.linalg.solve(A, b)
    x, _ = PS.gmres(lambda v: A @ v, b, x0=x_exact, tol=1e-12)
    assert torch.isfinite(x).all()
    assert torch.allclose(x, x_exact, rtol=0, atol=1e-14)
    z, _ = PS.gmres(lambda v: A @ v, torch.zeros(3, dtype=F64))
    assert torch.equal(z, torch.zeros(3, dtype=F64))
