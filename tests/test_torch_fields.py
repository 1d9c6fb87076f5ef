"""Port parity, runtime field parameters.

An energy with three runtime fields, each against the JAX package on the
same seeded inputs in f64 to 1e-12 relative:

    f(g; s, k, m) = 0.5 (1 + k.k + m^2) g.g + s (g.g)^2

with ``s`` a ``ScalarFieldCoefficient``, ``k`` a ``GridFunctionCoefficient``
on a vector (vdim 2) Q2 space and ``m`` one on an L2 space, over a scalar Q2
space on 3x3 quads: energy, residual, Hessian state, two-stage element
Jacobians and a Newton solve (dense and Jacobi-CG); the named refusals of
both kernel routes; a missing field; and ``convert`` carrying the field
tables.
"""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mfem_ad_tpu import mesh as JM
from mfem_ad_tpu import solvers as JS
from mfem_ad_tpu.ad import ADFunction as JADFunction
from mfem_ad_tpu.adeval import ADEval as JADEval
from mfem_ad_tpu.coefficients import GridFunctionCoefficient as JGF
from mfem_ad_tpu.coefficients import ScalarFieldCoefficient as JSF
from mfem_ad_tpu.fespace import FESpace as JFESpace
from mfem_ad_tpu.forms import NonlinearForm as JNonlinearForm
from mfem_ad_tpu.integrator import ADBlockIntegrator as JIntegrator
from mfem_ad_tpu_torch import mesh as PM
from mfem_ad_tpu_torch import solvers as PS
from mfem_ad_tpu_torch.ad import ADFunction as PADFunction
from mfem_ad_tpu_torch.adeval import ADEval as PADEval
from mfem_ad_tpu_torch.coefficients import GridFunctionCoefficient as PGF
from mfem_ad_tpu_torch.coefficients import ScalarFieldCoefficient as PSF
from mfem_ad_tpu_torch.convert import tables_from_numpy
from mfem_ad_tpu_torch.fespace import FESpace as PFESpace
from mfem_ad_tpu_torch.forms import NonlinearForm as PNonlinearForm
from mfem_ad_tpu_torch.integrator import ADBlockIntegrator as PIntegrator

F64 = torch.float64
N = 3  # 3x3 quads


class JaxFieldEnergy(JADFunction):
    def __init__(self, kspace, mspace):
        super().__init__(2)
        self.add_parameter("s", JSF("s"))
        self.add_parameter("k", JGF(kspace, "k"))
        self.add_parameter("m", JGF(mspace, "m"))

    def energy(self, g, p):
        gg = jnp.dot(g, g)
        c = 1.0 + jnp.dot(p["k"], p["k"]) + p["m"][0] ** 2
        return 0.5 * c * gg + p["s"][0] * gg * gg


class TorchFieldEnergy(PADFunction):
    def __init__(self, kspace, mspace):
        super().__init__(2)
        self.add_parameter("s", PSF("s"))
        self.add_parameter("k", PGF(kspace, "k"))
        self.add_parameter("m", PGF(mspace, "m"))

    def energy(self, g, p):
        gg = torch.dot(g, g)
        c = 1.0 + torch.dot(p["k"], p["k"]) + p["m"][0] ** 2
        return 0.5 * c * gg + p["s"][0] * gg * gg


def _spaces(M, FESpace):
    m = M.make_cartesian_2d(N, N)
    return (m, FESpace(m, 2), FESpace(m, 2, vdim=2),
            FESpace(m, 1, fe_type="L2"))


@functools.lru_cache(maxsize=None)
def _problem():
    """Both packages' integrators and forms, the fields (numpy) and a
    state."""
    jm, ju, jk, jl = _spaces(JM, JFESpace)
    pm, pu, pk, pl = _spaces(PM, PFESpace)
    ji = JIntegrator(JaxFieldEnergy(jk, jl), [ju], [JADEval.GRAD])
    pi = PIntegrator(TorchFieldEnergy(pk, pl), [pu], [PADEval.GRAD],
                     device="cpu")
    rng = np.random.default_rng(21)
    fields = {"s": 0.3, "k": 0.5 * rng.standard_normal(jk.ndof),
              "m": rng.standard_normal(jl.ndof)}
    u = 0.5 * rng.standard_normal(ju.ndof)
    return ji, pi, fields, u


def _jf(fields):
    return {k: jnp.asarray(v) for k, v in fields.items()}


def _rel(actual, ref):
    actual, ref = np.asarray(actual), np.asarray(ref)
    return np.abs(actual - ref).max() / max(np.abs(ref).max(), 1e-300)


QUANTITIES = {
    "energy": (lambda ji, u, f: ji.energy([u], f),
               lambda pi, u, f: pi.energy([u], f)),
    "residual": (lambda ji, u, f: ji.residual([u], f)[0],
                 lambda pi, u, f: pi.residual([u], f)[0]),
    "hess_state": (lambda ji, u, f: ji.hess_state([u], f),
                   lambda pi, u, f: pi.hess_state([u], f)),
    "hess_state_sym": (lambda ji, u, f: ji.hess_state([u], f, sym=True).full(),
                       lambda pi, u, f: pi.hess_state([u], f, sym=True).full()),
    "element_jacobians": (lambda ji, u, f: ji.element_jacobians([u], f),
                          lambda pi, u, f: pi.element_jacobians([u], f)),
}


@pytest.mark.parametrize("what", list(QUANTITIES))
def test_field_backed_integrator_matches_jax(what):
    ji, pi, fields, u = _problem()
    jfn, pfn = QUANTITIES[what]
    ref = jfn(ji, jnp.asarray(u), _jf(fields))
    got = pfn(pi, torch.as_tensor(u), fields)
    assert tuple(np.shape(got)) == tuple(np.shape(ref))
    assert _rel(got.detach().numpy(), ref) <= 1e-12


def test_fields_change_the_result():
    """Each field enters: changing any one changes the residual."""
    _, pi, fields, u = _problem()
    ut = torch.as_tensor(u)
    r0 = pi.residual([ut], fields)[0]
    for name in fields:
        f2 = dict(fields)
        f2[name] = 2.0 * np.asarray(fields[name]) + 0.1
        assert _rel(pi.residual([ut], f2)[0].numpy(), r0.numpy()) > 1e-3


def test_eval_params_shapes_and_scalar_is_a_view():
    _, pi, fields, _ = _problem()
    p = pi.eval_params(fields)
    ne, nq = N * N, pi.nq
    assert tuple(p["k"].shape) == (ne, nq, 2)
    assert tuple(p["m"].shape) == (ne, nq, 1)
    assert tuple(p["s"].shape) == (1, nq, 1)
    assert p["s"].stride()[1] == 0  # broadcast, not copied
    assert float(p["s"][0, 0, 0]) == 0.3


def test_missing_field_raises_key_error_naming_it():
    _, pi, fields, u = _problem()
    part = {k: v for k, v in fields.items() if k != "k"}
    with pytest.raises(KeyError, match="'k'"):
        pi.residual([torch.as_tensor(u)], part)
    with pytest.raises(KeyError, match="'s'"):
        pi.energy([torch.as_tensor(u)])


def test_kernel_routes_refuse_field_backed_integrators():
    _, pi, fields, u = _problem()
    for route in ("kernel", "kernel_ad"):
        why = pi.route_refusal(route)
        assert why is not None and "runtime field parameters" in why
        assert "'s'" not in why and "s, k, m" in why
    ut = torch.as_tensor(u)
    for route in ("kernel", "kernel_ad"):
        with pytest.raises(ValueError, match="runtime field parameters"):
            pi.element_jacobians([ut], fields, route=route)
    assert pi.auto_route(fields) == "two_stage"
    A = pi.element_jacobians([ut], fields)
    A2 = pi.element_matrices(pi.hess_state([ut], fields), 0, 0)
    assert torch.equal(A, A2)


def test_convert_carries_field_tables():
    ji, pi, fields, u = _problem()
    jt = jax.tree_util.tree_map(np.asarray, ji.tables)
    t = tables_from_numpy(jt, "cpu", F64)
    assert set(t["field"]) == {"k", "m"}
    for name, phi in t["field"].items():
        np.testing.assert_allclose(phi.numpy(), jt["field"][name][1],
                                   rtol=0, atol=0)
        np.testing.assert_allclose(phi.numpy(),
                                   pi.tables["field"][name].numpy(), rtol=0,
                                   atol=1e-15)
    pc = PIntegrator(pi.f, pi.spaces, pi.modes, device="cpu", tables=t)
    ut = torch.as_tensor(u)
    assert torch.allclose(pc.residual([ut], fields)[0],
                          pi.residual([ut], fields)[0], rtol=0, atol=1e-14)


def _forms():
    """Both packages' forms of the field energy, Dirichlet on the whole
    boundary with data 0.3 x + 0.2 y^2 projected, and the fields."""
    ji, pi, fields, _ = _problem()
    jform = JNonlinearForm(ji.spaces[0])
    jform.add_domain_integrator(ji)
    pform = PNonlinearForm(pi.spaces[0], device="cpu")
    pform.add_domain_integrator(pi)
    for form in (jform, pform):
        form.set_essential_bc([np.ones(form.space.mesh.max_bdr_attribute())])
    x0 = ji.spaces[0].project_bdr(np.zeros(ji.spaces[0].ndof),
                                  lambda x: 0.3 * x[0] + 0.2 * x[1] ** 2)
    return jform, pform, fields, x0


@pytest.mark.parametrize("lin_solver", ["dense", "cg"])
def test_newton_with_fields_matches_jax(lin_solver):
    jform, pform, fields, x0 = _forms()
    kw = dict(abs_tol=1e-11, rel_tol=1e-12, max_iter=20, lin_tol=1e-13,
              lin_solver=lin_solver,
              preconditioner="jacobi" if lin_solver == "cg" else None)
    jres = JS.newton(jform, jnp.asarray(x0), fields=_jf(fields),
                     opts=JS.NewtonOptions(**kw))
    pres = PS.newton(pform, torch.as_tensor(x0), fields=fields,
                     opts=PS.NewtonOptions(**kw))
    assert pres.converged and jres.converged
    assert pres.iterations == jres.iterations >= 2
    assert _rel(pres.x.numpy(), jres.x) <= 1e-10
    if lin_solver == "cg":
        assert len(pres.lin_iters) == pres.iterations
    else:
        assert pres.lin_iters == []
