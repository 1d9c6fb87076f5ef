"""Port parity, fused element-Jacobian op: the plain PyTorch version of the
CUDA kernel (``mfem_ad_tpu_torch.ops.fused_jacobian``) against the JAX
package's Pallas kernel ``_kernel_tile`` run in interpret mode (as
tests/test_ops.py runs it) and against JAX's two-stage route, plus the
routing rules on a host without a GPU.

The CUDA kernel is the blocked kernel's GEMM at vdim = 1, sd = n
(``ops/blocked_jacobian.py``): its launch plans are tested in
tests/test_torch_blocked_jacobian.py, and this file checks the route to
it, its operands and that its function is the blocked one at vdim = 1.

Tolerance: atol 1e-10 * max(1, max|A|) in f64, as tests/test_ops.py holds
the Pallas kernel to the two-stage route."""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import mfem_ad_tpu.ad as jad
from mfem_ad_tpu import mesh as JM
from mfem_ad_tpu.adeval import ADEval as JADEval
from mfem_ad_tpu.fespace import FESpace as JFESpace
from mfem_ad_tpu.integrator import ADBlockIntegrator as JIntegrator
from mfem_ad_tpu.ops.fused_jacobian import (
    element_jacobian_via_pallas,
    supports_fused as jax_supports_fused,
)
from mfem_ad_tpu_torch import ad as pad
from mfem_ad_tpu_torch import mesh as PM
from mfem_ad_tpu_torch.adeval import ADEval as PADEval
from mfem_ad_tpu_torch.convert import tables_from_numpy, vector_from_numpy
from mfem_ad_tpu_torch.fespace import FESpace as PFESpace
from mfem_ad_tpu_torch.integrator import ADBlockIntegrator as PIntegrator
from mfem_ad_tpu_torch.ops import blocked_jacobian as bj
from mfem_ad_tpu_torch.ops import fused_jacobian as fj
from mfem_ad_tpu_torch.ops import nvcc

F64 = torch.float64
ENERGIES = {"neohookean": "NeoHookeanEnergy",
            "elasticity": "LinearElasticityEnergy",
            "diffusion": "DiffusionEnergy"}


@functools.lru_cache(maxsize=None)
def _pair(energy, n, order=1, dim=2):
    cls = ENERGIES[energy]
    vdim = 1 if energy == "diffusion" else dim
    args = (dim,) if energy == "diffusion" else (dim, 1.3, 0.7)
    jm = JM.make_cartesian_2d(n, n) if dim == 2 else JM.make_cartesian_3d(
        n, n, n)
    pm = PM.make_cartesian_2d(n, n) if dim == 2 else PM.make_cartesian_3d(
        n, n, n)
    jmode = JADEval.GRAD | (JADEval.VECTOR if vdim > 1 else 0)
    pmode = PADEval.GRAD | (PADEval.VECTOR if vdim > 1 else 0)
    ji = JIntegrator(getattr(jad, cls)(*args),
                     [JFESpace(jm, order, vdim=vdim)], [jmode])
    jt = jax.tree_util.tree_map(np.asarray, ji.tables)
    pi = PIntegrator(getattr(pad, cls)(*args),
                     [PFESpace(pm, order, vdim=vdim)], [pmode], device="cpu",
                     tables=tables_from_numpy(jt, "cpu", F64))
    rng = np.random.default_rng(11)
    u = (0.1 / n) * rng.standard_normal(ji.spaces[0].ndof)
    return ji, pi, u


def _plain_inputs(pi, u):
    return pi.kernel_inputs([vector_from_numpy(u, "cpu", F64)])


def _tol(A):
    return 1e-10 * max(1.0, float(np.abs(A).max()))


@pytest.mark.parametrize("energy", ["neohookean", "elasticity"])
@pytest.mark.parametrize("n", [3, 4])  # 3x3 = 9 elements: a ragged block
def test_plain_matches_jax_pallas_interpret_and_two_stage(energy, n):
    ji, pi, u = _pair(energy, n)
    A_pallas = np.asarray(element_jacobian_via_pallas(
        ji, [jnp.asarray(u)], interpret=True, block=16))
    A_two = np.asarray(ji.element_matrices(
        ji.hess_state([jnp.asarray(u)]), 0, 0))
    A = fj.fused_element_jacobian_plain(pi.f, *_plain_inputs(pi, u)).numpy()
    assert A.shape == (n * n, 8, 8)
    np.testing.assert_allclose(A, A_pallas, rtol=0, atol=_tol(A_pallas))
    np.testing.assert_allclose(A, A_two, rtol=0, atol=_tol(A_two))


@pytest.mark.parametrize("energy", ["neohookean", "elasticity"])
def test_plain_matches_two_stage_in_3d(energy):
    """The plain version is shape-generic: p1/3D (full W installed)."""
    _, pi, u = _pair(energy, 2, dim=3)
    A = fj.fused_element_jacobian_plain(pi.f, *_plain_inputs(pi, u))
    A_two = pi.element_jacobians([vector_from_numpy(u, "cpu", F64)],
                                 route="two_stage")
    np.testing.assert_allclose(A.numpy(), A_two.numpy(), rtol=0,
                               atol=_tol(A_two.numpy()))


def test_wrapper_takes_plain_version_for_cpu_tensors():
    _, pi, u = _pair("neohookean", 3)
    before = fj.fused_element_jacobian.launches
    args = _plain_inputs(pi, u)
    A = fj.fused_element_jacobian(pi.f, *args)
    assert torch.equal(A, fj.fused_element_jacobian_plain(pi.f, *args))
    assert fj.fused_element_jacobian.launches == before


def test_forced_kernel_route_raises_on_cpu_and_auto_takes_two_stage():
    _, pi, u = _pair("neohookean", 3)
    ut = vector_from_numpy(u, "cpu", F64)
    assert pi.route_refusal("kernel") is not None
    with pytest.raises(ValueError, match="CUDA"):
        pi.element_jacobians([ut], route="kernel")
    with pytest.raises(ValueError, match="route"):
        pi.element_jacobians([ut], route="fused")
    assert torch.equal(pi.element_jacobians([ut]),
                       pi.element_jacobians([ut], route="two_stage"))


@pytest.mark.parametrize("energy,n,order,dim", [
    ("neohookean", 3, 1, 2), ("neohookean", 2, 2, 2),
    ("elasticity", 2, 1, 3), ("diffusion", 2, 2, 2),
])
def test_supports_fused_matches_jax(energy, n, order, dim):
    ji, pi, _ = _pair(energy, n, order, dim)
    assert pi.supports_fused() == jax_supports_fused(ji)


@pytest.mark.parametrize("energy,refusal", [
    ("neohookean", None), ("elasticity", None),
    ("diffusion", "DiffusionEnergy has no closed Hessian entries"),
])
def test_full_w_route_rules_with_tables_taken_for_cuda(monkeypatch, energy,
                                                       refusal):
    """With the device check stubbed, both closed-entries energies at 2D
    p1 (a full W, no W0) take the full-W instantiation of the GEMM
    kernel; an energy without closed entries is refused by name."""
    _, pi, _ = _pair(energy, 2)
    monkeypatch.setattr(PIntegrator, "_tables_on_cuda", lambda self: True)
    assert "0_0" in pi.tables["W"] and "0_0" not in pi.tables["W0"]
    assert not pi.uses_blocked_kernel()
    why = pi.route_refusal("kernel")
    if refusal is None:
        assert why is None
    else:
        assert refusal in why


class _QuarticDiffusion(pad.ADFunction):
    """0.5 |g|^2 + 0.25 g_0^4 on 2D GRAD input, with closed entries: an
    energy the library does not define."""

    def __init__(self):
        super().__init__(2)

    def energy(self, g, p):
        return 0.5 * (g[0] * g[0] + g[1] * g[1]) + 0.25 * g[0] ** 4

    def hessian_closed_entries(self, g, p):
        return [[1.0 + 3.0 * g[0] * g[0], 0.0], [0.0, 1.0]]


def test_full_w_route_takes_any_energy_whose_entries_trace(monkeypatch):
    """A scalar 2D p1 energy with closed entries (n=2, nde=4) takes the
    full-W instantiation, as the reference's _kernel_tile takes any
    hess_entries; with the device check stubbed its plain version equals
    two-stage."""
    fes = PFESpace(PM.make_cartesian_2d(3, 3), 1)
    pi = PIntegrator(_QuarticDiffusion(), [fes], [PADEval.GRAD],
                     device="cpu", dtype=F64)
    monkeypatch.setattr(PIntegrator, "_tables_on_cuda", lambda self: True)
    assert pi.route_refusal("kernel") is None
    assert not pi.uses_blocked_kernel()
    u = vector_from_numpy(
        0.3 * np.random.default_rng(2).standard_normal(fes.ndof), "cpu", F64)
    A = pi.element_jacobians([u], route="kernel").numpy()
    A_two = pi.element_jacobians([u], route="two_stage").numpy()
    assert A.shape == (9, 4, 4)
    np.testing.assert_allclose(A, A_two, rtol=0, atol=_tol(A_two))


def test_kernel_route_takes_full_w_kernel_with_tables_taken_for_cuda(
        monkeypatch):
    """route="kernel" and auto both reach fused_element_jacobian at 2D p1;
    with the device check stubbed, CPU tensors get its plain version, which
    must equal two-stage."""
    monkeypatch.setattr(PIntegrator, "_tables_on_cuda", lambda self: True)
    taken = []
    real = fj.fused_element_jacobian
    monkeypatch.setattr(fj, "fused_element_jacobian",
                        lambda *a: taken.append(1) or real(*a))
    _, pi, u = _pair("elasticity", 3)
    ut = vector_from_numpy(u, "cpu", F64)
    A_two = pi.element_jacobians([ut], route="two_stage").numpy()
    for route in ("kernel", "auto"):
        A = pi.element_jacobians([ut], route=route).numpy()
        np.testing.assert_allclose(A, A_two, rtol=0, atol=_tol(A_two))
    assert taken == [1, 1]


@pytest.mark.parametrize("energy", ["neohookean", "elasticity"])
def test_full_w_is_the_blocked_gemm_at_vdim_1(energy):
    """The full-W kernel's function is the blocked kernel's at vdim = 1,
    sd = n, nd = nde, B0 = Bf and W0 = W: the blocked plain version on
    those operands equals the full-W plain version (f64, the same GEMM up
    to the summation order)."""
    _, pi, u = _pair(energy, 3)
    ue, R, W, wq, params = _plain_inputs(pi, u)
    n, nde = pi.n_input, ue.shape[1]
    B0 = R.reshape(pi.nq, n, nde).transpose(1, 2)
    A = bj.blocked_element_jacobian_plain(pi.f, ue, B0, W, wq, params, 1, n)
    A_full = fj.fused_element_jacobian_plain(pi.f, ue, R, W, wq, params)
    np.testing.assert_allclose(A.numpy(), A_full.numpy(), rtol=0,
                               atol=1e-13 * float(A_full.abs().max()))


def test_full_w_kernel_source_instantiates_the_blocked_kernel():
    """The full-W library is the blocked kernel's template at vdim = 1,
    sd = n with the traced closed entries; it differs from the blocked
    instantiation of the same energy."""
    f = pad.NeoHookeanEnergy(2, 1.0, 1.0)
    code = bj.entries_code(f, {"lambda": 1, "mu": 1})
    src = bj.kernel_source(code, 1, 4)
    for t in ("float", "double"):
        assert f"bj::launch<{t}, 1, 4, Entries>" in src
    blocked = bj.kernel_source(code, 2, 2)
    assert nvcc.library_path("blocked_jacobian", src, bj.HEADERS) != (
        nvcc.library_path("blocked_jacobian", blocked, bj.HEADERS))
    with pytest.raises(ValueError, match="not among"):
        bj.kernel_source(code, 1, 3)


def test_full_w_operands_are_built_once_per_table():
    """B0 = Bf (R read as [nq, n, nde]) and the weighted tile-major factor
    are built at the first call and reused while the tables stand; a
    change of the weights builds the factor again."""
    _, pi, u = _pair("neohookean", 3)
    ue, R, W, wq, _ = _plain_inputs(pi, u)
    n, nde, nq = pi.n_input, ue.shape[1], pi.nq
    plan = bj.launch_plan(1, n, nde, nq, F64)
    B0, Ww = fj.full_w_operands(R, W, wq, n, plan)
    Bf = pi.tables["B"][0][0]  # [nq, nd, sd], vdim = 2 blocks
    nd, sd = pi.nd[0], pi.sd[0]
    for v in range(2):
        assert torch.equal(B0[:, v * nd:(v + 1) * nd, v * sd:(v + 1) * sd],
                           Bf)
    assert torch.equal(Ww, bj.tiled_factor(W, wq, n, plan))
    again = fj.full_w_operands(R, W, pi.tables["w"][0].contiguous(), n, plan)
    assert again[0] is B0 and again[1] is Ww
    w2 = wq.clone()
    w2[0] *= 2.0
    B0b, Ww2 = fj.full_w_operands(R, W, w2, n, plan)
    assert B0b is B0 and Ww2 is not Ww
    assert torch.equal(Ww2, bj.tiled_factor(W, w2, n, plan))


def test_wrapper_rejects_unsupported_inputs_before_any_launch():
    _, pi, u = _pair("neohookean", 3)
    ue, R, W, w, params = _plain_inputs(pi, u)
    meta = {k: v.to("meta") for k, v in params.items()}
    with pytest.raises(ValueError, match="device"):
        fj.fused_element_jacobian(pi.f, ue.to("meta"), R.to("meta"),
                                  W.to("meta"), w.to("meta"), meta)
