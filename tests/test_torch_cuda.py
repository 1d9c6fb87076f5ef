"""The CUDA element-Jacobian kernel's three instantiations (closed entries
against the full W and against the blocked W0, and generic AD against the
full W) against their plain PyTorch versions, on the card.  Skips where there is
no CUDA device.  This file imports neither jax nor the JAX package, so it
also runs on a machine without them:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py

Tolerance: 1e-12 * max|A| in f64 and 1e-5 * max|A| in f32 (the kernel and
cuBLAS sum in different orders; no TF32 anywhere)."""

import dataclasses

import numpy as np
import pytest
import torch

from mfem_ad_tpu_torch import mesh as M
from mfem_ad_tpu_torch.ad import (
    ADFunction,
    DiffusionEnergy,
    LinearElasticityEnergy,
    MassEnergy,
    NeoHookeanEnergy,
)
from mfem_ad_tpu_torch.adeval import ADEval
from mfem_ad_tpu_torch.fespace import FESpace
from mfem_ad_tpu_torch.integrator import ADBlockIntegrator
from mfem_ad_tpu_torch.ops import ad_jacobian as adj
from mfem_ad_tpu_torch.ops import blocked_jacobian as bj
from mfem_ad_tpu_torch.ops import fused_jacobian as fj

pytestmark = pytest.mark.cuda

TOL = {torch.float64: 1e-12, torch.float32: 1e-5}
ENERGIES = {"neohookean": NeoHookeanEnergy,
            "elasticity": LinearElasticityEnergy}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    assert not torch.backends.cuda.matmul.allow_tf32
    return torch.device("cuda")


def _integrator(energy, nx, ny, order, dtype, device):
    fes = FESpace(M.make_cartesian_2d(nx, ny), order, vdim=2)
    intg = ADBlockIntegrator(ENERGIES[energy](2, 1.0, 1.0), [fes],
                             [ADEval.GRAD | ADEval.VECTOR], device=device,
                             dtype=dtype)
    rng = np.random.default_rng(5)
    u = (0.1 / max(nx, ny)) * rng.standard_normal(fes.ndof)  # det F > 0
    return intg, torch.as_tensor(u, dtype=dtype, device=device)


@pytest.mark.parametrize("energy", sorted(ENERGIES))
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("nx,ny", [(3, 3), (61, 37)])
def test_kernel_matches_plain_on_card(cuda, energy, dtype, nx, ny):
    intg, u = _integrator(energy, nx, ny, 1, dtype, cuda)
    before = fj.fused_element_jacobian.launches
    A = intg.element_jacobians([u], route="kernel")
    args = intg.kernel_inputs([u])
    A_plain = fj.fused_element_jacobian_plain(intg.f, *args)
    torch.cuda.synchronize()
    assert fj.fused_element_jacobian.launches == before + 1
    assert A.shape == (nx * ny, 8, 8) and torch.isfinite(A).all()
    scale = float(A_plain.abs().max())
    assert float((A - A_plain).abs().max()) <= TOL[dtype] * scale


class _QuarticDiffusion(ADFunction):
    """0.5 |g|^2 + 0.25 g_0^4 with closed entries: not a library energy."""

    def __init__(self):
        super().__init__(2)

    def energy(self, g, p):
        return 0.5 * (g[0] * g[0] + g[1] * g[1]) + 0.25 * g[0] ** 4

    def hessian_closed_entries(self, g, p):
        return [[1.0 + 3.0 * g[0] * g[0], 0.0], [0.0, 1.0]]


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_full_w_kernel_takes_any_energy_whose_entries_trace(cuda, dtype):
    """A scalar 2D p1 energy with closed entries (n=2, nde=4, 61x37: a
    ragged tile) launches the full-W instantiation and matches its plain
    version."""
    fes = FESpace(M.make_cartesian_2d(61, 37), 1)
    intg = ADBlockIntegrator(_QuarticDiffusion(), [fes], [ADEval.GRAD],
                             device=cuda, dtype=dtype)
    rng = np.random.default_rng(8)
    u = torch.as_tensor(0.3 * rng.standard_normal(fes.ndof), dtype=dtype,
                        device=cuda)
    before = fj.fused_element_jacobian.launches
    A = intg.element_jacobians([u])
    A_plain = fj.fused_element_jacobian_plain(intg.f,
                                              *intg.kernel_inputs([u]))
    torch.cuda.synchronize()
    assert fj.fused_element_jacobian.launches == before + 1
    assert A.shape == (61 * 37, 4, 4) and torch.isfinite(A).all()
    scale = float(A_plain.abs().max())
    assert float((A - A_plain).abs().max()) <= TOL[dtype] * scale


def test_auto_route_takes_the_kernel_on_card(cuda):
    intg, u = _integrator("neohookean", 8, 8, 1, torch.float32, cuda)
    assert intg.route_refusal("kernel") is None
    before = fj.fused_element_jacobian.launches
    A = intg.element_jacobians([u])
    A_two = intg.element_jacobians([u], route="two_stage")
    torch.cuda.synchronize()
    assert fj.fused_element_jacobian.launches == before + 1
    scale = float(A_two.abs().max())
    assert float((A - A_two).abs().max()) <= 1e-5 * scale


def test_blocked_w0_configs_take_the_blocked_kernel(cuda):
    intg, u = _integrator("neohookean", 4, 4, 2, torch.float64, cuda)
    assert intg.route_refusal("kernel") is None
    assert intg.uses_blocked_kernel()
    before = (fj.fused_element_jacobian.launches,
              bj.blocked_element_jacobian.launches)
    A = intg.element_jacobians([u])
    A_kernel = intg.element_jacobians([u], route="kernel")
    assert A.shape == (16, 18, 18) and torch.equal(A, A_kernel)
    assert (fj.fused_element_jacobian.launches,
            bj.blocked_element_jacobian.launches) == (before[0],
                                                      before[1] + 2)


def test_wrapper_rejects_bad_operands_on_card(cuda):
    intg, u = _integrator("neohookean", 3, 3, 1, torch.float32, cuda)
    ue, R, W, w, params = intg.kernel_inputs([u])
    with pytest.raises(ValueError, match="shape"):
        fj.fused_element_jacobian(intg.f, ue[:, :6].contiguous(), R, W, w,
                                  params)
    with pytest.raises(ValueError, match="contiguous"):
        fj.fused_element_jacobian(intg.f, ue.T.contiguous().T, R, W, w,
                                  params)
    with pytest.raises(ValueError, match="float32"):
        fj.fused_element_jacobian(intg.f, ue.double(), R, W, w, params)


# ---------------------------------------------------------------------------
# The generic AD kernel
# ---------------------------------------------------------------------------


class _MinimalSurface(ADFunction):
    def __init__(self):
        super().__init__(2)

    def energy(self, g, p):
        gg = g[0] * g[0] + g[1] * g[1]
        return torch.sqrt(gg + 1.0) + 0.05 * gg


AD_CASES = {  # name -> (energy, order, mode, vdim, dim)
    "diffusion_p1": (lambda: DiffusionEnergy(2), 1, ADEval.GRAD, 1, 2),
    "diffusion_p2": (lambda: DiffusionEnergy(2), 2, ADEval.GRAD, 1, 2),
    "mass_p1": (lambda: MassEnergy(1), 1, ADEval.VALUE, 1, 2),
    "neohookean_p1": (lambda: NeoHookeanEnergy(2, 1.0, 1.0), 1,
                      ADEval.GRAD | ADEval.VECTOR, 2, 2),
    "minimal_surface_p2": (_MinimalSurface, 2, ADEval.GRAD, 1, 2),
    # sizes with nde > 9, served since the AD entries stage joined the GEMM
    # kernel: 2D p2 vector (n=4, nde=18), 3D Q1 and Q2 scalar (3, 8) and
    # (3, 27), 3D p1 vector (9, 24)
    "neohookean_p2": (lambda: NeoHookeanEnergy(2, 1.0, 1.0), 2,
                      ADEval.GRAD | ADEval.VECTOR, 2, 2),
    "diffusion3d_p1": (lambda: DiffusionEnergy(3), 1, ADEval.GRAD, 1, 3),
    "diffusion3d_p2": (lambda: DiffusionEnergy(3), 2, ADEval.GRAD, 1, 3),
    "elasticity3d_p1": (lambda: LinearElasticityEnergy(3, 1.0, 1.0), 1,
                        ADEval.GRAD | ADEval.VECTOR, 3, 3),
}


def _ad_integrator(case, nx, ny, dtype, device):
    """The case on an nx x ny mesh (nx x ny x 2 in 3D): 3x3 and 61x37 give
    element counts that are multiples of no launch plan's element tile."""
    make, order, mode, vdim, dim = AD_CASES[case]
    m = (M.make_cartesian_2d(nx, ny) if dim == 2
         else M.make_cartesian_3d(nx, ny, 2))
    fes = FESpace(m, order, vdim=vdim)
    intg = ADBlockIntegrator(make(), [fes], [mode], device=device,
                             dtype=dtype)
    rng = np.random.default_rng(6)
    # 0.01/n at p2 vector: at 0.1/n neo-Hookean has det F <= 0 there
    amp = 0.01 if order > 1 and vdim > 1 else 0.1
    u = (amp / max(nx, ny)) * rng.standard_normal(fes.ndof)
    return intg, torch.as_tensor(u, dtype=dtype, device=device)


@pytest.mark.parametrize("case", sorted(AD_CASES))
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("nx,ny", [(3, 3), (61, 37)])
def test_ad_kernel_matches_plain_on_card(cuda, case, dtype, nx, ny):
    intg, u = _ad_integrator(case, nx, ny, dtype, cuda)
    assert intg.route_refusal("kernel_ad") is None
    before = adj.ad_element_jacobian.launches
    A = intg.element_jacobians([u], route="kernel_ad")
    A_plain = adj.ad_element_jacobian_plain(
        intg.f, *intg.kernel_inputs([u]))
    torch.cuda.synchronize()
    assert adj.ad_element_jacobian.launches == before + 1
    nde = intg.vdim[0] * intg.nd[0]
    ne = intg.tables["edof"][0].shape[0]
    assert A.shape == (ne, nde, nde) and torch.isfinite(A).all()
    scale = float(A_plain.abs().max())
    assert float((A - A_plain).abs().max()) <= TOL[dtype] * scale


def test_ad_kernel_matches_closed_entries_kernel(cuda):
    intg, u = _ad_integrator("neohookean_p1", 40, 40, torch.float32, cuda)
    A = intg.element_jacobians([u], route="kernel_ad")
    A_closed = intg.element_jacobians([u], route="kernel")
    scale = float(A_closed.abs().max())
    assert float((A - A_closed).abs().max()) <= 1e-5 * scale


def test_auto_route_takes_the_ad_kernel_for_poisson(cuda):
    intg, u = _ad_integrator("diffusion_p2", 8, 8, torch.float32, cuda)
    assert intg.route_refusal("kernel") is not None
    before = adj.ad_element_jacobian.launches
    A = intg.element_jacobians([u])
    A_two = intg.element_jacobians([u], route="two_stage")
    torch.cuda.synchronize()
    assert adj.ad_element_jacobian.launches == before + 1
    assert float((A - A_two).abs().max()) <= 1e-5 * float(A_two.abs().max())


def test_ad_refusals_on_card(cuda):
    """A W0-only configuration and an energy that does not trace are
    refused by name; route="kernel_ad" raises and auto takes two-stage."""
    fes = FESpace(M.make_cartesian_3d(1, 1, 1), 2, vdim=3)
    w0 = ADBlockIntegrator(NeoHookeanEnergy(3, 1.0, 1.0), [fes],
                           [ADEval.GRAD | ADEval.VECTOR], device=cuda)
    assert "W0" in w0.route_refusal("kernel_ad")
    dot = ADFunction(2, lambda x, p: torch.dot(x, x))
    fes2 = FESpace(M.make_cartesian_2d(3, 3), 1)
    intg = ADBlockIntegrator(dot, [fes2], [ADEval.GRAD], device=cuda)
    assert "torch.dot" in intg.route_refusal("kernel_ad")
    u = torch.zeros(fes2.ndof, dtype=torch.float64, device=cuda)
    before = adj.ad_element_jacobian.launches
    with pytest.raises(ValueError, match="torch.dot"):
        intg.element_jacobians([u], route="kernel_ad")
    assert intg.element_jacobians([u]).shape == (9, 4, 4)
    assert adj.ad_element_jacobian.launches == before


def test_ad_wrapper_rejects_bad_operands_on_card(cuda):
    intg, u = _ad_integrator("neohookean_p1", 3, 3, torch.float32, cuda)
    ue, R, W, w, params = intg.kernel_inputs([u])
    f = intg.f
    before = adj.ad_element_jacobian.launches
    with pytest.raises(ValueError, match="shape"):
        adj.ad_element_jacobian(f, ue[:, :6].contiguous(), R, W, w, params)
    with pytest.raises(ValueError, match="shape"):
        adj.ad_element_jacobian(f, ue, R[:-1].contiguous(), W, w, params)
    with pytest.raises(ValueError, match="contiguous"):
        adj.ad_element_jacobian(f, ue.T.contiguous().T, R, W, w, params)
    with pytest.raises(ValueError, match="float32"):
        adj.ad_element_jacobian(f, ue, R.double(), W, w, params)
    with pytest.raises(ValueError, match="lambda"):
        adj.ad_element_jacobian(f, ue, R, W, w, {"mu": params["mu"]})
    with pytest.raises(ValueError, match="dtype"):
        adj.ad_element_jacobian(f, ue.half(), R, W, w, params)
    assert adj.ad_element_jacobian.launches == before


# ---------------------------------------------------------------------------
# The blocked-W0 kernel
# ---------------------------------------------------------------------------


def _vector_integrator(energy, dim, order, dims, dtype, device):
    m = (M.make_cartesian_2d(*dims) if dim == 2
         else M.make_cartesian_3d(*dims))
    fes = FESpace(m, order, vdim=dim)
    intg = ADBlockIntegrator(ENERGIES[energy](dim, 1.0, 1.0), [fes],
                             [ADEval.GRAD | ADEval.VECTOR], device=device,
                             dtype=dtype)
    rng = np.random.default_rng(7)
    # 0.01/n: det F stays above 0.6 at p2 and p3 (0.1/n does not)
    u = (0.01 / max(dims)) * rng.standard_normal(fes.ndof)
    return intg, torch.as_tensor(u, dtype=dtype, device=device)


@pytest.mark.parametrize("energy", sorted(ENERGIES))
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("dim,order,dims", [
    (2, 2, (3, 3)), (2, 2, (61, 37)), (3, 1, (5, 4, 3)), (3, 2, (3, 2, 2)),
])
def test_blocked_kernel_matches_plain_on_card(cuda, energy, dtype, dim,
                                              order, dims):
    intg, u = _vector_integrator(energy, dim, order, dims, dtype, cuda)
    assert intg.uses_blocked_kernel()
    before = bj.blocked_element_jacobian.launches
    A = intg.element_jacobians([u], route="kernel")
    A_plain = bj.blocked_element_jacobian_plain(
        intg.f, *intg.blocked_inputs([u]), dim, dim)
    torch.cuda.synchronize()
    assert bj.blocked_element_jacobian.launches == before + 1
    nde = dim * intg.nd[0]
    assert A.shape == (int(np.prod(dims)), nde, nde)
    assert torch.isfinite(A).all()
    scale = float(A_plain.abs().max())
    assert float((A - A_plain).abs().max()) <= TOL[dtype] * scale


def test_blocked_wrapper_rejects_bad_operands_on_card(cuda):
    intg, u = _vector_integrator("neohookean", 3, 1, (2, 2, 2),
                                 torch.float32, cuda)
    ue, B0, W0, w, params = intg.blocked_inputs([u])
    f = intg.f
    before = bj.blocked_element_jacobian.launches
    with pytest.raises(ValueError, match="shape"):
        bj.blocked_element_jacobian(f, ue[:, :12].contiguous(), B0, W0, w,
                                    params, 3, 3)
    with pytest.raises(ValueError, match="contiguous"):
        bj.blocked_element_jacobian(f, ue.T.contiguous().T, B0, W0, w,
                                    params, 3, 3)
    with pytest.raises(ValueError, match="float32"):
        bj.blocked_element_jacobian(f, ue, B0.double(), W0, w, params, 3, 3)
    with pytest.raises(ValueError, match="compiled shapes"):
        bj.blocked_element_jacobian(f, ue, B0, W0, w, params, 2, 3)
    with pytest.raises(ValueError, match="lambda"):
        bj.blocked_element_jacobian(f, ue, B0, W0, w, {"mu": params["mu"]},
                                    3, 3)
    with pytest.raises(ValueError, match="dtype"):
        bj.blocked_element_jacobian(f, ue.half(), B0, W0, w, params, 3, 3)
    assert bj.blocked_element_jacobian.launches == before


def test_blocked_kernel_refuses_a_plan_it_cannot_run(cuda):
    """The kernel checks the launch plan it is given and returns
    cudaErrorInvalidValue (1) without launching; the wrapper's own plan
    runs."""
    intg, u = _vector_integrator("neohookean", 3, 1, (2, 2, 2),
                                 torch.float32, cuda)
    ue, B0, W0, w, params = intg.blocked_inputs([u])
    nd, nq, ne = intg.nd[0], intg.nq, ue.shape[0]
    plan = bj.launch_plan(3, 3, nd, nq, torch.float32)
    code = bj.entries_code(intg.f, bj.param_sizes(params))
    lib = bj._library(code, 3, 3)
    Ww = torch.zeros((nq * 9, plan.padded_cols(nd)), device=cuda)
    prm = torch.cat([params["lambda"], params["mu"]], dim=1).contiguous()
    A = torch.zeros((ne, 3 * nd, 3 * nd), device=cuda)
    stream = torch.cuda.current_stream().cuda_stream

    def launch(**changes):
        p = dataclasses.replace(plan, **changes)
        return lib.bj_launch_f32(
            ue.data_ptr(), B0.data_ptr(), Ww.data_ptr(), prm.data_ptr(),
            A.data_ptr(), ne, nq, nd, p.elem_tile, p.col_tile, p.threads,
            p.stages, p.quad_stage, p.quad_chunk, p.smem_bytes, stream)

    for bad in (dict(threads=plan.threads + 32), dict(stages=5),
                dict(quad_stage=plan.quad_stage + 1),
                dict(smem_bytes=plan.smem_bytes - 4),
                dict(elem_tile=plan.row_tile)):
        assert launch(**bad) == 1, bad
    assert launch() == 0
    torch.cuda.synchronize()
