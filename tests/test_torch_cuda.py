"""The CUDA element-Jacobian kernel against its plain PyTorch version, on
the card.  Skips where there is no CUDA device.  This file imports neither
jax nor the JAX package, so it also runs on a machine without them:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py

Tolerance: 1e-12 * max|A| in f64 and 1e-5 * max|A| in f32 (the kernel and
cuBLAS sum in different orders; no TF32 anywhere)."""

import numpy as np
import pytest
import torch

from mfem_ad_tpu_torch import mesh as M
from mfem_ad_tpu_torch.ad import LinearElasticityEnergy, NeoHookeanEnergy
from mfem_ad_tpu_torch.adeval import ADEval
from mfem_ad_tpu_torch.fespace import FESpace
from mfem_ad_tpu_torch.integrator import ADBlockIntegrator
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
    args = fj.kernel_inputs(intg, [u])
    A_plain = fj.fused_element_jacobian_plain(intg.f, *args)
    torch.cuda.synchronize()
    assert fj.fused_element_jacobian.launches == before + 1
    assert A.shape == (nx * ny, 8, 8) and torch.isfinite(A).all()
    scale = float(A_plain.abs().max())
    assert float((A - A_plain).abs().max()) <= TOL[dtype] * scale


def test_auto_route_takes_the_kernel_on_card(cuda):
    intg, u = _integrator("neohookean", 8, 8, 1, torch.float32, cuda)
    assert fj.kernel_route_refusal(intg) is None
    before = fj.fused_element_jacobian.launches
    A = intg.element_jacobians([u])
    A_two = intg.element_jacobians([u], route="two_stage")
    torch.cuda.synchronize()
    assert fj.fused_element_jacobian.launches == before + 1
    scale = float(A_two.abs().max())
    assert float((A - A_two).abs().max()) <= 1e-5 * scale


def test_blocked_w0_configs_stay_on_two_stage(cuda):
    intg, u = _integrator("neohookean", 4, 4, 2, torch.float64, cuda)
    assert "W0" in fj.kernel_route_refusal(intg)
    with pytest.raises(ValueError, match="W0"):
        intg.element_jacobians([u], route="kernel")
    assert intg.element_jacobians([u]).shape == (16, 18, 18)


def test_wrapper_rejects_bad_operands_on_card(cuda):
    intg, u = _integrator("neohookean", 3, 3, 1, torch.float32, cuda)
    ue, R, W, w, params = fj.kernel_inputs(intg, [u])
    with pytest.raises(ValueError, match="shape"):
        fj.fused_element_jacobian(intg.f, ue[:, :6].contiguous(), R, W, w,
                                  params)
    with pytest.raises(ValueError, match="contiguous"):
        fj.fused_element_jacobian(intg.f, ue.T.contiguous().T, R, W, w,
                                  params)
    with pytest.raises(ValueError, match="float32"):
        fj.fused_element_jacobian(intg.f, ue.double(), R, W, w, params)
