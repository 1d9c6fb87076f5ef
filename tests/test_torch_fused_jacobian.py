"""Port parity, fused element-Jacobian op: the plain PyTorch version of the
CUDA kernel (``mfem_ad_tpu_torch.ops.fused_jacobian``) against the JAX
package's Pallas kernel ``_kernel_tile`` run in interpret mode (as
tests/test_ops.py runs it) and against JAX's two-stage route, plus the
routing rules on a host without a GPU.

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
from mfem_ad_tpu_torch.ops import fused_jacobian as fj

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
    return fj.kernel_inputs(pi, [vector_from_numpy(u, "cpu", F64)])


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
    assert fj.kernel_route_refusal(pi) is not None
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
    assert fj.supports_fused(pi) == jax_supports_fused(ji)


def test_cuda_energy_entries_cover_the_2d_energies_only():
    assert fj.cuda_energy_id(pad.NeoHookeanEnergy(2, 1.0, 1.0)) == 0
    assert fj.cuda_energy_id(pad.LinearElasticityEnergy(2, 1.0, 1.0)) == 1
    assert fj.cuda_energy_id(pad.NeoHookeanEnergy(3, 1.0, 1.0)) is None
    assert fj.cuda_energy_id(pad.DiffusionEnergy(2)) is None


def test_wrapper_rejects_unsupported_inputs_before_any_launch():
    _, pi, u = _pair("neohookean", 3)
    ue, R, W, w, params = _plain_inputs(pi, u)
    meta = {k: v.to("meta") for k, v in params.items()}
    with pytest.raises(ValueError, match="device"):
        fj.fused_element_jacobian(pi.f, ue.to("meta"), R.to("meta"),
                                  W.to("meta"), w.to("meta"), meta)
