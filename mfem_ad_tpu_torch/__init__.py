"""mfem_ad_tpu_torch — the PyTorch/CUDA port of mfem_ad_tpu, an automatic-
differentiation finite-element framework.

A user writes a scalar energy density at a quadrature point; the package
gives element energies, residuals and Jacobians by AD (``torch.func``) and
solves with matrix-free Newton–CG.  The element-Jacobian assembly has a
hand-written CUDA kernel for Hopper (``ops.fused_jacobian``).

Layout mirrors the JAX package: ``mesh`` ``fespace`` ``quadrature``
``basis`` ``geometry`` (numpy substrate), ``ad`` (energies), ``adeval``
``integrator`` ``forms`` (assembly), ``solvers``, ``models``, ``ops``
(kernels), ``convert`` (tables from the JAX package's arrays).

Every constructor that makes tensors takes an explicit ``device`` and
``dtype`` (FE default ``torch.float64``).
"""

from . import quadrature, basis, mesh, geometry, fespace  # noqa: F401
from .ad import (  # noqa: F401
    ADFunction,
    DiffusionEnergy,
    LinearElasticityEnergy,
    MassEnergy,
    NeoHookeanEnergy,
    admax,
    admin,
)
from .adeval import ADEval  # noqa: F401
from .forms import BlockNonlinearForm, LinearForm, NonlinearForm  # noqa: F401
from .integrator import ADBlockIntegrator  # noqa: F401

__version__ = "0.1.0"
