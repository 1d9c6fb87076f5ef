"""mfem_ad_tpu_torch — the PyTorch/CUDA port of mfem_ad_tpu, an automatic-
differentiation finite-element framework.

A user writes a scalar energy density at a quadrature point; the package
gives element energies, residuals and Jacobians by AD (``torch.func``) and
solves with Newton (matrix-free CG, GMRES or MINRES preconditioned by
Jacobi or geometric multigrid, the dense direct solver, or the exact
Schur elimination of a proximal-Galerkin saddle system).  The
element-Jacobian assembly has one hand-written CUDA GEMM kernel for
Hopper (``csrc/blocked_jacobian.cuh``) with three instantiations:
closed-form Hessian entries against the blocked factor W0
(``ops.blocked_jacobian``) or the full W (``ops.fused_jacobian``), and
any energy, code-generated and differentiated by nested dual numbers,
against the full W (``ops.ad_jacobian``).

Layout mirrors the JAX package: ``mesh`` ``fespace`` ``quadrature``
``basis`` ``geometry`` (numpy substrate), ``ad`` (energies), ``adeval``
``integrator`` ``forms`` (assembly), ``solvers``, ``multigrid``, ``pg``
and ``dof_pg`` (the LVPP layer), ``mmto`` (SiMPL topology
optimization), ``models``, ``ops`` (kernels), ``utils`` (logging,
checkpoints, VTU export, GLVis, profiling), ``examples`` (ex0-ex5,
topopt, template), ``bench``
(``python -m mfem_ad_tpu_torch.bench``), ``convert`` (tables from the
JAX package's arrays).

Every constructor that makes tensors takes a ``device`` (default
``"cuda"``: pass ``device="cpu"`` to run on the host) and a ``dtype``
(FE default ``torch.float64``).
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
