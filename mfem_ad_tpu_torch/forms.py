"""Nonlinear/linear forms: global operators with essential-BC handling.

PyTorch counterpart of ``mfem_ad_tpu.forms``.  A form owns integrators
and an essential-dof mask and exposes functions of the (concatenated,
true-dof) state vector:

- ``mult(u)``            residual, zeroed at essential dofs
- ``energy(u)``          total energy
- ``grad_state(u)``      per-integrator per-qp Hessians (Newton state)
- ``grad_mult(state, v)`` matrix-free Jacobian action, with eliminated
                         rows/columns and identity on essential dofs
- ``grad_diag(state)``   Jacobian diagonal (Jacobi preconditioning)

Block systems use MFEM-style true-dof offsets: ``u = cat(u_block0, ...)``.
"""

from __future__ import annotations

import numpy as np
import torch

from .coefficients import FunctionCoefficient, QPContext, as_coefficient
from .fespace import FESpace
from .geometry import geom_factors
from .integrator import ADBlockIntegrator
from .quadrature import get_rule


class BlockNonlinearForm:
    def __init__(self, spaces, *, device, dtype: torch.dtype = torch.float64):
        if isinstance(spaces, FESpace):
            spaces = [spaces]
        self.spaces = list(spaces)
        self.device = torch.device(device)
        self.dtype = dtype
        sizes = [s.ndof for s in self.spaces]
        self.offsets = np.concatenate([[0], np.cumsum(sizes)]).astype(np.int64)
        self.ndof = int(self.offsets[-1])
        self.integrators: list[ADBlockIntegrator] = []
        self.ess_mask = torch.zeros(self.ndof, dtype=torch.bool,
                                    device=self.device)

    def add_domain_integrator(self, intg: ADBlockIntegrator):
        if len(intg.spaces) != len(self.spaces):
            raise ValueError("integrator/space count mismatch")
        self.integrators.append(intg)
        return intg

    def set_essential_bc(self, attr_masks):
        """Per-space boundary-attribute masks (None entries = no BC): all
        vdim components of the marked boundaries are constrained."""
        mask = np.zeros(self.ndof, dtype=bool)
        for s, am in enumerate(attr_masks):
            if am is None:
                continue
            mask[self.offsets[s]:self.offsets[s + 1]] = (
                self.spaces[s].essential_mask(am)
            )
        self.ess_mask = torch.as_tensor(mask, device=self.device)

    def split(self, u):
        return [
            u[self.offsets[s]:self.offsets[s + 1]]
            for s in range(len(self.spaces))
        ]

    # ------------------------------------------------------------------
    def energy(self, u):
        return sum(intg.energy(self.split(u)) for intg in self.integrators)

    def mult(self, u):
        """Residual with essential rows zeroed (NonlinearForm::Mult)."""
        blocks = self.split(u)
        acc = torch.zeros(self.ndof, dtype=u.dtype, device=u.device)
        for intg in self.integrators:
            acc = acc + torch.cat(intg.residual(blocks))
        return torch.where(self.ess_mask, 0.0, acc)

    def grad_state(self, u):
        """Newton states, packed symmetric-compact (``SymHess``): written
        once per direction, read by every Krylov matvec."""
        return [
            intg.hess_state(self.split(u), sym=True)
            for intg in self.integrators
        ]

    def grad_mult(self, state, v):
        """J v with eliminated rows/cols and identity at essential dofs."""
        blocks = self.split(torch.where(self.ess_mask, 0.0, v))
        acc = torch.zeros(self.ndof, dtype=v.dtype, device=v.device)
        for intg, Hq in zip(self.integrators, state):
            acc = acc + torch.cat(intg.hess_mult(Hq, blocks))
        return torch.where(self.ess_mask, v, acc)

    def grad_diag(self, state):
        acc = torch.zeros(self.ndof, dtype=self.dtype, device=self.device)
        for intg, Hq in zip(self.integrators, state):
            acc = acc + torch.cat(intg.diagonal(Hq))
        return torch.where(self.ess_mask, 1.0, acc)


class NonlinearForm(BlockNonlinearForm):
    """Single-space convenience wrapper (MFEM NonlinearForm)."""

    def __init__(self, space: FESpace, *, device,
                 dtype: torch.dtype = torch.float64):
        super().__init__([space], device=device, dtype=dtype)

    @property
    def space(self) -> FESpace:
        return self.spaces[0]

    def add_ad_integrator(self, f, mode, ir_order=None):
        """Add an ``ADBlockIntegrator`` on this form's device and dtype."""
        return self.add_domain_integrator(
            ADBlockIntegrator(f, [self.space], [mode], ir_order=ir_order,
                              device=self.device, dtype=self.dtype)
        )


class LinearForm:
    """Load vector b_d = ∫ f φ_d (DomainLFIntegrator), assembled on the
    host as a numpy array.

    For vdim>1 spaces, ``coeff`` must produce vdim values per point
    (VectorDomainLFIntegrator).
    """

    def __init__(self, space: FESpace, coeff, ir_order: int | None = None):
        self.space = space
        if callable(coeff) and not hasattr(coeff, "eval_qp"):
            coeff = FunctionCoefficient(coeff, size=space.vdim)
        self.coeff = as_coefficient(coeff)
        self.ir_order = ir_order

    def assemble(self) -> np.ndarray:
        sp = self.space
        order = self.ir_order
        if order is None:
            order = 2 * sp.order + 2
        ir = get_rule(sp.mesh.geom, order)
        phi = sp.elem.eval(ir.points)  # [nq, nd]
        gf = geom_factors(sp.mesh, ir)
        vals = np.asarray(
            self.coeff.eval_qp(QPContext(gf.xq, ir=ir, mesh=sp.mesh))
        )  # [ne, nq, k]
        if vals.shape[-1] != sp.vdim:
            raise ValueError(
                f"load coefficient size {vals.shape[-1]} != vdim {sp.vdim}"
            )
        be = np.einsum("qd,eqv,eq->edv", phi, vals, gf.w, optimize=True)
        idx = np.asarray(sp.edof)[:, :, None] + (
            np.arange(sp.vdim, dtype=np.int32) * np.int32(sp.ndof_scalar)
        )
        return np.bincount(
            idx.ravel(), weights=be.ravel(), minlength=sp.ndof
        )
