"""Nonlinear/linear forms: global operators with essential-BC handling.

PyTorch counterpart of ``mfem_ad_tpu.forms``.  A form owns integrators
and an essential-dof mask and exposes functions of the (concatenated,
true-dof) state vector:

- ``mult(u, fields)``       residual, zeroed at essential dofs
- ``energy(u, fields)``     total energy
- ``grad_state(u, fields)`` per-integrator per-qp Hessians (Newton state)
- ``grad_mult(state, v)``   matrix-free Jacobian action, with eliminated
                            rows/columns and identity on essential dofs
- ``grad_diag(state)``      Jacobian diagonal (Jacobi preconditioning)
- ``assemble_dense(state)`` dense global Jacobian with the same
                            elimination (small problems, the direct solver)

``fields`` maps the names of the integrators' runtime field parameters
(``GridFunctionCoefficient``, ``ScalarFieldCoefficient``) to their values.

Block systems use MFEM-style true-dof offsets: ``u = cat(u_block0, ...)``.
"""

from __future__ import annotations

import numpy as np
import torch

from .basis import ref_element
from .coefficients import (
    ConstantCoefficient,
    FunctionCoefficient,
    QPContext,
    as_coefficient,
)
from .fespace import FESpace
from .geometry import geom_factors
from .integrator import ADBlockIntegrator
from .quadrature import get_rule


class BlockNonlinearForm:
    def __init__(self, spaces, *, device="cuda",
                 dtype: torch.dtype = torch.float64):
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

    def set_essential_dofs(self, dofs_or_mask, space: int = 0):
        """Mark essential dofs: a boolean mask over all dofs replaces the
        current one; dof indices of block ``space`` are added to it."""
        arr = np.asarray(dofs_or_mask)
        mask = self.ess_mask.cpu().numpy().copy()
        if arr.dtype == bool and arr.size == self.ndof:
            mask = arr.copy()
        else:
            mask[self.offsets[space] + arr.astype(np.int64)] = True
        self.ess_mask = torch.as_tensor(mask, device=self.device)

    def split(self, u):
        return [
            u[self.offsets[s]:self.offsets[s + 1]]
            for s in range(len(self.spaces))
        ]

    # ------------------------------------------------------------------
    def energy(self, u, fields=None):
        return sum(intg.energy(self.split(u), fields)
                   for intg in self.integrators)

    def mult(self, u, fields=None):
        """Residual with essential rows zeroed (NonlinearForm::Mult)."""
        blocks = self.split(u)
        acc = torch.zeros(self.ndof, dtype=u.dtype, device=u.device)
        for intg in self.integrators:
            acc = acc + torch.cat(intg.residual(blocks, fields))
        return torch.where(self.ess_mask, 0.0, acc)

    def grad_state(self, u, fields=None):
        """Newton states, packed symmetric-compact (``SymHess``; the full
        nonsymmetric dF/dx for a vector integrand): written once per
        direction, read by every Krylov matvec."""
        return [
            intg.hess_state(self.split(u), fields, sym=True)
            for intg in self.integrators
        ]

    def grad_mult(self, state, v):
        """J v with eliminated rows/cols and identity at essential dofs.
        A form of one ``ADBlockIntegrator`` leaves it to the integrator's
        ``grad_mult`` (one hand-written kernel where its grid route
        serves)."""
        intg = self.integrators[0] if len(self.integrators) == 1 else None
        if isinstance(intg, ADBlockIntegrator):
            return intg.grad_mult(state[0], v, self.ess_mask)
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

    def assemble_dense(self, state):
        """Dense global Jacobian [ndof, ndof] on the form's device, with
        essential rows and columns eliminated and 1 on their diagonal."""
        A = torch.zeros((self.ndof, self.ndof), dtype=self.dtype,
                        device=self.device)
        nb = len(self.spaces)
        off = self.offsets
        for intg, Hq in zip(self.integrators, state):
            for s in range(nb):
                for t in range(nb):
                    A[off[s]:off[s + 1], off[t]:off[t + 1]] += (
                        intg.assemble_dense_block(Hq, s, t))
        ess = self.ess_mask
        A[ess, :] = 0.0
        A[:, ess] = 0.0
        A[ess, ess] = 1.0
        return A


class NonlinearForm(BlockNonlinearForm):
    """Single-space convenience wrapper (MFEM NonlinearForm)."""

    def __init__(self, space: FESpace, *, device="cuda",
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
    host as a numpy array.  Constant and function coefficients on a
    uniform-Jacobian mesh of more than 2^16 elements take the chunked
    path (``_assemble_uniform_chunked``).

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
        mesh = sp.mesh
        # The chunked path hands the coefficient a chunk-local QPContext,
        # which is only right for coefficients that evaluate pointwise
        # from ctx.xq; element-indexed kinds (QuadratureCoefficient,
        # field-backed adapters) must see the whole mesh's context.
        pointwise = isinstance(
            self.coeff, (ConstantCoefficient, FunctionCoefficient))
        if (pointwise and mesh.uniform_jacobian
                and mesh.num_elements > (1 << 16)):
            be = self._assemble_uniform_chunked(ir, phi)
        else:
            gf = geom_factors(mesh, ir)
            vals = np.asarray(
                self.coeff.eval_qp(QPContext(gf.xq, ir=ir, mesh=mesh))
            )  # [ne, nq, k]
            if vals.shape[-1] != sp.vdim:
                raise ValueError(
                    f"load coefficient size {vals.shape[-1]} != "
                    f"vdim {sp.vdim}")
            be = np.einsum("qd,eqv,eq->edv", phi, vals, gf.w, optimize=True)
        idx = np.asarray(sp.edof)[:, :, None] + (
            np.arange(sp.vdim, dtype=np.int32) * np.int32(sp.ndof_scalar)
        )
        return np.bincount(
            idx.ravel(), weights=be.ravel(), minlength=sp.ndof
        )

    def _assemble_uniform_chunked(self, ir, phi) -> np.ndarray:
        """Element load vectors [ne, nd, vdim] of a uniform-Jacobian mesh,
        2^16 elements at a time: the qp coordinates are origin[e] + (J
        xi)[q], built per chunk into one reused buffer instead of one
        [ne, nq, dim] array, so the working set stays the chunk's."""
        sp = self.space
        mesh = sp.mesh
        ne, nq = mesh.num_elements, len(ir.weights)
        dim, nd, vdim = mesh.dim, phi.shape[1], sp.vdim
        dN = ref_element(mesh.geom, 1).grad(ir.points)  # [nq, nc, dim]
        c0 = mesh.vertices[mesh.elements[0].astype(np.int64)]  # [nc, dim]
        J = np.einsum("cm,ck->km", dN[0], c0)  # the constant affine Jacobian
        det = float(np.linalg.det(J))
        if det <= 0:
            raise ValueError("non-positive element Jacobian")
        off = ir.points @ J.T  # [nq, dim] qp offsets within any element
        phiw = phi * (det * ir.weights)[:, None]  # [nq, nd]
        origins = mesh.vertices[mesh.elements[:, 0].astype(np.int64)]

        CH = 1 << 16
        be = np.empty((ne, nd, vdim))
        xbuf = np.empty((CH, nq, dim))
        for s in range(0, ne, CH):
            e = min(s + CH, ne)
            xb = xbuf[: e - s]
            np.add(origins[s:e, None, :], off[None, :, :], out=xb)
            vals = np.asarray(
                self.coeff.eval_qp(QPContext(xb, ir=ir, mesh=mesh)))
            if vals.shape[-1] != vdim:
                raise ValueError(
                    f"load coefficient size {vals.shape[-1]} != "
                    f"vdim {vdim}")
            np.einsum("qd,bqv->bdv", phiw, vals, optimize=True, out=be[s:e])
        return be
