"""Plain reference of the neo-Hookean configurations: compressible
neo-Hookean hyperelasticity on vector fields (vdim = dim) of order p over
an n^dim grid of the unit square or cube, nq Gauss points per axis.

    W(F) = mu/2 (|F|^2 - dim) - mu log det F + lambda/2 (log det F)^2,
    F = I + grad u.

The stress dW/dF and the tangent d^2W/dF^2 come from plain torch.func
derivatives of ``energy``.  ``element_jacobians`` gives the Hessian of each
cell's energy with respect to its dofs (component-major: v D + node),
through one contraction of the per-point tangent with W = G (x) G;
``residual`` gives the internal force minus the load with the clamped rows
(the face x = 0) zeroed.  Both run in blocks of cells so that they fit
beside the program's peak.
"""

from __future__ import annotations

import importlib.util
import os

import numpy as np
import torch

_spec = importlib.util.spec_from_file_location(
    "fembench_reference_fem", os.path.join(os.path.dirname(__file__), "_fem.py"))
_fem = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(_fem)

BLOCK_ENTRIES = 1 << 24  # matrix entries per block of cells


class Grid:
    """The vector space of a configuration (``n``, ``order``, ``dim``,
    ``quadrature_points_per_axis``): each cell's global dofs, G (the map
    from a cell's dofs to F - I at each point, row-major), the weights."""

    def __init__(self, cfg: dict, device):
        n, p, dim = cfg["n"], cfg.get("order", 1), cfg.get("dim", 2)
        self.n, self.dim, self.device = n, dim, device
        self.ncell = n ** dim
        self.ndof_scalar = (p * n + 1) ** dim
        _, grad, w = _fem.tensor_basis(p, cfg["quadrature_points_per_axis"],
                                       1.0 / n, dim)
        cells = _fem.h1_cell_dofs(n, p, dim)
        nd = cells.shape[1]
        self.nde = dim * nd
        self.dofs = _fem.to_tensor(
            np.concatenate([cells + v * self.ndof_scalar for v in range(dim)],
                           axis=1), device, torch.int64)
        nqp = grad.shape[0]
        G = np.zeros((nqp, dim, dim, dim, nd))      # [q, v, a, w, node]
        for v in range(dim):
            G[:, v, :, v, :] = grad.transpose(0, 2, 1)
        self.G = _fem.to_tensor(G.reshape(nqp, dim * dim, self.nde), device)
        self.w = _fem.to_tensor(w, device)
        _, left = _fem.h1_boundary(n, p, dim)
        self.clamped = _fem.to_tensor(np.concatenate([left] * dim), device,
                                      torch.bool)
        self.block = max(1, BLOCK_ENTRIES // (self.nde * self.nde))
        self._W = None

    def W(self) -> torch.Tensor:
        """[q dim^2 dim^2, nde^2] G (x) G, built once."""
        if self._W is None:
            W = torch.einsum("qai,qbj->qabij", self.G, self.G)
            self._W = W.reshape(-1, self.nde * self.nde)
        return self._W

    def grad_u(self, u: torch.Tensor, lo: int, hi: int) -> torch.Tensor:
        """[cells, q, dim^2] grad u (row-major d u_v / d x_a) of cells
        lo:hi."""
        ue = u.to(torch.float64)[self.dofs[lo:hi]]
        return torch.einsum("qij,ej->eqi", self.G, ue)


def _det(F: torch.Tensor, dim: int) -> torch.Tensor:
    if dim == 2:
        return F[..., 0] * F[..., 3] - F[..., 1] * F[..., 2]
    return (F[..., 0] * (F[..., 4] * F[..., 8] - F[..., 5] * F[..., 7])
            - F[..., 1] * (F[..., 3] * F[..., 8] - F[..., 5] * F[..., 6])
            + F[..., 2] * (F[..., 3] * F[..., 7] - F[..., 4] * F[..., 6]))


def energy(g: torch.Tensor, lam: float, mu: float) -> torch.Tensor:
    """W at grad u ``g`` [..., dim^2], row-major."""
    dim = int(round(g.shape[-1] ** 0.5))
    eye = torch.eye(dim, dtype=g.dtype, device=g.device).reshape(-1)
    F = g + eye
    logj = torch.log(_det(F, dim))
    return (0.5 * mu * ((F * F).sum(-1) - dim) - mu * logj
            + 0.5 * lam * logj * logj)


def _pointwise(fn, g: torch.Tensor) -> torch.Tensor:
    flat = g.reshape(-1, g.shape[-1])
    out = torch.func.vmap(fn)(flat)
    return out.reshape(*g.shape[:-1], *out.shape[1:])


def stress(g: torch.Tensor, lam: float, mu: float) -> torch.Tensor:
    """First Piola-Kirchhoff stress dW/dF [..., dim^2]."""
    return _pointwise(torch.func.grad(lambda x: energy(x, lam, mu)), g)


def tangent(g: torch.Tensor, lam: float, mu: float) -> torch.Tensor:
    """d^2 W / dF^2 [..., dim^2, dim^2]."""
    return _pointwise(torch.func.hessian(lambda x: energy(x, lam, mu)), g)


def element_jacobians(grid: Grid, u: torch.Tensor, lam: float, mu: float,
                      lo: int, hi: int, precision: str = "float64"):
    """[hi - lo, nde, nde] cell Hessians.  ``precision`` "float64" is the
    reference; "tf32" is the control: the same contraction as one float32
    product whose operands are rounded to TF32."""
    g = grid.grad_u(u, lo, hi)
    cD = tangent(g, lam, mu) * grid.w[None, :, None, None]  # [e, q, d2, d2]
    cD = cD.reshape(hi - lo, -1)
    W = grid.W()
    if precision == "tf32":
        A = _fem.tf32(cD.float()) @ _fem.tf32(W.float())
    elif precision == "float64":
        A = cD @ W
    else:
        raise ValueError(f"unknown precision {precision!r}")
    return A.reshape(hi - lo, grid.nde, grid.nde)


def residual(grid: Grid, u: torch.Tensor, b: torch.Tensor, lam: float,
             mu: float) -> torch.Tensor:
    """Internal force of ``u`` minus ``b``, the clamped rows zeroed."""
    r = torch.zeros(grid.dim * grid.ndof_scalar, dtype=torch.float64,
                    device=grid.device)
    for lo in range(0, grid.ncell, grid.block):
        hi = min(lo + grid.block, grid.ncell)
        P = stress(grid.grad_u(u, lo, hi), lam, mu) * grid.w[None, :, None]
        fe = torch.einsum("eqi,qij->ej", P, grid.G)
        r.index_add_(0, grid.dofs[lo:hi].reshape(-1), fe.reshape(-1))
    r = r - b.to(torch.float64)
    return torch.where(grid.clamped, 0.0, r)


def body_load(n: int, force, device) -> torch.Tensor:
    """Load vector of the constant body force ``force`` (2,) on the n x n
    Q1 grid, the clamped rows zeroed: b_(v,i) = f_v int phi_i.  It builds
    only what the load needs (no ``Grid``): it is an input of both sides."""
    val, _, w = _fem.tensor_basis(1, 3, 1.0 / n)
    cell = _fem.to_tensor(w @ val, device)                      # [4]
    cells = _fem.to_tensor(_fem.h1_cell_dofs(n, 1), device, torch.int64)
    ones = torch.bincount(cells.reshape(-1), weights=cell.repeat(n * n),
                          minlength=(n + 1) ** 2)
    f = torch.as_tensor(force, dtype=torch.float64, device=device)
    b = torch.cat([f[0] * ones, f[1] * ones])
    _, left = _fem.h1_boundary(n, 1)
    clamped = _fem.to_tensor(np.concatenate([left, left]), device, torch.bool)
    return torch.where(clamped, 0.0, b)
