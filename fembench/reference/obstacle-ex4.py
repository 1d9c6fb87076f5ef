"""Plain reference of the obstacle configuration (ex4): the LVPP subproblem
of one proximal Galerkin iteration on H1 Q(p+1) x L2 Q(p-1) over an n x n
grid of the unit square, Fermi-Dirac entropy on [lower, upper]:

    L(u, psi) = int 1/2 |grad u|^2 + (u (psi - psi_k) - E*(psi)) / alpha
    E*(psi) = softplus(s psi) + lower psi,  s = upper - lower,

so that, with f the load, the residual of (u, psi) is

    R_u(v)   = int grad u . grad v + (psi - psi_k) v / alpha - (f, v)
    R_psi(w) = int (u - E*'(psi)) w / alpha,  E*'(psi) = s sigma(s psi) + lower,

u = 0 on the boundary (those rows zeroed).  Dofs: the H1 lattice, then the
L2 nodes cell by cell (``_fem``).  ``loads`` integrates the load with the
same quadrature; ``residual`` evaluates R at a given iterate.
"""

from __future__ import annotations

import importlib.util
import math
import os

import numpy as np
import torch

_spec = importlib.util.spec_from_file_location(
    "fembench_reference_fem", os.path.join(os.path.dirname(__file__), "_fem.py"))
_fem = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(_fem)


class Spaces:
    """H1 Q(order+1) and L2 Q(order-1) on the n x n grid, ``nq`` Gauss
    points per axis."""

    def __init__(self, n: int, order: int, nq: int, device):
        h = 1.0 / n
        self.n, self.device = n, device
        ph, pl = order + 1, order - 1
        vh, gh, w = _fem.tensor_basis(ph, nq, h)
        vl, _, _ = _fem.tensor_basis(pl, nq, h)
        self.vh, self.gh = _fem.to_tensor(vh, device), _fem.to_tensor(gh, device)
        self.vl, self.w = _fem.to_tensor(vl, device), _fem.to_tensor(w, device)
        self.h1 = _fem.to_tensor(_fem.h1_cell_dofs(n, ph), device, torch.int64)
        self.nh = (ph * n + 1) ** 2
        self.nl_cell = (pl + 1) ** 2
        self.nl = n * n * self.nl_cell
        bdr, _ = _fem.h1_boundary(n, ph)
        self.ess = _fem.to_tensor(
            np.concatenate([bdr, np.zeros(self.nl, bool)]), device, torch.bool)
        # physical points of each cell [cells, q, 2]
        xq, _ = _fem.gauss_legendre(nq)
        pts = np.stack(np.meshgrid(xq, xq, indexing="xy"), -1).reshape(-1, 2)
        j, i = np.divmod(np.arange(n * n), n)
        corner = np.stack([i, j], -1) * h
        self.xq = _fem.to_tensor(corner[:, None, :] + h * pts[None], device)

    @property
    def ndof(self) -> int:
        return self.nh + self.nl


def loads(n: int, order: int, nq: int, amplitudes, device):
    """[ndof] right-hand sides, one per amplitude a: a 2 pi^2 sin(pi x)
    sin(pi y) tested with the H1 basis, zero on the boundary and in the L2
    block.  They are inputs of both sides; the spaces they need are dropped
    with them."""
    sp = Spaces(n, order, nq, device)
    x, y = sp.xq[..., 0], sp.xq[..., 1]
    f = 2.0 * math.pi ** 2 * torch.sin(math.pi * x) * torch.sin(math.pi * y)
    fe = torch.einsum("eq,qd,q->ed", f, sp.vh, sp.w)
    b = torch.zeros(sp.ndof, dtype=torch.float64, device=sp.device)
    b.index_add_(0, sp.h1.reshape(-1), fe.reshape(-1))
    b = torch.where(sp.ess, 0.0, b)
    return [a * b for a in amplitudes]


def residual(sp: Spaces, x: torch.Tensor, psi_k: torch.Tensor, alpha: float,
             b: torch.Tensor, lower: float, upper: float) -> torch.Tensor:
    """R(x) of the subproblem with frozen latent ``psi_k`` (L2 dofs) and
    step ``alpha``; boundary rows zeroed."""
    x = x.to(torch.float64)
    ue = x[: sp.nh][sp.h1]                                        # [e, Dh]
    pe = x[sp.nh:].reshape(-1, sp.nl_cell)                         # [e, Dl]
    pke = psi_k.to(torch.float64).reshape(-1, sp.nl_cell)
    u = ue @ sp.vh.T                                               # [e, q]
    gu = torch.einsum("qda,ed->eqa", sp.gh, ue)
    psi = pe @ sp.vl.T
    dpsi = (pe - pke) @ sp.vl.T
    s = upper - lower
    dual = s * torch.sigmoid(s * psi) + lower
    ru = (torch.einsum("eqa,qda,q->ed", gu, sp.gh, sp.w)
          + torch.einsum("eq,qd,q->ed", dpsi / alpha, sp.vh, sp.w))
    rp = torch.einsum("eq,qd,q->ed", (u - dual) / alpha, sp.vl, sp.w)
    r = torch.zeros(sp.ndof, dtype=torch.float64, device=sp.device)
    r.index_add_(0, sp.h1.reshape(-1), ru.reshape(-1))
    r[sp.nh:] += rp.reshape(-1)
    r = r - b.to(torch.float64)
    return torch.where(sp.ess, 0.0, r)
