"""Plain reference of the density-filtered topology optimization
configuration (MFEM ex37): minimize the compliance C = (f, u) over the
latent psi in L2 Q(p-1), rho = sigmoid(psi), subject to

    -div(r(rho~) C eps(u)) = f,  u = 0 on the edge x = 0,
    -eps^2 lap rho~ + rho~ = rho  (natural conditions: the PDE filter),
    int rho = theta |Omega|,
    r(rho~) = rho_0 + rho~^3 (1 - rho_0),  C eps = lambda tr(eps) I + 2 mu eps,

on [0, 3] x [0, 1] cut into 3n x n square cells, f = (0, -a) on the
closed disc of radius 0.05 about (2.9, 0.5).  Design iteration k (from
1) with the step alpha_k = k alpha:

1. rho~ solves the filter with sigmoid(psi) on the right;
2. u solves the state at rho~;
3. w solves the filter with g = -r'(rho~) (lambda div(u)^2 + 2 mu
   |eps(u)|^2) on the right (the adjoint filter);
4. psi <- psi - alpha_k G, G the L2 projection of w on the latent space;
5. psi <- psi + c, c such that int sigmoid(psi + c) = theta |Omega|.

``solve_dense`` runs that loop at a small size with dense direct solves.
At the benchmark's size the pieces are evaluated in blocks of cells at
the program's iterates: ``state_residual``, ``filter_residual`` (also the
adjoint's, with ``sensitivity`` as its right-hand side) and
``next_latent`` from the reference's own bisection.

Written from the textbook definitions with numpy and torch alone, float64
and no TF32, on ``_fem``'s Gauss-Lobatto bases and Gauss-Legendre
points; the layout is the documented output format of the program's dof
vectors: the H1 lattice of (p 3n + 1) x (p n + 1) nodes numbered x
fastest (dof = j (3 p n + 1) + i), a vector field's components one after
the other, the L2 nodes cell by cell (cells x fastest), each cell's
nodes x fastest.

Departures from ex37.cpp (mfem/mfem examples):

- every integral takes nq x nq Gauss-Legendre points per cell (nq = 3:
  MFEM's default orders for the H1 Q2 forms; the latent's integrals with
  the same points are exact, the volume is taken at them);
- the volume projection bisects c on ex37's bracket logit(theta) -+
  max|psi| until the bracket stops shrinking (ex37's proj solves the same
  scalar equation);
- it runs no stopping test (ex37 stops on the change of rho over alpha).
"""

from __future__ import annotations

import importlib.util
import math
import os

import numpy as np
import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

_spec = importlib.util.spec_from_file_location(
    "fembench_reference_fem", os.path.join(os.path.dirname(__file__), "_fem.py"))
_fem = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(_fem)

F64 = torch.float64
BLOCK = 1 << 16  # cells per block
CENTER, RADIUS = (2.9, 0.5), 0.05


def rect_cell_dofs(nx: int, ny: int, p: int) -> np.ndarray:
    """[nx ny, (p+1)^2] scalar H1 dofs of each cell of the nx x ny grid:
    ``_fem.h1_cell_dofs`` on a rectangle."""
    NX = p * nx + 1
    e = np.arange(nx * ny)[:, None]
    node = np.arange((p + 1) ** 2)[None, :]
    gi = (e % nx) * p + node % (p + 1)
    gj = (e // nx) * p + node // (p + 1)
    return gj * NX + gi


class Spaces:
    """The Q(p) lattice on 3n x n cells of side 1/n, its bases at the nq^2
    points, the L2 Q(p-1) basis there, the points' coordinates and the
    clamped nodes."""

    def __init__(self, n: int, p: int, nq: int, device):
        self.nx, self.ny, self.p = 3 * n, n, p
        h = 1.0 / n
        self.NX, self.NY = p * self.nx + 1, p * n + 1
        self.N = self.NX * self.NY
        self.ne = self.nx * n
        val, grad, w = _fem.tensor_basis(p, nq, h)
        lval = _fem.tensor_basis(p - 1, nq, h)[0]
        t = lambda a: _fem.to_tensor(a, device)  # noqa: E731
        self.val, self.grad, self.w, self.lval = t(val), t(grad), t(w), t(lval)
        self.nl = self.ne * lval.shape[1]
        self.cells = torch.as_tensor(rect_cell_dofs(self.nx, n, p),
                                     device=device)
        xq, _ = _fem.gauss_legendre(nq)
        q = np.arange(nq * nq)
        self.ref_pts = np.stack([xq[q % nq], xq[q // nq]], axis=1) * h
        self.h = h
        self.clamped = torch.as_tensor(
            np.arange(self.N) % self.NX == 0, device=device)
        self.ess = torch.cat([self.clamped, self.clamped])
        mass = lval.T @ (w[:, None] * lval)
        self.mass_inv = t(np.linalg.inv(mass))
        self.volume_total = 3.0
        self.device = device

    def blocks(self):
        for s in range(0, self.ne, BLOCK):
            yield s, min(s + BLOCK, self.ne)

    def points(self, s: int, e: int) -> torch.Tensor:
        """[e - s, nq^2, 2] coordinates of the points of cells s..e-1."""
        c = torch.arange(s, e, device=self.device)
        org = torch.stack([(c % self.nx).to(F64), (c // self.nx).to(F64)],
                          dim=1) * self.h
        return org[:, None, :] + torch.as_tensor(self.ref_pts,
                                                 device=self.device)

    def scatter(self, out, cells, vals):
        out.index_add_(0, cells.reshape(-1), vals.reshape(-1))


def loads(sp: Spaces, amps) -> list:
    """f = (0, -a) on the closed disc, integrated at the points, for each
    amplitude a; zero at the clamped dofs."""
    base = torch.zeros(2 * sp.N, dtype=F64, device=sp.device)
    for s, e in sp.blocks():
        x = sp.points(s, e)
        inside = ((x[..., 0] - CENTER[0]) ** 2 + (x[..., 1] - CENTER[1]) ** 2
                  <= RADIUS ** 2).to(F64)                       # [c, Q]
        be = -(inside * sp.w) @ sp.val                          # [c, D]
        sp.scatter(base, sp.cells[s:e] + sp.N, be)
    base[sp.ess] = 0.0
    return [a * base for a in amps]


def _strain(sp, u, s, e):
    """(div u, |eps(u)|^2, grad u [c, Q, 2, 2]) at the points of cells
    s..e-1."""
    cells = sp.cells[s:e]
    ue = torch.stack([u[cells], u[cells + sp.N]], dim=-1)      # [c, D, 2]
    G = torch.einsum("cdi,qdj->cqij", ue, sp.grad)
    div = G[..., 0, 0] + G[..., 1, 1]
    eps = 0.5 * (G + G.transpose(-1, -2))
    return div, (eps * eps).sum(dim=(-1, -2)), eps


def _qp(sp, x, s, e):
    """Values of the scalar H1 field x at the points of cells s..e-1."""
    return x[sp.cells[s:e]] @ sp.val.T


def state_residual(sp, u, rho_f, b, lam, mu, rho0):
    """K(rho~) u - f, zero at the clamped dofs."""
    R = torch.zeros(2 * sp.N, dtype=F64, device=sp.device)
    for s, e in sp.blocks():
        div, _, eps = _strain(sp, u, s, e)
        r = rho0 + _qp(sp, rho_f, s, e) ** 3 * (1.0 - rho0)
        eye = torch.eye(2, dtype=F64, device=sp.device)
        sig = (r * sp.w)[..., None, None] * (
            lam * div[..., None, None] * eye + 2.0 * mu * eps)
        fe = torch.einsum("cqij,qdj->cdi", sig, sp.grad)       # [c, D, 2]
        cells = sp.cells[s:e]
        sp.scatter(R, cells, fe[..., 0])
        sp.scatter(R, cells + sp.N, fe[..., 1])
    R = R - b
    R[sp.ess] = 0.0
    return R


def filter_apply(sp, x, eps):
    """(eps^2 grad x, grad v) + (x, v) for every H1 dof v."""
    out = torch.zeros(sp.N, dtype=F64, device=sp.device)
    for s, e in sp.blocks():
        xe = x[sp.cells[s:e]]
        g = torch.einsum("cd,qdj->cqj", xe, sp.grad)
        v = xe @ sp.val.T
        fe = (eps * eps) * torch.einsum("cqj,qdj->cd", g * sp.w[:, None],
                                        sp.grad) + (v * sp.w) @ sp.val
        sp.scatter(out, sp.cells[s:e], fe)
    return out


def filter_residual(sp, x, rhs, eps):
    """The filter's residual at x against the right-hand side rhs."""
    return filter_apply(sp, x, eps) - rhs


def _psi_qp(sp, psi, s, e):
    nl = sp.lval.shape[1]
    return psi[s * nl:e * nl].reshape(e - s, nl) @ sp.lval.T


def filter_load(sp, psi):
    """(sigmoid(psi), v) for every H1 dof v."""
    out = torch.zeros(sp.N, dtype=F64, device=sp.device)
    for s, e in sp.blocks():
        fe = (torch.sigmoid(_psi_qp(sp, psi, s, e)) * sp.w) @ sp.val
        sp.scatter(out, sp.cells[s:e], fe)
    return out


def sensitivity(sp, u, rho_f, lam, mu, rho0):
    """(-r'(rho~) (lambda div(u)^2 + 2 mu |eps(u)|^2), v), the adjoint
    filter's right-hand side: dC/drho~."""
    out = torch.zeros(sp.N, dtype=F64, device=sp.device)
    for s, e in sp.blocks():
        div, e2, _ = _strain(sp, u, s, e)
        dr = 3.0 * _qp(sp, rho_f, s, e) ** 2 * (1.0 - rho0)
        fe = (-dr * (lam * div * div + 2.0 * mu * e2) * sp.w) @ sp.val
        sp.scatter(out, sp.cells[s:e], fe)
    return out


def latent_gradient(sp, w):
    """G: the L2 projection of the H1 field w on L2 Q(p-1), cell by cell."""
    out = []
    for s, e in sp.blocks():
        rhs = (_qp(sp, w, s, e) * sp.w) @ sp.lval               # [c, nl]
        out.append(rhs @ sp.mass_inv.T)
    return torch.cat(out).reshape(-1)


def volume(sp, psi, c: float) -> float:
    return sum(float((torch.sigmoid(_psi_qp(sp, psi, s, e) + c)
                      * sp.w).sum()) for s, e in sp.blocks())


def project(sp, psi, theta: float):
    """psi + c, int sigmoid(psi + c) = theta |Omega|: c bisected on
    logit(theta) -+ max|psi| until the bracket stops shrinking."""
    mid0 = math.log(theta / (1.0 - theta))
    r = float(psi.abs().max())
    lo, hi = mid0 - r, mid0 + r
    target = theta * sp.volume_total
    for _ in range(400):
        mid = 0.5 * (lo + hi)
        if mid in (lo, hi):
            break
        if volume(sp, psi, mid) > target:
            hi = mid
        else:
            lo = mid
    return psi + 0.5 * (lo + hi)


def next_latent(sp, psi, w, alpha_k: float, theta: float):
    """Steps 4 and 5 from the latent psi and the adjoint filter's w."""
    return project(sp, psi - alpha_k * latent_gradient(sp, w), theta)


def relative(r, b) -> float:
    return float(torch.linalg.vector_norm(r) / torch.linalg.vector_norm(b))


def _dense(apply, n: int, device) -> torch.Tensor:
    """The matrix of the linear map ``apply``, column by column."""
    eye = torch.eye(n, dtype=F64, device=device)
    return torch.stack([apply(eye[i]) for i in range(n)], dim=1)


def solve_dense(n: int, p: int, nq: int, iters: int, cfg: dict,
                amp: float = 1.0, device="cpu") -> list:
    """The whole loop at a small size with dense direct solves: per
    iteration (psi, rho~, u, w, psi_next, compliance)."""
    sp = Spaces(n, p, nq, device)
    lam, mu, rho0 = cfg["lambda"], cfg["mu"], cfg["rho_min"]
    eps, theta = cfg["filter_radius"], cfg["volume_fraction"]
    b = loads(sp, [amp])[0]
    A = _dense(lambda x: filter_apply(sp, x, eps), sp.N, device)
    free = ~sp.ess
    psi = torch.full((sp.nl,), math.log(theta / (1.0 - theta)), dtype=F64,
                     device=device)
    out = []
    for k in range(1, iters + 1):
        rho_f = torch.linalg.solve(A, filter_load(sp, psi))
        zero = torch.zeros(2 * sp.N, dtype=F64, device=device)
        K = _dense(lambda v: state_residual(sp, v, rho_f, zero, lam, mu,
                                            rho0), 2 * sp.N, device)
        u = torch.zeros_like(zero)
        u[free] = torch.linalg.solve(K[free][:, free], b[free])
        w = torch.linalg.solve(A, sensitivity(sp, u, rho_f, lam, mu, rho0))
        psi_next = next_latent(sp, psi, w, k * cfg["alpha"], theta)
        out.append((psi, rho_f, u, w, psi_next, float(b @ u)))
        psi = psi_next
    return out
