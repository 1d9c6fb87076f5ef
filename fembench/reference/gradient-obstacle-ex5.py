"""Plain reference of the gradient-constrained obstacle configuration (ex5):
the LVPP subproblem of one proximal Galerkin iteration on H1 P(p) x
H1 P(p-1)^2 over the n x n grid of the unit square, each cell split into
two triangles along its SW-NE diagonal, Hellinger entropy with the bound
phi(x, y) = 0.1 + 0.2 x + 0.4 y:

    L(grad u, psi) = 1/2 |grad u|^2 + (grad u . (psi - psi_k) - E*(psi)) / alpha
    E*(psi) = sqrt(1 + phi^2 |psi|^2),

so that, with f = 15 sin^2(pi x) the load, the residual of (u, psi) is

    R_u(v)   = int (grad u + (psi - psi_k) / alpha) . grad v - (f, v)
    R_psi(w) = int (grad u - phi^2 psi / sqrt(1 + phi^2 |psi|^2)) . w / alpha,

u = 0 on the boundary (those rows zeroed).  ``loads`` integrates the load
with the same quadrature; ``residual`` evaluates R at a given iterate.

Written from the textbook definitions with numpy and torch alone: the
Lagrange bases on the reference triangle from their Vandermonde matrices,
the quadrature from the Golub-Welsch eigenproblem.  The layout is the
documented output format of the program's dof vectors on a structured
triangle mesh:

- H1 P(p) on n x n cells: the nodes of P(p) over the triangulation fill
  the (p n + 1)^2 lattice of the p-refined grid, numbered x fastest
  (dof = j (p n + 1) + i for the node at (i, j) h / p);
- the vector latent stores its two components one after the other
  (component-major: dof = c N + node, N the scalar lattice's size);
- the primal block comes first, then the latent.

Departures from ex5.cpp (dohyun-cse/mfem-ad):

- the quadrature is the program's collapsed (Duffy) rule: nq Gauss-Legendre
  points in one direction times nq Gauss-Jacobi(1, 0) points in the other,
  nq = 4 (16 points, exact to degree 6 = 2p + 2), not MFEM's triangle
  rule of that order;
- the Lagrange nodes of each triangle are equispaced (at p <= 2 they are
  MFEM's too), so a dof is the value at its lattice node;
- phi and f are evaluated at the quadrature points as functions;
- the dof numbering is the program's (the lattice), not MFEM's;
- it evaluates the subproblem residual of one PG iteration; ex5.cpp solves
  it (with MUMPS), which the reference does not.
"""

from __future__ import annotations

import math

import numpy as np
import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


def gauss_jacobi_10(n: int) -> tuple[np.ndarray, np.ndarray]:
    """n-point Gauss-Jacobi rule on [-1, 1] for the weight (1 - x), by
    Golub-Welsch on the Jacobi recurrence with a = 1, b = 0."""
    a, b = 1.0, 0.0
    k = np.arange(n, dtype=np.float64)
    s = 2.0 * k + a + b
    diag = (b * b - a * a) / (s * (s + 2.0))
    kk = k[1:]
    s1 = 2.0 * kk + a + b
    off = np.sqrt(4.0 * kk * (kk + a) * (kk + b) * (kk + a + b)
                  / (s1 * s1 * (s1 + 1.0) * (s1 - 1.0)))
    x, V = np.linalg.eigh(np.diag(diag) + np.diag(off, 1) + np.diag(off, -1))
    return x, 2.0 * V[0, :] ** 2            # int_{-1}^{1} (1 - x) dx = 2


def triangle_rule(nq: int) -> tuple[np.ndarray, np.ndarray]:
    """Collapsed rule on the unit triangle {x, y >= 0, x + y <= 1}: points
    [nq^2, 2] and weights (summing to 1/2)."""
    xa, wa = np.polynomial.legendre.leggauss(nq)
    xb, wb = gauss_jacobi_10(nq)
    A, B = np.meshgrid(xa, xb, indexing="ij")
    pts = np.stack([((1.0 + A) * (1.0 - B) / 4.0).ravel(),
                    ((1.0 + B) / 2.0).ravel()], axis=1)
    return pts, (np.outer(wa, wb) / 8.0).ravel()


def lagrange_triangle(p: int, pts: np.ndarray):
    """The P(p) Lagrange basis on the unit triangle with the equispaced
    nodes (a / p, b / p), a + b <= p, in that order (b slowest): values
    [Q, D] and reference gradients [Q, D, 2] at ``pts``, and the nodes'
    (a, b)."""
    ab = [(a, b) for b in range(p + 1) for a in range(p + 1 - b)]
    nodes = np.array(ab, dtype=np.float64) / max(p, 1)
    # the monomials x^i y^j, i + j <= p, indexed as the nodes
    V = np.array([[x ** i * y ** j for i, j in ab] for x, y in nodes])
    coef = np.linalg.inv(V)                     # column d: basis function d
    x, y = pts[:, 0], pts[:, 1]
    M = np.stack([x ** i * y ** j for i, j in ab], 1)
    Mx = np.stack([i * x ** max(i - 1, 0) * y ** j for i, j in ab], 1)
    My = np.stack([j * x ** i * y ** max(j - 1, 0) for i, j in ab], 1)
    return M @ coef, np.stack([Mx @ coef, My @ coef], -1), ab


# the two triangles of a cell, as the lattice directions (in cells) of
# their reference axes: (v00, v10, v11) and (v00, v11, v01)
_ORIENT = (((1, 0), (1, 1)), ((1, 1), (0, 1)))


def _cell_dofs(n: int, p: int, ab) -> np.ndarray:
    """[2 n^2, D] lattice dofs of each triangle's nodes (triangles of a
    cell together, cells x fastest)."""
    N = p * n + 1
    j, i = np.divmod(np.arange(n * n), n)
    out = []
    for e1, e2 in _ORIENT:
        gi = [p * i + a * e1[0] + b * e2[0] for a, b in ab]
        gj = [p * j + a * e1[1] + b * e2[1] for a, b in ab]
        out.append(np.stack(gj, 1) * N + np.stack(gi, 1))
    return np.stack(out, 1).reshape(2 * n * n, -1)


class Spaces:
    """H1 P(order) and H1 P(order-1)^2 on the n x n grid of split cells,
    the collapsed rule of ``nq`` x ``nq`` points."""

    def __init__(self, n: int, order: int, nq: int, device):
        h = 1.0 / n
        self.n, self.device = n, device
        ph, pl = order, order - 1
        pts, w = triangle_rule(nq)
        vh, gh_ref, abh = lagrange_triangle(ph, pts)
        vl, _, abl = lagrange_triangle(pl, pts)
        self.nh = (ph * n + 1) ** 2
        self.nds = (pl * n + 1) ** 2            # scalar latent nodes
        self.nl = 2 * self.nds
        f64 = dict(dtype=torch.float64, device=device)
        self.vh = torch.as_tensor(vh, **f64)
        self.vl = torch.as_tensor(vl, **f64)
        self.w = torch.as_tensor(w * h * h, **f64)        # |det J| = h^2
        # physical gradients J^-T grad_ref per orientation [2, Q, Dh, 2]
        g = []
        for e1, e2 in _ORIENT:
            J = h * np.array([[e1[0], e2[0]], [e1[1], e2[1]]], float)
            g.append(np.einsum("qda,ab->qdb", gh_ref, np.linalg.inv(J)))
        ne = 2 * n * n
        self.gh = torch.as_tensor(np.stack(g), **f64).repeat(n * n, 1, 1, 1)
        self.h1 = torch.as_tensor(_cell_dofs(n, ph, abh), dtype=torch.int64,
                                  device=device)
        self.l1 = torch.as_tensor(_cell_dofs(n, pl, abl), dtype=torch.int64,
                                  device=device)
        # physical quadrature points [ne, Q, 2]
        j, i = np.divmod(np.arange(n * n), n)
        corner = np.stack([i, j], -1) * h
        xq = [corner[:, None, :] + h * (pts[:, :1] * np.array(e1)
                                        + pts[:, 1:] * np.array(e2))[None]
              for e1, e2 in _ORIENT]
        self.xq = torch.as_tensor(np.stack(xq, 1).reshape(ne, -1, 2), **f64)
        N = ph * n + 1
        gi, gj = np.arange(self.nh) % N, np.arange(self.nh) // N
        bdr = (gi == 0) | (gi == N - 1) | (gj == 0) | (gj == N - 1)
        self.ess = torch.as_tensor(
            np.concatenate([bdr, np.zeros(self.nl, bool)]), dtype=torch.bool,
            device=device)

    @property
    def ndof(self) -> int:
        return self.nh + self.nl


def phi(xq: torch.Tensor) -> torch.Tensor:
    return 0.1 + 0.2 * xq[..., 0] + 0.4 * xq[..., 1]


def loads(n: int, order: int, nq: int, amplitudes, device):
    """[ndof] right-hand sides, one per amplitude a: a 15 sin^2(pi x)
    tested with the H1 P(order) basis, zero on the boundary and in the
    latent block.  They are inputs of both sides; the spaces they need are
    dropped with them."""
    sp = Spaces(n, order, nq, device)
    f = 15.0 * torch.sin(math.pi * sp.xq[..., 0]) ** 2
    fe = torch.einsum("eq,qd,q->ed", f, sp.vh, sp.w)
    b = torch.zeros(sp.ndof, dtype=torch.float64, device=sp.device)
    b = b.index_add(0, sp.h1.reshape(-1), fe.reshape(-1))
    b = torch.where(sp.ess, 0.0, b)
    return [a * b for a in amplitudes]


def residual(sp: Spaces, x: torch.Tensor, psi_k: torch.Tensor, alpha: float,
             b: torch.Tensor) -> torch.Tensor:
    """R(x) of the subproblem with frozen latent ``psi_k`` (latent dofs)
    and step ``alpha``; boundary rows zeroed.  Out of place, so that
    ``torch.func`` differentiates it."""
    x = x.to(torch.float64)
    ue = x[: sp.nh][sp.h1]                                         # [e, Dh]
    lat = x[sp.nh:].reshape(2, sp.nds)
    lat_k = psi_k.to(torch.float64).reshape(2, sp.nds)
    pe = lat[:, sp.l1].permute(1, 0, 2)                            # [e, 2, Dl]
    pke = lat_k[:, sp.l1].permute(1, 0, 2)
    gu = torch.einsum("eqda,ed->eqa", sp.gh, ue)                   # [e, q, 2]
    psi = torch.einsum("ecd,qd->eqc", pe, sp.vl)
    dpsi = torch.einsum("ecd,qd->eqc", pe - pke, sp.vl)
    s2 = phi(sp.xq) ** 2
    dual = s2[..., None] * psi / torch.sqrt(
        1.0 + s2 * (psi * psi).sum(-1))[..., None]
    ru = torch.einsum("eqa,eqda,q->ed", gu + dpsi / alpha, sp.gh, sp.w)
    rp = torch.einsum("eqc,qd,q->ecd", (gu - dual) / alpha, sp.vl, sp.w)
    lat_dofs = (sp.l1[:, None, :]
                + sp.nh + sp.nds * torch.arange(2, device=sp.device)[:, None])
    r = torch.zeros(sp.ndof, dtype=torch.float64, device=sp.device)
    r = r.index_add(0, sp.h1.reshape(-1), ru.reshape(-1))
    r = r.index_add(0, lat_dofs.reshape(-1), rp.reshape(-1))
    r = r - b.to(torch.float64)
    return torch.where(sp.ess, 0.0, r)
