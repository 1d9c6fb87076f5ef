"""Plain tensor-product finite elements for the references: Gauss-Legendre
quadrature, Gauss-Lobatto nodal bases and the dof layout of a structured
grid of quadrilaterals or hexahedra on the unit square or cube.

Written from the textbook definitions with numpy and torch alone.  The
layout is the documented output format the program's dof vectors take:

- H1 of order p on n^dim cells: the (p n + 1)^dim lattice of
  Gauss-Lobatto nodes, numbered x fastest in 2D and z fastest in 3D; a
  vector field stores its components one after the other
  (component-major).
- L2 of order p: the (p+1)^2 Gauss-Lobatto nodes of each cell, cells in
  row order (x fastest), nodes in lexicographic order (x fastest).
- cells are numbered as the lattice: (i, j) -> j n + i, (i, j, k) ->
  (i n + j) n + k; a cell's own nodes are lexicographic, x fastest.
"""

from __future__ import annotations

import numpy as np
import torch


def gauss_legendre(n: int) -> tuple[np.ndarray, np.ndarray]:
    """n-point Gauss-Legendre points and weights on [0, 1]."""
    x, w = np.polynomial.legendre.leggauss(n)
    return 0.5 * (x + 1.0), 0.5 * w


def gauss_lobatto(p: int) -> np.ndarray:
    """The p+1 Gauss-Lobatto points on [0, 1]: the end points and the
    roots of P_p'."""
    if p == 0:
        return np.array([0.5])
    inner = np.polynomial.legendre.Legendre.basis(p).deriv().roots()
    return 0.5 * (np.concatenate([[-1.0], np.sort(inner.real), [1.0]]) + 1.0)


def lagrange_1d(nodes: np.ndarray, x: np.ndarray):
    """Values and derivatives [len(x), len(nodes)] of the Lagrange basis on
    ``nodes``, by the product formula."""
    n = len(nodes)
    val = np.ones((len(x), n))
    der = np.zeros((len(x), n))
    for j in range(n):
        for m in range(n):
            if m == j:
                continue
            den = nodes[j] - nodes[m]
            term = np.ones(len(x)) / den
            for k in range(n):
                if k not in (j, m):
                    term = term * (x - nodes[k]) / (nodes[j] - nodes[k])
            der[:, j] += term
            val[:, j] *= (x - nodes[m]) / den
    return val, der


def tensor_basis(p: int, nq: int, h: float, dim: int = 2):
    """Q_p Gauss-Lobatto basis at the nq^dim Gauss-Legendre points of a
    cube cell of side h: values [Q, D], physical gradients [Q, D, dim] and
    the weights times |J| [Q]; D = (p+1)^dim, points and nodes x fastest."""
    xq, wq = gauss_legendre(nq)
    v, d = lagrange_1d(gauss_lobatto(p), xq)

    def kron(factors):
        out = np.ones((1, 1))
        for f in factors:                        # slowest axis first
            out = np.kron(out, f)
        return out

    val = kron([v] * dim)
    grads = [kron([d if ax == a else v for ax in reversed(range(dim))]) / h
             for a in range(dim)]
    w = kron([wq[:, None]] * dim)[:, 0] * h ** dim
    return val, np.stack(grads, axis=-1), w


def strides(m: int, dim: int) -> list:
    """Per axis (x first), the stride of the program's numbering of an
    m^dim lattice: x fastest in 2D, z fastest in 3D."""
    if dim == 2:
        return [1, m]
    return [m ** (dim - 1 - a) for a in range(dim)]


def lattice_axes(n: int, p: int, dim: int = 2) -> list:
    """Per axis (x first), the coordinate of each H1 lattice node."""
    N = p * n + 1
    g = np.arange(N ** dim)
    return [(g // s) % N for s in strides(N, dim)]


def h1_cell_dofs(n: int, p: int, dim: int = 2) -> np.ndarray:
    """[n^dim, (p+1)^dim] scalar H1 dofs of each cell of the n^dim grid,
    cells in the program's order, a cell's nodes x fastest."""
    N = p * n + 1
    e = np.arange(n ** dim)[:, None]
    node = np.arange((p + 1) ** dim)[None, :]
    out = np.zeros((n ** dim, (p + 1) ** dim), dtype=np.int64)
    for a, (cs, ls) in enumerate(zip(strides(n, dim), strides(N, dim))):
        out += ((e // cs) % n * p + (node // (p + 1) ** a) % (p + 1)) * ls
    return out


def h1_boundary(n: int, p: int, dim: int = 2) -> np.ndarray:
    """Boolean mask of the scalar H1 lattice nodes on the boundary, and
    of those on the face x = 0, as (all, left)."""
    N = p * n + 1
    axes = lattice_axes(n, p, dim)
    on = np.zeros(N ** dim, bool)
    for g in axes:
        on |= (g == 0) | (g == N - 1)
    return on, axes[0] == 0


def to_tensor(a, device, dtype=torch.float64):
    return torch.as_tensor(np.ascontiguousarray(a), dtype=dtype, device=device)


def tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 ``x`` rounded to TF32 (10 mantissa bits, to nearest even),
    as the tensor cores round the operands of a TF32 product."""
    b = x.contiguous().view(torch.int32)
    b = (b + 0x0FFF + ((b >> 13) & 1)) & ~0x1FFF
    return b.view(torch.float32)
