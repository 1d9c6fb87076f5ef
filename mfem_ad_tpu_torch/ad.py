"""AD point-functions: scalar energies and their derivatives via torch.func.

PyTorch counterpart of ``mfem_ad_tpu.ad``.  One plain Python energy
``f(x, params) -> scalar`` on a single quadrature point's input vector is
differentiated by ``torch.func``:

- gradient: ``torch.func.grad`` (one reverse pass);
- Hessian:  ``torch.func.jacfwd(torch.func.grad(f))`` (forward-over-reverse);
- batches of points go through ``torch.func.vmap``.

Energies are written with component indexing (``x[k]``) and elementwise
torch functions, so the same body runs under ``vmap`` and on whole
``[ne, nq]`` tiles (``hessian_closed_entries``).  The log-determinant uses
plain autograd: the component-level custom JVP of the JAX package existed
only so the TPU kernel compiler could lower the graph.
"""

from __future__ import annotations

import torch
from torch.func import grad, jacfwd

from .coefficients import Coefficient, as_coefficient

__all__ = [
    "ADFunction",
    "admax",
    "admin",
    "MassEnergy",
    "DiffusionEnergy",
    "LinearElasticityEnergy",
    "NeoHookeanEnergy",
]


def admax(a, b):
    """max with subgradient-consistent tie handling (average at equality)."""
    return torch.where(a > b, a, torch.where(a < b, b, 0.5 * (a + b)))


def admin(a, b):
    """min with subgradient tie-averaging."""
    return torch.where(a < b, a, torch.where(a > b, b, 0.5 * (a + b)))


class ADFunction:
    """Scalar point-function f: R^n -> R, differentiated by torch.func.

    Subclass and implement ``energy(self, x, p)``, or pass a callable.
    ``params`` maps names to Coefficient-convertible sources, evaluated per
    quadrature point at assembly time; for standalone use pass a dict of
    tensors directly.

    A subclass MAY implement hand-derived closed forms of the SAME energy:
    ``gradient_closed(x, p) -> [n]``, ``hessian_closed(x, p) -> [n, n]``,
    and ``hessian_closed_entries(x, p) -> list[list[h_ab]]``, the n x n
    Hessian entries as plain expressions over the indexables ``x[k]`` and
    ``p[name][i]`` (constants or broadcastable tensors).  The element-
    Jacobian kernel route consumes the entries with whole tiles as the
    "scalars".
    """

    gradient_closed = None
    hessian_closed = None
    hessian_closed_entries = None

    def __init__(self, n_input: int, fn=None, params: dict | None = None):
        self.n_input = int(n_input)
        if fn is not None:
            self.energy = fn  # type: ignore[method-assign]
        self.params: dict[str, Coefficient] = {}
        for k, v in (params or {}).items():
            self.add_parameter(k, v)

    def add_parameter(self, name: str, src):
        self.params[name] = as_coefficient(src)

    def energy(self, x, p):
        raise NotImplementedError

    def __call__(self, x, p=None):
        return self.energy(x, p or {})

    def gradient(self, x, p=None):
        return grad(self.energy)(x, p or {})

    def hessian(self, x, p=None):
        return jacfwd(grad(self.energy))(x, p or {})

    def value_grad_hess(self, x, p=None):
        p = p or {}
        return self.energy(x, p), self.gradient(x, p), self.hessian(x, p)


def _stack_rows(rows, like):
    """[n, n] tensor from nested entry lists (entries may be constants)."""
    return torch.stack([
        torch.stack([torch.as_tensor(h, dtype=like.dtype,
                                     device=like.device).expand(like.shape)
                     for h in r])
        for r in rows
    ])


# ---------------------------------------------------------------------------
# Built-in energy library
# ---------------------------------------------------------------------------


class MassEnergy(ADFunction):
    """0.5 ||x||^2."""

    def energy(self, x, p):
        return 0.5 * sum(x[k] * x[k] for k in range(self.n_input))

    def gradient_closed(self, x, p):
        return x

    def hessian_closed(self, x, p):
        return torch.eye(self.n_input, dtype=x.dtype, device=x.device)


class DiffusionEnergy(ADFunction):
    """0.5 grad^T K grad with scalar/vector/matrix K.

    K may be omitted (identity), or a Coefficient of size 1, dim, or dim^2.
    """

    def __init__(self, dim: int, K=None):
        super().__init__(dim)
        self.dim = dim
        if K is not None:
            self.add_parameter("K", K)
            ksize = self.params["K"].size
            if ksize not in (1, dim, dim * dim):
                raise ValueError(
                    f"K must have size 1, {dim} or {dim*dim}, got {ksize}"
                )

    def energy(self, g, p):
        d = self.dim
        K = p.get("K")
        gg = sum(g[k] * g[k] for k in range(d))
        if K is None:
            return 0.5 * gg
        if K.shape[-1] == 1:
            return 0.5 * K[0] * gg
        if K.shape[-1] == d:
            return 0.5 * sum(K[k] * g[k] * g[k] for k in range(d))
        return 0.5 * sum(
            g[i] * K[i * d + j] * g[j] for i in range(d) for j in range(d)
        )

    def gradient_closed(self, g, p):
        d = self.dim
        K = p.get("K")
        if K is None:
            return g
        if K.shape[-1] == 1:
            return K[0] * g
        if K.shape[-1] == d:
            return torch.stack([K[k] * g[k] for k in range(d)])
        Ks = [
            0.5 * (K[i * d + j] + K[j * d + i])
            for i in range(d) for j in range(d)
        ]
        return torch.stack(
            [sum(Ks[i * d + j] * g[j] for j in range(d)) for i in range(d)]
        )

    def hessian_closed(self, g, p):
        d = self.dim
        K = p.get("K")
        eye = torch.eye(d, dtype=g.dtype, device=g.device)
        if K is None:
            return eye
        if K.shape[-1] == 1:
            return K[0] * eye
        if K.shape[-1] == d:
            return torch.diag(K)
        Km = K.reshape(d, d)
        return 0.5 * (Km + Km.T)


class LinearElasticityEnergy(ADFunction):
    """0.5 lambda (div u)^2 + mu ||sym grad u||^2.

    Input is the flattened gradient gradu[i*dim + j] = d u_i / d x_j
    (component-major).
    """

    def __init__(self, dim: int, lam, mu):
        super().__init__(dim * dim)
        self.dim = dim
        self.add_parameter("lambda", lam)
        self.add_parameter("mu", mu)

    def energy(self, gradu, p):
        d = self.dim
        div = sum(gradu[i * d + i] for i in range(d))
        symsq = 0.0
        for i in range(d):
            for j in range(d):
                s = 0.5 * (gradu[i * d + j] + gradu[j * d + i])
                symsq = symsq + s * s
        return 0.5 * p["lambda"][0] * div * div + p["mu"][0] * symsq

    def gradient_closed(self, gradu, p):
        d = self.dim
        lam, mu = p["lambda"][0], p["mu"][0]
        div = sum(gradu[i * d + i] for i in range(d))
        return torch.stack(
            [
                mu * (gradu[i * d + j] + gradu[j * d + i])
                + (lam * div if i == j else 0.0)
                for i in range(d) for j in range(d)
            ]
        )

    def hessian_closed_entries(self, gradu, p):
        # H_{(ij),(kl)} = lam d_ij d_kl + mu (d_ik d_jl + d_il d_jk):
        # state-independent (the energy is quadratic)
        d = self.dim
        lam, mu = p["lambda"][0], p["mu"][0]
        n = d * d
        rows = []
        for a in range(n):
            i, j = divmod(a, d)
            rows.append([
                lam * float((i == j) and (k == l_))
                + mu * float((i == k) * (j == l_) + (i == l_) * (j == k))
                for k, l_ in (divmod(b, d) for b in range(n))
            ])
        return rows

    def hessian_closed(self, gradu, p):
        return _stack_rows(
            self.hessian_closed_entries(gradu, p), p["lambda"][0]
        )


class NeoHookeanEnergy(ADFunction):
    """Compressible neo-Hookean hyperelasticity
    W = mu/2 (tr(F^T F) - d) - mu log(det F) + lambda/2 log^2(det F),
    F = I + grad u, with the flattened VECTOR|GRAD input layout of
    LinearElasticityEnergy (to which it linearizes at grad u -> 0).
    """

    def __init__(self, dim: int, lam, mu):
        super().__init__(dim * dim)
        self.dim = dim
        self.add_parameter("lambda", lam)
        self.add_parameter("mu", mu)

    def _inv_logj(self, gradu):
        """Flat row-major F, its closed-form inverse, and log det F."""
        d = self.dim
        Fc = [
            gradu[k] + (1.0 if k % (d + 1) == 0 else 0.0)
            for k in range(d * d)
        ]
        if d == 2:
            det = Fc[0] * Fc[3] - Fc[1] * Fc[2]
            r = 1.0 / det
            inv = [Fc[3] * r, -Fc[1] * r, -Fc[2] * r, Fc[0] * r]
        elif d == 3:
            c00 = Fc[4] * Fc[8] - Fc[5] * Fc[7]
            c01 = Fc[5] * Fc[6] - Fc[3] * Fc[8]
            c02 = Fc[3] * Fc[7] - Fc[4] * Fc[6]
            det = Fc[0] * c00 + Fc[1] * c01 + Fc[2] * c02
            r = 1.0 / det
            inv = [
                c00 * r,
                (Fc[2] * Fc[7] - Fc[1] * Fc[8]) * r,
                (Fc[1] * Fc[5] - Fc[2] * Fc[4]) * r,
                c01 * r,
                (Fc[0] * Fc[8] - Fc[2] * Fc[6]) * r,
                (Fc[2] * Fc[3] - Fc[0] * Fc[5]) * r,
                c02 * r,
                (Fc[1] * Fc[6] - Fc[0] * Fc[7]) * r,
                (Fc[0] * Fc[4] - Fc[1] * Fc[3]) * r,
            ]
        else:  # d == 1
            det = Fc[0]
            inv = [1.0 / Fc[0]]
        return Fc, inv, torch.log(det)

    def energy(self, gradu, p):
        d = self.dim
        lam, mu = p["lambda"][0], p["mu"][0]
        Fc = [
            gradu[k] + (1.0 if k % (d + 1) == 0 else 0.0)
            for k in range(d * d)
        ]
        if d == 1:
            det = Fc[0]
        elif d == 2:
            det = Fc[0] * Fc[3] - Fc[1] * Fc[2]
        else:
            det = (
                Fc[0] * (Fc[4] * Fc[8] - Fc[5] * Fc[7])
                + Fc[1] * (Fc[5] * Fc[6] - Fc[3] * Fc[8])
                + Fc[2] * (Fc[3] * Fc[7] - Fc[4] * Fc[6])
            )
        logJ = torch.log(det)
        I1 = sum(c * c for c in Fc)
        return 0.5 * mu * (I1 - d) - mu * logJ + 0.5 * lam * logJ * logJ

    def gradient_closed(self, gradu, p):
        # dW/dF = mu F + (lam logJ - mu) F^{-T}
        d = self.dim
        lam, mu = p["lambda"][0], p["mu"][0]
        Fc, inv, logJ = self._inv_logj(gradu)
        c = lam * logJ - mu
        return torch.stack(
            [
                mu * Fc[i * d + j] + c * inv[j * d + i]
                for i in range(d) for j in range(d)
            ]
        )

    def hessian_closed_entries(self, gradu, p):
        # H_{(ij),(kl)} = mu d_ik d_jl + lam Ft_ij Ft_kl
        #                 + (mu - lam logJ) Finv_jk Finv_li,
        # Ft = F^{-T}: the standard compressible neo-Hookean tangent
        # (dF^{-1}_ab/dF_kl = -F^{-1}_ak F^{-1}_lb, dlogJ/dF = F^{-T}).
        d = self.dim
        lam, mu = p["lambda"][0], p["mu"][0]
        _, inv, logJ = self._inv_logj(gradu)
        c2 = mu - lam * logJ
        n = d * d
        rows = []
        for a in range(n):
            i, j = divmod(a, d)
            row = []
            for b in range(n):
                k, l_ = divmod(b, d)
                h = (
                    lam * inv[j * d + i] * inv[l_ * d + k]
                    + c2 * inv[j * d + k] * inv[l_ * d + i]
                )
                if a == b:
                    h = h + mu
                row.append(h)
            rows.append(row)
        return rows

    def hessian_closed(self, gradu, p):
        return torch.stack(
            [torch.stack(r) for r in self.hessian_closed_entries(gradu, p)]
        )
