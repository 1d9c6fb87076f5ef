"""Proximal Galerkin / LVPP layer: entropies, PG functionals, outer loop.

PyTorch counterpart of ``mfem_ad_tpu.pg``:

- ``PGStepSizeRule``  step-size schedules (constant, polynomial,
  exponential, double exponential), clamped at ``max_alpha``.
- the entropies: dual (conjugate) entropies E* as ``ADFunction``s that
  ``torch.func`` differentiates, in numerically stable forms (Shannon,
  Fermi-Dirac, Hellinger, Simplex).
- ``ADPGFunctional``  the LVPP augmented energy L(u, psi) = f(u) +
  (1/alpha) (u·(psi - psi_k) - E*(psi)); alpha and psi_k are runtime
  fields, so every outer iteration reuses the same integrator.
- ``ADLambdaPGFunctional``  the lambda-variable variant.
- ``PGSolver``  the outer proximal-point loop with the lambda-increment
  stopping rule, checkpoint and resume.
- ``pg_block_preconditioner``  |diag(J)|^-1 for MINRES on the (u, psi)
  saddle system.
"""

from __future__ import annotations

import os
import time
from dataclasses import dataclass

import numpy as np
import torch

from .ad import ADFunction, admax
from .coefficients import GridFunctionCoefficient, ScalarFieldCoefficient
from .convert import vector_from_numpy
from .fespace import FESpace
from .norms import l1_norm
from .solvers import NewtonOptions, jacobi_diagonal, newton
from .utils import profiling
from .utils._host import to_numpy
from .utils.checkpoint import load_checkpoint, save_checkpoint


# ---------------------------------------------------------------------------
# Step-size rules
# ---------------------------------------------------------------------------


class PGStepSizeRule:
    CONSTANT, POLY, EXP, DOUBLE_EXP = range(4)

    def __init__(self, rule_type=0, alpha0=1.0, max_alpha=1e6, ratio=-1.0,
                 ratio2=-1.0):
        self.rule_type = rule_type
        self.alpha0 = alpha0
        self.max_alpha = max_alpha
        self.ratio = ratio
        self.ratio2 = ratio2

    def get(self, it: int) -> float:
        if self.rule_type == self.CONSTANT:
            a = self.alpha0
        elif self.rule_type == self.POLY:
            a = self.alpha0 * (it + 1.0) ** self.ratio
        elif self.rule_type == self.EXP:
            a = self.alpha0 * self.ratio**it
        elif self.rule_type == self.DOUBLE_EXP:
            a = self.alpha0 * self.ratio ** (self.ratio2**it)
        else:
            raise ValueError(f"invalid rule type {self.rule_type}")
        return float(min(a, self.max_alpha))


# ---------------------------------------------------------------------------
# Entropies
# ---------------------------------------------------------------------------


def softplus(x):
    """log(1 + exp(x)) in the branches of the JAX package's softplus
    (max(x, 0) + log1p(exp(-|x|))).  Each branch takes a clamped input,
    so neither overflows and every derivative is finite at any x; unlike
    ``torch.nn.functional.softplus`` there is no linear cut-off, so E*''
    stays positive (not exactly 0) where the mirror map saturates."""
    pos = x > 0
    xp = torch.where(pos, x, 0.0)
    xn = torch.where(pos, 0.0, x)
    return torch.where(pos, xp + torch.log1p(torch.exp(-xp)),
                       torch.log1p(torch.exp(xn)))


class ADEntropy(ADFunction):
    """Marker base for dual (conjugate) entropy functions E*."""


class ShannonEntropy(ADEntropy):
    """E*(psi) = sign*exp(sign*psi) + bound*psi: a one-sided bound;
    sign=+1: [lower, inf); sign=-1: (-inf, upper]."""

    def __init__(self, bound, sign: int = 1):
        super().__init__(1)
        if sign not in (1, -1):
            raise ValueError(f"sign must be 1 or -1, got {sign}")
        self.sign = sign
        self.add_parameter("bound", bound)

    def energy(self, x, p):
        s = self.sign
        return s * torch.exp(x[0] * s) + p["bound"][0] * x[0]


class FermiDiracEntropy(ADEntropy):
    """E*(psi) = softplus(scale*psi) + shift*psi with box bounds [lower,
    upper]; shift = lower, scale = upper - lower."""

    def __init__(self, lower_bound, upper_bound):
        super().__init__(1)
        self.add_parameter("lower", lower_bound)
        self.add_parameter("upper", upper_bound)

    def energy(self, x, p):
        shift = p["lower"][0]
        scale = p["upper"][0] - shift
        return softplus(x[0] * scale) + shift * x[0]


class HellingerEntropy(ADEntropy):
    """E*(psi) = sqrt(1 + scale^2 ||psi||^2): the gradient-norm bound
    ||grad u|| <= bound; scale = the (possibly spatial) bound."""

    def __init__(self, dim: int, bound):
        super().__init__(dim)
        self.add_parameter("bound", bound)

    def energy(self, x, p):
        s = p["bound"][0]
        return torch.sqrt(1.0 + torch.dot(x, x) * (s * s))


class SimplexEntropy(ADEntropy):
    """E*(psi) = scale * logsumexp(psi): the simplex constraint x_i >= 0,
    sum x_i = bound, in the max-shifted stable form (with the
    subgradient-averaging max)."""

    def __init__(self, n_input: int, bound):
        super().__init__(n_input)
        self.add_parameter("bound", bound)

    def energy(self, x, p):
        maxval = x[0]
        for i in range(1, self.n_input):
            maxval = admax(maxval, x[i])
        return p["bound"][0] * (
            maxval + torch.log(torch.sum(torch.exp(x - maxval)))
        )


# ---------------------------------------------------------------------------
# PG functionals
# ---------------------------------------------------------------------------


class ADPGFunctional(ADFunction):
    """LVPP augmented energy over the stacked input [x_f | psi_0 | psi_1 ...]:

        L = f(x) + (1/alpha) * sum_i [ x[primal_idx_i : +m_i]·(psi_i - psi_k_i)
                                       - E*_i(psi_i) ]

    Entropy i couples to the primal slice starting at ``primal_idx[i]``.
    Runtime fields:
      - ``alpha``        the scalar PG step (``ScalarFieldCoefficient``);
      - ``latent_k{i}``  the frozen latent dof vector on
                         ``latent_spaces[i]`` (``GridFunctionCoefficient``).
    An integrator with runtime fields takes the two-stage route.
    """

    def __init__(self, f: ADFunction, entropies, latent_spaces,
                 primal_idx=None):
        if isinstance(entropies, ADEntropy):
            entropies = [entropies]
        if latent_spaces is None or isinstance(latent_spaces, FESpace):
            latent_spaces = [latent_spaces] * len(entropies)
        sizes = [e.n_input for e in entropies]
        super().__init__(f.n_input + sum(sizes))
        self.f = f
        self.entropies = list(entropies)
        self.entropy_size = sizes
        if primal_idx is None:
            primal_idx = [0] * len(entropies)
        self.primal_idx = [int(i) for i in primal_idx]
        self.dual_idx = [
            int(i) for i in
            f.n_input + np.concatenate([[0], np.cumsum(sizes)[:-1]])
        ]
        for i, (pi, m) in enumerate(zip(self.primal_idx, sizes)):
            if f.n_input < pi + m:
                raise ValueError(
                    "ADPGFunctional: primal_idx + entropy size exceeds "
                    f"f.n_input for entropy {i}"
                )
        # merged parameter namespace
        self.params = dict(f.params)
        for i, e in enumerate(entropies):
            for k, c in e.params.items():
                self.params[f"entropy{i}_{k}"] = c
        for i, sp in enumerate(latent_spaces):
            if sp is not None:
                self.params[f"latent_k{i}"] = GridFunctionCoefficient(
                    sp, f"latent_k{i}"
                )
        self.params["alpha"] = ScalarFieldCoefficient("alpha")

    def _entropy_params(self, i, p):
        pre = f"entropy{i}_"
        return {k[len(pre):]: v for k, v in p.items() if k.startswith(pre)}

    def energy(self, x_psi, p):
        x = x_psi[: self.f.n_input]
        alpha = p["alpha"][0]
        cross = 0.0
        dual_sum = 0.0
        for i, e in enumerate(self.entropies):
            m = self.entropy_size[i]
            psi = x_psi[self.dual_idx[i]: self.dual_idx[i] + m]
            psi_k = p[f"latent_k{i}"]
            xi = x[self.primal_idx[i]: self.primal_idx[i] + m]
            cross = cross + torch.dot(xi, psi - psi_k)
            dual_sum = dual_sum + e.energy(psi, self._entropy_params(i, p))
        return self.f.energy(x, p) + (cross - dual_sum) / alpha


class ADLambdaPGFunctional(ADPGFunctional):
    """lambda-variable variant:
    L = f(x) + x·lambda - E*(psi_k + alpha*lambda)/alpha."""

    def energy(self, x_lam, p):
        x = x_lam[: self.f.n_input]
        alpha = p["alpha"][0]
        cross = 0.0
        dual_sum = 0.0
        for i, e in enumerate(self.entropies):
            m = self.entropy_size[i]
            lam = x_lam[self.dual_idx[i]: self.dual_idx[i] + m]
            psi_k = p[f"latent_k{i}"]
            psi = psi_k + alpha * lam
            xi = x[self.primal_idx[i]: self.primal_idx[i] + m]
            cross = cross + torch.dot(xi, lam)
            dual_sum = dual_sum + e.energy(psi, self._entropy_params(i, p))
        return self.f.energy(x, p) + cross - dual_sum / alpha


# ---------------------------------------------------------------------------
# Block preconditioner and outer solver
# ---------------------------------------------------------------------------


def pg_block_preconditioner(form, state):
    """SPD block-diagonal preconditioner |diag(J)|^-1 for MINRES on the
    (u, psi) saddle system (a ``NewtonOptions.preconditioner``), with the
    floor of ``solvers.jacobi_diagonal``."""
    safe = jacobi_diagonal(form.grad_diag(state),
                           getattr(form, "pmax", None))
    return lambda x: x / safe


@dataclass
class PGResult:
    x: object
    converged: bool
    iterations: int
    lambda_diff: float
    newton_iters: list
    lam: object


class PGSolver:
    """Outer LVPP proximal-point loop.

    Each iteration freezes psi_k <- psi, solves the saddle system with
    Newton, forms lambda = (psi - psi_k)/alpha and stops when the L1 norm
    of (lambda - lambda_prev) drops below ``tol``.

    ``newton_accept``: when the inner Newton stagnates above its tolerance
    but at an absolute residual norm at most this, the outer loop goes on
    instead of stopping (the PG iteration re-solves against the new psi_k
    every step, so a bounded inner error perturbs the fixed point rather
    than poisoning it).

    The loop runs unchanged on a ``parallel.ShardedForm`` and a
    ``parallel.HaloShardedForm`` (whose latent block it reads through
    ``canonical``); checkpoints are written by single-process runs only.
    """

    def __init__(
        self,
        form,
        rule: PGStepSizeRule,
        latent_block: int,
        latent_space: FESpace,
        newton_opts: NewtonOptions | None = None,
        max_iter: int = 100,
        tol: float = 1e-10,
        verbose: bool = False,
        checkpoint_path: str | None = None,
        checkpoint_every: int = 1,
        newton_accept: float = 0.0,
    ):
        self.form = form
        self.rule = rule
        self.latent_block = latent_block
        self.latent_space = latent_space
        self.newton_opts = newton_opts or NewtonOptions(
            abs_tol=1e-9, rel_tol=0.0, max_iter=20
        )
        self.max_iter = max_iter
        self.tol = tol
        self.verbose = verbose
        self.checkpoint_path = checkpoint_path
        self.checkpoint_every = checkpoint_every
        self.newton_accept = newton_accept

    def _resume(self):
        """(x, lambda_prev, first iteration) of the latest checkpoint, or
        None when there is none.  A checkpoint written by the JAX
        package's ``PGSolver`` has the same layout and resumes here."""
        path = self.checkpoint_path
        final = path if path.endswith(".npz") else path + ".npz"
        if not os.path.exists(final):
            return None
        arrays, meta = load_checkpoint(path)
        dev, dt = self.form.device, self.form.dtype
        x = vector_from_numpy(arrays["x"], dev, dt)
        lam_prev = (vector_from_numpy(arrays["lam_prev"], dev, dt)
                    if "lam_prev" in arrays else None)
        start = 0
        if meta is not None and "iteration" in meta:
            start = int(meta["iteration"]) + 1
        return x, lam_prev, start

    def solve(self, x0, rhs, fields=None, callback=None,
              resume: bool = False) -> PGResult:
        """Run the outer LVPP loop.  With ``checkpoint_path`` set, the
        state (x, lambda_prev, iteration) is saved every
        ``checkpoint_every`` outer iterations; ``resume=True`` restarts
        from the latest one.  ``callback(it, x, lam)`` runs after every
        outer iteration."""
        fields = dict(fields or {})
        x = x0
        off = self.form.offsets
        s = self.latent_block
        lo, hi = int(off[s]), int(off[s + 1])
        lam_prev = None
        lam = None
        lam_diff = np.inf
        newton_iters = []
        converged = False
        it = 0
        start_it = 0
        distributed = getattr(getattr(self.form, "comm", None),
                              "world_size", 1) > 1
        if distributed and self.checkpoint_path is not None:
            raise ValueError(
                "checkpoints of a distributed form are not written: every "
                "rank would write the same file")
        if hasattr(self.form, "canonical"):
            # a halo form's latent block lives in its ranks' slot blocks:
            # extracted through the canonical layout once per outer
            # iteration (one all-reduce); the fields stay canonical
            def latent_of(xv):
                return self.form.canonical(xv)[lo:hi]
        else:
            def latent_of(xv):
                return xv[lo:hi]
        if resume and self.checkpoint_path is not None:
            state = self._resume()
            if state is not None:
                x, lam_prev, start_it = state
                if self.verbose:
                    print(f"PG resume from iteration {start_it}", flush=True)

        for it in range(start_it, self.max_iter):
            t_it = time.perf_counter()
            alpha = self.rule.get(it)
            psik = latent_of(x)
            fields["alpha"] = alpha
            fields["latent_k0"] = psik
            with profiling.phase("pg/newton"):
                res = newton(self.form, x, rhs, fields, self.newton_opts)
            newton_iters.append(res.iterations)
            if not res.converged:
                if res.final_norm <= self.newton_accept:
                    if self.verbose:
                        print(
                            f"PG it {it+1}: Newton stagnated at "
                            f"||r||={res.final_norm:.3e} <= accept "
                            f"{self.newton_accept:g}; continuing",
                            flush=True,
                        )
                else:
                    if self.verbose:
                        print(
                            f"PG it {it+1}: Newton FAILED after "
                            f"{res.iterations} its "
                            f"(||r||={res.final_norm:.3e})",
                            flush=True,
                        )
                    break
            x = res.x
            lam = (latent_of(x) - psik) / alpha
            if lam_prev is not None:
                with profiling.phase("pg/lambda_norm"):
                    lam_diff = float(
                        l1_norm(self.latent_space, to_numpy(lam - lam_prev))
                    )
            if self.verbose:
                lin = (f" lin={sum(res.lin_iters)}"
                       if res.lin_iters else "")
                print(
                    f"PG it {it+1}: alpha={alpha:.4g} newton={res.iterations}"
                    f"{lin} |lam diff|_L1={lam_diff:.3e} "
                    f"[{time.perf_counter() - t_it:.1f}s]",
                    flush=True,
                )
            if callback is not None:
                callback(it, x, lam)
            if self.checkpoint_path is not None and (
                it % self.checkpoint_every == 0
            ):
                with profiling.phase("pg/checkpoint"):
                    save_checkpoint(
                        self.checkpoint_path, {"x": x, "lam_prev": lam},
                        meta={"iteration": it, "alpha": float(alpha),
                              "lam_diff": float(lam_diff)},
                    )
            profiling.step()
            if lam_diff < self.tol:
                converged = True
                break
            lam_prev = lam
        return PGResult(
            x=x,
            converged=converged,
            iterations=it + 1,
            lambda_diff=lam_diff,
            newton_iters=newton_iters,
            lam=lam,
        )
