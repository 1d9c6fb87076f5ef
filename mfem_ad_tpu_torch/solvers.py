"""Matrix-free preconditioned CG and an MFEM-NewtonSolver-style Newton.

PyTorch counterpart of ``mfem_ad_tpu.solvers`` (``cg``, ``newton`` with
``lin_solver="cg"``).  ``newton`` solves ``form.mult(x) = b``: it solves
J c = r with r = mult(x) - b, updates x <- x - c, and converges on
||r|| <= max(rel_tol*||r0||, abs_tol).
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch


# CG reads its stopping test back to the host every this many iterations
_CHECK_EVERY = 16
# consecutive <5% residual reductions after which Newton counts as floored
_STALL_ITERS = 2


def _safe_div(num, den):
    """num / den, or 0 where den == 0."""
    return torch.where(den != 0, num / torch.where(den == 0, 1.0, den), 0.0)


def cg(matvec, b, x0=None, M=None, tol=1e-10, atol=0.0, maxiter=1000,
       stall_window=200):
    """Preconditioned CG with division guards and a normalized RHS.

    Solves for b/||b|| so the monitored quantities stay O(1); every
    division is guarded (a zero denominator stops progress instead of
    poisoning the iterate).  Floor exit: every ``stall_window`` iterations
    the best residual must have dropped by at least 1%, else CG stops
    (``stall_window=None`` disables it).

    The loop state stays on the device.  Each iteration updates it only
    while the stopping test still holds, so the iterate equals that of a
    loop that stops exactly on time; the host reads the test back every
    ``_CHECK_EVERY`` iterations.

    Returns (x, iterations).
    """
    norm_b = torch.linalg.vector_norm(b)
    bsafe = torch.where(norm_b == 0, 1.0, norm_b)
    bn = b / bsafe
    if M is None:
        M = lambda v: v  # noqa: E731
    x = torch.zeros_like(b) if x0 is None else x0 / bsafe
    target2 = torch.clamp(atol / bsafe, min=tol) ** 2  # vs ||r||/||b||
    window = maxiter + 1 if stall_window is None else min(stall_window, maxiter)

    r = bn - matvec(x)
    z = M(r)
    p = z
    gamma = torch.dot(r, z)
    rs = torch.dot(r, r)
    best = rs
    mark = rs
    stall = torch.zeros((), dtype=torch.bool, device=b.device)
    k = torch.zeros((), dtype=torch.int64, device=b.device)
    for i in range(maxiter):
        active = (rs > target2) & (gamma != 0) & ~stall
        if i % _CHECK_EVERY == 0 and not bool(active):
            break
        Ap = matvec(p)
        alpha = _safe_div(gamma, torch.dot(p, Ap))
        x = torch.where(active, x + alpha * p, x)
        r = torch.where(active, r - alpha * Ap, r)
        z = M(r)
        gamma_new = torch.dot(r, z)
        beta = _safe_div(gamma_new, gamma)
        p = torch.where(active, z + beta * p, p)
        gamma = torch.where(active, gamma_new, gamma)
        rs = torch.dot(r, r)
        best = torch.where(active, torch.minimum(best, rs), best)
        at_window = (i + 1) % window == 0
        stall = torch.where(
            active, at_window & (best > mark * (1.0 - 1e-2)), stall
        )
        if at_window:
            mark = torch.where(active, best, mark)
        k = k + active.to(torch.int64)
    return x * bsafe, int(k)


# ---------------------------------------------------------------------------
# Newton
# ---------------------------------------------------------------------------


@dataclass
class NewtonOptions:
    abs_tol: float = 1e-12
    rel_tol: float = 0.0
    max_iter: int = 100
    lin_solver: str = "cg"
    lin_tol: float = 1e-12
    lin_maxiter: int = 2000
    # cg's floor exit: iterations per required 1% drop of the best
    # residual; None runs CG to lin_tol or lin_maxiter
    lin_stall_window: int | None = 200
    preconditioner: object = None  # None | "jacobi"


@dataclass
class NewtonResult:
    x: object
    converged: bool
    iterations: int
    final_norm: float
    history: list = field(default_factory=list)
    lin_iters: list = field(default_factory=list)  # CG iterations per step


def _residual_norm(form, x, b) -> float:
    r = torch.where(form.ess_mask, 0.0, form.mult(x) - b)
    return float(torch.linalg.vector_norm(r))


def _direction(form, x, b, opts: NewtonOptions):
    """Newton direction c of J c = r (residual, Jacobian state, Krylov
    solve); returns (c, CG iterations)."""
    r = torch.where(form.ess_mask, 0.0, form.mult(x) - b)
    state = form.grad_state(x)
    M = None
    if opts.preconditioner == "jacobi":
        # |diag| keeps the preconditioner SPD on indefinite systems
        d = torch.abs(form.grad_diag(state))
        safe = torch.where(d < 1e-30, 1.0, d)
        M = lambda v: v / safe  # noqa: E731
    return cg(
        lambda v: form.grad_mult(state, v), r, M=M, tol=opts.lin_tol,
        maxiter=opts.lin_maxiter, stall_window=opts.lin_stall_window,
    )


def _apply_step(form, x, c, b, norm):
    """``x - d*c`` with a backtracking safeguard: halve ``d = 1`` (up to 4
    times) while the step increases the residual norm, and keep the least-
    bad candidate if every damping fails; returns ``x`` itself when every
    candidate's residual is NaN."""
    d = 1.0
    best_x, best_n = None, np.inf
    for _ in range(5):
        xn = x - d * c
        nn = _residual_norm(form, xn, b)
        if nn <= norm * (1.0 + 1e-10):
            return xn
        if nn < best_n:
            best_x, best_n = xn, nn
        d *= 0.5
    return x if best_x is None else best_x


def newton(form, x0, b=None, opts: NewtonOptions | None = None):
    """MFEM-NewtonSolver-style damped Newton on ``form.mult(x) = b`` with
    a Jacobi-preconditioned matrix-free CG direction."""
    opts = opts or NewtonOptions()
    if opts.lin_solver != "cg":
        raise NotImplementedError(f"lin_solver={opts.lin_solver!r}: only 'cg'")
    if opts.preconditioner not in (None, "jacobi"):
        raise ValueError(f"unknown preconditioner {opts.preconditioner!r}")
    x = x0
    b = torch.zeros_like(x) if b is None else b.to(x.dtype)

    hist, lin_iters = [], []
    norm0 = None
    it = 0
    converged = False
    norm = np.inf
    stalled = 0
    for it in range(opts.max_iter + 1):
        norm = _residual_norm(form, x, b)
        hist.append(norm)
        if norm0 is None:
            norm0 = norm
        if norm <= max(opts.rel_tol * norm0, opts.abs_tol):
            converged = True
            break
        if it == opts.max_iter:
            break
        # two consecutive <5% reductions: Newton has floored
        stalled = stalled + 1 if it > 0 and norm > 0.95 * hist[-2] else 0
        if stalled >= _STALL_ITERS:
            break
        c, li = _direction(form, x, b, opts)
        lin_iters.append(li)
        xn = _apply_step(form, x, c, b, norm)
        if xn is x:
            break
        x = xn

    return NewtonResult(
        x=x, converged=converged, iterations=it, final_norm=norm,
        history=hist, lin_iters=lin_iters,
    )
