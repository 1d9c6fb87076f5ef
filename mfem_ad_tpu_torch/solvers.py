"""Matrix-free preconditioned CG and GMRES, and an MFEM-NewtonSolver-style
Newton.

PyTorch counterpart of ``mfem_ad_tpu.solvers`` (``cg``, ``gmres``,
``newton`` with ``lin_solver="cg"`` or ``"gmres"``).  ``newton`` solves
``form.mult(x) = b``: it solves J c = r with r = mult(x) - b, updates
x <- x - c, and converges on ||r|| <= max(rel_tol*||r0||, abs_tol).
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


def gmres(matvec, b, x0=None, M=None, tol=1e-10, atol=0.0, maxiter=1000,
          restart=50):
    """Restarted, left-preconditioned GMRES with Givens rotations and
    guarded divisions.

    Solves for b/||b||; ``M`` approximates A^-1 and the monitored residual
    is the preconditioned one (as in MFEM's GMRESSolver).  Each Arnoldi
    cycle orthogonalises by classical Gram-Schmidt twice; a zero Arnoldi
    norm is a happy breakdown that ends the cycle, and a zero denominator
    anywhere stops progress instead of poisoning the iterate.  A restart
    cycle that improves the residual by less than 0.1% ends the solve.

    Returns (x, iterations).
    """
    dt, dev = b.dtype, b.device
    n = b.shape[0]
    norm_b = torch.linalg.vector_norm(b)
    bscale = torch.where(norm_b == 0, 1.0, norm_b)
    bn = b / bscale
    if M is None:
        M = lambda v: v  # noqa: E731
    x = torch.zeros_like(b) if x0 is None else x0 / bscale
    target = max(tol, float(atol / bscale))
    m = int(max(1, min(restart, maxiter)))

    def cycle(x):
        """One Arnoldi cycle from iterate x; returns (x', res, its)."""
        r0 = M(bn - matvec(x))
        beta = torch.linalg.vector_norm(r0)
        V = torch.zeros((m + 1, n), dtype=dt, device=dev)
        V[0] = _safe_div(r0, beta)
        H = torch.zeros((m + 1, m), dtype=dt, device=dev)
        cs = torch.ones(m, dtype=dt, device=dev)
        sn = torch.zeros(m, dtype=dt, device=dev)
        g = torch.zeros(m + 1, dtype=dt, device=dev)
        g[0] = beta
        res = float(beta)
        j = 0
        while j < m and res > target:
            w = M(matvec(V[j]))
            # CGS2: classical Gram-Schmidt, twice (orthogonality to ~eps)
            h = V[:j + 1] @ w
            w = w - h @ V[:j + 1]
            h2 = V[:j + 1] @ w
            w = w - h2 @ V[:j + 1]
            hn = torch.linalg.vector_norm(w)
            hcol = torch.zeros(m + 1, dtype=dt, device=dev)
            hcol[:j + 1] = h + h2
            hcol[j + 1] = hn
            for i in range(j):  # the previous rotations
                hi, hi1 = hcol[i].clone(), hcol[i + 1].clone()
                hcol[i] = cs[i] * hi + sn[i] * hi1
                hcol[i + 1] = -sn[i] * hi + cs[i] * hi1
            hj, hj1 = hcol[j].clone(), hcol[j + 1].clone()
            den = torch.sqrt(hj * hj + hj1 * hj1)
            cs[j] = torch.where(den == 0, 1.0, _safe_div(hj, den))
            sn[j] = _safe_div(hj1, den)
            hcol[j] = den
            hcol[j + 1] = 0.0
            gj = g[j].clone()
            g[j] = cs[j] * gj
            g[j + 1] = -sn[j] * gj
            H[:, j] = hcol
            res = float(torch.abs(sn[j] * gj))
            V[j + 1] = _safe_div(w, hn)
            j += 1
            if float(hn) == 0:
                break  # happy breakdown
        # back-substitute the j x j triangular system R y = g
        y = torch.zeros(m, dtype=dt, device=dev)
        for i in range(j - 1, -1, -1):
            y[i] = _safe_div(g[i] - H[i] @ y, H[i, i])
        return x + y @ V[:m], res, j

    res_prev = np.inf
    total = 0
    while True:
        x, res, jdone = cycle(x)
        total += max(jdone, 1)
        # a cycle that made < 0.1% progress is at its floor
        if (res <= target or total >= maxiter or jdone == 0
                or res > res_prev * (1.0 - 1e-3)):
            break
        res_prev = res
    return x * bscale, total


# ---------------------------------------------------------------------------
# Newton
# ---------------------------------------------------------------------------


@dataclass
class NewtonOptions:
    abs_tol: float = 1e-12
    rel_tol: float = 0.0
    max_iter: int = 100
    lin_solver: str = "cg"  # "cg" or "gmres"
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
    lin_iters: list = field(default_factory=list)  # Krylov its per step


def _residual_norm(form, x, b) -> float:
    r = torch.where(form.ess_mask, 0.0, form.mult(x) - b)
    return float(torch.linalg.vector_norm(r))


def _direction(form, x, b, opts: NewtonOptions):
    """Newton direction c of J c = r (residual, Jacobian state, Krylov
    solve); returns (c, Krylov iterations)."""
    r = torch.where(form.ess_mask, 0.0, form.mult(x) - b)
    state = form.grad_state(x)
    M = None
    if opts.preconditioner == "jacobi":
        # |diag| keeps the preconditioner SPD on indefinite systems
        d = torch.abs(form.grad_diag(state))
        safe = torch.where(d < 1e-30, 1.0, d)
        M = lambda v: v / safe  # noqa: E731
    mv = lambda v: form.grad_mult(state, v)  # noqa: E731
    if opts.lin_solver == "gmres":
        return gmres(mv, r, M=M, tol=opts.lin_tol, maxiter=opts.lin_maxiter)
    return cg(mv, r, M=M, tol=opts.lin_tol, maxiter=opts.lin_maxiter,
              stall_window=opts.lin_stall_window)


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
    a matrix-free Krylov direction (``opts.lin_solver``: "cg" or
    "gmres"), optionally Jacobi-preconditioned."""
    opts = opts or NewtonOptions()
    if opts.lin_solver not in ("cg", "gmres"):
        raise NotImplementedError(
            f"lin_solver={opts.lin_solver!r}: only 'cg' and 'gmres'")
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
