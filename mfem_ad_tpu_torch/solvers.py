"""Matrix-free preconditioned CG, GMRES and MINRES, and an
MFEM-NewtonSolver-style Newton.

PyTorch counterpart of ``mfem_ad_tpu.solvers`` (``cg``, ``gmres``,
``minres``, the Schur elimination of the LVPP saddle system
``schur_solve`` / ``make_pg_schur_solver``, ``newton`` with ``lin_solver``
"cg", "gmres", "minres", "dense", "schur" or a callable).  ``newton``
solves ``form.mult(x, fields) = b``: it solves J c = r with r = mult(x) -
b, updates x <- x - d c, and converges on ||r|| <= max(rel_tol*||r0||,
abs_tol).
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

from .utils import profiling


# CG and MINRES read their stopping test back to the host every this many
# iterations
_CHECK_EVERY = 16


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


def minres(matvec, b, x0=None, M=None, tol=1e-10, maxiter=1000,
           stall_window=200):
    """Preconditioned MINRES (Paige-Saunders) for symmetric, possibly
    indefinite systems; ``M`` must be SPD.  Stops when the residual
    estimate phibar <= tol*||b||, after ``maxiter`` iterations, or at the
    floor exit: every ``stall_window`` iterations phibar (monotone in
    MINRES) must have dropped by at least 1% (``None`` disables it).

    The loop state stays on the device and is updated only while the
    stopping test holds, as in ``cg``; the host reads the test back every
    ``_CHECK_EVERY`` iterations.

    Returns (x, iterations).
    """
    dt, dev = b.dtype, b.device
    if M is None:
        M = lambda v: v  # noqa: E731
    x = torch.zeros_like(b) if x0 is None else x0
    tiny = torch.finfo(dt).tiny
    target = tol * torch.clamp(torch.linalg.vector_norm(b), min=1e-30)
    window = maxiter + 1 if stall_window is None else min(stall_window, maxiter)

    def scalar(v):
        return torch.full((), v, dtype=dt, device=dev)

    r1 = b - matvec(x)
    y = M(r1)
    beta = torch.sqrt(torch.abs(torch.dot(r1, y)))
    r2 = r1
    oldb, dbar, epsln = scalar(0.0), scalar(0.0), scalar(0.0)
    phibar, cs, sn = beta, scalar(-1.0), scalar(0.0)
    w = torch.zeros_like(b)
    w2 = torch.zeros_like(b)
    mark = beta
    stall = torch.zeros((), dtype=torch.bool, device=dev)
    k = torch.zeros((), dtype=torch.int64, device=dev)
    for i in range(maxiter):
        active = (phibar > target) & ~stall
        if i % _CHECK_EVERY == 0 and not bool(active):
            break
        bsafe = torch.where(beta == 0, 1.0, beta)
        v = y / bsafe
        yv = matvec(v)
        if i > 0:
            yv = yv - (beta / torch.where(oldb == 0, 1.0, oldb)) * r1
        alfa = torch.dot(v, yv)
        yv = yv - (alfa / bsafe) * r2
        yn = M(yv)
        beta_n = torch.sqrt(torch.abs(torch.dot(yv, yn)))
        delta = cs * dbar + sn * alfa
        gbar = sn * dbar - cs * alfa
        gamma = torch.sqrt(gbar * gbar + beta_n * beta_n)
        gamma = torch.where(gamma == 0, tiny, gamma)
        cs_n = gbar / gamma
        sn_n = beta_n / gamma
        phibar_n = sn_n * phibar
        wn = (v - epsln * w2 - delta * w) / gamma

        def keep(new, old):
            return torch.where(active, new, old)

        if (i + 1) % window == 0:
            stall = keep(phibar_n > mark * (1.0 - 1e-2), stall)
            mark = keep(phibar_n, mark)
        # one MINRES step where active, else the state unchanged
        x, r1, r2, y, w, w2 = (keep(x + (cs_n * phibar) * wn, x),
                               keep(r2, r1), keep(yv, r2), keep(yn, y),
                               keep(wn, w), keep(w, w2))
        oldb, beta = keep(beta, oldb), keep(beta_n, beta)
        dbar, epsln = keep(-cs * beta_n, dbar), keep(sn * beta_n, epsln)
        phibar, cs, sn = keep(phibar_n, phibar), keep(cs_n, cs), keep(sn_n, sn)
        k = k + active.to(torch.int64)
    return x, int(k)


# ---------------------------------------------------------------------------
# Schur-complement solver for (u, psi) saddle systems with an L2 latent
# ---------------------------------------------------------------------------


def _schur_arrays(form, state, reg: float, jacobi: bool):
    """The array pieces of the Schur reduction, once per Newton direction:
    the inverse latent element blocks ``De_inv`` and, with ``jacobi``, the
    condensed Jacobi diagonal ``safe`` and the reaction diagonal
    ``dshift`` = diag(C D^-1 C^T) on the primal block (zero at essential
    dofs), the shift of the V-cycle."""
    intg, Hq = form.integrators[0], state[0]
    t = intg.tables
    off = form.offsets
    lb = len(off) - 2
    ub = lb - 1
    n0 = int(off[lb])
    out = {}
    De = -intg.element_matrices(Hq, lb, lb)  # [ne, ndl, ndl]
    ndl = De.shape[1]
    # E*'' underflows where the mirror map saturates (the active set),
    # making D_e numerically singular; a relative shift keeps the condensed
    # system solvable.  Its size is load-bearing: near the Newton solution
    # the true step stays O(1e2) even at ||r|| ~ 1e-6, and a too-small
    # shift amplifies solve noise by 1/(reg*dmax) into a divergent step
    # (the JAX package measured reg = 1e-10 against a dense solve: relative
    # step error 1.1e+2; reg = 1e-6 with one refinement pass: 4e-5).  The
    # absolute mass-scaled floor guards blocks that flush to exactly zero.
    dmax = torch.max(torch.abs(De))
    eye = torch.eye(ndl, dtype=De.dtype, device=De.device)
    Bl = t["B"][lb][..., 0]  # [1|ne, nq, ndl] latent VALUE shapes
    Me = torch.einsum("eqd,eqk,eq->edk", Bl, Bl, t["w"])
    out["De_inv"] = torch.linalg.inv(De + (reg * dmax) * eye + 1e-20 * Me)
    if jacobi:
        # diag(S) = diag(A) + diag(C D^-1 C^T); the second term dominates
        # as alpha grows (D ~ E*''/alpha -> 0 on the active set)
        d_full = torch.abs(form.grad_diag(state))
        ess_u = form.ess_mask[:n0]
        Ce = intg.element_matrices(Hq, ub, lb)  # [ne, nde_u, ndl]
        ne = Ce.shape[0]
        sp_u = form.spaces[ub]
        dS = torch.einsum("eij,ejk,eik->ei", Ce, out["De_inv"], Ce)
        # byNODES flat rows (v, d) = v*nd + d -> [ne, nd, vdim] to scatter
        dS3 = dS.reshape(ne, sp_u.vdim, sp_u.nd).permute(0, 2, 1)
        dS_nodes = intg.scatter(ub, dS3)
        d = d_full[:n0] + dS_nodes
        out["dshift"] = torch.where(ess_u, 0.0, dS_nodes)
        out["safe"] = torch.where(d < 1e-30, 1.0, d)
    return out


def schur_solve(form, state, r, tol: float, maxiter: int, reg: float = 1e-6,
                jacobi: bool = True, refine: int = 1, fp=None):
    """Schur reduction of the 2-block LVPP saddle Jacobian [[A, C], [C^T,
    -D]] whose latent block D is element-block-diagonal (an L2 latent:
    its dofs never couple across elements).  The latent is eliminated
    exactly,

        (A + C D^-1 C^T) du = r_u + C D^-1 r_psi,
        dpsi = D^-1 (C^T du - r_psi),

    and the SPD condensed system is solved by CG, preconditioned (with
    ``jacobi``) by its Jacobi diagonal or, with ``fp`` (a
    ``multigrid.PGSchurGMG``), by the V-cycle shifted by the reaction
    diagonal.  The latent blocks are regularized (``reg`` times their
    largest entry) so the solve is range-safe where the mirror map
    saturates; ``refine`` passes of iterative refinement against the true
    Jacobian remove the O(reg) direction error.

    Returns (dx, CG iterations summed over the solve and its refinement
    passes).  A latent space that is not L2 needs the lumped Schur
    complement, which is not ported.
    """
    if form.spaces[-1].fe_type != "L2":
        raise NotImplementedError(
            "the lumped Schur direction for a non-L2 latent (ex5's H1 "
            "latent) is not ported yet (ROADMAP A5)"
        )
    if fp is not None and not hasattr(fp, "apply_primal"):
        raise ValueError(
            f"lin_solver='schur' takes a multigrid.PGSchurGMG "
            f"preconditioner (or none, or 'jacobi'), not {type(fp).__name__}"
        )
    arrays = _schur_arrays(form, state, reg, jacobi)
    De_inv = arrays["De_inv"]
    ne, ndl = De_inv.shape[0], De_inv.shape[1]
    n0 = int(form.offsets[-2])
    n1 = form.ndof - n0

    def Dinv(w):  # L2 dofs are element-contiguous: a pure reshape
        return torch.einsum("eij,ej->ei", De_inv, w.reshape(ne, ndl)
                            ).reshape(-1)

    def pad_u(v):
        return torch.cat([v, torch.zeros(n1, dtype=v.dtype, device=v.device)])

    def pad_p(w):
        return torch.cat([torch.zeros(n0, dtype=w.dtype, device=w.device), w])

    def mv(v):
        return form.grad_mult(state, v)

    def S(v):
        Jv = mv(pad_u(v))
        Av, Ctv = Jv[:n0], Jv[n0:]
        return Av + mv(pad_p(Dinv(Ctv)))[:n0]

    M = None
    if jacobi and fp is not None:
        # the V-cycle on A + diag(C D^-1 C^T): it handles both the
        # diffusion-dominated dofs and the alpha-amplified reaction
        sdata = fp.shift_data(arrays["dshift"])
        M = lambda v: fp.apply_primal(v, sdata)  # noqa: E731
    elif jacobi:
        safe = arrays["safe"]
        M = lambda v: v / safe  # noqa: E731

    def solve_reg(rr):
        r_u, r_p = rr[:n0], rr[n0:]
        rhs = r_u + mv(pad_p(Dinv(r_p)))[:n0]
        du, k = cg(S, rhs, M=M, tol=tol, maxiter=maxiter)
        dp = Dinv(mv(pad_u(du))[n0:] - r_p)
        return torch.cat([du, dp]), k

    dx, its = solve_reg(r)
    for _ in range(refine):
        d1, k = solve_reg(r - mv(dx))
        dx = dx + d1
        its += k
    return dx, its


def _check_schur_form(form, latent_block: int = 1):
    """The refusals of the Schur direction: it needs a 2-block (primal,
    latent-last) system, element-block access and no essential dofs on
    the latent block."""
    off = form.offsets
    if len(off) != 3 or latent_block != len(off) - 2:
        raise ValueError(
            "lin_solver='schur' needs a 2-block (primal, latent) system "
            f"with the latent block last; got {len(off) - 1} blocks, "
            f"latent_block={latent_block}"
        )
    if not hasattr(form, "integrators"):
        raise ValueError(
            "lin_solver='schur' needs element-block access "
            "(BlockNonlinearForm)"
        )
    if bool(form.ess_mask[int(off[1]):].any()):
        raise ValueError(
            "lin_solver='schur' requires no essential dofs on the latent "
            "block"
        )


def make_pg_schur_solver(latent_block: int = 1, tol: float = 1e-12,
                         maxiter: int = 2000, jacobi: bool = True,
                         reg: float = 1e-6):
    """Exact Schur reduction of the LVPP saddle Jacobian as a callable
    ``NewtonOptions.lin_solver`` (``schur_solve`` with Jacobi-CG).  The
    form must have one integrator and an L2 latent block last."""

    def solve(form, state, r):
        _check_schur_form(form, latent_block)
        return schur_solve(form, state, r, tol, maxiter, reg, jacobi)[0]

    return solve


# ---------------------------------------------------------------------------
# Newton
# ---------------------------------------------------------------------------


@dataclass
class NewtonOptions:
    abs_tol: float = 1e-12
    rel_tol: float = 0.0
    max_iter: int = 100
    damping: float = 1.0  # MFEM's c scaling factor of the step
    # "cg" | "gmres" | "minres" | "dense" | callable(form, state, r) -> c
    lin_solver: object = "cg"
    lin_tol: float = 1e-12
    lin_maxiter: int = 2000
    # cg's and minres's floor exit: iterations per required 1% drop of
    # the monitored residual; None runs them to lin_tol or lin_maxiter
    lin_stall_window: int | None = 200
    preconditioner: object = None  # None | "jacobi" | callable(form, state)
    verbose: bool = False
    # consecutive <5% residual reductions after which Newton counts as
    # floored and stops unconverged; None disables the exit
    stall_iters: int | None = 2


@dataclass
class NewtonResult:
    x: object
    converged: bool
    iterations: int
    final_norm: float
    history: list = field(default_factory=list)
    lin_iters: list = field(default_factory=list)  # Krylov its per step


_KRYLOV = ("cg", "gmres", "minres")


def _residual(form, x, b, fields):
    return torch.where(form.ess_mask, 0.0, form.mult(x, fields) - b)


def _make_precond(form, state, spec):
    if spec is None:
        return None
    if spec == "jacobi":
        # |diag| keeps the preconditioner SPD on indefinite systems, so
        # it serves MINRES as well as CG
        d = torch.abs(form.grad_diag(state))
        safe = torch.where(d < 1e-30, 1.0, d)
        return lambda v: v / safe
    return spec(form, state)


def dense_solve(A, r):
    """c = A^-1 r by LU (``solve_ex``, whose ``info`` is read instead of
    raising); where the LU is singular or its solution is not finite or
    more than 1e12 x max|r|, the minimum-norm least-squares solution with
    singular values below 1e-10 x the largest cut (the reference's
    ``lstsq(rcond=1e-10)``)."""
    c, info = torch.linalg.solve_ex(A, r)
    tiny = torch.finfo(r.dtype).tiny
    bad = ((info != 0) | ~torch.isfinite(c).all()
           | (c.abs().max() > 1e12 * (r.abs().max() + tiny)))
    if bool(bad):
        c = torch.linalg.pinv(A, rtol=1e-10) @ r
    return c


def _direction(form, x, b, fields, opts: NewtonOptions):
    """Newton direction c of J c = r (residual, Jacobian state, linear
    solve); returns (c, Krylov iterations or None).

    A preconditioner factory that carries ``fused_precond`` (the
    ``multigrid`` preconditioners) is asked for the direction's
    preconditioner at the iterate: a GMG's finest level takes the Newton
    state and a nonlinear GMG re-linearizes every level at ``x``.  The
    Schur direction takes it as its condensed-system preconditioner."""
    r = _residual(form, x, b, fields)
    state = form.grad_state(x, fields)
    fp = getattr(opts.preconditioner, "fused_precond", None)
    if opts.lin_solver == "schur":
        return schur_solve(form, state, r, opts.lin_tol, opts.lin_maxiter,
                           fp=fp)
    if opts.lin_solver == "dense":
        return dense_solve(form.assemble_dense(state), r), None
    if callable(opts.lin_solver):
        return opts.lin_solver(form, state, r), None
    if fp is not None:
        M = fp.newton_precond(form, x, state, fields)
    else:
        M = _make_precond(form, state, opts.preconditioner)
    mv = lambda v: form.grad_mult(state, v)  # noqa: E731
    if opts.lin_solver == "gmres":
        return gmres(mv, r, M=M, tol=opts.lin_tol, maxiter=opts.lin_maxiter)
    solve = cg if opts.lin_solver == "cg" else minres
    return solve(mv, r, M=M, tol=opts.lin_tol, maxiter=opts.lin_maxiter,
                 stall_window=opts.lin_stall_window)


def _apply_step(form, x, c, b, fields, norm, opts):
    """``x - d*c`` with a backtracking safeguard: halve ``d =
    opts.damping`` (up to 4 times) while the step increases the residual
    norm, and keep the least-bad candidate if every damping fails; returns
    ``x`` itself when every candidate's residual is NaN."""
    with profiling.phase("newton/line_search"):
        return _apply_step_impl(form, x, c, b, fields, norm, opts)


def _apply_step_impl(form, x, c, b, fields, norm, opts):
    d = opts.damping
    best_x, best_n = None, np.inf
    for _ in range(5):
        xn = x - d * c
        nn = float(torch.linalg.vector_norm(_residual(form, xn, b, fields)))
        if nn <= norm * (1.0 + 1e-10):
            return xn
        if nn < best_n:
            best_x, best_n = xn, nn
        d *= 0.5
    return x if best_x is None else best_x


def newton(form, x0, b=None, fields=None, opts: NewtonOptions | None = None):
    """MFEM-NewtonSolver-style damped Newton on ``form.mult(x, fields) =
    b``; the direction comes from ``opts.lin_solver``: a matrix-free
    Krylov solve ("cg", "gmres", "minres"; preconditioned per
    ``opts.preconditioner``), the dense direct solve of the assembled
    Jacobian ("dense", ``dense_solve``), the exact Schur elimination of an
    LVPP saddle system with an L2 latent ("schur", ``schur_solve``;
    ``lin_iters`` counts its CG iterations, refinement pass included), or
    a callable ``(form, state, r) -> c``."""
    opts = opts or NewtonOptions()
    if not (callable(opts.lin_solver)
            or opts.lin_solver in _KRYLOV + ("dense", "schur")):
        raise ValueError(f"unknown lin_solver {opts.lin_solver!r}")
    if opts.lin_solver == "schur":
        _check_schur_form(form)
    if not (opts.preconditioner in (None, "jacobi")
            or callable(opts.preconditioner)):
        raise ValueError(f"unknown preconditioner {opts.preconditioner!r}")
    fields = fields or {}
    x = x0
    b = torch.zeros_like(x) if b is None else b.to(x.dtype)

    hist, lin_iters = [], []
    norm0 = None
    it = 0
    converged = False
    norm = np.inf
    stalled = 0
    for it in range(opts.max_iter + 1):
        with profiling.phase("newton/residual"):
            norm = float(torch.linalg.vector_norm(
                _residual(form, x, b, fields)))
        hist.append(norm)
        if norm0 is None:
            norm0 = norm
        if opts.verbose:
            print(f"  newton it {it:3d}: ||r|| = {norm:.6e}", flush=True)
        if norm <= max(opts.rel_tol * norm0, opts.abs_tol):
            converged = True
            break
        if it == opts.max_iter:
            break
        # consecutive <5% reductions: Newton has floored
        stalled = stalled + 1 if it > 0 and norm > 0.95 * hist[-2] else 0
        if opts.stall_iters is not None and stalled >= opts.stall_iters:
            break
        with profiling.phase("newton/direction", sync=x):
            c, li = _direction(form, x, b, fields, opts)
        if li is not None:
            lin_iters.append(li)
        xn = _apply_step(form, x, c, b, fields, norm, opts)
        if xn is x:
            break
        x = xn

    return NewtonResult(
        x=x, converged=converged, iterations=it, final_norm=norm,
        history=hist, lin_iters=lin_iters,
    )
