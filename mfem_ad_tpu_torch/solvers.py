"""Matrix-free preconditioned CG, GMRES and MINRES, and an
MFEM-NewtonSolver-style Newton.

PyTorch counterpart of ``mfem_ad_tpu.solvers`` (``cg``, ``gmres``,
``minres``, the directions of the LVPP saddle system: the exact Schur
elimination of an L2 latent ``schur_solve`` / ``make_pg_schur_solver``,
and for any other latent ``lumped_schur_solve``, LDU-preconditioned FGMRES
with a GMG or block-diagonal MINRES without one; ``newton`` with
``lin_solver`` "cg", "gmres", "minres", "dense", "schur" or a callable).  ``newton``
solves ``form.mult(x, fields) = b``: it solves J c = r with r = mult(x) -
b, updates x <- x - d c, and converges on ||r|| <= max(rel_tol*||r0||,
abs_tol).
"""

from __future__ import annotations

from dataclasses import dataclass, field

import os

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
       stall_window=200, dot=None, norm=None):
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

    ``dot`` and ``norm`` (default ``torch.dot`` and the 2-norm) are the
    inner product and norm of the vectors: a distributed form's own
    (``HaloShardedForm``), whose scalars every rank gets alike.

    Returns (x, iterations).
    """
    dot = dot or torch.dot
    norm = norm or torch.linalg.vector_norm
    norm_b = norm(b)
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
    gamma = dot(r, z)
    rs = dot(r, r)
    best = rs
    mark = rs
    stall = torch.zeros((), dtype=torch.bool, device=b.device)
    k = torch.zeros((), dtype=torch.int64, device=b.device)
    for i in range(maxiter):
        active = (rs > target2) & (gamma != 0) & ~stall
        if i % _CHECK_EVERY == 0 and not bool(active):
            break
        Ap = matvec(p)
        alpha = _safe_div(gamma, dot(p, Ap))
        x = torch.where(active, x + alpha * p, x)
        r = torch.where(active, r - alpha * Ap, r)
        z = M(r)
        gamma_new = dot(r, z)
        beta = _safe_div(gamma_new, gamma)
        p = torch.where(active, z + beta * p, p)
        gamma = torch.where(active, gamma_new, gamma)
        rs = dot(r, r)
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
          restart=50, dot=None, norm=None):
    """Restarted, left-preconditioned GMRES with Givens rotations and
    guarded divisions.

    Solves for b/||b||; ``M`` approximates A^-1 and the monitored residual
    is the preconditioned one (as in MFEM's GMRESSolver).  Each Arnoldi
    cycle orthogonalises by classical Gram-Schmidt twice; a zero Arnoldi
    norm is a happy breakdown that ends the cycle, and a zero denominator
    anywhere stops progress instead of poisoning the iterate.  A restart
    cycle that improves the residual by less than 0.1% ends the solve.
    ``dot`` (default ``torch.matmul``: the Gram-Schmidt products V @ w)
    and ``norm`` are a distributed form's, as in ``cg``.

    Returns (x, iterations).
    """
    dt, dev = b.dtype, b.device
    n = b.shape[0]
    dot = dot or torch.matmul
    norm = norm or torch.linalg.vector_norm
    norm_b = norm(b)
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
        beta = norm(r0)
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
            h = dot(V[:j + 1], w)
            w = w - h @ V[:j + 1]
            h2 = dot(V[:j + 1], w)
            w = w - h2 @ V[:j + 1]
            hn = norm(w)
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
           stall_window=200, dot=None, norm=None):
    """Preconditioned MINRES (Paige-Saunders) for symmetric, possibly
    indefinite systems; ``M`` must be SPD.  Stops when the residual
    estimate phibar <= tol*||b||, after ``maxiter`` iterations, or at the
    floor exit: every ``stall_window`` iterations phibar (monotone in
    MINRES) must have dropped by at least 1% (``None`` disables it).

    The loop state stays on the device and is updated only while the
    stopping test holds, as in ``cg``; the host reads the test back every
    ``_CHECK_EVERY`` iterations.  ``dot`` and ``norm`` as in ``cg``.

    Returns (x, iterations).
    """
    dt, dev = b.dtype, b.device
    dot = dot or torch.dot
    norm = norm or torch.linalg.vector_norm
    if M is None:
        M = lambda v: v  # noqa: E731
    x = torch.zeros_like(b) if x0 is None else x0
    tiny = torch.finfo(dt).tiny
    target = tol * torch.clamp(norm(b), min=1e-30)
    window = maxiter + 1 if stall_window is None else min(stall_window, maxiter)

    def scalar(v):
        return torch.full((), v, dtype=dt, device=dev)

    r1 = b - matvec(x)
    y = M(r1)
    beta = torch.sqrt(torch.abs(dot(r1, y)))
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
        alfa = dot(v, yv)
        yv = yv - (alfa / bsafe) * r2
        yn = M(yv)
        beta_n = torch.sqrt(torch.abs(dot(yv, yn)))
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


def _ident(x):
    return x


def _lumped_latent(form, intg, Hq, reg: float, out: dict, psum=_ident):
    """The node-block lumped latent of a latent space that couples across
    elements (ex5's H1^dim latent): per scalar node the vdim x vdim diagonal
    block of D (scalar lumping is badly wrong for anisotropic entropies: the
    Hellinger E*'' goes rank-deficient along psi near saturation) and its
    regularized inverse ``Dblk_inv`` [nds, vdim, vdim].  The node sums go
    through the latent space's own dof exchange, so their order is
    fixed; ``psum`` completes them across ranks."""
    lb = len(form.offsets) - 2
    sp_l = form.spaces[lb]
    vl, ndl = sp_l.vdim, sp_l.nd
    De = -intg.element_matrices(Hq, lb, lb)
    ne = De.shape[0]
    De4 = De.reshape(ne, vl, ndl, vl, ndl)
    node_blocks = torch.diagonal(De4, dim1=2, dim2=4).permute(0, 3, 1, 2)
    Dblk = psum(intg.node_sum(lb, node_blocks))  # [nds, vl, vl]
    eye = torch.eye(vl, dtype=De.dtype, device=De.device)
    tr = torch.diagonal(Dblk, dim1=1, dim2=2).sum(-1) / vl
    shift = torch.clamp(reg * tr.abs().max(), min=1e-30)
    out["Dblk_inv"] = torch.linalg.inv(Dblk + shift * eye)


def _schur_arrays(form, state, reg: float, jacobi: bool,
                  lumped: bool = False):
    """The array pieces of the Schur reduction, once per Newton direction:
    the inverse latent element blocks ``De_inv`` (an L2 latent) or, with
    ``lumped``, the node-block arrays of ``_lumped_latent``; with
    ``jacobi``, the condensed Jacobi diagonal ``safe`` and the reaction
    diagonal ``dshift`` = diag(C D^-1 C^T) on the primal block (zero at
    essential dofs), the shift of the V-cycle (D^-1 the node-block
    inverse when ``lumped``).  A distributed form computes them itself
    (``schur_arrays``, through ``_schur_arrays_core`` with its
    collectives)."""
    if hasattr(form, "schur_arrays"):
        return form.schur_arrays(state, reg, jacobi, lumped)
    return _schur_arrays_core(form, form.integrators[0], state[0], reg,
                              jacobi, lumped, SchurOps(form, state))


class SchurOps:
    """What ``_schur_arrays_core`` needs of a form beyond one integrator's
    element blocks, in the form's own vector layout: ``diag()`` (|diag(J)|),
    the essential mask ``ess`` and ``usplit`` (the primal block of a form
    vector); and the collectives ``psum`` (completes a node scatter across
    ranks), ``pmax`` (a maximum across ranks) and ``globalize`` (the band's
    ``De_inv`` into the form's layout).  The defaults are a serial form's:
    identities, and ``v[:n0]``."""

    def __init__(self, form, state, psum=_ident, pmax=_ident,
                 globalize=_ident, usplit=None):
        self.form, self.state, self.ess = form, state, form.ess_mask
        self.psum, self.pmax, self.globalize = psum, pmax, globalize
        n0 = int(form.offsets[-2])
        self.usplit = usplit or (lambda v: v[:n0])

    def diag(self):
        return torch.abs(self.form.grad_diag(self.state))


def _schur_arrays_core(form, intg, Hq, reg: float, jacobi: bool,
                       lumped: bool, ops: SchurOps):
    """The array math of ``_schur_arrays`` on one integrator's elements:
    the serial form's, or a rank's band, with the form's ``ops``."""
    lb = len(form.offsets) - 2
    t = intg.tables
    out = {}
    if lumped:
        _lumped_latent(form, intg, Hq, reg, out, ops.psum)
        if jacobi:
            _schur_jacobi(form, intg, Hq, out, None, ops)
        return out
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
    dmax = ops.pmax(torch.max(torch.abs(De)))
    eye = torch.eye(ndl, dtype=De.dtype, device=De.device)
    Bl = t["B"][lb][..., 0]  # [1|ne, nq, ndl] latent VALUE shapes
    Me = torch.einsum("eqd,eqk,eq->edk", Bl, Bl, t["w"])
    De_inv = torch.linalg.inv(De + (reg * dmax) * eye + 1e-20 * Me)
    out["De_inv"] = ops.globalize(De_inv)
    if jacobi:
        _schur_jacobi(form, intg, Hq, out, De_inv, ops)
    return out


def _schur_jacobi(form, intg, Hq, out: dict, De_inv, ops: SchurOps):
    """diag(S) = diag(A) + diag(C D^-1 C^T) as ``safe``, and the reaction
    diagonal diag(C D^-1 C^T) (zero at essential dofs) as ``dshift``; the
    second term dominates as alpha grows (D ~ E*''/alpha -> 0 on the
    active set).  ``De_inv`` is the integrator's own (the band's on a
    rank); the node-block ``Dblk_inv`` is global."""
    t = intg.tables
    lb = len(form.offsets) - 2
    ub = lb - 1
    Ce = intg.element_matrices(Hq, ub, lb)  # [ne, nde_u, nde_l]
    ne = Ce.shape[0]
    sp_u = form.spaces[ub]
    if "Dblk_inv" in out:
        # node-block inverse; Ce's columns are (w, d) = w*ndl + d byNODES
        sp_l = form.spaces[lb]
        Ce4 = Ce.reshape(ne, Ce.shape[1], sp_l.vdim, sp_l.nd)
        be = out["Dblk_inv"][t["edof"][lb]]  # [ne, ndl, vl, vl]
        dS = torch.einsum("eivd,edvw,eiwd->ei", Ce4, be, Ce4)
    else:
        dS = torch.einsum("eij,ejk,eik->ei", Ce, De_inv, Ce)
    # byNODES flat rows (v, d) = v*nd + d -> [ne, nd, vdim] to scatter
    dS3 = dS.reshape(ne, sp_u.vdim, sp_u.nd).permute(0, 2, 1)
    dS_nodes = ops.psum(intg.scatter(ub, dS3))
    d = ops.usplit(ops.diag()) + dS_nodes
    out["dshift"] = torch.where(ops.usplit(ops.ess), 0.0, dS_nodes)
    out["safe"] = torch.where(d < 1e-30, 1.0, d)


def _schur_blocks(form, De_inv):
    """(split, pad_u, pad_p, join, Dinv) of the Schur reduction: the
    primal and latent blocks of a form vector, the embeddings of each
    block, and the element-local latent inverse D^-1.  A distributed form
    (``HaloShardedForm``) gives its own, on its slot blocks."""
    if hasattr(form, "split_u_p"):
        return (form.split_u_p, form.pad_u, form.pad_p, form.join_u_p,
                form.make_latent_dinv(De_inv))
    ne, ndl = De_inv.shape[0], De_inv.shape[1]
    n0 = int(form.offsets[-2])
    n1 = form.ndof - n0

    def split(v):
        return v[:n0], v[n0:]

    def pad_u(v):
        return torch.cat([v, torch.zeros(n1, dtype=v.dtype, device=v.device)])

    def pad_p(w):
        return torch.cat([torch.zeros(n0, dtype=w.dtype, device=w.device), w])

    def join(a, b):
        return torch.cat([a, b])

    def Dinv(w):  # L2 dofs are element-contiguous: a pure reshape
        return torch.einsum("eij,ej->ei", De_inv, w.reshape(ne, ndl)
                            ).reshape(-1)

    return split, pad_u, pad_p, join, Dinv


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

    On a ``HaloShardedForm`` every block operation is local to the rank's
    slot blocks and the CG's inner products are the form's; the V-cycle
    works on canonical vectors, so the halo form takes the Jacobi
    diagonal.

    Returns (dx, CG iterations summed over the solve and its refinement
    passes).  A latent space that is not L2 couples across elements and
    takes ``lumped_schur_solve`` instead (``newton`` chooses by the
    latent space).
    """
    if form.spaces[-1].fe_type != "L2":
        raise ValueError(
            "schur_solve eliminates an element-local (L2) latent; a "
            f"{form.spaces[-1].fe_type} latent takes lumped_schur_solve"
        )
    if fp is not None and not hasattr(fp, "apply_primal"):
        raise ValueError(
            f"lin_solver='schur' takes a multigrid.PGSchurGMG "
            f"preconditioner (or none, or 'jacobi'), not {type(fp).__name__}"
        )
    if fp is not None and hasattr(form, "split_u_p"):
        raise ValueError(
            "the primal GMG works on canonical vectors; a HaloShardedForm "
            "takes the Jacobi-preconditioned Schur direction")
    arrays = _schur_arrays(form, state, reg, jacobi)
    split, pad_u, pad_p, join, Dinv = _schur_blocks(form, arrays["De_inv"])
    dot, norm = getattr(form, "dot", None), getattr(form, "norm", None)

    def mv(v):
        return form.grad_mult(state, v)

    def S(v):
        Av, Ctv = split(mv(pad_u(v)))
        return Av + split(mv(pad_p(Dinv(Ctv))))[0]

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
        r_u, r_p = split(rr)
        rhs = r_u + split(mv(pad_p(Dinv(r_p))))[0]
        du, k = cg(S, rhs, M=M, tol=tol, maxiter=maxiter, dot=dot,
                   norm=norm)
        dp = Dinv(split(mv(pad_u(du)))[1] - r_p)
        return join(du, dp), k

    dx, its = solve_reg(r)
    for _ in range(refine):
        d1, k = solve_reg(r - mv(dx))
        dx = dx + d1
        its += k
    return dx, its


def _check_schur_form(form, latent_block: int = 1):
    """The refusals of the Schur direction: it needs a 2-block (primal,
    latent-last) system, element-block access (a form with integrators,
    or a distributed form with ``schur_arrays``) and no essential dofs on
    the latent block."""
    off = form.offsets
    if len(off) != 3 or latent_block != len(off) - 2:
        raise ValueError(
            "lin_solver='schur' needs a 2-block (primal, latent) system "
            f"with the latent block last; got {len(off) - 1} blocks, "
            f"latent_block={latent_block}"
        )
    if not (hasattr(form, "integrators") or hasattr(form, "schur_arrays")):
        raise ValueError(
            "lin_solver='schur' needs element-block access "
            "(BlockNonlinearForm, ShardedForm or HaloShardedForm)"
        )
    # the canonical mask: a distributed form carries the serial form at
    # .form, and a halo form's own mask is in its slot layout
    base = getattr(form, "form", form)
    if bool(base.ess_mask[int(off[1]):].any()):
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
# The lumped-latent saddle direction (a latent that couples across
# elements: ex5's H1^dim latent)
# ---------------------------------------------------------------------------


# the reference's cap of the dense dual-Schur factor (latent dofs); above
# it Sigma^-1 is applied matrix-free (Woodbury)
SIGMA_DIRECT_MAX = 16384
# inner tolerances and budgets of the LDU preconditioner: A^-1 by CG, and
# Sigma^-1 by CG (its budget per mode: the dense factor, Woodbury)
LDU_A_TOL, LDU_A_MAX = 1e-5, 64
LDU_S_TOL, LDU_S_MAX = 3e-3, {"direct": 50, "wb": 60}
LDU_RESTART = 32


def _lumped_ops(form, state, arrays):
    """The operators of the lumped direction: the Jacobian action ``mv``,
    the lumped primal Schur complement ``S`` = A + C D~^-1 C^T with the
    node-block D~, its application ``Dinv`` and the primal block size."""
    lb = len(form.offsets) - 2
    n0 = int(form.offsets[lb])
    n1 = form.ndof - n0
    sp_l = form.spaces[lb]
    vl, nds_l = sp_l.vdim, sp_l.ndof_scalar
    Dblk_inv = arrays["Dblk_inv"]

    def Dinv(w):  # byNODES layout: dof = v*nds + node
        z = torch.einsum("nvw,wn->vn", Dblk_inv, w.reshape(vl, nds_l))
        return z.reshape(-1)

    def mv(v):
        return form.grad_mult(state, v)

    def S(v):
        Jv = mv(torch.cat([v, v.new_zeros(n1)]))
        Cw = mv(torch.cat([v.new_zeros(n0), Dinv(Jv[n0:])]))[:n0]
        return Jv[:n0] + Cw

    return mv, S, Dinv, n0


def _lumped_minres(form, state, r, arrays, tol: float):
    """Block-diagonal MINRES on the saddle Jacobian, preconditioned by
    blockdiag(S~^-1, D~^-1) with S~^-1 a bounded inner Jacobi-CG (rel
    1e-8, at most 200 iterations) and at most 200 outer iterations: the
    direction without a GMG.  Returns (dx, MINRES iterations)."""
    mv, S, Dinv, n0 = _lumped_ops(form, state, arrays)
    safe = arrays["safe"]

    def Mblock(rr):
        zu = cg(S, rr[:n0], M=lambda v: v / safe, tol=1e-8, maxiter=200)[0]
        return torch.cat([zu, Dinv(rr[n0:])])

    return minres(mv, r, M=Mblock, tol=tol, maxiter=200)


def _sigma_direct_enabled(form, opts, fp, nl: int) -> bool:
    """The dense dual-Schur factor serves the LDU direction when
    ``opts.sigma_direct`` is "auto", a primal GMG is there, the latent
    has at most ``SIGMA_DIRECT_MAX`` dofs and the form is not
    distributed (its dense build is a serial-form tool)."""
    if not getattr(opts, "sigma_direct", "auto"):
        return False
    if hasattr(form, "schur_arrays"):
        return False
    if fp is None or not hasattr(fp, "apply_primal"):
        return False
    return nl <= SIGMA_DIRECT_MAX


def _inv_f32(S):
    """f32 inverse of a symmetric (near-)SPD matrix, symmetrized: a
    preconditioner needs a few digits, and the Krylov solve around it
    supplies the rest."""
    out = torch.linalg.inv(S.to(torch.float32))
    out = out + out.T
    return out.mul_(0.5)


def _free_bytes(device) -> int:
    """Memory the form's device can still give: the card's free memory
    plus what PyTorch's allocator holds unused, or the host's available
    memory for a CPU form."""
    if device.type == "cuda":
        free = torch.cuda.mem_get_info(device)[0]
        return free + (torch.cuda.memory_reserved(device)
                       - torch.cuda.memory_allocated(device))
    return os.sysconf("SC_AVPHYS_PAGES") * os.sysconf("SC_PAGE_SIZE")


def sigma_gemm_fits(form, n0: int, nl: int) -> bool:
    """The GEMM K builder's peak (f32: the dense A, its LU and inverse, the
    coupling and its product, K) against three quarters of the memory the
    form's device has free: the budget decides up front which builder
    runs."""
    need = 4.0 * (3.0 * n0 * n0 + 2.0 * n0 * nl + nl * nl)
    return need < 0.75 * _free_bytes(form.device)


def _dense_AC(form, state, alpha: float, n0: int, nl: int):
    """The dense primal block A (essential rows and columns -> identity)
    and the alpha-scaled coupling alpha*C, f32 on the form's device, as
    ``grad_mult`` eliminates the essential dofs."""
    lb = len(form.spaces) - 1
    off = form.offsets
    dev = form.device
    A = torch.zeros((n0, n0), dtype=torch.float32, device=dev)
    Cm = torch.zeros((n0, nl), dtype=torch.float32, device=dev)
    for intg, Hq in zip(form.integrators, state):
        for s_ in range(lb):
            r0, r1 = int(off[s_]), int(off[s_ + 1])
            for t_ in range(lb):
                A[r0:r1, int(off[t_]):int(off[t_ + 1])] += (
                    intg.assemble_dense_block(Hq, s_, t_))
            Cm[r0:r1] += intg.assemble_dense_block(Hq, s_, lb)
    pe, le = form.ess_mask[:n0], form.ess_mask[n0:]
    A[pe] = 0.0
    A[:, pe] = 0.0
    A[pe, pe] = 1.0
    Cm[pe] = 0.0
    Cm[:, le] = 0.0
    return A, Cm.mul_(alpha)


def sigma_K_gemm(form, state, alpha: float, n0: int, nl: int,
                 cache: dict):
    """K = (alpha C)^T A^-1 (alpha C) from the dense blocks (two GEMMs);
    keeps A^-1 (f32) and the invariance witness (one column of A and of
    alpha C) in ``cache``."""
    A, Ca = _dense_AC(form, state, alpha, n0, nl)
    j = int((~form.ess_mask[:n0]).nonzero()[0])  # first free primal dof
    cache["chk"] = (j, A[:, j].clone(), Ca[j].clone())
    Ainv = _inv_f32(A)
    del A
    K = Ca.T @ (Ainv @ Ca)
    cache["Ainv"] = Ainv
    K = K + K.T
    return K.mul_(0.5)


def sigma_K_columns(form, fp, state, alpha: float, n0: int, cols):
    """Columns ``cols`` of K = (alpha C)^T V_A (alpha C), V_A one V-cycle
    on the primal block, through the Jacobian action: [len(cols), nl]."""
    nl = form.ndof - n0
    out = []
    for j in cols:
        w = torch.zeros(form.ndof, dtype=form.dtype, device=form.device)
        w[n0 + j] = 1.0
        z = fp.apply_primal(form.grad_mult(state, w)[:n0])
        t3 = form.grad_mult(state, torch.cat([z, z.new_zeros(nl)]))
        out.append((alpha * alpha) * t3[n0:])
    return torch.stack(out)


def sigma_K_matvec(form, fp, state, alpha: float, n0: int, nl: int):
    """K built column by column through the Jacobian action and the
    V-cycle (no dense primal block): the builder where the GEMM one does
    not fit (``sigma_gemm_fits``)."""
    K = sigma_K_columns(form, fp, state, alpha, n0, range(nl)).T
    return 0.5 * (K + K.T)


def _sigma_drift(form, fp, state, alpha: float, n0: int, nl: int,
                 cache: dict) -> bool:
    """True when the cached K no longer matches the live Jacobian (a
    nonlinear primal energy or coupling): one fresh column against the
    cache's witness."""
    if cache["mode"] == "gemm":
        j, colA, colC = cache["chk"]
        ej = torch.zeros(form.ndof, dtype=form.dtype, device=form.device)
        ej[j] = 1.0
        col = form.grad_mult(state, ej)
        dA = torch.linalg.vector_norm(col[:n0] - colA)
        dC = torch.linalg.vector_norm(alpha * col[n0:] - colC)
        den = max(float(torch.linalg.vector_norm(colA)),
                  float(torch.linalg.vector_norm(colC)), 1e-30)
        # 1e-5: above the f32 rounding of the witness, far below any real
        # drift of the state
        return float(dA + dC) > 1e-5 * den
    j = nl // 2
    col = sigma_K_columns(form, fp, state, alpha, n0, [j])[0]
    ref = cache["K"][:, j]
    den = max(float(torch.linalg.vector_norm(ref)), 1e-30)
    return float(torch.linalg.vector_norm(col - ref)) > 1e-8 * den


def _sigma_direct_update(form, fp, state, alpha: float, n0: int, nl: int):
    """Build or refresh the dense inverse of the scaled dual Schur
    complement Sigma(alpha) = alpha^2 D + K, K = (alpha C)^T A^-1
    (alpha C), cached on ``fp`` across the PG loop.

    K is alpha- and state-invariant for LVPP functionals with a linear
    primal-latent coupling (C is 1/alpha times a constant mixed mass), so
    it is paid once per run and each refresh only re-assembles alpha^2 D
    and re-inverts.  Every refresh checks the invariance on one fresh
    column; drift makes K rebuild on every refresh from then on.

    K's builder: ``sigma_K_gemm`` (dense A and alpha*C, A^-1 kept for the
    LDU apply) where ``sigma_gemm_fits``, else ``sigma_K_matvec``.
    Refresh policy (lazy): alpha moved more than 4x since the factor was
    built, or the previous direction took more than 12 FGMRES
    iterations; the Sigma-CG around the factor keeps every direction
    right whatever its staleness.  Returns the cache dict (``Sinv``, and
    ``Ainv`` in gemm mode), kept in ``fp.sigma_cache``.  The profiling
    phases "ldu/sigma_K" and "ldu/sigma_refresh" count and time the builds
    and refreshes, and ``fp.sigma_builds`` and ``fp.sigma_refreshes``
    count them."""
    cache = fp.sigma_cache
    if cache is None or cache.get("nl") != nl:
        cache = fp.sigma_cache = {"nl": nl}

    def build_K():
        fp.sigma_builds += 1
        with profiling.phase("ldu/sigma_K", sync=form.ess_mask):
            if cache["mode"] == "gemm":
                return sigma_K_gemm(form, state, alpha, n0, nl, cache)
            return sigma_K_matvec(form, fp, state, alpha, n0, nl)

    if "K" not in cache:
        cache["mode"] = "gemm" if sigma_gemm_fits(form, n0, nl) else "matvec"
        cache["K"] = build_K()
        cache["k_dynamic"] = False
    a_prev = cache.get("alpha")
    a_ratio = (max(alpha, a_prev) / max(min(alpha, a_prev), 1e-300)
               if a_prev else np.inf)
    if not ("Sinv" not in cache or a_ratio > 4.0
            or cache.get("outer_prev", 0) > 12):
        return cache
    fp.sigma_refreshes += 1
    with profiling.phase("ldu/sigma_refresh", sync=form.ess_mask):
        _sigma_refresh(form, fp, state, alpha, n0, nl, cache, build_K)
    return cache


def _sigma_refresh(form, fp, state, alpha, n0, nl, cache, build_K):
    """Re-assemble alpha^2 D, add K (rebuilt first where it drifted) and
    re-invert: the refresh of ``_sigma_direct_update``."""
    if cache["k_dynamic"] or _sigma_drift(form, fp, state, alpha, n0, nl,
                                          cache):
        cache["k_dynamic"] = True
        cache["K"] = build_K()
    lb = len(form.offsets) - 2
    D = -form.integrators[0].assemble_dense_block(state[0], lb, lb)
    le = form.ess_mask[n0:]
    if cache["mode"] == "gemm":
        S = ((alpha * alpha) * D).to(torch.float32) + cache["K"]
        keep = (~le).to(S.dtype)
        S = S * keep[:, None] * keep[None, :]
        S = 0.5 * (S + S.T)
        dmax = torch.diagonal(S).abs().max()
        S.diagonal().add_(le.to(S.dtype) + 1e-14 * dmax)
    else:
        S = (alpha * alpha) * D + cache["K"]
        S[le] = 0.0
        S[:, le] = 0.0
        S[le, le] = 1.0
        S = 0.5 * (S + S.T)
        S.diagonal().add_(1e-14 * torch.diagonal(S).abs().max())
    cache["Sinv"] = _inv_f32(S)
    cache["alpha"] = alpha


@dataclass
class LDUBlocks:
    """The blocks of one direction's block-LDU preconditioner
    (``_ldu_fgmres``): ``a_solve`` and ``sigma_solve`` map a right-hand
    side to (solution, inner CG iterations) of A and of Sigma; ``ct`` maps
    a primal vector zu to alpha C^T zu, ``c`` a latent vector zp to
    alpha C zp; ``n0`` is the primal block's size."""

    n0: int
    a_solve: object
    sigma_solve: object
    ct: object
    c: object


def ldu_apply(fp, blocks: LDUBlocks, v):
    """One application of the block-LDU preconditioner to v = (ru, rp):
    zu' = A^-1 ru; zp = -Sigma^-1 (rp - alpha C^T zu');
    zu = A^-1 (ru - alpha C zp).  Adds the application and its inner CG
    iterations (the host ints ``cg`` returns) to the counters of ``fp``,
    the direction's ``multigrid.PGSchurGMG``.  A module-level function, so
    that a wrapper can time every application."""
    n0 = blocks.n0
    ru, rp = v[:n0], v[n0:]
    zu1, k1 = blocks.a_solve(ru)
    zp, ks = blocks.sigma_solve(rp - blocks.ct(zu1))
    zp = -zp
    zu, k2 = blocks.a_solve(ru - blocks.c(zp))
    fp.ldu_applies += 1
    fp.ldu_a_cg_iters += k1 + k2
    fp.ldu_sigma_cg_iters += ks
    return torch.cat([zu, zp])


def _ldu_fgmres(form, opts, fp, state, r, arrays, alpha: float):
    """Flexible GMRES on the alpha-scaled saddle Jacobian with the inexact
    block-LDU preconditioner

        J = [[I, 0], [C^T A^-1, I]] [[A, 0], [0, -Sigma]]
            [[I, A^-1 C], [0, I]],      Sigma = D + C^T A^-1 C,

    applied as zu' = A^-1 ru; zp = -Sigma^-1 (rp - C^T zu');
    zu = A^-1 (ru - C zp) (``ldu_apply``), with
      - A^-1: CG on the primal block preconditioned by V_A (rel 1e-5, at
        most 64 iterations), V_A the dense f32 A^-1 in direct mode (where
        it was built), else one V-cycle;
      - Sigma^-1: CG on w -> D w + C^T V_A (C w) (rel 3e-3), preconditioned
        in one of the two modes a ``PGSchurGMG`` takes: "direct", the dense
        inverse of Sigma (``_sigma_direct_update``; at most 50
        iterations), wherever ``_sigma_direct_enabled``; else "wb", the
        Woodbury identity (D~ + C^T A^-1 C)^-1 = D~^-1 - D~^-1 C^T S~^-1 C
        D~^-1 with one shifted V-cycle for S~^-1 (at most 60).

    The system is scaled by Lam = blockdiag(I, alpha I), so every block is
    O(1) and the residual tolerance ``opts.lin_tol`` measures the
    multiplier's accuracy; dpsi = alpha * zhat_p.  Restarts every 32
    iterations; CGS2 Arnoldi with the Hessenberg matrix on the host: each
    Gram-Schmidt pass is one device GEMV, each iteration one copy to the
    host.
    Block-diagonal preconditioners floor MINRES on this system as alpha
    grows; this one keeps the outer count flat.

    Returns (dx, FGMRES iterations); the profiling phase
    "ldu/fgmres_<mode>" counts and times the directions of each mode."""
    n0 = int(form.offsets[len(form.offsets) - 2])
    nl = form.ndof - n0
    sp_l = form.spaces[-1]
    vl, nds_l = sp_l.vdim, sp_l.ndof_scalar
    tol = float(opts.lin_tol)
    budget = int(opts.lin_maxiter)
    m = min(LDU_RESTART, budget)
    a2 = alpha * alpha

    sd = sdata = None
    if _sigma_direct_enabled(form, opts, fp, nl):
        mode = "direct"
        sd = _sigma_direct_update(form, fp, state, alpha, n0, nl)
    else:
        mode = "wb"
        # shifted-V-cycle data for S~ = A + diag(C D~^-1 C^T)
        sdata = fp.shift_data(arrays["dshift"])
    s_max = LDU_S_MAX[mode]

    def mvraw(v):
        return form.grad_mult(state, v)

    def pad_u(v):
        return torch.cat([v, v.new_zeros(nl)])

    def pad_p(w):
        return torch.cat([w.new_zeros(n0), w])

    def mvs(v):  # the scaled saddle operator Lam J Lam
        out = mvraw(torch.cat([v[:n0], alpha * v[n0:]]))
        return torch.cat([out[:n0], alpha * out[n0:]])

    ainv = None if sd is None else sd.get("Ainv")
    if ainv is not None:
        # the exact inverse the dual-Schur factor was built from
        def V_A(v):
            return (ainv @ v.to(ainv.dtype)).to(v.dtype)
    else:
        def V_A(v):
            return fp.apply_primal(v)

    if mode == "direct":
        sinv = sd["Sinv"]

        def SigM(w):
            return (sinv @ w.to(sinv.dtype)).to(w.dtype)
    else:
        Dblk_inv = arrays["Dblk_inv"]

        def Dtinv(w):  # byNODES layout: dof = v*nds + node
            return torch.einsum("nvw,wn->vn", Dblk_inv,
                                w.reshape(vl, nds_l)).reshape(-1)

        def SigM(w):
            z0 = Dtinv(w)
            z1 = fp.apply_primal(mvraw(pad_p(z0))[:n0], sdata)  # V on S~
            return (z0 - Dtinv(mvraw(pad_u(z1))[n0:])) / a2

    def Sig_mv(w):  # the scaled dual Schur complement alpha^2 (D + C^T V_A C)
        t2 = mvraw(pad_p(w))
        return a2 * (-t2[n0:] + mvraw(pad_u(V_A(t2[:n0])))[n0:])

    blocks = LDUBlocks(
        n0=n0,
        a_solve=lambda rhs: cg(lambda v: mvraw(pad_u(v))[:n0], rhs, M=V_A,
                               tol=LDU_A_TOL, maxiter=LDU_A_MAX,
                               stall_window=None),
        sigma_solve=lambda rhs: cg(Sig_mv, rhs, M=SigM, tol=LDU_S_TOL,
                                   maxiter=s_max, stall_window=None),
        ct=lambda zu: alpha * mvraw(pad_u(zu))[n0:],
        c=lambda zp: alpha * mvraw(pad_p(zp))[:n0])

    def M_ldu(v):
        return ldu_apply(fp, blocks, v)

    with profiling.phase(f"ldu/fgmres_{mode}", sync=r):
        dx, total = _fgmres(mvs, M_ldu, r, n0, alpha, tol, budget, m)
    if sd is not None:
        sd["outer_prev"] = total
    return dx, total


def _fgmres(mvs, M_ldu, r, n0: int, alpha: float, tol: float, budget: int,
            m: int):
    """Restarted flexible GMRES of ``_ldu_fgmres`` on the scaled system
    (Lam J Lam) z = Lam r; returns (Lam z, iterations)."""
    r0 = torch.cat([r[:n0], alpha * r[n0:]])  # the scaled rhs Lam r
    beta0 = float(torch.linalg.vector_norm(r0))
    dx = torch.zeros_like(r0)
    if beta0 == 0.0:
        return dx, 0
    target = tol * beta0
    total = 0
    rel_prev = 1.0
    r_cur = r0
    n = r0.shape[0]
    while total < budget:
        beta = float(torch.linalg.vector_norm(r_cur))
        if beta <= target:
            break
        V = r0.new_empty((m + 1, n))
        Z = r0.new_empty((m, n))
        V[0] = r_cur / beta
        H = np.zeros((m + 1, m))
        g = np.zeros(m + 1)
        g[0] = beta
        j_done = 0
        y = None
        for j in range(m):
            Z[j] = M_ldu(V[j])
            w = mvs(Z[j])
            Vj = V[:j + 1]
            # CGS2: classical Gram-Schmidt twice (once leaves ~1e-7 of
            # orthogonality at tight tolerances), each pass one GEMV; the
            # column and the norm of what is left reach the host in one
            # copy
            h = Vj @ w
            w = w - h @ Vj
            h2 = Vj @ w
            w = w - h2 @ Vj
            col = torch.cat([h + h2, torch.linalg.vector_norm(w)[None]])
            col = col.cpu().numpy()
            H[:j + 1, j] = col[:j + 1]
            H[j + 1, j] = col[j + 1]
            total += 1
            j_done = j + 1
            y, *_ = np.linalg.lstsq(H[:j + 2, :j + 1], g[:j + 2],
                                    rcond=None)
            rn = float(np.linalg.norm(H[:j + 2, :j + 1] @ y - g[:j + 2]))
            if rn <= target or H[j + 1, j] < 1e-30 or total >= budget:
                break
            V[j + 1] = w / H[j + 1, j]
        yd = torch.as_tensor(y, dtype=Z.dtype, device=Z.device)
        dx = dx + yd @ Z[:j_done]
        r_cur = r0 - mvs(dx)
        rel = float(torch.linalg.vector_norm(r_cur)) / beta0
        if rel <= tol or rel > 0.95 * rel_prev:
            break  # converged, or the restart made < 5% progress
        rel_prev = rel
    dx[n0:] *= alpha  # the direction is Lam zhat
    return dx, total


def lumped_schur_solve(form, state, r, opts, fp=None, alpha: float = 1.0):
    """The Newton direction of an LVPP saddle system whose latent couples
    across elements (ex5's H1^dim latent), where the exact elimination of
    ``schur_solve`` does not apply: with a primal GMG (``fp``, a
    ``multigrid.PGSchurGMG``) LDU-preconditioned FGMRES on the
    alpha-scaled system (``_ldu_fgmres``), else block-diagonal MINRES with
    an inner CG on the lumped Schur complement (``_lumped_minres``).
    ``alpha`` is the PG step of the current outer iteration.  Returns
    (dx, outer iterations)."""
    if fp is not None and not hasattr(fp, "shift_data"):
        raise ValueError(
            f"lin_solver='schur' takes a multigrid.PGSchurGMG "
            f"preconditioner (or none, or 'jacobi'), not {type(fp).__name__}"
        )
    arrays = _schur_arrays(form, state, 1e-6, True, lumped=True)
    if fp is not None:
        return _ldu_fgmres(form, opts, fp, state, r, arrays, alpha)
    return _lumped_minres(form, state, r, arrays, float(opts.lin_tol))


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
    # the dense dual-Schur factor of the lumped LDU direction: "auto" (up
    # to SIGMA_DIRECT_MAX latent dofs) or False (Woodbury at any size)
    sigma_direct: object = "auto"
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
        safe = jacobi_diagonal(form.grad_diag(state),
                               getattr(form, "pmax", None))
        return lambda v: v / safe
    return spec(form, state)


def jacobi_diagonal(d, pmax=None):
    """The Jacobi scale |d|, with 1 where |d| is at or below the dtype's
    rounding of its largest entry (eps * max|d|).  |d| keeps the
    preconditioner SPD on indefinite systems, so it serves MINRES as well
    as CG.  Entries under the rounding level are numerically zero: where
    a Fermi-Dirac mirror map saturates, the port's E*'' keeps values such
    as 1e-20 (the JAX package's rounds them to exactly 0 and so takes 1
    there), and dividing by them would scale those saddle rows by 1e20
    and stall MINRES.  ``pmax`` takes the largest entry across the ranks
    of a distributed form (``HaloShardedForm.pmax``)."""
    d = torch.abs(d)
    dmax = d.max()
    if pmax is not None:
        dmax = pmax(dmax)
    floor = torch.finfo(d.dtype).eps * dmax
    return torch.where(d <= floor, 1.0, d)


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
    Schur direction takes it as its condensed-system preconditioner, the
    lumped one (a latent that is not L2) as the GMG of its LDU
    preconditioner."""
    r = _residual(form, x, b, fields)
    fp = getattr(opts.preconditioner, "fused_precond", None)
    with profiling.phase("newton/linearize"):
        state = form.grad_state(x, fields)
        if fp is not None and opts.lin_solver in _KRYLOV:
            M = fp.newton_precond(form, x, state, fields)
    if opts.lin_solver == "schur" and form.spaces[-1].fe_type != "L2":
        alpha = float(fields.get("alpha", 1.0))
        return lumped_schur_solve(form, state, r, opts, fp=fp, alpha=alpha)
    if opts.lin_solver == "schur":
        return schur_solve(form, state, r, opts.lin_tol, opts.lin_maxiter,
                           fp=fp)
    if opts.lin_solver == "dense":
        return dense_solve(form.assemble_dense(state), r), None
    if callable(opts.lin_solver):
        return opts.lin_solver(form, state, r), None
    if fp is None:
        M = _make_precond(form, state, opts.preconditioner)
    mv = lambda v: form.grad_mult(state, v)  # noqa: E731
    ip = {"dot": getattr(form, "dot", None),
          "norm": getattr(form, "norm", None)}
    if opts.lin_solver == "gmres":
        return gmres(mv, r, M=M, tol=opts.lin_tol, maxiter=opts.lin_maxiter,
                     **ip)
    solve = cg if opts.lin_solver == "cg" else minres
    return solve(mv, r, M=M, tol=opts.lin_tol, maxiter=opts.lin_maxiter,
                 stall_window=opts.lin_stall_window, **ip)


def _apply_step(form, x, c, b, fields, norm, opts):
    """``x - d*c`` with a backtracking safeguard: halve ``d =
    opts.damping`` (up to 4 times) while the step increases the residual
    norm, and keep the least-bad candidate if every damping fails; returns
    ``x`` itself when every candidate's residual is NaN."""
    with profiling.phase("newton/line_search"):
        return _apply_step_impl(form, x, c, b, fields, norm, opts)


def _norm(form):
    """The 2-norm of the form's vectors: a distributed form's own, else
    torch's."""
    return getattr(form, "norm", torch.linalg.vector_norm)


def _apply_step_impl(form, x, c, b, fields, norm, opts):
    d = opts.damping
    best_x, best_n = None, np.inf
    for _ in range(5):
        xn = x - d * c
        nn = float(_norm(form)(_residual(form, xn, b, fields)))
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
    Jacobian ("dense", ``dense_solve``), the LVPP saddle direction
    ("schur": the exact Schur elimination of an L2 latent,
    ``schur_solve``, whose CG iterations ``lin_iters`` counts, refinement
    pass included; for any other latent ``lumped_schur_solve``, whose
    FGMRES or MINRES iterations it counts), or a callable ``(form, state,
    r) -> c``.  It runs unchanged on a ``parallel.ShardedForm`` (replicated
    vectors: every rank solves alike) and a ``parallel.HaloShardedForm``
    (owner-zero slot blocks, whose inner products and norms the form
    supplies)."""
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
            norm = float(_norm(form)(_residual(form, x, b, fields)))
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
