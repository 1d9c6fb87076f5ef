"""Geometric multigrid on structured dof grids.

PyTorch counterpart of ``mfem_ad_tpu.multigrid``.  On the structured
meshes whose H1 dofs are numbered lexicographically (``fespace``), the
replacement for an algebraic multigrid is a geometric one:

- **transfers** are separable 1-D stencils on the dof grid: a strided
  write into a zero grid, then shifted sums (no gather or scatter);
- **smoother** is damped Jacobi (omega = 2/3), symmetric, so the V-cycle
  is a valid CG preconditioner;
- **coarse solve** is a dense inverse on the coarsest level (a few hundred
  dofs), by ``torch.linalg.inv`` on the forms' device.

Usage: build the same form on each level of a nested mesh hierarchy (fine
to coarse, each coarser mesh with half the cells per side), then

    gmg = GMG([form_0, form_1, ..., form_L])
    opts = NewtonOptions(lin_solver="cg", preconditioner=gmg.as_preconditioner())

Any order works on structured quad/hex meshes: an order-p fine space
p-coarsens to its Q1 subspace on the same mesh (the nodal grids are
equispaced, so the exact Q1 -> Qp embedding is the same separable linear
stencil with factor p; see ``_up1d``), then the geometric Q1 hierarchy
takes over.  ``build_hp_hierarchy`` assembles that level list.

The level data (states, diagonals, coarse inverse) lives on the
``GMG`` object; ``newton`` refreshes it once per direction through
``newton_precond``, writing it into the same tensors.

On a CUDA device a V-cycle from the finest level is about 1,400 small
kernels with no host sync between them, and the host's launches, not the
device, set its time.  So ``GMG.vcycle(0, b)`` replays a CUDA graph of the
whole V-cycle there (one per kind: plain and shifted), captured once over
the level tensors; on the CPU it runs the same body eagerly.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from .integrator import SymHess
from .utils import profiling


# ---------------------------------------------------------------------------
# 1-D transfer stencils on nodal grids (Q1: linear interpolation)
# ---------------------------------------------------------------------------


def _axis_slice(nd: int, axis: int, sl: slice):
    idx = [slice(None)] * nd
    idx[axis] = sl
    return tuple(idx)


def _shift(x, by: int, axis: int):
    """x shifted by ``by`` places along ``axis`` with zero fill: out[i] =
    x[i - by] where that index exists, else 0."""
    n, nd = x.shape[axis], x.ndim
    out = torch.zeros_like(x)
    if by > 0:
        out[_axis_slice(nd, axis, slice(by, None))] = x[
            _axis_slice(nd, axis, slice(0, n - by))]
    else:
        out[_axis_slice(nd, axis, slice(0, n + by))] = x[
            _axis_slice(nd, axis, slice(-by, None))]
    return out


def _pad1(s, axis: int, left: bool):
    """One zero slab before (``left``) or after ``s`` along ``axis``."""
    shape = list(s.shape)
    shape[axis] = 1
    z = torch.zeros(shape, dtype=s.dtype, device=s.device)
    return torch.cat([z, s] if left else [s, z], dim=axis)


def _up1d(a, axis: int, p: int = 2):
    """Linear prolongation by factor ``p`` along ``axis``:
    [.., Nc, ..] -> [.., p(Nc-1)+1, ..].

    p = 2 is the classic geometric h-transfer.  p > 2 is p-coarsening: the
    order-p nodal dof grid is equispaced (basis nodes k/p), so the exact
    embedding Q1 -> Qp is the same separable linear-interpolation stencil
    with factor p.  The coarse values go to every p-th slot of a zero grid
    (the JAX package's interior-dilated pad), then shifted sums fill the
    slots between them.
    """
    shape = list(a.shape)
    shape[axis] = p * (a.shape[axis] - 1) + 1
    z = torch.zeros(shape, dtype=a.dtype, device=a.device)
    z[_axis_slice(a.ndim, axis, slice(None, None, p))] = a
    out = z
    for j in range(1, p):
        out = out + ((p - j) / p) * (_shift(z, j, axis) + _shift(z, -j, axis))
    return out


def _down1d(r, axis: int, p: int = 2):
    """Transpose of ``_up1d`` (full weighting by factor ``p``):
    [.., Nf, ..] -> [.., (Nf-1)//p + 1, ..]."""
    nd = r.ndim
    out = r[_axis_slice(nd, axis, slice(0, None, p))]
    for j in range(1, p):
        s = r[_axis_slice(nd, axis, slice(j, None, p))]  # [.., Nc-1, ..]
        out = (out + ((p - j) / p) * _pad1(s, axis, left=False)
               + (j / p) * _pad1(s, axis, left=True))
    return out


def _down1d_sq(r, axis: int, p: int = 2):
    """Squared-weight variant of ``_down1d``: restricts a DIAGONAL field,
    d_c[c] = sum_f P[f,c]^2 d_f[f] = diag(P^T diag(d_f) P)[c], the exact
    Galerkin coarse diagonal of a diagonal fine operator under the
    separable linear transfer."""
    nd = r.ndim
    out = r[_axis_slice(nd, axis, slice(0, None, p))]
    for j in range(1, p):
        s = r[_axis_slice(nd, axis, slice(j, None, p))]
        out = (out + ((p - j) / p) ** 2 * _pad1(s, axis, left=False)
               + (j / p) ** 2 * _pad1(s, axis, left=True))
    return out


def _write(buf, new, owned: bool):
    """``new`` (a tensor, a ``SymHess`` or a list of them) copied into
    ``buf`` where ``buf`` has its layout (shape, type, device), which keeps
    the memory that a V-cycle's graph reads; else ``new`` itself, or a copy
    of it where the caller keeps it (``owned`` False)."""
    if isinstance(new, (list, tuple)):
        if not (isinstance(buf, list) and len(buf) == len(new)):
            buf = [None] * len(new)
        return [_write(a, b, owned) for a, b in zip(buf, new)]
    if isinstance(new, SymHess):
        return SymHess(_write(getattr(buf, "planes", None), new.planes,
                              owned), new.n)
    if (isinstance(buf, torch.Tensor) and buf.shape == new.shape
            and buf.dtype == new.dtype and buf.device == new.device):
        return buf.copy_(new)
    return new if owned else new.clone()


@dataclass
class _VGraph:
    """One captured V-cycle: the graph, the static vector it reads its
    right-hand side from and writes its result to, and the level tensors
    it was captured over (held, so that their memory cannot be reused
    while the graph lives) with the key that says whether a call may
    replay it."""

    graph: object
    key: tuple
    held: list
    b: torch.Tensor


def _grid_shape(space):
    # 'h1t' (triangle meshes cut from a structured quad grid) is accepted as
    # in the JAX package: the tensor-grid bilinear transfer is not the exact
    # embedding for P1 triangle spaces, but the V-cycle stays SPD and
    # convergent as a CG/MINRES preconditioner.
    g = getattr(space, "grid", None)
    if g is None or g[0] not in ("h1", "h1t"):
        raise ValueError(
            "GMG requires structured H1 spaces (lexicographic dof grids)"
        )
    return tuple(g[2])  # ndims: 2D (NY, NX); 3D (NX, NY, NZ)


class GMG:
    """Symmetric V-cycle preconditioner over nested structured forms.

    Args:
        forms: fine-to-coarse list of single-space forms on nested meshes.
        fields: runtime fields for the Jacobian states (default none).
        x_levels: linearization points per level (default zeros).
        nu: pre/post smoothing steps.
        omega: Jacobi damping.
        nonlinear: re-linearize every level at the (injected) current
            Newton iterate once per direction (``refresh``); the default
            freezes the coarse levels at ``x_levels``, exact for linear
            energies and weak for nonlinear ones.

    ``captures``, ``replays`` and ``eager_calls`` count the V-cycle graphs
    captured, their replays and the V-cycles from level 0 run eagerly.
    """

    def __init__(self, forms, fields=None, x_levels=None, nu: int = 2,
                 omega: float = 2.0 / 3.0, nonlinear: bool = False):
        self.forms = list(forms)
        self.nu = nu
        self.omega = omega
        self.nonlinear = bool(nonlinear)
        fields = fields or {}
        self.vdim = self.forms[0].spaces[0].vdim
        self.shapes = [_grid_shape(f.spaces[0]) for f in self.forms]
        # per-pair transfer factor: 2 = geometric h-coarsening, p > 2 =
        # p-coarsening (order-p space -> its Q1 subspace on the same mesh)
        self.factors = []
        for fine, coarse in zip(self.shapes, self.shapes[1:]):
            fac = (fine[0] - 1) // (coarse[0] - 1)
            for nf, nc in zip(fine, coarse):
                if fac < 2 or nf != fac * (nc - 1) + 1:
                    raise ValueError(
                        f"levels not nested: fine grid {fine} vs coarse "
                        f"{coarse} (need Nf = f(Nc-1)+1 for an integer "
                        "factor f >= 2 on every axis)"
                    )
            self.factors.append(fac)
        if x_levels is None:
            x_levels = [torch.zeros(f.ndof, dtype=f.dtype, device=f.device)
                        for f in self.forms]
        self.states = [None] * len(self.forms)
        self.diags = [None] * len(self.forms)
        self.coarse_inv = None
        self._sdata = None
        self._graphs = {}
        self._stream = None
        self.captures = self.replays = self.eager_calls = 0
        self._linearize(x_levels, fields)

    def _linearize(self, x_levels, fields):
        """States and diagonals of every level at ``x_levels``, and the
        coarsest level's dense matrix (identity rows at essential dofs)
        and its inverse; level by level, each written into the tensors of
        the last linearization."""
        for lvl, (f, x) in enumerate(zip(self.forms, x_levels)):
            s = f.grad_state(x, fields)
            d = f.grad_diag(s)
            self.states[lvl] = _write(self.states[lvl], s, True)
            self.diags[lvl] = _write(self.diags[lvl], d, True)
        self.coarse_inv = _write(self.coarse_inv,
                                 torch.linalg.inv(self.coarse_A), True)

    @property
    def coarse_A(self):
        """The coarsest level's dense matrix (identity rows at essential
        dofs), assembled from its state where it is read (once per
        linearization and per ``shift_data``): not kept between."""
        return self.forms[-1].assemble_dense(self.states[-1])

    # -- grid helpers ----------------------------------------------------
    def _to_grid(self, lvl, u):
        return u.reshape((self.vdim,) + self.shapes[lvl])

    def _axes(self, lvl):
        return range(1, 1 + len(self.shapes[lvl]))

    def prolong(self, lvl, uc):
        """coarse level lvl+1 -> fine level lvl."""
        g = self._to_grid(lvl + 1, uc)
        for ax in self._axes(lvl + 1):
            g = _up1d(g, ax, self.factors[lvl])
        return torch.where(self.forms[lvl].ess_mask, 0.0, g.reshape(-1))

    def restrict(self, lvl, rf):
        """fine level lvl -> coarse level lvl+1."""
        g = self._to_grid(lvl, rf)
        for ax in self._axes(lvl):
            g = _down1d(g, ax, self.factors[lvl])
        return torch.where(self.forms[lvl + 1].ess_mask, 0.0, g.reshape(-1))

    def restrict_diag(self, lvl, d):
        """fine -> coarse for a DIAGONAL operator field: d_c = diag(P^T
        diag(d_f) P), the exact Galerkin coarse diagonal (squared transfer
        weights).  The cross terms P[f,c] d_f P[f,c'] (c != c') are
        dropped."""
        g = self._to_grid(lvl, d)
        for ax in self._axes(lvl):
            g = _down1d_sq(g, ax, self.factors[lvl])
        return torch.where(self.forms[lvl + 1].ess_mask, 0.0, g.reshape(-1))

    def inject(self, lvl, xf):
        """Nodal injection fine level lvl -> coarse level lvl+1: the nested
        lattices share nodes at stride ``factor``, so subsampling is the
        exact interpolant of the fine iterate on the coarse space."""
        g = self._to_grid(lvl, xf)
        f = self.factors[lvl]
        sl = [slice(None)] * g.ndim
        for ax in self._axes(lvl):
            sl[ax] = slice(None, None, f)
        return g[tuple(sl)].reshape(-1)

    # -- shifted V-cycle and nonlinear refresh ---------------------------
    def shift_data(self, dshift):
        """Per-level data for the SHIFTED V-cycle on A + diag(dshift): the
        fine-level diagonal reaction restricted down every level with the
        exact-Galerkin squared weights, plus the inverse of the shifted
        coarse matrix.  Built once per Newton direction; a V-cycle with it
        costs what one without it does.

        This makes the hierarchy alpha-aware: in the LVPP Schur solve the
        reaction diag(C D^-1 C^T) grows like alpha on the active set, and a
        V-cycle built on A alone over-corrects those dofs by O(alpha).

        The tensors are the GMG's own: each call writes over those of the
        call before (the shifted V-cycle's graph reads them in place)."""
        old = self._sdata or {"shifts": [None] * len(self.forms),
                              "coarse_inv": None}
        shifts = list(old["shifts"])
        shifts[0] = _write(shifts[0],
                           torch.where(self.forms[0].ess_mask, 0.0, dshift),
                           True)
        for lvl in range(len(self.forms) - 1):
            shifts[lvl + 1] = _write(shifts[lvl + 1],
                                     self.restrict_diag(lvl, shifts[lvl]),
                                     True)
        Ac = self.coarse_A + torch.diag(shifts[-1])
        self._sdata = {"shifts": shifts,
                       "coarse_inv": _write(old["coarse_inv"],
                                            torch.linalg.inv(Ac), True)}
        return self._sdata

    def refresh(self, x, fields=None):
        """Re-linearize EVERY level at the Newton iterate ``x``: states and
        diagonals from the iterate injected down the levels, the coarse
        matrix assembled densely (the same matrix as the coarse form's
        matvec applied to the unit vectors) and its inverse.  A linear
        hierarchy (``nonlinear=False``) is left as it is."""
        if not self.nonlinear:
            return
        xs = [x]
        for lvl in range(len(self.forms) - 1):
            xs.append(self.inject(lvl, xs[-1]))
        self._linearize(xs, fields or {})

    # -- V-cycle ---------------------------------------------------------
    def _op(self, lvl, x, sdata=None):
        y = self.forms[lvl].grad_mult(self.states[lvl], x)
        if sdata is not None:
            y = y + sdata["shifts"][lvl] * x  # shifts are 0 at ess dofs
        return y

    def _smooth(self, lvl, x, b, sdata=None):
        d = self.diags[lvl]
        if sdata is not None:
            d = d + sdata["shifts"][lvl]
        safe = torch.where(torch.abs(d) < 1e-30, 1.0, d)
        for _ in range(self.nu):
            r = b - self._op(lvl, x, sdata)
            x = x + self.omega * r / safe
        return x

    def vcycle(self, lvl, b, sdata=None):
        """One V-cycle from level ``lvl`` down: on A, or on A +
        diag(shift) with ``sdata`` from ``shift_data``.

        From level 0 on a CUDA device it replays the graph of its kind
        (plain or shifted) and returns a new tensor; the graph is captured
        at the first call, and again where a level tensor it reads was
        replaced instead of written in place."""
        if lvl or not b.is_cuda:
            if lvl == 0:
                self.eager_calls += 1
            return self._vcycle(lvl, b, sdata)
        return self._replay(b, sdata)

    def _vcycle(self, lvl, b, sdata=None):
        if lvl == len(self.forms) - 1:
            cinv = self.coarse_inv if sdata is None else sdata["coarse_inv"]
            return cinv @ b
        x = self._smooth(lvl, torch.zeros_like(b), b, sdata)
        r = b - self._op(lvl, x, sdata)
        rc = self.restrict(lvl, r)
        xc = self._vcycle(lvl + 1, rc, sdata)
        x = x + self.prolong(lvl, xc)
        return self._smooth(lvl, x, b, sdata)

    def _read_by_vcycle(self, sdata):
        """The level tensors a V-cycle reads."""
        held = [f.ess_mask for f in self.forms] + self.diags[:-1]
        for state in self.states[:-1]:
            held += [h.planes if isinstance(h, SymHess) else h
                     for h in state]
        if sdata is None:
            return held + [self.coarse_inv]
        return held + list(sdata["shifts"]) + [sdata["coarse_inv"]]

    def _replay(self, b, sdata):
        kind = "plain" if sdata is None else "shifted"
        held = self._read_by_vcycle(sdata)
        key = (b.shape, b.dtype, b.device,
               tuple(t.data_ptr() for t in held))
        g = self._graphs.get(kind)
        if g is None or g.key != key:
            self._graphs.pop(kind, None)  # its memory pool goes first
            g = self._graphs[kind] = self._capture(b, sdata, key, held)
        else:
            g.b.copy_(b)
        g.graph.replay()
        self.replays += 1
        # a new tensor: cg keeps p = z across the next call
        return g.b.clone()

    def _capture(self, b, sdata, key, held):
        """A CUDA graph of one V-cycle from level 0 on a static copy of
        ``b``, which its last node overwrites with the result (the V-cycle
        has read ``b`` for the last time), after an eager V-cycle on the
        capture stream (libraries set themselves up lazily, which a
        capture does not allow).

        cuBLAS keeps a workspace for each stream it runs on (32 MiB on
        Hopper).  Its workspaces are dropped before the warm-up, before
        the capture and after it: the capture stream's is then allocated
        inside the graph's private pool, which keeps it for the replays,
        and no second workspace stays allocated beside the main stream's."""
        with profiling.phase("gmg/capture"):
            static_b = b.clone()
            if self._stream is None:
                self._stream = torch.cuda.Stream(b.device)
            main = torch.cuda.current_stream(b.device)
            self._stream.wait_stream(main)
            torch._C._cuda_clearCublasWorkspaces()
            with torch.cuda.stream(self._stream):
                self._vcycle(0, static_b, sdata)
            torch._C._cuda_clearCublasWorkspaces()
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph, stream=self._stream):
                static_b.copy_(self._vcycle(0, static_b, sdata))
            torch._C._cuda_clearCublasWorkspaces()
            main.wait_stream(self._stream)
        self.captures += 1
        return _VGraph(graph, key, held, static_b)

    def __call__(self, r):
        return self.vcycle(0, r)

    def set_fine(self, state, diag):
        """Linearize the finest level at the caller's Newton state, copied
        into the finest level's tensors."""
        self.states[0] = _write(self.states[0], state, False)
        self.diags[0] = _write(self.diags[0], diag, False)

    def as_preconditioner(self):
        """``NewtonOptions.preconditioner`` factory: the finest level takes
        the current Newton state, the coarse levels stay as they are.
        ``newton`` finds the GMG in ``fused_precond`` and calls
        ``newton_precond`` instead, which also refreshes a nonlinear
        hierarchy at the iterate."""

        def make(form, state):
            self.set_fine(state, form.grad_diag(state))
            return self

        make.fused_precond = self
        return make

    def newton_precond(self, form, x, state, fields):
        """The preconditioner of one Newton direction at iterate ``x``: a
        nonlinear hierarchy re-linearizes every level at ``x``, then the
        finest level takes the form's Newton state and its diagonal."""
        d0 = form.grad_diag(state)
        self.refresh(x, fields)
        self.set_fine(state, d0)
        return self


class PGBlockGMG:
    """Block preconditioner for the LVPP (u, psi) saddle Jacobian, with
    geometric multigrid on the primal block:

        M = blockdiag( GMG V-cycle on the primal (stiffness) block,
                       |diag|^{-1} on the latent block ).

    ``gmg`` is a GMG on primal-space forms of the objective energy (its
    states stay frozen: the objective block of the PG Jacobian is the
    plain objective Hessian); the latent |diag| comes from the current
    Newton state of the saddle form.
    """

    def __init__(self, gmg: GMG, form, latent_block: int = 1):
        self.gmg = gmg
        self.form = form
        self.n0 = int(form.offsets[latent_block])

    def as_preconditioner(self):
        def make(form, state):
            d = torch.abs(form.grad_diag(state))[self.n0:]
            safe = torch.where(d < 1e-30, 1.0, d)

            def M(r):
                zu = self.gmg.vcycle(0, r[:self.n0])
                return torch.cat([zu, r[self.n0:] / safe])

            return M

        make.fused_precond = self
        return make

    def newton_precond(self, form, x, state, fields):
        return self.as_preconditioner()(form, state)


def build_hierarchy(build_fn, n0: int, levels: int):
    """Forms on meshes n0*2^(levels-1), ..., 2*n0, n0 cells per side.

    ``build_fn(n) -> form`` builds the discretization on an n x n (x n)
    structured mesh (and chooses its device).  Returns the fine-to-coarse
    form list.
    """
    ns = [n0 * 2**k for k in range(levels - 1, -1, -1)]
    return [build_fn(n) for n in ns]


def build_hp_hierarchy(build_fn, n0: int, levels: int, order: int):
    """hp-hierarchy: the order-p space on the finest mesh, its Q1 subspace
    on the same mesh, then geometric Q1 coarsening down to ``n0`` cells.

    ``build_fn(n, order) -> form``.  Returns the fine-to-coarse form list
    for ``GMG`` (factors [p, 2, 2, ...]; for order 1 the duplicate fine
    level is skipped).
    """
    ns = [n0 * 2**k for k in range(levels - 1, -1, -1)]
    forms = [build_fn(ns[0], order)] if order > 1 else []
    forms += [build_fn(n, 1) for n in ns]
    return forms


class PGSchurGMG:
    """Preconditioner for the CONDENSED LVPP primal system S = A + C D^-1
    C^T of the Schur Newton direction (``solvers.schur_solve``): a V-cycle
    on the primal objective block A, shifted by the exact reaction
    diagonal diag(C D^-1 C^T) that the Schur solve computes per direction
    (``shift_data``), so the V-cycle handles both the diffusion-dominated
    dofs and the alpha-amplified active-set reaction.

    Build the GMG on primal-space forms of the objective energy
    (``build_hp_hierarchy`` for order > 1) and pass ``as_preconditioner()``
    to NewtonOptions together with ``lin_solver='schur'``.
    """

    def __init__(self, gmg: GMG):
        self.gmg = gmg

    def as_preconditioner(self):
        def make(form, state):
            raise ValueError(
                "PGSchurGMG only serves the Schur Newton direction "
                "(lin_solver='schur'); there is no eager preconditioner"
            )

        make.fused_precond = self
        return make

    def newton_precond(self, form, x, state, fields):
        return self.as_preconditioner()(form, state)

    def shift_data(self, dshift):
        """See ``GMG.shift_data``."""
        return self.gmg.shift_data(dshift)

    def apply_primal(self, v, sdata=None):
        """V-cycle on the primal block: on A when ``sdata`` is None, on the
        shifted A + diag(dshift) when ``sdata`` comes from ``shift_data``."""
        return self.gmg.vcycle(0, v, sdata)
