"""Batched AD assembly: energy, residual, Jacobian from a point energy.

PyTorch counterpart of ``mfem_ad_tpu.integrator`` for structured meshes
(uniform Cartesian quads and hexes).  The per-element dual-number loops of
an AD integrator become batched tensor programs over ``[n_elem, n_qp]``:

- energy      = sum_eq f(B^T u) * w
- residual    = scatter(B (grad f) w)
- Jacobian    = B H B^T w, applied matrix-free (``hess_state`` +
                ``hess_mult``) or as dense element blocks
                (``element_jacobians``)

The tabulated tensors live in ``ADBlockIntegrator.tables``, a nested
dictionary with the JAX package's keys and install rules, backed by the
module's registered buffers.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch
from torch import nn
from torch.func import grad, jacfwd, vmap

from .ad import ADFunction
from .adeval import ADEval, build_B, shapedim
from .coefficients import (
    GridFunctionCoefficient,
    QPContext,
    ScalarFieldCoefficient,
)
from .fespace import FESpace
from .geometry import geom_factors
from .quadrature import default_ad_order, get_rule

ROUTES = ("auto", "kernel", "two_stage")


def qpmap(fn, x, p: dict):
    """Apply a per-point function over the [ne, nq] leading dims of ``x``
    and of every parameter (element-shared [1, nq, k] values broadcast
    without a copy)."""
    ne = x.shape[0]
    pe = {k: v.expand((ne,) + tuple(v.shape[1:])) for k, v in p.items()}
    return vmap(vmap(fn))(x, pe)


# ---------------------------------------------------------------------------
# Compact symmetric Hessian state
# ---------------------------------------------------------------------------


@lru_cache(maxsize=None)
def _tri_expand(n: int) -> np.ndarray:
    """flat (i, j) -> packed index of (min, max) in the upper-triangle pair
    order (a, b), a <= b."""
    ki = {}
    for a in range(n):
        for b in range(a, n):
            ki[(a, b)] = len(ki)
    return np.asarray(
        [ki[(min(i, j), max(i, j))] for i in range(n) for j in range(n)]
    )


class SymHess:
    """Packed symmetric per-qp Hessian state: triangle planes [K, ne, nq]
    (K = n(n+1)/2, pair order (a, b), a <= b).

    Produced by ``hess_state(..., sym=True)`` (the Newton state), consumed
    plane by plane by ``hess_mult`` (n(n+1)/2 state reads per qp instead
    of n^2) and expanded once per Newton direction by ``diagonal`` and
    ``element_matrices``.
    """

    def __init__(self, planes: torch.Tensor, n: int):
        self.planes = planes
        self.n = int(n)

    def full(self) -> torch.Tensor:
        """Expand to the full [ne, nq, n, n] tensor."""
        n = self.n
        idx = torch.as_tensor(_tri_expand(n), device=self.planes.device)
        out = self.planes[idx].reshape((n, n) + tuple(self.planes.shape[1:]))
        return out.permute(2, 3, 0, 1)


# ---------------------------------------------------------------------------
# Table construction helpers
# ---------------------------------------------------------------------------


def _dedup_elements(arr: np.ndarray) -> np.ndarray:
    """Collapse the element axis to 1 when every element is identical."""
    if arr.shape[0] > 1:
        scale = np.abs(arr).max() or 1.0
        if np.allclose(arr, arr[:1], rtol=0.0, atol=1e-12 * scale):
            return arr[:1]
    return arr


def _mxu_cost(m_mult: int, k: int, n: int) -> int:
    """The JAX package's padded 128-lane GEMM cost model.  It decides which
    contraction factors are installed; kept so that the same factors (and
    hence the same kernel routes) exist in both packages."""
    ru = lambda x: -(-x // 128) * 128  # noqa: E731
    return m_mult * ru(k) * ru(n)


def _space_gridmeta(space: FESpace):
    """("l2",) for element-contiguous L2 dofs, ("h1", dims, ndims, offs, p)
    for lexicographically numbered structured H1 dofs, else None."""
    g = getattr(space, "grid", None)
    if g is None or g[0] == "h1t":
        return None
    if g[0] == "l2":
        return ("l2",)
    p = space.order
    offs = np.rint(np.asarray(space.elem.nodes) * p).astype(np.int64)
    return ("h1", g[1], g[2], offs, p)


def _node_slices(dims, offs_d, p):
    """Strided slice of the dof grid holding one element node for every
    element, in element order (2D: [ny, nx]; 3D: [nx, ny, nz])."""
    if len(dims) == 2:
        nx, ny = dims
        ai, aj = int(offs_d[0]), int(offs_d[1])
        return (
            slice(aj, aj + (ny - 1) * p + 1, p),
            slice(ai, ai + (nx - 1) * p + 1, p),
        ), (ny, nx)
    nx, ny, nz = dims
    ai, aj, ak = (int(offs_d[k]) for k in range(3))
    return (
        slice(ai, ai + (nx - 1) * p + 1, p),
        slice(aj, aj + (ny - 1) * p + 1, p),
        slice(ak, ak + (nz - 1) * p + 1, p),
    ), (nx, ny, nz)


def _fast_gather(u, meta, vdim: int, nd: int):
    """Element dofs [ne, nd, vdim] by reshape (L2) or strided slices of the
    structured dof grid (H1)."""
    if meta[0] == "l2":
        return u.reshape(vdim, -1, nd).permute(1, 2, 0)
    _, dims, ndims, offs, p = meta
    ne = int(np.prod(dims))
    U = u.reshape((vdim,) + tuple(ndims))
    cols = []
    for d in range(nd):
        sl, _ = _node_slices(dims, offs[d], p)
        cols.append(U[(slice(None),) + sl].reshape(vdim, ne))
    return torch.stack(cols, dim=0).permute(2, 0, 1)


def _fast_scatter(re, meta, vdim: int, nd: int):
    """Scatter-add element values [ne, nd, vdim] into the dof vector: the
    exact adjoint of ``_fast_gather``.  Each element node adds into a
    strided view of a zero dof grid; within one node's view no two
    elements share a dof, so there are no atomics and the sum order is
    fixed."""
    if meta[0] == "l2":
        return re.permute(2, 0, 1).reshape(-1)
    _, dims, ndims, offs, p = meta
    out = torch.zeros((vdim,) + tuple(ndims), dtype=re.dtype,
                      device=re.device)
    for d in range(nd):
        sl, shape = _node_slices(dims, offs[d], p)
        out[(slice(None),) + sl].add_(re[:, d, :].T.reshape((vdim,) + shape))
    return out.reshape(-1)


def _elmat_from_h(B0s, B0t, H6):
    """Dense element blocks A_e[(v,d),(w,k)] = B_s H B_t^T summed over qp
    (element-shared shape tensors [nq, nd, sd])."""
    return torch.einsum("qds,eqvswt,qkt->evdwk", B0s, H6, B0t)


# ---------------------------------------------------------------------------


class ADBlockIntegrator(nn.Module):
    """Domain integrator of a scalar energy over one or more FE spaces on a
    structured (uniform-Jacobian) mesh.

    Args:
        f: the ADFunction energy; its ``params`` coefficients are tabulated
           here (static parameters only).
        spaces: list of FESpace, one per block.
        modes: list of ADEval, one per space.
        ir_order: quadrature order (default 2*max(p)+2).
        device, dtype: where and in which type the tables live.
        tables: a ready tables dictionary (see ``convert.tables_from_numpy``)
           to use instead of tabulating.
        closed: use the energy's hand-derived ``gradient_closed`` /
           ``hessian_closed`` in ``residual`` / ``hess_state`` instead of
           AD (off by default, as in the JAX package).

    ``tables`` (backed by registered buffers):
        B:      tuple of [1, nq, nd_s, sd_s]
        w:      [1, nq]
        edof:   tuple of [ne, nd_s] int64
        static: dict name -> [1, nq, k]
        R, R0, D0: tuples of GEMM factors for x = B^T u, r = B g, diagonals
        W, W0:  dicts "s_t" -> element-matrix contraction factors
    """

    def __init__(
        self,
        f: ADFunction,
        spaces,
        modes,
        ir_order: int | None = None,
        *,
        device,
        dtype: torch.dtype = torch.float64,
        tables: dict | None = None,
        closed: bool = False,
    ):
        super().__init__()
        if isinstance(spaces, FESpace):
            spaces = [spaces]
        if isinstance(modes, ADEval):
            modes = [modes]
        if len(spaces) != len(modes):
            raise ValueError("one ADEval mode per space")
        self.f = f
        self.spaces = list(spaces)
        self.modes = list(modes)
        self.closed = closed
        self.dtype = dtype
        mesh = spaces[0].mesh
        for s in spaces:
            if s.mesh is not mesh:
                raise ValueError("all spaces must share one mesh")
        self.mesh = mesh
        if not mesh.uniform_jacobian:
            raise NotImplementedError(
                "only structured quad/hex meshes are ported (the geometry "
                "pullback for unstructured meshes is not)"
            )
        for name, coeff in f.params.items():
            if isinstance(coeff, (GridFunctionCoefficient,
                                  ScalarFieldCoefficient)):
                raise NotImplementedError(
                    f"runtime field parameter {name!r}: only static "
                    "parameters are ported"
                )
        if ir_order is None:
            ir_order = default_ad_order(max(s.order for s in spaces))
        self.ir = get_rule(mesh.geom, ir_order)
        self.nq = self.ir.npoints
        sdim = mesh.dim
        self.sd = [shapedim(m, sdim) for m in modes]
        self.vdim = [s.vdim for s in spaces]
        self.nd = [s.nd for s in spaces]
        self.nds = [s.ndof_scalar for s in spaces]
        self.widths = [sd * v for sd, v in zip(self.sd, self.vdim)]
        self.x_off = np.concatenate([[0], np.cumsum(self.widths)])
        self.n_input = int(self.x_off[-1])
        if self.n_input != f.n_input:
            raise ValueError(
                f"energy n_input={f.n_input} but input layout has width "
                f"{self.n_input} (widths per space: {self.widths})"
            )
        for s, m in zip(spaces, modes):
            if s.vdim > 1 and not (m & ADEval.VECTOR):
                raise ValueError("vdim > 1 requires ADEval.VECTOR")
        self._gridmeta = [_space_gridmeta(s) for s in spaces]
        if any(m is None for m in self._gridmeta):
            raise NotImplementedError(
                "only lexicographic structured H1 and L2 spaces are ported"
            )
        if tables is None:
            tables = self._tabulate(device)
        self._install(tables)

    # ------------------------------------------------------------------
    def _tabulate(self, device) -> dict:
        mesh, dtype = self.mesh, self.dtype
        spaces, modes = self.spaces, self.modes
        nb = len(spaces)
        gf = geom_factors(mesh, self.ir)

        def dev(a):
            return torch.as_tensor(np.array(a), dtype=dtype, device=device)

        B_np = [
            _dedup_elements(np.asarray(build_B(s, m, self.ir, gf)))
            for s, m in zip(spaces, modes)
        ]
        static = {}
        ctx = QPContext(gf.xq, ir=self.ir, mesh=mesh)
        for name, coeff in self.f.params.items():
            static[name] = dev(_dedup_elements(np.asarray(coeff.eval_qp(ctx))))
        t = {
            "B": tuple(dev(b) for b in B_np),
            "w": dev(_dedup_elements(np.asarray(gf.w))),
            "edof": tuple(
                torch.as_tensor(np.asarray(s.edof, dtype=np.int64),
                                device=device)
                for s in spaces
            ),
            "static": static,
        }
        # GEMM forms of the contractions against the element-shared B:
        #   R_s  [nq*w_s, nde_s]       R[(q,a), i] = Bf[q, i, a]
        #   W_st [nq*w_s*w_t, nde_s*nde_t] = Bf_s (x) Bf_t   (A = Hflat @ W)
        # with Bf the vdim-block-diagonal expansion of B; blocked factors
        # R0/W0 contract against B itself.  Install rules follow the JAX
        # package (integrator.py:709-872).
        Bf_np = []
        for s in range(nb):
            b0 = B_np[s][0]  # [nq, nd, sd]
            v, ndl, sdl = self.vdim[s], self.nd[s], self.sd[s]
            bf = np.zeros((self.nq, v * ndl, v * sdl), b0.dtype)
            for k in range(v):
                bf[:, k * ndl:(k + 1) * ndl, k * sdl:(k + 1) * sdl] = b0
            Bf_np.append(bf)
        t["R"] = tuple(
            dev(bf.transpose(0, 2, 1).reshape(-1, bf.shape[1])) for bf in Bf_np
        )
        R0 = []
        for s in range(nb):
            v, nd, sdl = self.vdim[s], self.nd[s], self.sd[s]
            blocked = _mxu_cost(v, self.nq * sdl, nd)
            full = _mxu_cost(1, self.nq * sdl * v, nd * v)
            if v > 1 and blocked >= full:
                R0 = None  # one flag for all spaces: keep keys uniform
                break
            R0.append(dev(B_np[s][0].transpose(0, 2, 1).reshape(-1, nd)))
        if R0 is not None:
            t["R0"] = tuple(R0)
        t["D0"] = tuple(
            dev(np.einsum("qda,qdb->qabd", B_np[s][0], B_np[s][0])
                .reshape(-1, self.nd[s]))
            for s in range(nb)
        )
        W0d, Wd = {}, {}
        for s in range(nb):
            for t_ in range(nb):
                vs = self.vdim[s]
                sds, sdt = self.sd[s], self.sd[t_]
                nds, ndt = self.nd[s], self.nd[t_]
                ws, wt = self.widths[s], self.widths[t_]
                ns, nt = vs * nds, self.vdim[t_] * ndt
                full_fits = self.nq * ws * wt * ns * nt <= 16_000_000
                if full_fits:
                    Wd[f"{s}_{t_}"] = dev(
                        np.einsum("qia,qjb->qabij", Bf_np[s], Bf_np[t_])
                        .reshape(self.nq * ws * wt, ns * nt)
                    )
                if self.nq * sds * sdt * nds * ndt > 32_000_000:
                    continue
                m_mult = (
                    vs * (vs + 1) // 2 if s == t_ and vs >= 3
                    else vs * self.vdim[t_]
                )
                blocked = _mxu_cost(m_mult, self.nq * sds * sdt, nds * ndt)
                if full_fits and blocked >= _mxu_cost(
                    1, self.nq * ws * wt, ns * nt
                ):
                    continue  # the full-W GEMM is preferred
                W0d[f"{s}_{t_}"] = dev(
                    np.einsum("qia,qjb->qabij", B_np[s][0], B_np[t_][0])
                    .reshape(self.nq * sds * sdt, nds * ndt)
                )
        t["W0"] = W0d
        t["W"] = Wd
        return t

    def _install(self, tables: dict):
        """Register every table as a buffer; ``tables`` rebuilds the nested
        view from them, so ``.to()`` keeps it current."""
        layout = {}
        for key, val in tables.items():
            if isinstance(val, (tuple, list)):
                names = []
                for i, v in enumerate(val):
                    self.register_buffer(f"{key}_{i}", v)
                    names.append(f"{key}_{i}")
                layout[key] = ("tuple", names)
            elif isinstance(val, dict):
                names = {}
                for k, v in val.items():
                    self.register_buffer(f"{key}_{k}", v)
                    names[k] = f"{key}_{k}"
                layout[key] = ("dict", names)
            else:
                self.register_buffer(key, val)
                layout[key] = ("tensor", key)
        self._layout = layout

    @property
    def tables(self) -> dict:
        out = {}
        for key, (kind, names) in self._layout.items():
            if kind == "tuple":
                out[key] = tuple(getattr(self, n) for n in names)
            elif kind == "dict":
                out[key] = {k: getattr(self, n) for k, n in names.items()}
            else:
                out[key] = getattr(self, names)
        return out

    # ------------------------------------------------------------------
    def eval_params(self) -> dict:
        """Static per-qp parameter values, name -> [1, nq, k]."""
        return dict(self.tables["static"])

    def gather(self, s: int, u):
        """Element dofs of block s: [ne, nd, vdim] (byNODES layout)."""
        return _fast_gather(u, self._gridmeta[s], self.vdim[s], self.nd[s])

    def scatter(self, s: int, re):
        """Scatter-add element values [ne, nd, vdim] into block-s dofs."""
        return _fast_scatter(re, self._gridmeta[s], self.vdim[s], self.nd[s])

    def x_qp(self, ublocks):
        """Stacked per-qp input x [ne, nq, n_input] (x = B^T u per space,
        component-major within a space)."""
        t = self.tables
        nq = self.nq
        xs = []
        for s in range(len(self.spaces)):
            ue = self.gather(s, ublocks[s])
            ne = ue.shape[0]
            if "R0" in t:
                v, nd, sd = self.vdim[s], self.nd[s], self.sd[s]
                ue2 = ue.permute(0, 2, 1).reshape(ne * v, nd)
                x = (ue2 @ t["R0"][s].T).reshape(ne, v, nq, sd)
                x = x.permute(0, 2, 1, 3)  # [ne, nq, v, sd]
            else:
                ue2 = ue.permute(0, 2, 1).reshape(ne, -1)  # [ne, nde]
                x = ue2 @ t["R"][s].T  # [ne, nq*w] — one GEMM
            xs.append(x.reshape(ne, nq, self.widths[s]))
        return torch.cat(xs, dim=-1)

    def _re_from_g(self, g, s: int):
        """Element vectors [ne, nd, vdim] from weighted per-qp gradients."""
        t = self.tables
        ne, nq = g.shape[0], g.shape[1]
        o = int(self.x_off[s])
        seg = g[..., o:o + self.widths[s]]
        if "R0" in t:
            v, nd, sd = self.vdim[s], self.nd[s], self.sd[s]
            gp = seg.reshape(ne, nq, v, sd).permute(0, 2, 1, 3)
            re = gp.reshape(ne * v, nq * sd) @ t["R0"][s]  # [ne*v, nd]
            return re.reshape(ne, v, nd).permute(0, 2, 1)
        re = seg.reshape(ne, -1) @ t["R"][s]  # [ne, nde] — one GEMM
        return re.reshape(ne, self.vdim[s], self.nd[s]).permute(0, 2, 1)

    # ------------------------------------------------------------------
    def energy(self, ublocks):
        x = self.x_qp(ublocks)
        vals = qpmap(self.f.energy, x, self.eval_params())
        return torch.sum(vals * self.tables["w"])

    def residual(self, ublocks):
        """Per-block residual vectors r_s = scatter(B_s (grad f) w)."""
        x = self.x_qp(ublocks)
        if self.closed and callable(self.f.gradient_closed):
            pt = self.f.gradient_closed
        else:
            pt = grad(self.f.energy)
        g = qpmap(pt, x, self.eval_params()) * self.tables["w"][..., None]
        return [
            self.scatter(s, self._re_from_g(g, s))
            for s in range(len(self.spaces))
        ]

    def hess_state(self, ublocks, sym: bool = False):
        """Per-qp weighted Hessian, the Newton state: the full
        [ne, nq, n, n] tensor, or with ``sym=True`` the packed ``SymHess``
        upper-triangle planes [n(n+1)/2, ne, nq]."""
        x = self.x_qp(ublocks)
        p = self.eval_params()
        if self.closed and callable(self.f.hessian_closed):
            H = qpmap(self.f.hessian_closed, x, p)
        else:
            # jacfwd(grad) promotes f32 per-point ops that take a Python
            # float to f64 (torch 2.x); the state keeps the tables' type
            H = qpmap(jacfwd(grad(self.f.energy)), x, p).to(x.dtype)
        w = self.tables["w"]
        if not sym:
            return H * w[..., None, None]
        n = self.n_input
        planes = torch.stack(
            [H[:, :, a, b] for a in range(n) for b in range(a, n)], dim=0
        )
        return SymHess(planes * w[None], n)

    def hess_mult(self, Hq, vblocks):
        """Matrix-free J v = scatter(B (Hq (B^T v)))."""
        xv = self.x_qp(vblocks)
        if isinstance(Hq, SymHess):
            n = Hq.n
            xvT = xv.permute(2, 0, 1)  # [n, ne, nq]
            acc = [None] * n
            k = 0
            for a in range(n):
                for b in range(a, n):
                    tk = Hq.planes[k]
                    k += 1
                    ta = tk * xvT[b]
                    acc[a] = ta if acc[a] is None else acc[a] + ta
                    if a != b:
                        tb = tk * xvT[a]
                        acc[b] = tb if acc[b] is None else acc[b] + tb
            Hxv = torch.stack(acc, dim=-1)  # [ne, nq, n]
        else:
            Hxv = torch.einsum("eqnm,eqm->eqn", Hq, xv)
        return [
            self.scatter(s, self._re_from_g(Hxv, s))
            for s in range(len(self.spaces))
        ]

    def diagonal(self, Hq):
        """Per-block diagonal of the assembled Jacobian (Jacobi PC)."""
        t = self.tables
        if isinstance(Hq, SymHess):
            Hq = Hq.full()  # once per Newton direction, not per matvec
        ne, nq = Hq.shape[0], Hq.shape[1]
        out = []
        for s in range(len(self.spaces)):
            o = int(self.x_off[s])
            v, nd, sd = self.vdim[s], self.nd[s], self.sd[s]
            blk = Hq[..., o:o + self.widths[s], o:o + self.widths[s]]
            H6 = blk.reshape(ne, nq, v, sd, v, sd)
            Hvv = torch.diagonal(H6, dim1=2, dim2=4)  # [ne,nq,sd,sd,vdim]
            Hp = Hvv.permute(0, 4, 1, 2, 3).reshape(ne * v, nq * sd * sd)
            D = (Hp @ t["D0"][s]).reshape(ne, v, nd).permute(0, 2, 1)
            out.append(self.scatter(s, D))
        return out

    def element_jacobians(self, ublocks, route: str = "auto"):
        """Dense element Jacobians A_e [ne, nde, nde] of the (0, 0) block.

        ``route``:
          "kernel"     the fused element-Jacobian kernel
                       (``ops.fused_jacobian``); raises where it does not
                       apply (see ``kernel_route_refusal``);
          "two_stage"  ``hess_state`` then ``element_matrices``;
          "auto"       the kernel where it applies, else two-stage.
        """
        from .ops.fused_jacobian import (
            element_jacobian_via_kernel,
            kernel_route_refusal,
        )

        if route not in ROUTES:
            raise ValueError(f"route must be one of {ROUTES}, got {route!r}")
        if route == "auto":
            route = "two_stage" if kernel_route_refusal(self) else "kernel"
        if route == "kernel":
            return element_jacobian_via_kernel(self, ublocks)
        return self.element_matrices(self.hess_state(ublocks), 0, 0)

    def element_matrices(self, Hq, s: int, t_: int):
        """Dense element blocks A_e[(v,d),(w,k)] for pair (test s, trial
        t_), byNODES flat layout (v*nd + d): one GEMM against the full W
        factor where it is installed, else the per-qp B H B^T einsum."""
        t = self.tables
        if isinstance(Hq, SymHess):
            Hq = Hq.full()
        ne, nq = Hq.shape[0], Hq.shape[1]
        os_, ot = int(self.x_off[s]), int(self.x_off[t_])
        nde_s = self.vdim[s] * self.nd[s]
        nde_t = self.vdim[t_] * self.nd[t_]
        blk = Hq[..., os_:os_ + self.widths[s], ot:ot + self.widths[t_]]
        key = f"{s}_{t_}"
        if key in t["W"]:
            A = blk.reshape(ne, -1) @ t["W"][key]
            return A.reshape(ne, nde_s, nde_t)
        H6 = blk.reshape(
            ne, nq, self.vdim[s], self.sd[s], self.vdim[t_], self.sd[t_]
        )
        A = _elmat_from_h(t["B"][s][0], t["B"][t_][0], H6)
        return A.reshape(ne, nde_s, nde_t)
