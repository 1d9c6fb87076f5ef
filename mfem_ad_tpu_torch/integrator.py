"""Batched AD assembly: energy, residual, Jacobian from a point energy.

PyTorch counterpart of ``mfem_ad_tpu.integrator``.  The per-element
dual-number loops of an AD integrator become batched tensor programs over
``[n_elem, n_qp]``:

- energy      = sum_eq f(B^T u) * w
- residual    = scatter(B (grad f) w)
- Jacobian    = B H B^T w, applied matrix-free (``hess_state`` +
                ``hess_mult``) or as dense element blocks
                (``element_jacobians``)

The tabulated tensors live in ``ADBlockIntegrator.tables``, a nested
dictionary with the JAX package's keys and install rules, backed by the
module's registered buffers.

Dof exchange (gather of element dofs, its adjoint scatter), by space:

- L2: element-contiguous dofs, a reshape;
- structured quads and hexes ("h1"): one strided slice of the
  lexicographic dof grid per element node;
- structured triangles ("h1t"): the same, with one slice group per cell
  orientation, interleaved into the e = 2*cell + t element order;
- anything else (tets, meshes without their structure): an index gather
  by ``edof``, and as its adjoint the transpose-gather: every dof sums the
  element slots it appears in (``einv``, a fixed valence axis).  No
  scatter-add and no atomics: the sum order is the same in every run.

Unstructured meshes take the geometry pullback (``_PullbackEnergy``): the
shape tensor is built from the reference basis, so it stays
element-shared and the GEMM factors apply, and the per-element inverse
Jacobian ``_invj`` maps reference gradients to physical ones inside the
point energy.  Vector integrands and DIV/CURL/QVALUE modes keep physical,
element-varying shape tensors and contract them by einsum.
"""

from __future__ import annotations

import copy
from functools import lru_cache

import numpy as np
import torch
from torch import nn
from torch.func import grad, jacfwd

from .ad import ADFunction, ADVectorFunction, qpmap
from .adeval import ADEval, build_B, shapedim
from .coefficients import (
    GridFunctionCoefficient,
    QPContext,
    ScalarFieldCoefficient,
)
from .fespace import FESpace
from .geometry import GeomFactors, geom_factors
from .ops import ad_jacobian as adj
from .ops import blocked_jacobian as bj
from .ops import fused_jacobian as fj
from .ops import grid_hess_mult as ghm
from .ops.energy_codegen import UnsupportedEnergy
from .quadrature import default_ad_order, get_rule

ROUTES = ("auto", "kernel", "kernel_ad", "two_stage")


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
    """The dof exchange of a space: ("l2",) for element-contiguous L2 dofs,
    ("h1", dims, ndims, offs, p) for lexicographically numbered structured
    H1 dofs, ("h1t", dims, ndims, offs[2, nd, 2], p) for structured
    triangle meshes (one slice group per cell orientation), else None (the
    generic gather by ``edof`` and the transpose-gather scatter)."""
    g = getattr(space, "grid", None)
    if g is None:
        return None
    if g[0] == "l2":
        return ("l2",)
    p = space.order
    if g[0] == "h1t":
        rs = np.asarray(space.elem.nodes)  # [nd, 2] reference (r, s)
        r, s = rs[:, 0], rs[:, 1]
        # cells split along the SW-NE diagonal (mesh.make_cartesian_2d):
        #   t=0 (v00, v10, v11): X = (r + s, s) in cell units
        #   t=1 (v00, v11, v01): X = (r, r + s)
        offs = np.stack([
            np.stack([np.rint(p * (r + s)), np.rint(p * s)], axis=1),
            np.stack([np.rint(p * r), np.rint(p * (r + s))], axis=1),
        ]).astype(np.int64)  # [2, nd, (ai, aj)]
        return ("h1t", g[1], g[2], offs, p)
    offs = np.rint(np.asarray(space.elem.nodes) * p).astype(np.int64)
    return ("h1", g[1], g[2], offs, p)


def _node_slices(dims, offs_d, p):
    """Strided slice of the dof grid holding one element node for every
    element (every cell of one orientation on triangles), in element order
    (2D: [ny, nx]; 3D: [nx, ny, nz])."""
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


def _gather(u, meta, vdim: int, nd: int, edof):
    """Element dofs [ne, nd, vdim]: a reshape (L2), strided slices of the
    structured dof grid (h1, h1t), or the index gather by ``edof`` [ne, nd]
    (no grid)."""
    if meta is None:
        return u.reshape(vdim, -1)[:, edof].permute(1, 2, 0)
    if meta[0] == "l2":
        return u.reshape(vdim, -1, nd).permute(1, 2, 0)
    _, dims, ndims, offs, p = meta
    ne = int(np.prod(dims))
    U = u.reshape((vdim,) + tuple(ndims))

    def columns(offs_t):
        return torch.stack([
            U[(slice(None),) + _node_slices(dims, offs_t[d], p)[0]]
            .reshape(vdim, ne)
            for d in range(nd)
        ], dim=0)  # [nd, vdim, ne]

    if meta[0] == "h1t":
        # one slice group per orientation, interleaved back into the
        # mesh's e = 2*cell + t element order
        both = torch.stack([columns(offs[0]), columns(offs[1])], dim=0)
        return both.permute(3, 0, 1, 2).reshape(2 * ne, nd, vdim)
    return columns(offs).permute(2, 0, 1)


def _scatter(re, meta, vdim: int, nd: int, einv):
    """Sum element values [ne, nd, vdim] into the dof vector: the exact
    adjoint of ``_gather``.  On a grid each element node adds into a
    strided view of a zero dof grid, and within one node's view no two
    elements share a dof.  Without a grid every dof sums its element slots
    through ``einv`` [nds, V] (``_edof_inverse``).  Neither uses atomics,
    so the sum order is fixed."""
    if meta is None:
        flat = re.reshape(-1, vdim)  # [ne*nd, vdim]
        padded = torch.cat([flat, flat.new_zeros(1, vdim)])
        return padded[einv].sum(dim=1).T.reshape(-1)  # byNODES
    if meta[0] == "l2":
        return re.permute(2, 0, 1).reshape(-1)
    _, dims, ndims, offs, p = meta
    out = torch.zeros((vdim,) + tuple(ndims), dtype=re.dtype,
                      device=re.device)
    if meta[0] == "h1t":
        re4 = re.reshape(-1, 2, nd, vdim)  # e = 2*cell + t
        groups = [(offs[t], re4[:, t]) for t in range(2)]
    else:
        groups = [(offs, re)]
    for offs_t, vals in groups:
        for d in range(nd):
            sl, shape = _node_slices(dims, offs_t[d], p)
            out[(slice(None),) + sl].add_(
                vals[:, d, :].T.reshape((vdim,) + shape))
    return out.reshape(-1)


def _halo_local_meta(meta, K: int):
    """A rank's grid meta under a K-way band partition of the outer grid
    axis (dof-grid dim 0: y in 2D, x in 3D, the axis the element order is
    outer-major in).  Rank k owns the cell band [k*n_loc, (k+1)*n_loc);
    its dof block spans n_loc*p + 1 planes, the last the interface plane
    owned by rank k+1 (the ghost of the owner-zero layout; the last rank
    owns its last plane)."""
    kind, dims, ndims, offs, p = meta
    if len(dims) == 2:
        nx, ny = dims  # 2D element order e = j*nx + i: outer = ny
        if ny % K:
            raise ValueError(f"halo partition needs ny % K == 0 ({ny}, {K})")
        nl = ny // K
        ldims = (nx, nl)
    else:
        nx, ny, nz = dims  # 3D element order: outer = nx
        if nx % K:
            raise ValueError(f"halo partition needs nx % K == 0 ({nx}, {K})")
        nl = nx // K
        ldims = (nl, ny, nz)
    lndims = (nl * p + 1,) + tuple(ndims[1:])
    return (kind, ldims, lndims, offs, p)


class Band:
    """One rank's contiguous share of an integrator's element axis, and the
    dof exchange that goes with it (the JAX package's ("shard", ...) and
    ("halo", ...) modes).

    Shard mode: dof vectors are replicated.  The gather runs the whole
    serial gather, extends the element range with copies of element 0 to
    ``ne_loc * K`` (the zero-weight copy-pad of ``padded_tables``) and
    takes the band; the scatter embeds the band into the whole element
    range, drops the pad and runs the whole serial scatter, and the
    caller's sum over the ranks completes it.  Without a dof grid the
    gather indexes the band's own ``edof``.

    Halo mode (``halo=True``): a dof block is the rank's slot block of the
    owner-zero layout (``_halo_local_meta``).  The gather fills the ghost
    plane with the next rank's first plane, then runs the serial gather on
    the local grid; the scatter runs the local scatter, sends the ghost
    plane's sum to its owner (the next rank's first plane) and zeros the
    ghost again.  L2 blocks are element-local and exchange nothing.
    Runtime fields stay replicated and take the shard mode.

    ``comm`` None is the serial integrator's band: one rank, every element,
    the serial gather and scatter unchanged.
    """

    def __init__(self, comm, ne_true: int, halo: bool = False):
        self.comm = comm
        self.K = 1 if comm is None else comm.world_size
        self.halo = halo
        self.ne_true = int(ne_true)
        self.ne_loc = -(-self.ne_true // self.K)
        self.lo = 0 if comm is None else comm.rank * self.ne_loc

    def take(self, a: torch.Tensor) -> torch.Tensor:
        """The band of an element-leading array of the true element count,
        copy-padded with element 0 past its end."""
        lo, n = self.lo, self.ne_loc
        hi = min(lo + n, self.ne_true)
        if hi - lo == n:
            return a[lo:hi]
        return torch.cat([a[lo:hi],
                          a[:1].expand((n - max(hi - lo, 0),) + a.shape[1:])])

    def embed(self, a: torch.Tensor) -> torch.Tensor:
        """The band's element values placed in the true element range
        (zero elsewhere; the copy-pad dropped)."""
        if self.K == 1:
            return a
        full = a.new_zeros((self.ne_loc * self.K,) + tuple(a.shape[1:]))
        full[self.lo:self.lo + self.ne_loc] = a
        return full[:self.ne_true]

    def gather(self, u, meta, vdim: int, nd: int, edof, dofs: bool = True):
        """Element dofs [ne_loc, nd, vdim] of the band: ``dofs`` False for a
        replicated runtime field in halo mode."""
        if self.halo and dofs:
            if meta[0] == "l2":
                return _gather(u, meta, vdim, nd, None)
            lmeta = _halo_local_meta(meta, self.K)
            U = u.reshape((vdim,) + tuple(lmeta[2]))
            # the next rank's first (owned) plane into the ghost, which
            # holds zero (the last rank receives zeros)
            incoming = self.comm.shift(U[:, 0], -1)
            U = torch.cat([U[:, :-1], (U[:, -1] + incoming)[:, None]], dim=1)
            return _gather(U.reshape(-1), lmeta, vdim, nd, None)
        if meta is None:
            return _gather(u, None, vdim, nd, edof)  # the band's edof
        if self.K == 1:
            return _gather(u, meta, vdim, nd, None)
        return self.take(_gather(u, meta, vdim, nd, None))

    def scatter(self, re, meta, vdim: int, nd: int, einv):
        """Adjoint of ``gather`` (dof blocks): the band's sum in the halo
        layout, or its share of the replicated vector before the caller's
        sum over the ranks."""
        if not self.halo:
            return _scatter(self.embed(re), meta, vdim, nd, einv)
        if meta[0] == "l2":
            return _scatter(re, meta, vdim, nd, None)
        comm = self.comm
        lmeta = _halo_local_meta(meta, self.K)
        G = _scatter(re, lmeta, vdim, nd, None).reshape(
            (vdim,) + tuple(lmeta[2]))
        recv = comm.shift(G[:, -1], 1)  # the ghost's sum to its owner
        first = (G[:, 0] + recv)[:, None]
        last = G[:, -1:]
        if comm.rank != comm.world_size - 1:
            last = torch.zeros_like(last)
        return torch.cat([first, G[:, 1:-1], last], dim=1).reshape(-1)


def _per_element(t: dict, fn) -> dict:
    """The tables ``t`` with ``fn(a, shared)`` applied to every
    element-leading table: B, w and the statics (``shared``: a leading 1
    is an element-shared table), edof and the fields' edof.  The other
    tables (contraction factors, ``einv``, the fields' shape tables) are
    the same for every element and stay."""
    out = dict(t)
    out.update(
        B=tuple(fn(b, True) for b in t["B"]),
        w=fn(t["w"], True),
        edof=tuple(fn(e, False) for e in t["edof"]),
        static={k: fn(v, True) for k, v in t["static"].items()},
        field_edof={k: fn(v, False) for k, v in t["field_edof"].items()},
    )
    return out


def _edof_inverse(edof: np.ndarray, nds: int) -> np.ndarray:
    """Transpose of the element-dof map: [nds, V] indices into the
    flattened [ne*nd] element values, V the largest dof valence, each row
    the dof's slots in increasing order, padded with the sentinel ne*nd
    (the zero row the scatter appends).  The same table as the JAX
    package's ``_edof_inverse``."""
    flat = np.asarray(edof, dtype=np.int64).reshape(-1)
    count = np.bincount(flat, minlength=nds)
    V = int(count.max()) if flat.size else 1
    order = np.argsort(flat, kind="stable")  # slots grouped by dof
    start = np.concatenate([[0], np.cumsum(count)[:-1]])
    dof = flat[order]
    inv = np.full((nds, V), flat.size, dtype=np.int64)
    inv[dof, np.arange(flat.size) - start[dof]] = order
    return inv


# Element-varying shape tensors B [ne, nq, nd, sd] (physical shapes on an
# unstructured mesh, where the GEMM factors are not installed) and
# element-shared ones [1, nq, nd, sd] both broadcast over the element axis.


def _x_from_u(B, ue):
    """x = B^T u per qp: [ne, nq, vdim, sd]."""
    return torch.einsum("eqds,edv->eqvs", B, ue)


def _r_from_g(B, g):
    """r_e = B g per element: [ne, nd, vdim] from g [ne, nq, vdim, sd]."""
    return torch.einsum("eqds,eqvs->edv", B, g)


def _diag_from_h(B, Hvv):
    """Element diagonal d_e[d, v] = sum_q B[d, :] Hvv[:, :, v] B[d, :]."""
    return torch.einsum("eqds,eqstv,eqdt->edv", B, Hvv, B)


def _elmat_from_h(Bs, Bt, H6):
    """Dense element blocks A_e[(v,d),(w,k)] = B_s H B_t^T summed over qp."""
    return torch.einsum("eqds,eqvswt,eqkt->evdwk", Bs, H6, Bt)


class _PullbackEnergy(ADFunction):
    """The user's energy evaluated on physical per-qp inputs rebuilt from
    reference-basis ones: physical gradients are invj^T times reference
    gradients, with the per-qp inverse Jacobian ``p["_invj"]`` (row-major
    J^-1[m, k]).  The shape tensor stays element-shared on an unstructured
    mesh, so every shared-B GEMM factor applies, and the chain rule
    H_ref = P^T H_phys P happens inside the differentiated point energy.
    The JAX package's ``_PullbackEnergy``."""

    def __init__(self, f, layout, dim: int):
        super().__init__(f.n_input)
        self.f = f
        self.layout = layout  # per space: (offset, vdim, sd, columns)
        self.dim = dim
        self.params = f.params

    def energy(self, x, p):
        J = p["_invj"]
        d = self.dim
        out = []
        for off, v, sd, cols in self.layout:
            for c in range(v):
                base = off + c * sd
                k = 0
                for kind in cols:
                    if kind == "v":
                        out.append(x[base + k])
                        k += 1
                        continue
                    for kk in range(d):  # reference gradient -> physical
                        acc = J[kk] * x[base + k]
                        for mm in range(1, d):
                            acc = acc + J[mm * d + kk] * x[base + k + mm]
                        out.append(acc)
                    k += d
        return self.f.energy(torch.stack(out), p)


# ---------------------------------------------------------------------------


class ADBlockIntegrator(nn.Module):
    """Domain integrator of a scalar energy over one or more FE spaces.

    Args:
        f: the ADFunction energy, or an ADVectorFunction F whose output
           width equals the input width (a pointwise flux: the residual is
           scatter(B F(B^T u) w) and the Newton state is the generally
           nonsymmetric Jacobian dF/dx); its ``params`` coefficients are
           tabulated here, except the runtime fields
           (``GridFunctionCoefficient``, ``ScalarFieldCoefficient``), whose
           values every call takes from ``fields``.
        spaces: list of FESpace, one per block.
        modes: list of ADEval, one per space.
        ir_order: quadrature order (default 2*max(p)+2).
        device, dtype: where and in which type the tables live (the card
           unless the caller asks for the CPU).
        tables: a ready tables dictionary (see ``convert.tables_from_numpy``)
           to use instead of tabulating.
        closed: use the energy's hand-derived ``gradient_closed`` /
           ``hessian_closed`` in ``residual`` / ``hess_state`` instead of
           AD (off by default, as in the JAX package).

    ``tables`` (backed by registered buffers; a leading 1 is an
    element-shared table, ne an element-varying one):
        B:      tuple of [1 | ne, nq, nd_s, sd_s]
        w:      [1 | ne, nq]
        edof:   tuple of [ne, nd_s] int64
        static: dict name -> [1 | ne, nq, k]; with the geometry pullback
                also "_invj" [ne, nq, dim*dim], row-major inverse Jacobians
        field:  dict name -> phi [nq, nd_f] of each grid-function field
        field_edof: dict name -> edof [ne, nd_f] of its space (its dofs
                are gathered on its own space's dof exchange)
        einv:   dict s -> [nds_s, V] transpose of edof, for the spaces
                without a dof grid (``_edof_inverse``)
        R, R0, D0: tuples of GEMM factors for x = B^T u, r = B g, diagonals
                (installed where every B is element-shared)
        W, W0:  dicts "s_t" -> element-matrix contraction factors (empty
                where a B is element-varying)

    ``pullback`` is True where the mesh has no uniform Jacobian and the
    energy is a scalar one on VALUE/GRAD inputs: ``f`` is then wrapped in
    ``_PullbackEnergy`` and B holds reference shapes (the JAX package's
    default; it has no other route for such an integrator but its A/B
    switch).
    """

    def __init__(
        self,
        f: ADFunction,
        spaces,
        modes,
        ir_order: int | None = None,
        *,
        device="cuda",
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
        self.vector_fn = isinstance(f, ADVectorFunction)
        if self.vector_fn and f.n_output != self.n_input:
            raise ValueError(
                f"vector integrand n_output={f.n_output} must equal the "
                f"input layout width {self.n_input}"
            )
        for s, m in zip(spaces, modes):
            if s.vdim > 1 and not (m & ADEval.VECTOR):
                raise ValueError("vdim > 1 requires ADEval.VECTOR")
        self._gridmeta = [_space_gridmeta(s) for s in spaces]
        self.pullback = not mesh.uniform_jacobian and not self.vector_fn and all(
            not (m & (ADEval.DIV | ADEval.CURL | ADEval.QVALUE))
            for m in modes)
        if self.pullback:
            layout = tuple(
                (int(self.x_off[s]), self.vdim[s], self.sd[s],
                 tuple(c for c, bit in (("v", ADEval.VALUE),
                                        ("g", ADEval.GRAD)) if modes[s] & bit))
                for s in range(len(spaces)))
            self.f = _PullbackEnergy(f, layout, sdim)
        # runtime field parameters: name -> ("gf", vdim, ndof_scalar, nd,
        # gridmeta) or ("scalar", size); values come from ``fields``
        self.field_kinds: dict[str, tuple] = {}
        for name, coeff in f.params.items():
            if isinstance(coeff, GridFunctionCoefficient):
                sp = coeff.space
                if sp.mesh is not mesh:
                    raise ValueError(
                        f"field {name!r} lives on a different mesh")
                self.field_kinds[name] = (
                    "gf", sp.vdim, sp.ndof_scalar, sp.nd,
                    _space_gridmeta(sp))
            elif isinstance(coeff, ScalarFieldCoefficient):
                self.field_kinds[name] = ("scalar", coeff.size)
        if tables is None:
            tables = self._tabulate(device)
        self._install(tables)
        # the share of the element axis: every element in serial
        self.band = Band(None, tables["edof"][0].shape[0])

    # ------------------------------------------------------------------
    def _tabulate(self, device) -> dict:
        mesh, dtype = self.mesh, self.dtype
        spaces, modes = self.spaces, self.modes
        nb = len(spaces)
        gf = geom_factors(mesh, self.ir)

        def dev(a):
            return torch.as_tensor(np.array(a), dtype=dtype, device=device)

        def index(a):
            return torch.as_tensor(np.asarray(a, dtype=np.int64),
                                   device=device)

        gf_b = gf
        if self.pullback:
            # reference shapes: B from an identity Jacobian, the geometry
            # goes into the energy through _invj
            eye = np.broadcast_to(np.eye(mesh.dim), gf.invj.shape)
            gf_b = GeomFactors(xq=gf.xq, jac=eye, detj=gf.detj, invj=eye,
                               w=gf.w)
        B_np = [
            _dedup_elements(np.asarray(build_B(s, m, self.ir, gf_b)))
            for s, m in zip(spaces, modes)
        ]
        static, field, field_edof = {}, {}, {}
        ctx = QPContext(gf.xq, ir=self.ir, mesh=mesh)
        for name, coeff in self.f.params.items():
            kind = self.field_kinds.get(name)
            if kind is None:
                static[name] = dev(
                    _dedup_elements(np.asarray(coeff.eval_qp(ctx))))
            elif kind[0] == "gf":
                field[name] = dev(coeff.space.elem.eval(self.ir.points))
                field_edof[name] = index(coeff.space.edof)
        if self.pullback:
            static["_invj"] = dev(np.ascontiguousarray(gf.invj).reshape(
                -1, self.nq, mesh.dim * mesh.dim))
        t = {
            "B": tuple(dev(b) for b in B_np),
            "w": dev(_dedup_elements(np.asarray(gf.w))),
            "edof": tuple(index(s.edof) for s in spaces),
            "static": static,
            "field": field,
            "field_edof": field_edof,
            "einv": {
                s: index(_edof_inverse(sp.edof, sp.ndof_scalar))
                for s, sp in enumerate(spaces) if self._gridmeta[s] is None
            },
            "W0": {},
            "W": {},
        }
        if any(b.shape[0] != 1 for b in B_np):
            return t  # element-varying shapes: the einsum forms serve
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

    def padded_tables(self, n_shards: int) -> dict:
        """The tables with the element axis copy-padded to a multiple of
        ``n_shards``: padded elements repeat element 0 with zero quadrature
        weight, so their contributions vanish while the energy stays in its
        domain (zero inputs could leave it).  A shared ``w`` is materialized
        per element; the contraction factors, ``einv`` (its indices address
        the true element slots) and the fields' shape tables stay as they
        are."""
        t = self.tables
        ne = t["edof"][0].shape[0]
        pad = (-ne) % n_shards
        if pad == 0:
            return t

        def padel(a, shared):
            if shared and a.shape[0] == 1:
                return a
            return torch.cat([a, a[:1].expand((pad,) + tuple(a.shape[1:]))])

        out = _per_element(t, padel)
        w = t["w"].expand(ne, t["w"].shape[1])
        out["w"] = torch.cat([w, w.new_zeros(pad, w.shape[1])])
        return out

    def band_view(self, comm, halo: bool = False):
        """This integrator restricted to rank ``comm.rank``'s contiguous
        band of the element axis, with the shard (replicated dof vectors)
        or, with ``halo``, the halo dof exchange (see ``Band``).  The view
        shares the replicated tables (contraction factors, ``einv``, the
        fields' shape tables) and slices the element-leading ones of
        ``padded_tables(comm.world_size)``; in halo mode the element count
        must divide."""
        K = comm.world_size
        ne = self.tables["edof"][0].shape[0]
        if halo and ne % K:
            raise ValueError(
                f"element count {ne} not divisible by the rank count {K}")
        band = Band(comm, ne, halo)
        lo, n = band.lo, band.ne_loc
        bt = _per_element(
            self.padded_tables(K),
            lambda a, shared: a if shared and a.shape[0] == 1
            else a[lo:lo + n])
        view = copy.copy(self)
        object.__setattr__(view, "_buffers", {})
        object.__setattr__(view, "_non_persistent_buffers_set", set())
        view._install(bt)
        view.band = band
        return view

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
    def eval_params(self, fields=None) -> dict:
        """Per-qp parameter values, name -> [1 or ne, nq, k]: the static
        tables, a grid-function field gathered on its own space and
        interpolated at the points, a scalar field broadcast (a view, no
        copy).  Raises ``KeyError`` naming a field missing from
        ``fields``."""
        t = self.tables
        fields = fields or {}
        p = dict(t["static"])
        w = t["w"]
        for name, kind in self.field_kinds.items():
            if name not in fields:
                raise KeyError(
                    f"assembly requires field {name!r}; got {list(fields)}"
                )
            if kind[0] == "gf":
                _, vdim, _, nd_f, meta = kind
                phi = t["field"][name]
                u = torch.as_tensor(fields[name], dtype=w.dtype,
                                    device=w.device)
                # [ne, nd, vdim]; fields stay replicated
                ue = self.band.gather(u, meta, vdim, nd_f,
                                      t["field_edof"][name], dofs=False)
                p[name] = torch.einsum("qd,edv->eqv", phi, ue)
            else:
                v = torch.as_tensor(fields[name], dtype=w.dtype,
                                    device=w.device).reshape(-1)
                p[name] = v.reshape(1, 1, -1).expand(1, self.nq, kind[1])
        return p

    def gather(self, s: int, u):
        """Element dofs of block s: [ne, nd, vdim] (byNODES layout)."""
        return self.band.gather(u, self._gridmeta[s], self.vdim[s],
                                self.nd[s], self.tables["edof"][s])

    def scatter(self, s: int, re):
        """Sum element values [ne, nd, vdim] into block-s dofs."""
        return self.band.scatter(re, self._gridmeta[s], self.vdim[s],
                                 self.nd[s], self.tables["einv"].get(s))

    def node_sum(self, s: int, vals):
        """Per-node values [ne, nd, *k] of block s summed over the elements
        that share each scalar dof: [nds, *k] (the scatter's exchange, any
        trailing shape)."""
        ne, nd = vals.shape[:2]
        k = tuple(vals.shape[2:])
        flat = vals.reshape(ne, nd, -1)
        width = flat.shape[-1]
        out = self.band.scatter(flat, self._gridmeta[s], width, nd,
                                self.tables["einv"].get(s))
        return out.reshape(width, -1).T.reshape((-1,) + k)

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
            elif "R" in t:
                ue2 = ue.permute(0, 2, 1).reshape(ne, -1)  # [ne, nde]
                x = ue2 @ t["R"][s].T  # [ne, nq*w] — one GEMM
            else:
                x = _x_from_u(t["B"][s], ue)
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
        if "R" in t:
            re = seg.reshape(ne, -1) @ t["R"][s]  # [ne, nde] — one GEMM
            return re.reshape(ne, self.vdim[s], self.nd[s]).permute(0, 2, 1)
        return _r_from_g(
            t["B"][s], seg.reshape(ne, nq, self.vdim[s], self.sd[s]))

    # ------------------------------------------------------------------
    def energy(self, ublocks, fields=None):
        if self.vector_fn:
            raise ValueError("vector integrands have no scalar energy")
        x = self.x_qp(ublocks)
        vals = qpmap(self.f.energy, x, self.eval_params(fields))
        return torch.sum(vals * self.tables["w"])

    def residual(self, ublocks, fields=None):
        """Per-block residual vectors r_s = scatter(B_s (grad f) w); for a
        vector integrand, grad f is F itself."""
        x = self.x_qp(ublocks)
        if self.vector_fn:
            pt = self.f.function
        elif self.closed and callable(self.f.gradient_closed):
            pt = self.f.gradient_closed
        else:
            pt = grad(self.f.energy)
        g = qpmap(pt, x, self.eval_params(fields)) * self.tables["w"][..., None]
        return [
            self.scatter(s, self._re_from_g(g, s))
            for s in range(len(self.spaces))
        ]

    def hess_state(self, ublocks, fields=None, sym: bool = False):
        """Per-qp weighted Hessian, the Newton state: the full
        [ne, nq, n, n] tensor, or with ``sym=True`` the packed ``SymHess``
        upper-triangle planes [n(n+1)/2, ne, nq].  For a vector integrand
        it is the Jacobian dF/dx, nonsymmetric in general, so it is never
        packed: ``sym`` is ignored and the full tensor returned."""
        x = self.x_qp(ublocks)
        p = self.eval_params(fields)
        w = self.tables["w"]
        if self.vector_fn:
            H = qpmap(jacfwd(self.f.function), x, p).to(x.dtype)
            return H * w[..., None, None]
        if self.closed and callable(self.f.hessian_closed):
            H = qpmap(self.f.hessian_closed, x, p)
        else:
            # jacfwd(grad) promotes f32 per-point ops that take a Python
            # float to f64 (torch 2.x); the state keeps the tables' type
            H = qpmap(jacfwd(grad(self.f.energy)), x, p).to(x.dtype)
        if not sym:
            return H * w[..., None, None]
        n = self.n_input
        planes = torch.stack(
            [H[:, :, a, b] for a in range(n) for b in range(a, n)], dim=0
        )
        return SymHess(planes * w[None], n)

    def hess_mult(self, Hq, vblocks):
        """Matrix-free J v = scatter(B (Hq (B^T v))).  On CUDA tensors the
        grid route (``route_refusal("grid", Hq)``) applies it in one
        hand-written kernel (``ops.grid_hess_mult``)."""
        if vblocks[0].is_cuda and self.route_refusal("grid", Hq) is None:
            return [ghm.grid_grad_mult(vblocks[0].contiguous(), None,
                                       Hq.planes, *self.grid_operands())]
        return self._hess_mult_eager(Hq, vblocks)

    def grad_mult(self, Hq, v, ess):
        """J v on the dof vector ``v`` (the blocks concatenated) with the
        dofs of the bool mask ``ess`` eliminated: their rows and columns
        zeroed, identity on their diagonal (``NonlinearForm.grad_mult`` of
        a form of this one integrator).  On a CUDA tensor the grid route
        applies it, elimination included, in one hand-written kernel."""
        if v.is_cuda and self.route_refusal("grid", Hq) is None:
            return ghm.grid_grad_mult(v, ess, Hq.planes,
                                      *self.grid_operands())
        blocks = torch.split(torch.where(ess, 0.0, v),
                             [sp.ndof for sp in self.spaces])
        eager = torch.cat(self._hess_mult_eager(Hq, blocks))
        # summed into zeros as a form sums its integrators: -0.0 -> +0.0
        return torch.where(ess, v, torch.zeros_like(v) + eager)

    def _hess_mult_eager(self, Hq, vblocks):
        """``hess_mult``'s body in PyTorch operations, on any device."""
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
            if "D0" in t:
                Hp = Hvv.permute(0, 4, 1, 2, 3).reshape(ne * v, nq * sd * sd)
                D = (Hp @ t["D0"][s]).reshape(ne, v, nd).permute(0, 2, 1)
            else:
                D = _diag_from_h(t["B"][s], Hvv)
            out.append(self.scatter(s, D))
        return out

    # -- the hand-written kernels' routes -------------------------------
    def uses_blocked_kernel(self, s: int = 0) -> bool:
        """True when the closed-entries route takes the blocked-W0 kernel
        (``ops.blocked_jacobian``) for the (s, s) block rather than the
        full-W kernel (``ops.fused_jacobian``): the energy has closed
        entries, ``W0["s_s"]`` is installed and the input is pure
        GRAD|VECTOR, n = vdim*sd.  The JAX package makes the same choice
        (``fused_jacobian.py:403-416``) but checks n against vdim alone
        where sd is missing."""
        return (f"{s}_{s}" in self.tables["W0"]
                and self.f.hessian_closed_entries is not None
                and self.n_input == self.vdim[s] * self.sd[s])

    def supports_fused(self, s: int = 0) -> bool:
        """True when the tables admit a fused element-Jacobian kernel for
        the (s, s) block: shared R plus a full W (or a blocked W0 where
        ``uses_blocked_kernel``), one space, element-shared static
        parameters and quadrature weights (the JAX package's
        ``supports_fused``)."""
        t = self.tables
        if "R" not in t:
            return False
        has_w = f"{s}_{s}" in t["W"]
        if not (has_w or self.uses_blocked_kernel(s)) or len(self.spaces) != 1:
            return False
        if not all(v.shape[0] == 1 for v in t["static"].values()):
            return False
        return t["w"].shape[0] == 1

    def _tables_on_cuda(self) -> bool:
        return self.tables["w"].device.type == "cuda"

    def route_refusal(self, route: str, state=None) -> str | None:
        """Why the hand-written kernel of ``route`` cannot serve this
        integrator, or None where it can; every kernel route asks here.

          "kernel"     the closed-entries element-Jacobian kernel the tables
                       select: blocked-W0 where ``uses_blocked_kernel``,
                       else full-W;
          "kernel_ad"  the AD element-Jacobian kernel, for any energy that
                       traces;
          "grid"       the grid Jacobian apply at the Newton state
                       ``state`` (``grad_mult`` and ``hess_mult``, on CUDA
                       tensors).

        The element-Jacobian kernels take element-shared tables and static
        parameters only, as the JAX package's kernel does; an energy is
        traced once per energy object and parameter sizes."""
        if route == "grid":
            meta = self._gridmeta[0]
            if len(self.spaces) != 1:
                return f"a mixed form of {len(self.spaces)} spaces"
            if meta is None or meta[0] != "h1":
                kind = ("generic (no dof grid)" if meta is None
                        else repr(meta[0]))
                return (f"the dof exchange is {kind}, not a structured H1 "
                        "grid")
            if len(meta[1]) != 2:
                return f"a {len(meta[1])}D grid"
            if self.band.K != 1:
                return "one rank's band of a sharded form"
            if "R" not in self._layout:
                return ("B is element-varying (no uniform Jacobian, no "
                        "table R)")
            if not isinstance(state, SymHess):
                return ("the state is a full Hessian (a vector integrand's "
                        "dF/dx)")
            if self.dtype not in (torch.float32, torch.float64):
                return f"unsupported dtype {self.dtype}"
            if self.nq > ghm.MAX_POINTS:
                return (f"{self.nq} points per element (at most "
                        f"{ghm.MAX_POINTS})")
            return None
        if route not in ("kernel", "kernel_ad"):
            raise ValueError(f"no kernel route {route!r}")
        ad = route == "kernel_ad"
        t = self.tables
        if self.vector_fn:
            return "vector integrands (ADVectorFunction) have no " + (
                "scalar energy to differentiate" if ad else
                "closed Hessian entries: the state is the Jacobian of F")
        if self.field_kinds:
            return (f"runtime field parameters ({', '.join(self.field_kinds)})"
                    " are not kernel inputs: field-backed integrators take "
                    "two-stage")
        varying = [k for k, v in t["static"].items() if v.shape[0] != 1]
        varying += ["w"] if t["w"].shape[0] != 1 else []
        varying += ["B"] if any(b.shape[0] != 1 for b in t["B"]) else []
        if varying:
            return (f"element-varying geometry ({', '.join(varying)}): "
                    "unstructured integrators take two-stage")
        if not self._tables_on_cuda():
            return f"the {'AD ' if ad else ''}kernel runs on CUDA tables only"
        if not ad and self.f.hessian_closed_entries is None:
            return f"{type(self.f).__name__} has no closed Hessian entries"
        if not self.supports_fused():
            return "tables do not admit a fused kernel (supports_fused)"
        if ad and "0_0" not in t["W"]:
            return ("no full W factor: blocked-W0 configurations take the "
                    "blocked-W0 kernel or two-stage")
        blocked = not ad and self.uses_blocked_kernel()
        n, vdim, sd = self.n_input, self.vdim[0], self.sd[0]
        if blocked and (vdim, sd) not in bj.BLOCKED_SHAPES:
            return (f"(vdim, sd) = ({vdim}, {sd}) is not among the compiled "
                    f"shapes {bj.BLOCKED_SHAPES}")
        if not blocked and n not in bj.FULL_WIDTHS:
            return f"n = {n} is not among the compiled widths {bj.FULL_WIDTHS}"
        if self.dtype not in (torch.float32, torch.float64):
            return f"unsupported dtype {self.dtype}"
        if not blocked:
            try:
                bj.launch_plan(1, n, vdim * self.nd[0], self.nq, self.dtype)
            except ValueError as e:
                return str(e)
        psizes = bj.param_sizes(t["static"])
        try:
            if ad:
                adj.energy_code(self.f, psizes)
            else:
                bj.entries_code(self.f, psizes)
        except UnsupportedEnergy as e:
            what = "energy does" if ad else "closed entries do"
            return f"the {what} not trace: {e}"
        return None

    def _element_operands(self, ublocks):
        """The tables, the (0, 0) block's element dofs [ne, nde] (byNODES
        (v, d) flat) and the element-shared parameters [nq, k]."""
        t = self.tables
        ue = self.gather(0, ublocks[0])  # [ne, nd, vdim]
        ue2 = ue.permute(0, 2, 1).reshape(ue.shape[0], -1).contiguous()
        return t, ue2, {k: v[0].contiguous() for k, v in t["static"].items()}

    def kernel_inputs(self, ublocks):
        """The operands (ue, R, W, wq, params) of the full-W and the AD
        kernel (``ops.fused_jacobian``, ``ops.ad_jacobian``) for the (0, 0)
        block of a single-space integrator with a full W."""
        t, ue, params = self._element_operands(ublocks)
        return (ue, t["R"][0].contiguous(), t["W"]["0_0"].contiguous(),
                t["w"][0].contiguous(), params)

    def blocked_inputs(self, ublocks):
        """The operands (ue, B0, W0, wq, params) of the blocked-W0 kernel
        (``ops.blocked_jacobian``) for the (0, 0) block of a single-space
        integrator with a blocked factor W0."""
        t, ue, params = self._element_operands(ublocks)
        return (ue, t["B"][0][0].contiguous(), t["W0"]["0_0"].contiguous(),
                t["w"][0].contiguous(), params)

    def grid_operands(self):
        """(B0 [nq, nd, sd], node offsets [nd, 2] (x, y), nx, ny, p, vdim):
        the operands of the grid apply (``ops.grid_hess_mult``) after the
        state's planes, where the grid route serves; B0 is the one block
        of the vdim-block-diagonal table R, derived once per table."""
        vdim, nd, nq, sd = self.vdim[0], self.nd[0], self.nq, self.sd[0]
        _, (nx, ny), _, offs, p = self._gridmeta[0]
        R = self.tables["R"][0]  # [(q, c, k), (c, d)]
        B0 = bj.derived(R, ("grid_B0", vdim, sd), (), lambda: R.reshape(
            nq, vdim, sd, vdim, nd)[:, 0, :, 0, :].permute(0, 2, 1)
            .contiguous())
        return B0, offs, int(nx), int(ny), int(p), vdim

    def auto_route(self, fields=None) -> str:
        """The route ``element_jacobians(route="auto")`` takes."""
        if fields:
            return "two_stage"
        for route in ("kernel", "kernel_ad"):
            if self.route_refusal(route) is None:
                return route
        return "two_stage"

    def element_jacobians(self, ublocks, fields=None, route: str = "auto"):
        """Dense element Jacobians A_e [ne, nde, nde] of the (0, 0) block.

        ``route``:
          "kernel"     the closed-entries element-Jacobian kernel: the
                       blocked-W0 kernel (``ops.blocked_jacobian``) where
                       ``uses_blocked_kernel``, else the full-W kernel
                       (``ops.fused_jacobian``, the same GEMM kernel with
                       vdim = 1, sd = n); raises where
                       ``route_refusal("kernel")`` names a reason;
          "kernel_ad"  the AD element-Jacobian kernel for any energy that
                       traces (``ops.ad_jacobian``); raises where
                       ``route_refusal("kernel_ad")`` names a reason;
          "two_stage"  ``hess_state`` then ``element_matrices``;
          "auto"       the first that applies of "kernel", "kernel_ad"
                       and "two_stage"; two-stage whenever ``fields`` are
                       given, as in the JAX package.
        Vector integrands and field-backed integrators take two-stage:
        both kernel routes refuse them.
        """
        if route not in ROUTES:
            raise ValueError(f"route must be one of {ROUTES}, got {route!r}")
        if route == "auto":
            route = self.auto_route(fields)
        elif route != "two_stage":
            why = self.route_refusal(route)
            if why is not None:
                name = "AD kernel" if route == "kernel_ad" else "kernel"
                raise ValueError(f"{name} route unavailable: {why}")
        if route == "kernel" and self.uses_blocked_kernel():
            return bj.blocked_element_jacobian(
                self.f, *self.blocked_inputs(ublocks), self.vdim[0],
                self.sd[0])
        if route == "kernel":
            return fj.fused_element_jacobian(self.f,
                                             *self.kernel_inputs(ublocks))
        if route == "kernel_ad":
            return adj.ad_element_jacobian(self.f,
                                           *self.kernel_inputs(ublocks))
        return self.element_matrices(self.hess_state(ublocks, fields), 0, 0)

    def element_matrices(self, Hq, s: int, t_: int):
        """Dense element blocks A_e[(v,d),(w,k)] for pair (test s, trial
        t_), byNODES flat layout (v*nd + d).  The first installed factor
        serves: one GEMM against the blocked W0 (the vdim axes become GEMM
        rows), else one against the full W, else the per-qp B H B^T
        einsum.  The GEMMs are plain ``torch.matmul`` in the tables' type
        (no TF32)."""
        t = self.tables
        if isinstance(Hq, SymHess):
            Hq = Hq.full()
        ne, nq = Hq.shape[0], Hq.shape[1]
        os_, ot = int(self.x_off[s]), int(self.x_off[t_])
        vs, vt = self.vdim[s], self.vdim[t_]
        nds, ndt = self.nd[s], self.nd[t_]
        nde_s, nde_t = vs * nds, vt * ndt
        blk = Hq[..., os_:os_ + self.widths[s], ot:ot + self.widths[t_]]
        key = f"{s}_{t_}"
        if key in t["W0"]:
            sds, sdt = self.sd[s], self.sd[t_]
            H6 = blk.reshape(ne, nq, vs, sds, vt, sdt)
            Hp = H6.permute(0, 2, 4, 1, 3, 5).reshape(
                ne * vs * vt, nq * sds * sdt)
            A = (Hp @ t["W0"][key]).reshape(ne, vs, vt, nds, ndt)
            # byNODES flat layout: row (v, i) -> v*nd_s + i
            return A.permute(0, 1, 3, 2, 4).reshape(ne, nde_s, nde_t)
        if key in t["W"]:
            A = blk.reshape(ne, -1) @ t["W"][key]
            return A.reshape(ne, nde_s, nde_t)
        H6 = blk.reshape(
            ne, nq, self.vdim[s], self.sd[s], self.vdim[t_], self.sd[t_]
        )
        A = _elmat_from_h(t["B"][s], t["B"][t_], H6)
        return A.reshape(ne, nde_s, nde_t)

    def assemble_dense_block(self, Hq, s: int, t_: int):
        """Assembled dense [N_s, N_t] block (small problems, the direct
        solver), accumulated on the tables' device."""
        Ae = self.element_matrices(Hq, s, t_)
        ne = Ae.shape[0]
        idx = []
        for b in (s, t_):
            sp = self.spaces[b]
            edof = self.tables["edof"][b]  # [ne, nd]
            comp = torch.arange(sp.vdim, device=edof.device) * sp.ndof_scalar
            # byNODES element layout: flat (v, d) = v*nd + d
            idx.append((edof[:, None, :] + comp[None, :, None])
                       .reshape(ne, -1))
        gi, gj = idx
        A = torch.zeros((self.spaces[s].ndof, self.spaces[t_].ndof),
                        dtype=Ae.dtype, device=Ae.device)
        A.index_put_((gi[:, :, None].expand_as(Ae),
                      gj[:, None, :].expand_as(Ae)), Ae, accumulate=True)
        return A
