"""Dof-level proximal Galerkin: the entropy coupling at the nodal points.

PyTorch counterpart of ``mfem_ad_tpu.dof_pg``.  The coupling acts
pointwise at the FE nodal points instead of at quadrature points, which
makes every coupling block diagonal:

- primal residual += (psi_j - psi_k_j) w_j / alpha
- dual residual    = (u_j - dE*(psi_j)) w_j / alpha
- Jacobian: dual-dual diag(-E*''(psi_j) w_j / alpha), primal-dual and
  dual-primal diag(w_j / alpha)

The objective f(u) is delegated to an ordinary ``ADBlockIntegrator`` on
the primal spaces.  Primal and dual spaces must have identical element
dof counts.  Nodal weights: w_j = detJ(node_j) * wref_j with wref_j the
integral of the node's basis function over the reference element (the
interpolatory nodal quadrature weight).

``DofPGIntegrator`` has the integrator protocol of ``ADBlockIntegrator``
(``energy``, ``residual``, ``hess_state``, ``hess_mult``, ``diagonal``,
``element_matrices``, ``assemble_dense_block``), so it plugs into
``BlockNonlinearForm``.  The primal block's dof exchange is the inner
integrator's (strided slices on structured meshes, the transpose-gather
elsewhere: one sum order, no atomics); the L2 dual block is
element-contiguous, so its exchange is a reshape.
"""

from __future__ import annotations

import copy

import numpy as np
import torch
from torch.func import grad, jacfwd

from .ad import qpmap
from .adeval import ADEval
from .coefficients import (
    GridFunctionCoefficient,
    QPContext,
    ScalarFieldCoefficient,
)
from .fespace import FESpace
from .geometry import geom_factors
from .integrator import ADBlockIntegrator, _space_gridmeta
from .pg import ADEntropy
from .quadrature import IntegrationRule, get_rule


def _nodal_weights(space: FESpace) -> np.ndarray:
    """Interpolatory nodal quadrature weights wref_j = integral of phi_j
    over the reference element."""
    ir = get_rule(space.mesh.geom, 2 * space.order + 2)
    phi = space.elem.eval(ir.points)  # [nq, nd]
    return ir.weights @ phi  # [nd]


class DofPGIntegrator:
    """Nodal PG coupling of (primal, dual) space pairs + a delegated
    objective.

    Args:
        objective: ADFunction on the primal spaces' stacked input.
        primal_spaces, primal_modes: as for ``ADBlockIntegrator``.
        dual_spaces: one per primal space, same element dof count and
            vdim.
        entropies: one ``ADEntropy`` per pair, ``n_input`` = the pair's
            vdim.  Parameters that are ``GridFunctionCoefficient``s or
            ``ScalarFieldCoefficient``s are runtime fields, interpolated
            at the nodal points on every call.
        device, dtype: where and in which type the tables live.
        tables: a ready tables dictionary (``convert.tables_from_numpy``
            of the JAX package's) to use instead of tabulating.

    Runtime fields: ``alpha`` (the PG step), ``latent_k{i}`` (the frozen
    dual dof vector of pair i), the entropies' fields and the
    objective's.

    ``tables``:
        inner:  the objective integrator's tables
        wn:     tuple of [ne, nd] nodal weights detJ * wref
        edof_p, edof_d: tuples of [ne, nd] int64 element dof maps
        static: tuple of dicts name -> [ne, nd, k] entropy parameters
                tabulated at the nodal points
        efield: tuple of dicts name -> (edof [ne, nd_f], phi [nd, nd_f])
                of each grid-function entropy parameter: its space's dof
                map and its basis at the pair's nodal points
    """

    def __init__(self, objective, primal_spaces, primal_modes, dual_spaces,
                 entropies, ir_order=None, *, device="cuda",
                 dtype: torch.dtype = torch.float64,
                 tables: dict | None = None):
        if isinstance(primal_spaces, FESpace):
            primal_spaces = [primal_spaces]
        if isinstance(primal_modes, ADEval):
            primal_modes = [primal_modes]
        if isinstance(dual_spaces, FESpace):
            dual_spaces = [dual_spaces]
        if isinstance(entropies, ADEntropy):
            entropies = [entropies]
        if not len(primal_spaces) == len(dual_spaces) == len(entropies):
            raise ValueError(
                "every primal space needs a dual space and an entropy")
        self.inner = ADBlockIntegrator(
            objective, primal_spaces, primal_modes, ir_order=ir_order,
            device=device, dtype=dtype,
            tables=None if tables is None else tables["inner"],
        )
        self.dtype = dtype
        self.primal_spaces = list(primal_spaces)
        self.dual_spaces = list(dual_spaces)
        self.entropies = list(entropies)
        self.spaces = self.primal_spaces + self.dual_spaces
        self.np_ = len(primal_spaces)
        mesh = primal_spaces[0].mesh
        for ps, ds, e in zip(primal_spaces, dual_spaces, entropies):
            if ps.nd != ds.nd:
                raise ValueError(
                    "primal and dual elements must have the same dof count "
                    f"({ps.nd} != {ds.nd})")
            if ds.vdim != ps.vdim:
                raise ValueError(
                    "DofPG coupling pairs components pointwise: primal and "
                    f"dual vdim must match ({ps.vdim} != {ds.vdim})")
            if e.n_input != ps.vdim:
                raise ValueError(
                    f"entropy n_input={e.n_input} must equal the pair's "
                    f"vdim={ps.vdim} (one nodal vector per node)")
            if ds.fe_type != "L2":
                raise ValueError("the dual space of a DofPG pair must be L2")
        # runtime entropy parameters per pair: name -> ("gf", field name,
        # vdim, nd, gridmeta) or ("scalar", field name, size)
        self._efield_kinds: list[dict] = []
        for e in entropies:
            kinds = {}
            for name, coeff in e.params.items():
                if isinstance(coeff, GridFunctionCoefficient):
                    sp = coeff.space
                    if sp.mesh is not mesh:
                        raise ValueError(
                            f"entropy field {name!r} lives on another mesh")
                    kinds[name] = ("gf", coeff.name, sp.vdim, sp.nd,
                                   _space_gridmeta(sp))
                elif isinstance(coeff, ScalarFieldCoefficient):
                    kinds[name] = ("scalar", coeff.name, coeff.size)
            self._efield_kinds.append(kinds)
        self.tables = (self._tabulate(mesh, device) if tables is None
                       else tables)
        self.field_kinds = dict(self.inner.field_kinds)
        self.band = self.inner.band  # the share of the element axis

    def _tabulate(self, mesh, device) -> dict:
        dtype = self.dtype

        def dev(a):
            return torch.as_tensor(np.array(a), dtype=dtype, device=device)

        def index(a):
            return torch.as_tensor(np.asarray(a, dtype=np.int64),
                                   device=device)

        wn, edof_p, edof_d, static, efield = [], [], [], [], []
        for ps, ds, e, kinds in zip(self.primal_spaces, self.dual_spaces,
                                    self.entropies, self._efield_kinds):
            nodes = ps.elem.nodes
            ir_nodes = IntegrationRule(mesh.geom, nodes, np.zeros(len(nodes)))
            gfac = geom_factors(mesh, ir_nodes)
            wn.append(dev(gfac.detj * _nodal_weights(ps)[None, :]))
            edof_p.append(index(ps.edof))
            edof_d.append(index(ds.edof))
            ctx = QPContext(gfac.xq)
            p, ftab = {}, {}
            for name, coeff in e.params.items():
                if name not in kinds:
                    p[name] = dev(coeff.eval_qp(ctx))
                elif kinds[name][0] == "gf":
                    sp = coeff.space
                    ftab[name] = (index(sp.edof),
                                  dev(sp.elem.eval(nodes)))
            static.append(p)
            efield.append(ftab)
        return {
            "inner": self.inner.tables,
            "wn": tuple(wn),
            "edof_p": tuple(edof_p),
            "edof_d": tuple(edof_d),
            "static": tuple(static),
            "efield": tuple(efield),
        }

    # -- element bands ------------------------------------------------------
    def padded_tables(self, n_shards: int) -> dict:
        """The tables with the element axis copy-padded to a multiple of
        ``n_shards`` (the inner integrator's ``padded_tables``; zero nodal
        weights on the padded elements)."""
        t = self.tables
        ne = t["wn"][0].shape[0]
        pad = (-ne) % n_shards
        inner = self.inner.padded_tables(n_shards)
        if pad == 0:
            return {**t, "inner": inner}

        def padel(a):
            return torch.cat([a, a[:1].expand((pad,) + tuple(a.shape[1:]))])

        return {
            "inner": inner,
            "wn": tuple(torch.cat([w, w.new_zeros((pad,) + w.shape[1:])])
                        for w in t["wn"]),
            "edof_p": tuple(padel(e) for e in t["edof_p"]),
            "edof_d": tuple(padel(e) for e in t["edof_d"]),
            "static": tuple({k: padel(v) for k, v in p.items()}
                            for p in t["static"]),
            "efield": tuple({k: (padel(ed), phi) for k, (ed, phi) in f.items()}
                            for f in t["efield"]),
        }

    def band_view(self, comm):
        """This integrator restricted to rank ``comm.rank``'s band of the
        element axis, dof vectors replicated (``integrator.Band``'s shard
        mode; the halo layout needs grid metadata, which a DofPG
        integrator does not carry)."""
        t = self.padded_tables(comm.world_size)
        view = copy.copy(self)
        view.inner = self.inner.band_view(comm)
        view.band = view.inner.band
        lo, n = view.band.lo, view.band.ne_loc

        def cut(a):
            return a[lo:lo + n]

        view.tables = {
            "inner": view.inner.tables,
            "wn": tuple(cut(w) for w in t["wn"]),
            "edof_p": tuple(cut(e) for e in t["edof_p"]),
            "edof_d": tuple(cut(e) for e in t["edof_d"]),
            "static": tuple({k: cut(v) for k, v in p.items()}
                            for p in t["static"]),
            "efield": tuple({k: (cut(ed), phi) for k, (ed, phi) in f.items()}
                            for f in t["efield"]),
        }
        return view

    # -- dof exchange -----------------------------------------------------
    def _gather_pair(self, i, u, dual: bool):
        """Nodal values [ne, nd, v] of a pair's flat byNODES dof block."""
        u = torch.as_tensor(u, dtype=self.dtype,
                            device=self.tables["wn"][i].device)
        if not dual:
            return self.inner.gather(i, u)
        ds = self.dual_spaces[i]
        return self.band.gather(u, ("l2",), ds.vdim, ds.nd, None)

    def _scatter_pair(self, i, re, dual: bool):
        """Adjoint of ``_gather_pair``: [ne, nd, v] -> flat [v*nds]."""
        if not dual:
            return self.inner.scatter(i, re)
        ds = self.dual_spaces[i]
        return self.band.scatter(re, ("l2",), ds.vdim, ds.nd, None)

    def _entropy_params_nodes(self, i, fields):
        """Per-node entropy parameters, name -> [ne, nd, k]: the static
        tabulations and the runtime fields interpolated at the nodes."""
        t = self.tables
        wn = t["wn"][i]
        ne, nd = wn.shape
        p = dict(t["static"][i])
        for name, kind in self._efield_kinds[i].items():
            val = torch.as_tensor(fields[kind[1]], dtype=wn.dtype,
                                  device=wn.device)
            if kind[0] == "scalar":
                p[name] = val.reshape(1, 1, -1).expand(ne, nd, kind[2])
                continue
            _, _, pv, nd_f, meta = kind
            ed, phi = t["efield"][i][name]
            # [ne, nd_f, pv]
            ue = self.band.gather(val, meta, pv, nd_f, ed, dofs=False)
            p[name] = torch.einsum("jd,edv->ejv", phi, ue)
        return p

    def _entropy_d(self, i, psi, fields):
        """E*' [ne, nd, v] and E*'' [ne, nd, v, v] at the nodal psi."""
        f = self.entropies[i].energy
        p = self._entropy_params_nodes(i, fields)
        d1 = qpmap(grad(f), psi, p)
        # jacfwd(grad) may promote f32 per-point ops to f64
        d2 = qpmap(jacfwd(grad(f)), psi, p).to(psi.dtype)
        return d1, d2

    def _alpha(self, fields):
        return torch.as_tensor(fields["alpha"], dtype=self.dtype,
                               device=self.tables["wn"][0].device)

    # -- integrator protocol ----------------------------------------------
    def energy(self, ublocks, fields=None):
        fields = fields or {}
        t = self.tables
        e = self.inner.energy(ublocks[: self.np_], fields)
        pg = 0.0
        for i in range(self.np_):
            u = self._gather_pair(i, ublocks[i], dual=False)
            psi = self._gather_pair(i, ublocks[self.np_ + i], dual=True)
            psik = self._gather_pair(i, fields[f"latent_k{i}"], dual=True)
            p = self._entropy_params_nodes(i, fields)
            estar = qpmap(self.entropies[i].energy, psi, p)
            cross = torch.sum(u * (psi - psik), dim=-1)
            pg = pg + torch.sum((cross - estar) * t["wn"][i])
        return e + pg / self._alpha(fields)

    def residual(self, ublocks, fields=None):
        fields = fields or {}
        rs = self.inner.residual(ublocks[: self.np_], fields)
        alpha = self._alpha(fields)
        out_d = []
        for i in range(self.np_):
            w = (self.tables["wn"][i] / alpha)[..., None]
            u = self._gather_pair(i, ublocks[i], dual=False)
            psi = self._gather_pair(i, ublocks[self.np_ + i], dual=True)
            psik = self._gather_pair(i, fields[f"latent_k{i}"], dual=True)
            d1, _ = self._entropy_d(i, psi, fields)
            rs[i] = rs[i] + self._scatter_pair(i, (psi - psik) * w,
                                               dual=False)
            out_d.append(self._scatter_pair(i, (u - d1) * w, dual=True))
        return rs + out_d

    def hess_state(self, ublocks, fields=None, sym: bool = False):
        """(inner Newton state, per pair (w / alpha [ne, nd],
        -E*'' w / alpha [ne, nd, v, v]))."""
        fields = fields or {}
        Hq = self.inner.hess_state(ublocks[: self.np_], fields, sym=sym)
        alpha = self._alpha(fields)
        d2s = []
        for i in range(self.np_):
            psi = self._gather_pair(i, ublocks[self.np_ + i], dual=True)
            _, d2 = self._entropy_d(i, psi, fields)
            wn = self.tables["wn"][i] / alpha
            d2s.append((wn, -d2 * wn[..., None, None]))
        return (Hq, tuple(d2s))

    def hess_mult(self, state, vblocks):
        Hq, d2s = state
        ys = self.inner.hess_mult(Hq, vblocks[: self.np_])
        out_d = []
        for i in range(self.np_):
            w, dd = d2s[i]
            vp = self._gather_pair(i, vblocks[i], dual=False)
            vd = self._gather_pair(i, vblocks[self.np_ + i], dual=True)
            ys[i] = ys[i] + self._scatter_pair(i, vd * w[..., None],
                                               dual=False)
            rd = vp * w[..., None] + torch.einsum("envw,enw->env", dd, vd)
            out_d.append(self._scatter_pair(i, rd, dual=True))
        return ys + out_d

    def diagonal(self, state):
        Hq, d2s = state
        ds = self.inner.diagonal(Hq)
        out_d = []
        for i in range(self.np_):
            ddiag = torch.diagonal(d2s[i][1], dim1=2, dim2=3)  # [ne, nd, v]
            out_d.append(self._scatter_pair(i, ddiag, dual=True))
        return ds + out_d

    def element_matrices(self, state, s: int, t_: int):
        """Dense element blocks of pair (test s, trial t_), byNODES flat
        layout (v*nd + d); the coupling blocks are node- and
        component-diagonal."""
        Hq, d2s = state
        npq = self.np_
        if s < npq and t_ < npq:
            # primal-primal has no nodal part (the coupling is off-diagonal)
            return self.inner.element_matrices(Hq, s, t_)
        ne = d2s[0][0].shape[0]
        nde_s = self.spaces[s].nd * self.spaces[s].vdim
        nde_t = self.spaces[t_].nd * self.spaces[t_].vdim
        i, j = s % npq, t_ % npq
        if i != j:
            return d2s[0][0].new_zeros((ne, nde_s, nde_t))
        w, dd = d2s[i]  # [ne, nd], [ne, nd, v, v]
        eye_n = torch.eye(w.shape[1], dtype=w.dtype, device=w.device)
        if s < npq or t_ < npq:  # coupling: w / alpha on the diagonal
            eye_v = torch.eye(self.spaces[s].vdim, dtype=w.dtype,
                              device=w.device)
            A = torch.einsum("vw,ei,ij->eviwj", eye_v, w, eye_n)
        else:
            A = torch.einsum("eivw,ij->eviwj", dd, eye_n)
        return A.reshape(ne, nde_s, nde_t)

    def assemble_dense_block(self, state, s: int, t_: int):
        """Assembled dense [N_s, N_t] block, accumulated on the tables'
        device."""
        Ae = self.element_matrices(state, s, t_)
        ne = Ae.shape[0]
        edofs = list(self.tables["edof_p"]) + list(self.tables["edof_d"])
        idx = []
        for b in (s, t_):
            sp = self.spaces[b]
            edof = edofs[b]
            comp = torch.arange(sp.vdim, device=edof.device) * sp.ndof_scalar
            idx.append((edof[:, None, :] + comp[None, :, None])
                       .reshape(ne, -1))
        gi, gj = idx
        A = torch.zeros((self.spaces[s].ndof, self.spaces[t_].ndof),
                        dtype=Ae.dtype, device=Ae.device)
        A.index_put_((gi[:, :, None].expand_as(Ae),
                      gj[:, None, :].expand_as(Ae)), Ae, accumulate=True)
        return A
