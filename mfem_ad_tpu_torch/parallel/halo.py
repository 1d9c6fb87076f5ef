"""HaloShardedForm: distributed dof vectors with interface-only exchange.

PyTorch counterpart of ``mfem_ad_tpu.parallel.halo``.  ``ShardedForm``
replicates dof vectors and completes every assembly with an
``ndof``-length all-reduce.  This form keeps each dof on one rank:

- elements are banded along the element-major grid axis, one band per
  rank (the same contiguous bands as ``ShardedForm``);
- a dof vector is distributed in the owner-zero layout: each rank holds
  its band's dof planes plus one ghost interface plane, always zero, so
  every dof value lives exactly once, on its owner.  An inner product is
  a local dot and one scalar all-reduce (``Comm.dot``): the form gives
  ``dot`` and ``norm``, and ``cg``, ``gmres``, ``minres``, ``newton``,
  the Schur direction and ``PGSolver`` take them from it;
- a matvec exchanges two interface dof planes per h1-type space (the
  ghost fill before the gather, the owner return after the scatter,
  ``integrator.Band``): O(surface) bytes, not O(ndof).  L2 blocks are
  element-local and exchange nothing.

Layout: rank k's slot block (``slots`` entries) concatenates every
space's local block, [vdim, planes_loc, rest...] for an h1-type space
(``planes_loc = n_loc*p + 1`` with the ghost) or [vdim, ne_loc, nd] for
L2.  The global distributed vector (``ndof_dist = K * slots``, rank
blocks in rank order) is the JAX package's, byte for byte: ``to_dist``
and ``from_dist`` convert host arrays between it and the canonical
byNODES layout, ``dist_array`` gives this rank's block as a tensor, and
``canonical`` assembles the canonical vector from the ranks' blocks (one
all-reduce: the PG loop's latent, once per outer iteration).

Requirements: structured spaces (grid meta) and an outer cell count
divisible by the rank count; ``ShardedForm`` serves everything else.
"""

from __future__ import annotations

import numpy as np
import torch

from ..integrator import _halo_local_meta
from .comm import world
from .sharding import cat_sum


def _outer_cells(meta) -> int:
    dims = meta[1]
    return dims[1] if len(dims) == 2 else dims[0]


class HaloShardedForm:
    """Element-banded, dof-distributed view of a ``BlockNonlinearForm``.

    Args:
        form: the built serial form.
        comm: this rank's ``parallel.Comm`` (default: the default group,
            or this process alone).

    Raises ``ValueError`` for a space without grid metadata and for an
    outer cell (or L2 element) count not divisible by the rank count.
    """

    def __init__(self, form, comm=None):
        self.form = form
        self.comm = comm or world(form.device)
        self.n_ranks = K = self.comm.world_size
        if not form.integrators:
            raise ValueError("form has no integrators")
        intg0 = form.integrators[0]
        gridmeta = getattr(intg0, "_gridmeta", None)
        if gridmeta is None:
            raise ValueError(
                f"{type(intg0).__name__} has no grid metadata; use "
                "ShardedForm")
        self._meta, self._local_shape = [], []
        for s, sp in enumerate(form.spaces):
            meta = gridmeta[s]
            if meta is None:
                raise ValueError(
                    "HaloShardedForm requires structured spaces (grid "
                    "meta); use ShardedForm for unstructured meshes")
            self._meta.append(meta)
            if meta[0] == "l2":
                if sp.num_elements % K:
                    raise ValueError("element count not divisible by K")
                self._local_shape.append(
                    (sp.vdim, sp.num_elements // K, sp.nd))
            else:
                if _outer_cells(meta) % K:
                    raise ValueError(
                        f"outer cell count {_outer_cells(meta)} not "
                        f"divisible by the rank count {K}")
                lm = _halo_local_meta(meta, K)
                self._local_shape.append((sp.vdim,) + tuple(lm[2]))
        sizes = [int(np.prod(sh)) for sh in self._local_shape]
        self._loc_off = np.concatenate([[0], np.cumsum(sizes)]).astype(int)
        self.slots = int(self._loc_off[-1])
        self.ndof_dist = K * self.slots
        self.bands = [intg.band_view(self.comm, halo=True)
                      for intg in form.integrators]
        # pos[i]: the slot of canonical dof i in the global distributed
        # vector (its owner's)
        g = self.to_dist(np.arange(form.ndof, dtype=np.float64) + 1.0)
        owned = np.nonzero(g)[0]
        self._pos = np.empty(form.ndof, dtype=np.int64)
        self._pos[g[owned].astype(np.int64) - 1] = owned
        self._pos_t = torch.as_tensor(self._pos, device=form.device)
        self.ess_mask = self.dist_array(form.ess_mask.cpu().numpy())

    # -- layout conversion (host numpy) -------------------------------------
    def _space_blocks(self, u, s: int):
        """Canonical space vector -> [K, *local_shape] (ghosts zero)."""
        sp = self.form.spaces[s]
        K = self.n_ranks
        meta = self._meta[s]
        u = np.asarray(u)
        if meta[0] == "l2":
            vdim, nel, nd = self._local_shape[s]
            return u.reshape(sp.vdim, K, nel, nd).transpose(1, 0, 2, 3)
        ndims = meta[2]
        planes_own = (ndims[0] - 1) // K
        planes_loc = planes_own + 1
        U = u.reshape((sp.vdim,) + tuple(ndims))
        out = np.zeros((K, sp.vdim, planes_loc) + tuple(ndims[1:]), u.dtype)
        for k in range(K):
            lo = k * planes_own
            out[k] = U[:, lo:lo + planes_loc]
            if k < K - 1:
                out[k, :, -1] = 0  # ghost plane: owner-zero
        return out

    def to_dist(self, u) -> np.ndarray:
        """Canonical concatenated dof vector -> the global distributed
        layout [K * slots] (host numpy)."""
        u = np.asarray(u)
        off = self.form.offsets
        blocks = [self._space_blocks(u[off[s]:off[s + 1]], s)
                  for s in range(len(self.form.spaces))]
        return np.concatenate([
            np.concatenate([b[k].ravel() for b in blocks])
            for k in range(self.n_ranks)])

    def from_dist(self, ud) -> np.ndarray:
        """The global distributed layout -> the canonical concatenated dof
        vector (host numpy; each dof read from its owner)."""
        return np.asarray(ud)[self._pos]

    def dist_array(self, u_canonical) -> torch.Tensor:
        """This rank's slot block of a canonical host vector, as a tensor on
        the form's device."""
        ud = self.to_dist(np.asarray(u_canonical)).reshape(
            self.n_ranks, self.slots)[self.comm.rank]
        dtype = (self.form.dtype if np.issubdtype(ud.dtype, np.floating)
                 else None)
        return torch.as_tensor(np.ascontiguousarray(ud), dtype=dtype,
                               device=self.form.device)

    def canonical(self, u_loc: torch.Tensor) -> torch.Tensor:
        """The canonical dof vector (on every rank) of a distributed vector
        given by this rank's slot block: the ranks' blocks embedded in a
        zero [K, slots] buffer and summed (one all-reduce)."""
        buf = u_loc.new_zeros((self.n_ranks, self.slots))
        buf[self.comm.rank] = u_loc
        return self.comm.sum_(buf).reshape(-1)[self._pos_t]

    def halo_bytes_per_matvec(self) -> int:
        """Interface bytes one ``grad_mult`` exchanges, summed over the
        ranks (both exchanges, every rank boundary, every h1-type space):
        the O(surface) figure that replaces ``ShardedForm``'s O(ndof)
        all-reduce."""
        itemsize = torch.empty((), dtype=self.form.dtype).element_size()
        total = 0
        for sp, meta in zip(self.form.spaces, self._meta):
            if meta[0] == "l2":
                continue
            plane = sp.vdim * int(np.prod(meta[2][1:]))
            total += 2 * (self.n_ranks - 1) * plane * itemsize
        return total

    # -- the form protocol (vectors: this rank's slot block) -----------------
    @property
    def spaces(self):
        return self.form.spaces

    @property
    def offsets(self):
        """The serial form's block offsets: the Schur direction's block
        count check reads them; slot blocks are not sliced by them."""
        return self.form.offsets

    @property
    def ndof(self):
        return self.ndof_dist

    @property
    def device(self):
        return self.form.device

    @property
    def dtype(self):
        return self.form.dtype

    def dot(self, a, b):
        return self.comm.dot(a, b)

    def norm(self, a):
        return self.comm.norm(a)

    def pmax(self, t):
        return self.comm.max_(t)

    def split_local(self, u_loc):
        """Slot block -> per-space local flat blocks."""
        return [u_loc[self._loc_off[s]:self._loc_off[s + 1]]
                for s in range(len(self.form.spaces))]

    def energy(self, u, fields=None):
        blocks = self.split_local(u)
        e = sum(b.energy(blocks, fields) for b in self.bands)
        return self.comm.sum_(torch.as_tensor(e).clone())

    def mult(self, u, fields=None):
        blocks = self.split_local(u)
        r = cat_sum(b.residual(blocks, fields) for b in self.bands)
        return torch.where(self.ess_mask, 0.0, r)

    def grad_state(self, u, fields=None):
        """The bands' Newton states (rank-local)."""
        blocks = self.split_local(u)
        return [b.hess_state(blocks, fields, sym=True) for b in self.bands]

    def grad_mult(self, state, v):
        blocks = self.split_local(torch.where(self.ess_mask, 0.0, v))
        y = cat_sum(b.hess_mult(Hq, blocks)
                    for b, Hq in zip(self.bands, state))
        return torch.where(self.ess_mask, v, y)

    def grad_diag(self, state):
        d = cat_sum(b.diagonal(Hq) for b, Hq in zip(self.bands, state))
        return torch.where(self.ess_mask, 1.0, d)

    # -- the Schur direction's block helpers --------------------------------
    def _slots_u(self) -> int:
        return int(self._loc_off[len(self.form.spaces) - 1])

    def split_u_p(self, v):
        """Slot block -> (primal slots, latent slots)."""
        su = self._slots_u()
        return v[:su], v[su:]

    def join_u_p(self, vu, wp):
        return torch.cat([vu, wp])

    def pad_u(self, vu):
        return torch.cat([vu, vu.new_zeros(self.slots - self._slots_u())])

    def pad_p(self, wp):
        return torch.cat([wp.new_zeros(self._slots_u()), wp])

    def make_latent_dinv(self, De_inv):
        """w -> D^-1 w on the latent slots: a scalar L2 latent's dofs are
        element-contiguous in the band, so the band's element inverses
        apply locally."""
        sp_l = self.form.spaces[-1]
        if sp_l.fe_type != "L2" or sp_l.vdim != 1:
            raise NotImplementedError(
                "halo Schur elimination needs a scalar L2 latent block")
        ndl = sp_l.nd

        def apply(wp):
            return torch.einsum("eij,ej->ei", De_inv,
                                wp.reshape(-1, ndl)).reshape(-1)

        return apply

    def schur_arrays(self, state, reg: float, jacobi: bool, lumped: bool):
        """``solvers._schur_arrays`` on the band: the element-block math is
        band-local, the primal node scatter completes through the halo
        exchange, one max all-reduce takes the largest latent entry, and
        every output stays in its distributed layout (``De_inv`` the
        band's, ``safe`` and ``dshift`` primal slots): no dof-length
        collective."""
        if lumped:
            raise NotImplementedError(
                "halo Schur takes the L2-latent exact elimination; use "
                "ShardedForm for a lumped H1 latent")
        if len(self.form.spaces) != 2:
            raise NotImplementedError("halo Schur needs a 2-block form")
        from ..solvers import SchurOps, _schur_arrays_core

        su = self._slots_u()
        ops = SchurOps(self, state, pmax=self.comm.max_,
                       usplit=lambda v: v[:su])
        return _schur_arrays_core(self.form, self.bands[0], state[0], reg,
                                  jacobi, False, ops)
