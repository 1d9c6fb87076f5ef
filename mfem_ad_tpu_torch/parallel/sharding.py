"""ShardedForm: a block form's assembly over the ranks of a process group.

PyTorch counterpart of ``mfem_ad_tpu.parallel.sharding``.  The JAX
package runs it as one ``shard_map`` program over a device mesh; here
every rank is a process of its own:

- each rank holds the whole serial form and assembles its contiguous band
  of the element axis (``integrator.Band``; the element count is
  copy-padded with zero-weight elements to a multiple of the rank count);
- dof vectors are replicated: each rank scatters its band into a
  full-length vector and one sum all-reduce completes ``mult``,
  ``grad_mult`` and ``grad_diag`` (hypre's ParallelAssemble as one
  collective);
- Newton and the Krylov solvers then run redundantly, and alike, on every
  rank: their vectors and every scalar they test are the same bits on
  each.

``ShardedForm`` has the ``BlockNonlinearForm`` protocol, so ``newton``,
the Schur directions (``schur_arrays``) and ``PGSolver`` run on it
unchanged.  The Newton state (``grad_state``) stays rank-local: the
band's per-qp Hessians.
"""

from __future__ import annotations

import torch

from ..integrator import SymHess
from .comm import world


def cat_sum(parts):
    """Sum over the integrators of their per-block lists, each list
    concatenated into one form vector."""
    acc = None
    for blocks in parts:
        y = torch.cat(blocks)
        acc = y if acc is None else acc + y
    return acc


def _embed_tree(state, band, comm):
    """A rank-local Newton state on the whole element axis: every
    element-leading array (SymHess planes along dim 1) placed in the true
    element range and summed over the ranks."""
    if isinstance(state, SymHess):
        planes = band.embed(state.planes.transpose(0, 1)).transpose(0, 1)
        return SymHess(comm.sum_(planes.contiguous()), state.n)
    if isinstance(state, (tuple, list)):
        return type(state)(_embed_tree(s, band, comm) for s in state)
    return comm.sum_(band.embed(state))


class ShardedForm:
    """Element-banded view of a ``BlockNonlinearForm`` with replicated dof
    vectors.

    Args:
        form: the built serial form (kept whole on every rank: the dense
            fallback and the Schur solver's canonical layout use it).
        comm: this rank's ``parallel.Comm`` (default: the default group,
            or this process alone).
    """

    def __init__(self, form, comm=None):
        self.form = form
        self.comm = comm or world(form.device)
        self.bands = [intg.band_view(self.comm)
                      for intg in form.integrators]

    # -- the BlockNonlinearForm protocol -----------------------------------
    @property
    def spaces(self):
        return self.form.spaces

    @property
    def offsets(self):
        return self.form.offsets

    @property
    def ndof(self):
        return self.form.ndof

    @property
    def ess_mask(self):
        return self.form.ess_mask

    @property
    def device(self):
        return self.form.device

    @property
    def dtype(self):
        return self.form.dtype

    def split(self, u):
        return self.form.split(u)

    def energy(self, u, fields=None):
        e = sum(b.energy(self.split(u), fields) for b in self.bands)
        return self.comm.sum_(torch.as_tensor(e).clone())

    def _sum(self, parts):
        """``cat_sum`` of the bands' block lists, summed over the ranks."""
        return self.comm.sum_(cat_sum(parts))

    def mult(self, u, fields=None):
        blocks = self.split(u)
        r = self._sum(b.residual(blocks, fields) for b in self.bands)
        return torch.where(self.ess_mask, 0.0, r)

    def grad_state(self, u, fields=None):
        """The bands' Newton states (rank-local)."""
        return [b.hess_state(self.split(u), fields, sym=True)
                for b in self.bands]

    def grad_mult(self, state, v):
        blocks = self.split(torch.where(self.ess_mask, 0.0, v))
        y = self._sum(b.hess_mult(Hq, blocks)
                      for b, Hq in zip(self.bands, state))
        return torch.where(self.ess_mask, v, y)

    def grad_diag(self, state):
        d = self._sum(b.diagonal(Hq) for b, Hq in zip(self.bands, state))
        return torch.where(self.ess_mask, 1.0, d)

    def schur_arrays(self, state, reg: float, jacobi: bool, lumped: bool):
        """``solvers._schur_arrays`` on the bands: the element-block math is
        band-local, one sum all-reduce completes each node scatter and the
        diagonal, one max all-reduce the largest latent entry, and the
        latent inverses ``De_inv`` are embedded and summed into the whole
        (trimmed) element range.  Every output is replicated."""
        from ..solvers import SchurOps, _schur_arrays_core

        comm, band = self.comm, self.bands[0].band

        def globalize(a):
            return comm.sum_(band.embed(a))

        ops = SchurOps(self, state, psum=comm.sum_, pmax=comm.max_,
                       globalize=globalize)
        return _schur_arrays_core(self.form, self.bands[0], state[0], reg,
                                  jacobi, lumped, ops)

    def assemble_dense(self, state):
        """The dense fallback: the bands' states gathered onto the whole
        element range, then the serial form's assembly."""
        full = [_embed_tree(Hq, b.band, self.comm)
                for b, Hq in zip(self.bands, state)]
        return self.form.assemble_dense(full)
