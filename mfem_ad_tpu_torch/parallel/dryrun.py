"""A dry run of the distributed production solver: one Schur Newton step
of the LVPP obstacle problem on ``HaloShardedForm`` over K ranks (the
counterpart of the JAX package's ``__graft_entry__.dryrun_multichip``).

The exact elimination of the L2 latent runs on each rank's band, dof
vectors stay in the owner-zero layout, and the only traffic between the
ranks is each matvec's interface-plane exchange and scalar all-reduces.
The problem is ``obstacle.build(order=1, ref_levels=0, n0=2K)``: its
outer cell count 2K divides among the ranks.

    python -m mfem_ad_tpu_torch.parallel.dryrun --nproc 4
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from ..models import obstacle
from ..solvers import schur_solve
from .comm import spawn
from .halo import HaloShardedForm


def newton_step(comm):
    """One rank's Schur Newton step from zero at alpha 1; asserts a finite
    iterate of the rank's slot-block shape.  Returns (slots, CG iterations,
    the iterate's norm)."""
    K = comm.world_size
    pb = obstacle.build(order=1, ref_levels=0, n0=2 * K, device=comm.device)
    hf = HaloShardedForm(pb.form, comm)
    fields = {"alpha": 1.0,
              "latent_k0": torch.zeros(pb.latent_space.ndof,
                                       dtype=pb.form.dtype,
                                       device=comm.device)}
    x0 = hf.dist_array(np.zeros(pb.form.ndof))
    rhs = hf.dist_array(pb.rhs.cpu().numpy())
    r = torch.where(hf.ess_mask, 0.0, hf.mult(x0, fields) - rhs)
    state = hf.grad_state(x0, fields)
    dx, its = schur_solve(hf, state, r, 1e-10, 200)
    x1 = x0 - dx
    if x1.shape != (hf.slots,) or not bool(torch.isfinite(x1).all()):
        raise AssertionError(
            f"rank {comm.rank}: iterate of shape {tuple(x1.shape)}, finite "
            f"{bool(torch.isfinite(x1).all())}")
    return hf.slots, its, float(hf.norm(x1))


def dryrun_multichip(n_ranks: int, device="cuda", timeout: float = 300.0):
    """``newton_step`` on ``n_ranks`` spawned ranks; returns their results.
    ``timeout`` bounds the rendezvous and each collective."""
    return spawn(newton_step, n_ranks, device=device, timeout=timeout)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--nproc", type=int, default=4)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--timeout", type=float, default=300.0)
    args = ap.parse_args(argv)
    out = dryrun_multichip(args.nproc, args.device, args.timeout)
    slots, its, nrm = out[0]
    print(f"dryrun: {args.nproc} ranks, {slots} slots per rank, {its} CG, "
          f"|x1| = {nrm:.12e}", flush=True)
    return out


if __name__ == "__main__":
    main()
