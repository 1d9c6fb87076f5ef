"""Multi-device example skeleton: Poisson on element bands over the ranks
of a process group (the counterpart of the JAX package's
``examples/par_template.py``).

Each rank holds the whole form and assembles its band of the element axis
(``parallel.ShardedForm``); one all-reduce completes every assembly and
Newton-CG runs alike on every rank.  Start the ranks with ``torchrun`` or
with ``--nproc``:

    torchrun --nproc_per_node 4 -m mfem_ad_tpu_torch.examples.par_template
    python -m mfem_ad_tpu_torch.examples.par_template --nproc 4

Several ranks on one GPU run over gloo (NCCL refuses two ranks on one
card); ``--device cpu`` runs the ranks on the host.
"""

from __future__ import annotations

import argparse

import torch

from mfem_ad_tpu_torch.models import poisson
from mfem_ad_tpu_torch.norms import l2_error
from mfem_ad_tpu_torch.parallel import ShardedForm, init, spawn
from mfem_ad_tpu_torch.parallel.comm import local_ranks, rank_device
from mfem_ad_tpu_torch.solvers import NewtonOptions, newton
from mfem_ad_tpu_torch.utils._host import to_numpy
from mfem_ad_tpu_torch.utils.viz import maybe_export


def run(comm, args):
    """One rank's solve; rank 0 prints.  Returns (converged, L2 error,
    Newton iterations)."""
    K = comm.world_size
    if comm.rank == 0:
        _, local = local_ranks(comm.rank, K)
        devs = {rank_device(args.device, r) for r in range(local)}
        print(f"ranks: {K}, {local} per host on {len(devs)} x "
              f"{comm.device.type}, backend "
              f"{comm.backend or 'none'}", flush=True)
    pb = poisson.build(order=args.order, ref_levels=args.ref,
                       device=comm.device)
    sf = ShardedForm(pb.form, comm)  # element bands over the ranks
    res = newton(
        sf,
        torch.zeros(pb.form.ndof, dtype=pb.rhs.dtype, device=comm.device),
        b=pb.rhs,
        opts=NewtonOptions(
            abs_tol=1e-10, max_iter=3, lin_solver="cg", lin_tol=1e-14,
            preconditioner="jacobi",
        ),
    )
    err = l2_error(pb.space, to_numpy(res.x), poisson.exact_fn)
    if comm.rank == 0:
        print(f"converged={res.converged} L2 error={err:.3e}", flush=True)
        maybe_export(args.paraview, "par-template", pb.space, {"u": res.x})
    return res.converged, err, res.iterations


def main(argv=None):
    ap = argparse.ArgumentParser(
        description="multi-device skeleton (par_template.cpp)")
    ap.add_argument("-o", "--order", type=int, default=2)
    ap.add_argument("-r", "--ref", type=int, default=1)
    ap.add_argument("-pv", "--paraview", action="store_true")
    ap.add_argument("--nproc", type=int, default=0,
                    help="spawn this many ranks (0: one process, or the "
                         "ranks torchrun started)")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--timeout", type=float, default=300.0,
                    help="seconds for the rendezvous and each collective")
    args = ap.parse_args(argv)
    if args.nproc:
        return spawn(run, args.nproc, (args,), device=args.device,
                     timeout=args.timeout)[0]
    return run(init(device=args.device, timeout=args.timeout), args)


if __name__ == "__main__":
    main()
