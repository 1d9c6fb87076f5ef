"""Topology optimization: SiMPL mirror descent on a cantilever.

Minimizes the compliance of a clamped cantilever under a tip load,
subject to a volume fraction, by mirror descent in the Fermi-Dirac
latent variable with volume bisection (``mfem_ad_tpu_torch.mmto``).

    python -m mfem_ad_tpu_torch.examples.topopt -nx 48 -ny 24

``--ex37`` runs MFEM ex37's density-filtered SiMPL instead
(``models.topopt.build_ex37``; ``-r`` refinements of the 3 x 1 mesh,
``-a`` its alpha, ``-mi`` design iterations), printing each iteration's
compliance, CG counts and the filtered density's contrast, then the
phase table:

    python -m mfem_ad_tpu_torch.examples.topopt --ex37 -r 5 -a 10 -mi 20
"""

from __future__ import annotations

import argparse

from mfem_ad_tpu_torch.mmto import SiMPLTopopt, build_cantilever
from mfem_ad_tpu_torch.models import topopt
from mfem_ad_tpu_torch.utils import profiling
from mfem_ad_tpu_torch.utils._host import to_numpy
from mfem_ad_tpu_torch.utils.viz import maybe_export


def ex37(args):
    pb = topopt.build_ex37(args.refine, alpha=args.alpha,
                           device=args.device)

    def report(k, psi, rho_f, u, w, psi_next):
        lo, hi = topopt.contrast(rho_f, pb.filter_space)
        print(f"ex37 it {k:3d}: rho~ in [{float(rho_f.min()):.4f}, "
              f"{float(rho_f.max()):.4f}], cells below 0.01 {lo:.4f}, "
              f"above 0.99 {hi:.4f}")

    res = pb.opt.solve(args.max_iter, callback=report, verbose=True)
    print(f"ex37 finished: compliance {res.compliance_history[-1]:.6e} "
          f"({len(res.compliance_history)} its), volume fraction "
          f"{res.volume_history[-1]:.6f}, state CG {res.cg_iterations}, "
          f"filter CG {res.filter_cg_iterations}")
    profiling.print_cost_table()
    return res, pb


def main(argv=None):
    ap = argparse.ArgumentParser(
        description="SiMPL topology optimization (cantilever)")
    ap.add_argument("-nx", type=int, default=48)
    ap.add_argument("-ny", type=int, default=24)
    ap.add_argument("-o", "--order", type=int, default=1)
    ap.add_argument("-vf", "--vol-frac", type=float, default=0.5)
    ap.add_argument("-s", "--step", type=float, default=5.0)
    ap.add_argument("-mi", "--max-iter", type=int, default=60)
    ap.add_argument("-se", "--simp-exp", type=float, default=3.0)
    ap.add_argument("-pv", "--paraview", action="store_true")
    ap.add_argument("--ex37", action="store_true")
    ap.add_argument("-r", "--refine", type=int, default=5)
    ap.add_argument("-a", "--alpha", type=float, default=1.0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    if args.ex37:
        return ex37(args)

    form, design, b, m, disp = build_cantilever(
        nx=args.nx, ny=args.ny, order=args.order, simp_exp=args.simp_exp,
        device=args.device,
    )
    opt = SiMPLTopopt(form, design, b, vol_frac=args.vol_frac,
                      step=args.step)
    res = opt.solve(max_iter=args.max_iter, verbose=True)

    rho = to_numpy(res.rho)
    print(
        f"topopt finished: compliance {res.compliance_history[-1]:.6e} "
        f"({len(res.compliance_history)} its), "
        f"volume fraction {res.volume_history[-1]:.4f} "
        f"(target {args.vol_frac}), rho in [{rho.min():.3f}, {rho.max():.3f}]"
    )
    maybe_export(args.paraview, "topopt-design", design, {"rho": res.rho})
    return res, opt


if __name__ == "__main__":
    main()
