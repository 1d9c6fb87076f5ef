"""Example 5: the gradient-constrained obstacle by proximal Galerkin
(LVPP).

||grad u|| <= 0.1 + 0.2x + 0.4y through the Hellinger mirror map on
H1(p) x H1(p-1)^dim spaces over a triangle mesh; the outer PG loop with
the alpha schedule flags and the lambda-increment stopping rule (1e-8).
The default solver is LDU-preconditioned FGMRES on the saddle system
with the hp-GMG on the primal block.  The reference's invocation:

    python -m mfem_ad_tpu_torch.examples.ex5 -rule 2 -a0 1 -ar 2
"""

from __future__ import annotations

import argparse

from mfem_ad_tpu_torch.models import gradient_obstacle
from mfem_ad_tpu_torch.utils import profiling
from mfem_ad_tpu_torch.utils.viz import maybe_export


def main(argv=None):
    ap = argparse.ArgumentParser(description="LVPP gradient obstacle (ex5)")
    ap.add_argument("-o", "--order", type=int, default=2)
    ap.add_argument("-r", "--ref", type=int, default=3)
    ap.add_argument("-rule", "--rule", type=int, default=0,
                    help="0=CONSTANT 1=POLY 2=EXP 3=DOUBLE_EXP")
    ap.add_argument("-ma", "--max-alpha", type=float, default=1e6)
    ap.add_argument("-a0", "--alpha0", type=float, default=1.0)
    ap.add_argument("-ar", "--alpha-ratio", type=float, default=1.0)
    ap.add_argument("-ar2", "--alpha-ratio2", type=float, default=1.0)
    ap.add_argument("--solver", default="schur",
                    choices=["schur", "dense", "minres", "gmres"],
                    help="schur = FGMRES on the saddle system under the "
                         "block-LDU preconditioner with the hp-GMG; dense "
                         "= LU of the assembled Jacobian (small problems)")
    ap.add_argument("-pv", "--paraview", action="store_true")
    ap.add_argument("--profile", default=None, metavar="LOGDIR",
                    help="write a torch.profiler trace of the second PG "
                         "iteration to LOGDIR and print the per-phase cost "
                         "table of the whole run")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    if args.profile:
        profiling.reset()
    with profiling.trace(args.profile):
        res, pb = gradient_obstacle.solve(
            order=args.order,
            ref_levels=args.ref,
            rule_type=args.rule,
            alpha0=args.alpha0,
            max_alpha=args.max_alpha,
            ratio=args.alpha_ratio,
            ratio2=args.alpha_ratio2,
            lin_solver=args.solver,
            verbose=True,
            device=args.device,
        )
    print(
        f"PG {'converged' if res.converged else 'stopped'} in "
        f"{res.iterations} iterations, final lambda diff {res.lambda_diff:.3e}"
    )
    if args.profile:
        profiling.print_cost_table()
    maybe_export(
        args.paraview, "ad-grad-obstacle", pb.primal_space,
        {"x": res.x[: pb.primal_space.ndof]},
    )
    return res, pb


if __name__ == "__main__":
    main()
