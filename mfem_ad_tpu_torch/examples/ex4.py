"""Example 4: AD obstacle problem by proximal Galerkin (LVPP).

0 <= u <= 0.5 through the Fermi-Dirac mirror map on mixed H1(p+1) x
L2(p-1) spaces; the outer PG loop with the alpha schedule flags and the
lambda-increment stopping rule.  The default solver is the exact Schur
elimination of the latent with CG preconditioned by the alpha-shifted
hp-GMG.  ``--dof-pg`` runs the dof-level PG variant (``--spatial-bound``:
the upper bound 0.3 + 0.2 x).  The reference's smoke invocation:

    python -m mfem_ad_tpu_torch.examples.ex4 -rule 2 -a0 0.1 -ar 2
"""

from __future__ import annotations

import argparse

from mfem_ad_tpu_torch.models import obstacle
from mfem_ad_tpu_torch.utils import profiling
from mfem_ad_tpu_torch.utils._host import to_numpy
from mfem_ad_tpu_torch.utils.viz import maybe_export


def main(argv=None):
    ap = argparse.ArgumentParser(description="LVPP obstacle (ex4)")
    ap.add_argument("-o", "--order", type=int, default=2)
    ap.add_argument("-r", "--ref", type=int, default=3)
    ap.add_argument("-rule", "--rule", type=int, default=0,
                    help="0=CONSTANT 1=POLY 2=EXP 3=DOUBLE_EXP")
    ap.add_argument("-ma", "--max-alpha", type=float, default=1e4)
    ap.add_argument("-a0", "--alpha0", type=float, default=1.0)
    ap.add_argument("-ar", "--alpha-ratio", type=float, default=1.0)
    ap.add_argument("-ar2", "--alpha-ratio2", type=float, default=1.0)
    ap.add_argument("--solver", default="schur",
                    choices=["schur", "dense", "minres", "gmres"],
                    help="schur = exact latent elimination + CG with the "
                         "shifted hp-GMG; dense = LU of the assembled "
                         "Jacobian (small problems)")
    ap.add_argument("-pv", "--paraview", action="store_true")
    ap.add_argument("--geom", default=None, choices=[None, "tet"],
                    help="tetrahedral mesh (dim=3 only; default hex)")
    ap.add_argument("-d", "--dim", type=int, default=2, choices=[2, 3],
                    help="3 = the obstacle problem on hexes")
    ap.add_argument("--profile", default=None, metavar="LOGDIR",
                    help="write a torch.profiler trace of the second PG "
                         "iteration to LOGDIR and print the per-phase cost "
                         "table of the whole run")
    ap.add_argument("--dof-pg", action="store_true",
                    help="dof-level PG variant: entropy coupling at the H1 "
                         "nodal points, L2 dual of equal order, Jacobi-"
                         "MINRES directions (schur maps to minres); use "
                         "modest -r (the saddle conditioning grows like "
                         "alpha x E*'' saturation)")
    ap.add_argument("--spatial-bound", action="store_true",
                    help="with --dof-pg: upper bound 0.3 + 0.2 x as a "
                         "grid-function entropy parameter")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    if args.profile:
        profiling.reset()
    common = dict(
        order=args.order,
        ref_levels=args.ref,
        dim=args.dim,
        rule_type=args.rule,
        alpha0=args.alpha0,
        max_alpha=args.max_alpha,
        ratio=args.alpha_ratio,
        ratio2=args.alpha_ratio2,
        verbose=True,
        device=args.device,
    )
    with profiling.trace(args.profile):
        if args.dof_pg:
            res, pb = obstacle.solve_dofpg(
                lin_solver=("minres" if args.solver == "schur"
                            else args.solver),
                spatial_bound=args.spatial_bound,
                tol=1e-6,
                **common,
            )
        else:
            res, pb = obstacle.solve(geom=args.geom,
                                     lin_solver=args.solver, **common)
    u = to_numpy(res.x[: pb.primal_space.ndof])
    print(
        f"PG {'converged' if res.converged else 'stopped'} in "
        f"{res.iterations} iterations, final lambda diff {res.lambda_diff:.3e}"
    )
    ub = "0.3 + 0.2 x" if args.spatial_bound else "0.5"
    print(f"u range: [{u.min():.6f}, {u.max():.6f}] (bounds [0, {ub}])")
    if args.profile:
        profiling.print_cost_table()
    maybe_export(
        args.paraview, "ad-obstacle", pb.primal_space,
        {"x": res.x[: pb.primal_space.ndof]},
    )
    return res, pb


if __name__ == "__main__":
    main()
