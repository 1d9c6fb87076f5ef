"""Example 1: AD diffusion (Poisson).

-Δu = 2π² sin(πx) sin(πy) on the unit square, u = 0 on the boundary;
prints the L2 error against the exact solution sin(πx) sin(πy).

    python -m mfem_ad_tpu_torch.examples.ex1 -o 2 -r 2 --solver dense
"""

from __future__ import annotations

import argparse

from mfem_ad_tpu_torch.models import poisson
from mfem_ad_tpu_torch.utils.viz import maybe_export


def main(argv=None):
    ap = argparse.ArgumentParser(description="AD diffusion (ex1)")
    ap.add_argument("-o", "--order", type=int, default=1)
    ap.add_argument("-r", "--ref", type=int, default=1)
    ap.add_argument("--solver", default="cg",
                    choices=["cg", "dense", "minres", "gmres"])
    ap.add_argument("-pv", "--paraview", action="store_true")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    res, err, pb = poisson.solve(args.order, args.ref,
                                 lin_solver=args.solver, device=args.device)
    print("Error:", err)
    maybe_export(args.paraview, "ad-diffusion", pb.space, {"x": res.x})
    return res, err, pb


if __name__ == "__main__":
    main()
