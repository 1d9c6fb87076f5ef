"""Example 2: AD minimal surface.

Energy sqrt(1 + |grad u|²) + ε|grad u|², ε halved over the continuation
passes of a Newton solve (tolerance 1e-10); prints each pass.

    python -m mfem_ad_tpu_torch.examples.ex2 -r 3 -n 30
"""

from __future__ import annotations

import argparse

from mfem_ad_tpu_torch.models import minimal_surface
from mfem_ad_tpu_torch.utils.viz import maybe_export


def main(argv=None):
    ap = argparse.ArgumentParser(description="AD minimal surface (ex2)")
    ap.add_argument("-o", "--order", type=int, default=1)
    ap.add_argument("-r", "--ref", type=int, default=3)
    ap.add_argument("-n", "--steps", type=int, default=30)
    ap.add_argument("--solver", default="cg",
                    choices=["cg", "dense", "minres", "gmres"])
    ap.add_argument("-pv", "--paraview", action="store_true")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    x, hist, pb = minimal_surface.solve(
        args.order, args.ref, continuation_steps=args.steps,
        lin_solver=args.solver, verbose=True, device=args.device,
    )
    maybe_export(args.paraview, "ad-minimalsurface", pb.space, {"x": x})
    return x, hist, pb


if __name__ == "__main__":
    main()
