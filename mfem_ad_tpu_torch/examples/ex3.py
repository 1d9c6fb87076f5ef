"""Example 3: AD linear elasticity with vector finite elements.

LinearElasticityEnergy in GRAD|VECTOR mode, unit body load, clamped on
boundary attribute 4; one linear solve.  Quads and hexes, or with
``--geom`` triangles (2D) and tets (3D).

    python -m mfem_ad_tpu_torch.examples.ex3 -d 3 -r 1 --solver minres
    python -m mfem_ad_tpu_torch.examples.ex3 -d 3 -r 0 --geom tet
"""

from __future__ import annotations

import argparse

from mfem_ad_tpu_torch.models import elasticity
from mfem_ad_tpu_torch.utils.viz import maybe_export


def main(argv=None):
    ap = argparse.ArgumentParser(description="AD elasticity (ex3)")
    ap.add_argument("-o", "--order", type=int, default=1)
    ap.add_argument("-r", "--ref", type=int, default=3)
    ap.add_argument("-d", "--dim", type=int, default=2, choices=[2, 3])
    ap.add_argument("--geom", default=None, choices=[None, "tri", "tet"],
                    help="simplex mesh (tri in 2D, tet in 3D; default "
                         "quad/hex)")
    ap.add_argument("--solver", default="cg",
                    choices=["cg", "dense", "minres", "gmres"])
    ap.add_argument("-pv", "--paraview", action="store_true")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    res, pb = elasticity.solve(args.order, args.ref, lin_solver=args.solver,
                               dim=args.dim, geom=args.geom,
                               device=args.device)
    print("converged:", res.converged, " |u|_max:",
          float(res.x.abs().max()))
    maybe_export(args.paraview, "ad-elasticity", pb.space, {"x": res.x})
    return res, pb


if __name__ == "__main__":
    main()
