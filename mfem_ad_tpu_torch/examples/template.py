"""Serial driver skeleton: the starting point for a new driver.

Options parsing, mesh construction and refinement, an FE space, a
projected field on the chosen device, and optional GLVis and ParaView
(VTU) output.

    python -m mfem_ad_tpu_torch.examples.template -n 10 -o 2 -vis
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from mfem_ad_tpu_torch import mesh as M
from mfem_ad_tpu_torch.fespace import FESpace
from mfem_ad_tpu_torch.quadrature import SQUARE, TRIANGLE
from mfem_ad_tpu_torch.utils.glvis import GLVis
from mfem_ad_tpu_torch.utils.viz import maybe_export


def main(argv=None):
    ap = argparse.ArgumentParser(description="driver skeleton")
    ap.add_argument("-m", "--mesh", default=None,
                    help="MFEM mesh file (default: built-in Cartesian)")
    ap.add_argument("-n", type=int, default=10, help="cells per side")
    ap.add_argument("-o", "--order", type=int, default=1)
    ap.add_argument("-r", "--ref", type=int, default=0,
                    help="uniform refinement levels")
    ap.add_argument("--tri", action="store_true", help="triangle mesh")
    ap.add_argument("-vis", "--visualization", action="store_true",
                    help="send the field to a running GLVis server")
    ap.add_argument("-pv", "--paraview", action="store_true",
                    help="write a VTU file for ParaView")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    if args.mesh:
        m = M.read_mfem_mesh(args.mesh)
    else:
        geom = TRIANGLE if args.tri else SQUARE
        m = M.make_cartesian_2d(args.n, args.n, geom)
    m = m.uniform_refine(args.ref)
    print(f"mesh: {m.num_elements} elements, {m.num_vertices} vertices")

    fes = FESpace(m, args.order)
    print(f"space: order {args.order}, {fes.ndof} dofs")

    u = torch.as_tensor(
        fes.project(lambda x: np.sin(np.pi * x[0]) * np.sin(np.pi * x[1])),
        dtype=torch.float64, device=args.device,
    )

    if args.visualization:
        g = GLVis()
        g.append(fes, u, name="u")
        g.update()
    maybe_export(args.paraview, "template", fes, {"u": u})
    return fes, u


if __name__ == "__main__":
    main()
