"""Topology optimization: SiMPL mirror descent on a cantilever.

Minimizes the compliance of a clamped cantilever under a tip load,
subject to a volume fraction, by mirror descent in the Fermi-Dirac
latent variable with volume bisection (``mfem_ad_tpu_torch.mmto``).

    python -m mfem_ad_tpu_torch.examples.topopt -nx 48 -ny 24
"""

from __future__ import annotations

import argparse

from mfem_ad_tpu_torch.mmto import SiMPLTopopt, build_cantilever
from mfem_ad_tpu_torch.utils._host import to_numpy
from mfem_ad_tpu_torch.utils.viz import maybe_export


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
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

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
