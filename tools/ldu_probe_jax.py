"""The JAX package's side of ``tools/ldu_probe_torch.py`` (CPU, f64).

    JAX_PLATFORMS=cpu python tools/ldu_probe_jax.py --n0 10 0 1

For ex5's problem (order 2) at each ref: the first Newton direction
(alpha 1, from zero) in the Woodbury mode (``sigma_direct=False``) to
``lin_tol`` 1e-10 through the package's default (chunked) driver, which
takes ``_ldu_fgmres``; its own summary line (``MFEM_AD_TPU_LDU_DEBUG``:
FGMRES iterations and the relative residual reached), then wall time.
Imports the JAX package only.
"""

import argparse
import os
import sys
import time

os.environ["MFEM_AD_TPU_LDU_DEBUG"] = "1"
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import jax.numpy as jnp  # noqa: E402

from mfem_ad_tpu import solvers as JS  # noqa: E402
from mfem_ad_tpu.models import gradient_obstacle as go  # noqa: E402


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("refs", type=int, nargs="*", default=[0, 1])
    ap.add_argument("--n0", type=int, default=10)
    a = ap.parse_args()
    for ref in a.refs:
        pb = go.build(order=2, ref_levels=ref, n0=a.n0)
        gmg = go._primal_gmg(2, ref, a.n0)
        x = jnp.zeros(pb.form.ndof)
        nu = pb.primal_space.ndof
        opts = JS.NewtonOptions(lin_solver="schur", lin_tol=1e-10,
                                sigma_direct=False)
        t0 = time.perf_counter()
        _, k = JS._schur_dir_chunked(
            pb.form, opts, gmg, x, pb.rhs,
            {"alpha": 1.0, "latent_k0": x[nu:]}, gmg.fused_pdata())
        print(f"ref {ref} n0 {a.n0} ({pb.form.ndof} dofs): Woodbury "
              f"direction {int(k)} FGMRES, {time.perf_counter() - t0:.1f} s",
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
