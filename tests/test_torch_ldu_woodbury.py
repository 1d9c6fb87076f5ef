"""Port parity, ex5's Woodbury LDU direction above the coarsest mesh.

At order 2, ref 0 the hp-GMG of ``models.gradient_obstacle`` has only its
p-coarsening level, so ``tests/test_torch_gradient_obstacle.py`` never
reaches the triangle grids' geometric transfers or the shifted V-cycle
that the Woodbury apply of Sigma^-1 runs.  Here ex5's form at order 2,
ref 1, n0 4 (451 dofs, 162 latent; the GMG p-coarsens P2 to P1 on 8x8
cells, then coarsens P1 geometrically to 4x4) takes one LDU-FGMRES
direction with ``sigma_direct=False`` at a seeded state in both
packages, f64, CPU: the FGMRES counts equal (7), the directions within
1e-8 relative of each other and of the dense direct solve of the same
Jacobian.  The inner CGs stop at a loose tolerance (3e-3), so a rounding
difference can move one inner count and, with it, the outer count by
one; at ref 1 both packages take the same path.
"""

import numpy as np
import torch

import jax.numpy as jnp

from mfem_ad_tpu import solvers as JS
from mfem_ad_tpu.models import gradient_obstacle as jgo
from mfem_ad_tpu_torch import solvers as PS
from mfem_ad_tpu_torch.models import gradient_obstacle as pgo
from mfem_ad_tpu_torch.utils import profiling

F64 = torch.float64
TOL_DIR = 1e-8
ORDER, REF, N0 = 2, 1, 4
ALPHA = 4.0


def rel(a, b) -> float:
    a, b = np.asarray(a), np.asarray(b)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def test_woodbury_direction_at_ref1_matches_jax_and_dense():
    pbj = jgo.build(order=ORDER, ref_levels=REF, n0=N0)
    pbp = pgo.build(order=ORDER, ref_levels=REF, n0=N0, device="cpu")
    rng = np.random.default_rng(3)
    x = 0.1 * rng.standard_normal(pbj.form.ndof)
    nu = pbj.primal_space.ndof
    x[np.asarray(pbj.primal_space.boundary_dofs())] = 0.0
    lat = 0.5 * x[nu:]

    gmg = jgo._primal_gmg(ORDER, REF, N0)
    jopts = JS.NewtonOptions(lin_solver="schur", lin_tol=1e-10,
                             sigma_direct=False)
    jdx, jk = JS._schur_dir_chunked(
        pbj.form, jopts, gmg, jnp.asarray(x), pbj.rhs,
        {"alpha": ALPHA, "latent_k0": jnp.asarray(lat)}, gmg.fused_pdata())

    fields = {"alpha": ALPHA, "latent_k0": torch.as_tensor(lat, dtype=F64)}
    xt = torch.as_tensor(x, dtype=F64)
    r = PS._residual(pbp.form, xt, pbp.rhs, fields)
    state = pbp.form.grad_state(xt, fields)
    fp = pgo._primal_gmg(ORDER, REF, N0, device="cpu")
    assert fp.gmg.shapes[1] != fp.gmg.shapes[2]  # a geometric level
    profiling.reset()
    opts = PS.NewtonOptions(lin_solver="schur", lin_tol=1e-10,
                            sigma_direct=False)
    dx, k = PS.lumped_schur_solve(pbp.form, state, r, opts, fp=fp,
                                  alpha=ALPHA)
    assert "ldu/fgmres_wb" in profiling.cost_table()
    assert k == int(jk) == 7  # as at ref 0 (test_torch_gradient_obstacle)
    assert rel(dx.numpy(), np.asarray(jdx)) <= TOL_DIR
    dense = PS.dense_solve(pbp.form.assemble_dense(state), r)
    assert rel(dx.numpy(), dense.numpy()) <= TOL_DIR
