"""Port parity, the gradient-constrained obstacle (ex5): the lumped-latent
saddle direction of ``mfem_ad_tpu_torch.solvers``,
``models.gradient_obstacle`` and ``examples.ex5``.

Against ``mfem_ad_tpu`` on ex5's form at order 2, ref 0, n0 4 (131 dofs:
H1 P2 + H1 P1^2 on 32 triangles), f64, CPU; relative 1e-10 for single
operations, 1e-8 for directions and trajectories, iteration counts equal:

- the lumped Schur arrays (node-block D~^-1, the dual node blocks
  Sigma~^-1, the reaction diagonal, the Jacobi diagonal) at a fixed state;
- one LDU-FGMRES direction in modes "direct" (the dense dual-Schur
  factor) and "wb" (Woodbury) against JAX's ``_ldu_fgmres`` and against
  ``dense_solve``; the MINRES direction without a GMG against JAX's
  ``_schur_solve_traced(lumped=True)`` and its chunked driver's count;
- the matvec K builder against the GEMM K (with a one-level GMG, whose
  V-cycle is the exact inverse, the two are the same matrix up to the
  f32 inverse); the lazy refresh of the dual-Schur factor (alpha moved
  more than 4x, more than 12 FGMRES iterations) and its inverse against
  an f64 one.

The JAX references run once per module and are jitted.
``tests/test_torch_ex5.py`` holds the outer loop and the example.
"""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mfem_ad_tpu import solvers as JS
from mfem_ad_tpu.models import gradient_obstacle as jgo
from mfem_ad_tpu_torch import solvers as PS
from mfem_ad_tpu_torch.ad import DiffusionEnergy
from mfem_ad_tpu_torch.adeval import ADEval
from mfem_ad_tpu_torch.fespace import FESpace
from mfem_ad_tpu_torch.forms import NonlinearForm
from mfem_ad_tpu_torch.models import gradient_obstacle as pgo
from mfem_ad_tpu_torch.multigrid import GMG, PGSchurGMG
from mfem_ad_tpu_torch.utils import profiling

F64 = torch.float64
TOL_OP = 1e-10
TOL_DIR = 1e-8
PB_KW = dict(order=2, ref_levels=0, n0=4)
ALPHA = 4.0


def rel(a, b) -> float:
    a, b = np.asarray(a), np.asarray(b)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def _t(a):
    return torch.as_tensor(np.asarray(a), dtype=F64)


@functools.lru_cache(maxsize=None)
def _problem():
    """Both packages' forms, a seeded state with zero primal boundary
    values, and the port's residual and Newton state there (alpha 4)."""
    pbj, pbp = jgo.build(**PB_KW), pgo.build(**PB_KW, device="cpu")
    rng = np.random.default_rng(3)
    x = 0.1 * rng.standard_normal(pbj.form.ndof)
    nu = pbj.primal_space.ndof
    x[np.asarray(pbj.primal_space.boundary_dofs())] = 0.0
    lat = 0.5 * x[nu:]
    fj = {"alpha": ALPHA, "latent_k0": jnp.asarray(lat)}
    fp = {"alpha": ALPHA, "latent_k0": _t(lat)}
    xt = _t(x)
    r = PS._residual(pbp.form, xt, pbp.rhs, fp)
    state = pbp.form.grad_state(xt, fp)
    return pbj, pbp, x, fj, fp, r, state


def _opts(S, sigma_direct="auto", precond=None):
    return S.NewtonOptions(lin_solver="schur", lin_tol=1e-10,
                           sigma_direct=sigma_direct,
                           preconditioner=precond)


@functools.lru_cache(maxsize=None)
def _jax_direction(mode: str):
    """JAX's direction at the fixed state: "direct" and "wb" through its
    default (chunked) driver with a GMG, which takes ``_ldu_fgmres``;
    "minres" through it without one; "traced" through the one-shot
    ``_schur_solve_traced(lumped=True)``."""
    pbj, _, x, fj, _, _, _ = _problem()
    form = pbj.form
    if mode == "traced":
        tables = form._tables()

        @jax.jit
        def run(tables, ess, x, fields):
            r = jnp.where(ess, 0.0, form.mult_raw(tables, ess, x, fields)
                          - pbj.rhs)
            state = form.grad_state_raw(tables, x, fields)
            return JS._schur_solve_traced(form, tables, ess, state, r,
                                          1e-10, 2000, lumped=True)

        return np.asarray(run(tables, form.ess_mask, jnp.asarray(x), fj)), 0
    gmg = jgo._primal_gmg(2, 0, 4) if mode != "minres" else None
    opts = _opts(JS, "auto" if mode == "direct" else False)
    dx, k = JS._schur_dir_chunked(
        form, opts, gmg, jnp.asarray(x), pbj.rhs, fj,
        gmg.fused_pdata() if gmg is not None else ())
    return np.asarray(dx), int(k)


def test_lumped_schur_arrays_match_jax():
    pbj, pbp, x, fj, _, _, state = _problem()
    form = pbj.form

    @jax.jit
    def run(tables, ess, x, fields):
        s = form.grad_state_raw(tables, x, fields)
        return JS._schur_arrays(form, tables, ess, s, 1e-6, True, True)

    ref = run(form._tables(), form.ess_mask, jnp.asarray(x), fj)
    out = PS._schur_arrays(pbp.form, state, 1e-6, True, lumped=True)
    assert set(out) == {"Dblk_inv", "dshift", "safe"}
    for k in out:
        assert rel(out[k].numpy(), ref[k]) <= TOL_OP, k


@pytest.mark.parametrize("mode", ["direct", "wb"])
def test_ldu_direction_matches_jax_and_dense(mode):
    """One LDU-FGMRES direction at the fixed state: JAX's direction and
    count, and the dense direct solve of the same Jacobian."""
    _, pbp, _, _, _, r, state = _problem()
    fp = pgo._primal_gmg(2, 0, 4, device="cpu")
    profiling.reset()
    dx, k = PS.lumped_schur_solve(
        pbp.form, state, r, _opts(PS, "auto" if mode == "direct" else False),
        fp=fp, alpha=ALPHA)
    assert f"ldu/fgmres_{mode}" in profiling.cost_table()
    jdx, jk = _jax_direction(mode)
    assert k == jk == {"direct": 2, "wb": 7}[mode]
    assert rel(dx.numpy(), jdx) <= TOL_DIR
    dense = PS.dense_solve(pbp.form.assemble_dense(state), r)
    assert rel(dx.numpy(), dense.numpy()) <= TOL_DIR


def test_lumped_minres_without_gmg_matches_jax():
    """Without a GMG: block-diagonal MINRES with an inner CG on S~, equal
    to JAX's one-shot and chunked drivers (the chunked one's count)."""
    _, pbp, _, _, _, r, state = _problem()
    dx, k = PS.lumped_schur_solve(pbp.form, state, r, _opts(PS), fp=None,
                                  alpha=ALPHA)
    jdx, jk = _jax_direction("minres")
    assert k == jk
    assert rel(dx.numpy(), jdx) <= TOL_DIR
    assert rel(dx.numpy(), _jax_direction("traced")[0]) <= TOL_DIR


def _one_level_gmg(pbp):
    """A GMG whose only level is the primal diffusion form: its V-cycle is
    the exact (dense) inverse of the primal block A."""
    sp = pbp.primal_space
    f = NonlinearForm(FESpace(sp.mesh, sp.order), device="cpu")
    f.add_ad_integrator(DiffusionEnergy(2), ADEval.GRAD)
    f.set_essential_bc([np.ones(sp.mesh.max_bdr_attribute())])
    return PGSchurGMG(GMG([f]))


def test_sigma_K_matvec_builder_matches_gemm():
    _, pbp, _, _, _, _, state = _problem()
    n0 = pbp.primal_space.ndof
    nl = pbp.form.ndof - n0
    K_gemm = PS.sigma_K_gemm(pbp.form, state, ALPHA, n0, nl, {})
    K_mv = PS.sigma_K_matvec(pbp.form, _one_level_gmg(pbp), state, ALPHA,
                             n0, nl)
    assert K_gemm.dtype == torch.float32 and K_mv.dtype == F64
    # f32 A^-1 against the exact coarse inverse
    assert rel(K_gemm.double().numpy(), K_mv.numpy()) <= 1e-5


def test_sigma_refresh_policy():
    """K is built once (the coupling is linear: alpha C is invariant, which
    every refresh checks on one column); the factor refreshes when alpha
    moves more than 4x or the previous direction took more than 12 FGMRES
    iterations, and is the f32 inverse of alpha^2 D + (alpha C)^T A^-1
    (alpha C)."""
    _, pbp, x, _, fields, _, _ = _problem()
    form = pbp.form
    n0 = pbp.primal_space.ndof
    nl = form.ndof - n0
    fp = pgo._primal_gmg(2, 0, 4, device="cpu")
    profiling.reset()

    def update(alpha):
        state = form.grad_state(_t(x), dict(fields, alpha=alpha))
        return PS._sigma_direct_update(form, fp, state, alpha, n0, nl), state

    def counts():
        t = profiling.cost_table()
        return tuple(t[k].count if k in t else 0
                     for k in ("ldu/sigma_K", "ldu/sigma_refresh"))

    c, _ = update(1.0)
    assert c["mode"] == "gemm" and counts() == (1, 1)
    first = c["Sinv"]
    c, _ = update(4.0)
    assert c["Sinv"] is first and counts() == (1, 1)  # 4x: not more
    c, _ = update(8.0)
    assert c["Sinv"] is not first and c["alpha"] == 8.0
    assert counts() == (1, 2)
    c["outer_prev"] = 13
    c, state = update(8.0)
    assert counts() == (1, 3) and not c["k_dynamic"]
    A = form.assemble_dense(state)
    Aa, C, D = A[:n0, :n0], A[:n0, n0:], -A[n0:, n0:]
    Sigma = 64.0 * (D + C.T @ torch.linalg.solve(Aa, C))
    err = torch.linalg.matrix_norm(c["Sinv"].double() @ Sigma
                                   - torch.eye(nl, dtype=F64))
    assert float(err) <= 1e-3
