"""Rank bodies of tests/test_torch_parallel.py and tests/test_torch_halo.py.

Spawned rank processes import this module, so it imports torch and the
port, never jax.  Each body runs every scenario of its test file on one
rank (a group of 4 ranks, and two subgroups of 2) and returns numpy
results; the test files hold them against the JAX package's serial forms.
The problems and their seeded inputs are defined here once, for both
sides: ``PROBLEMS`` names each by (model, build arguments), ``inputs``
draws its vectors.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from mfem_ad_tpu_torch.models import gradient_obstacle, obstacle, poisson
from mfem_ad_tpu_torch.norms import l2_error
from mfem_ad_tpu_torch.parallel import (
    HaloShardedForm,
    ShardedForm,
    auto_sharded,
)
from mfem_ad_tpu_torch.parallel.dryrun import newton_step
from mfem_ad_tpu_torch.pg import PGSolver, PGStepSizeRule
from mfem_ad_tpu_torch.solvers import (
    NewtonOptions,
    lumped_schur_solve,
    newton,
    schur_solve,
)
from mfem_ad_tpu_torch.utils._host import to_numpy

MODELS = {"poisson": poisson, "obstacle": obstacle,
          "gradient_obstacle": gradient_obstacle}

# name -> (model[:function], build arguments): the JAX tests' own problems,
# the dof-level PG obstacle and the obstacle on 162 Kuhn tets (no dof
# grid).  The non-divisible element count is 7 x 7 = 49 (the JAX test's
# 6 x 6 = 36 over 8 devices divides among 2 and 4 ranks)
PROBLEMS = {
    "dofpg7": ("obstacle:build_dofpg", dict(order=1, ref_levels=0, n0=7)),
    "tet3": ("obstacle", dict(order=1, ref_levels=0, n0=3, dim=3,
                              geom="tet")),
    "poisson10": ("poisson", dict(order=2, ref_levels=0)),
    "poisson7": ("poisson", dict(order=2, ref_levels=0, n0=7)),
    "poisson8": ("poisson", dict(order=2, ref_levels=0, n0=8)),
    "poisson8r1": ("poisson", dict(order=2, ref_levels=1, n0=8)),
    "poisson_r1": ("poisson", dict(order=2, ref_levels=1)),
    "obstacle1": ("obstacle", dict(order=1, ref_levels=0)),
    "obstacle1_8": ("obstacle", dict(order=1, ref_levels=0, n0=8)),
    "obstacle1_16": ("obstacle", dict(order=1, ref_levels=0, n0=16)),
    "obstacle2_7": ("obstacle", dict(order=2, ref_levels=0, n0=7)),
    "obstacle2_8": ("obstacle", dict(order=2, ref_levels=0, n0=8)),
    "gobstacle4": ("gradient_obstacle", dict(order=2, ref_levels=0, n0=4)),
    "gobstacle4r1": ("gradient_obstacle", dict(order=2, ref_levels=1, n0=4)),
}

# PG runs: the JAX tests' EXP rule, capped at PG_ITERS outer iterations
# (to convergence they take 15-20, half a minute each on one CPU core)
PG_RULE = (PGStepSizeRule.EXP, 0.1, 1e4, 2.0, 1.0)
PG_ITERS = 2
# the lumped direction's MINRES tolerance: the JAX test's 1e-12 takes 4,355
# matvecs (about 15 s on 4 CPU ranks), 1e-3 1,139
LUMPED_TOL = 1e-3
PG_OPTS = {
    "minres": dict(abs_tol=1e-9, max_iter=20, lin_solver="minres",
                   lin_tol=1e-13, lin_maxiter=5000, preconditioner="jacobi"),
    "schur": dict(abs_tol=1e-9, max_iter=20, lin_solver="schur",
                  lin_tol=1e-12, lin_maxiter=400),
}
POISSON_OPTS = dict(abs_tol=1e-10, max_iter=3, lin_solver="cg",
                    lin_tol=1e-14, preconditioner="jacobi")


def build_function(models: dict, name: str):
    """The build function of problem ``name`` in ``models`` (model name ->
    module), and its arguments."""
    model, kw = PROBLEMS[name]
    module, _, fn = model.partition(":")
    return getattr(models[module], fn or "build"), kw


def build(name: str):
    fn, kw = build_function(MODELS, name)
    return fn(**kw, device="cpu")


def inputs(ndof: int, nl: int, seed: int, scale: float, alpha=None):
    """(u, v, fields) from ``seed``: a state u (``scale`` N(0, 1)), a
    direction v (N(0, 1)) and, with ``alpha``, the PG fields (latent_k0
    0.1 N(0, 1) over ``nl`` latent dofs)."""
    rng = np.random.default_rng(seed)
    u = scale * rng.standard_normal(ndof)
    v = rng.standard_normal(ndof)
    fields = {}
    if alpha is not None:
        fields = {"alpha": alpha,
                  "latent_k0": 0.1 * rng.standard_normal(nl)}
    return u, v, fields


def _t(a):
    return torch.as_tensor(np.asarray(a), dtype=torch.float64)


def _tfields(fields):
    return {k: (_t(v) if k == "latent_k0" else v) for k, v in fields.items()}


def _latent_ndof(pb) -> int:
    return pb.latent_space.ndof if hasattr(pb, "latent_space") else 0


def case_inputs(pb, seed: int, scale: float, alpha=None):
    return inputs(pb.form.ndof, _latent_ndof(pb), seed, scale, alpha)


def products(f, pb, seed, scale, alpha=None):
    """mult, grad_mult, grad_diag and energy of a sharded or halo form (a
    halo form's vectors as the rank's slot blocks), and the bytes each
    kind of collective moved during the grad_mult."""
    u, v, fields = case_inputs(pb, seed, scale, alpha)
    tf = _tfields(fields)
    halo = isinstance(f, HaloShardedForm)
    uu = f.dist_array(u) if halo else _t(u)
    vv = f.dist_array(v) if halo else _t(v)
    st = f.grad_state(uu, tf)
    f.comm.reset()
    y = f.grad_mult(st, vv)
    moved = dict(f.comm.bytes)
    return {"r": to_numpy(f.mult(uu, tf)), "y": to_numpy(y),
            "d": to_numpy(f.grad_diag(st)), "e": float(f.energy(uu, tf)),
            "bytes": moved}


def direction_case(pb, seed: int):
    """(x, fields) of the JAX tests' Schur direction cases: x 0.05 N(0, 1),
    alpha 4, latent_k0 0.1 N(0, 1)."""
    x, _, fields = case_inputs(pb, seed, 0.05, 4.0)
    return x, fields


def sharded_direction(f, pb, seed: int, lumped: bool = False):
    x, fields = direction_case(pb, seed)
    xt, tf = _t(x), _tfields(fields)
    r = torch.where(f.ess_mask, 0.0, f.mult(xt, tf) - pb.rhs)
    state = f.grad_state(xt, tf)
    if lumped:
        dx, _ = lumped_schur_solve(f, state, r,
                                   NewtonOptions(lin_tol=LUMPED_TOL))
    else:
        dx, _ = schur_solve(f, state, r, 1e-13, 2000)
    return to_numpy(dx)


def pg_run(form, pb, solver: str, x0, rhs):
    """The capped PG run of the JAX tests' EXP rule; returns (x, PG
    iterations, Newton iterations, lambda diff)."""
    res = PGSolver(
        form, PGStepSizeRule(*PG_RULE), latent_block=1,
        latent_space=pb.latent_space,
        newton_opts=NewtonOptions(**PG_OPTS[solver]), max_iter=PG_ITERS,
        tol=1e-8,
    ).solve(x0, rhs)
    return (to_numpy(res.x), res.iterations, list(res.newton_iters),
            float(res.lambda_diff))


def _zeros(pb):
    return torch.zeros(pb.form.ndof, dtype=torch.float64)


# ---------------------------------------------------------------------------
# tests/test_torch_parallel.py
# ---------------------------------------------------------------------------


def parallel_ranks(comm):
    """ShardedForm's scenarios (test_parallel.py's).  On 4 ranks: the
    assemblies, Newton, the dense fallback and ``auto_sharded``.  Then, at
    once, on ranks 0-1 the non-divisible assembly, the Schur directions
    and the lumped one, followed by the port's serial PG references
    (test_torch_obstacle holds its PGSolver to JAX's), and on ranks 2-3
    the two PG runs: the iterative scenarios cost their collectives'
    latency, which two ranks keep lower."""
    out = {}
    # every rank joins the creation of both groups
    low, high = comm.subgroup([0, 1]), comm.subgroup([2, 3])
    for name, seed, scale, alpha in (
            ("poisson10", 0, 1.0, None), ("poisson7", 7, 1.0, None),
            ("obstacle2_8", 0, 0.1, 1.0), ("gobstacle4", 0, 0.1, 1.0),
            ("tet3", 9, 0.1, 1.0)):
        pb = build(name)
        out[f"assembly/{name}"] = products(ShardedForm(pb.form, comm), pb,
                                           seed, scale, alpha)
    pb = build("poisson_r1")
    res = newton(ShardedForm(pb.form, comm), _zeros(pb), b=pb.rhs,
                 opts=NewtonOptions(**POISSON_OPTS))
    out["newton"] = (to_numpy(res.x), res.converged,
                     l2_error(pb.space, to_numpy(res.x), poisson.exact_fn))
    pb = build("obstacle1")
    u, _, fields = case_inputs(pb, 1, 0.1, 1.0)
    fields["latent_k0"] = np.zeros(pb.latent_space.ndof)
    sf = ShardedForm(pb.form, comm)
    out["dense"] = to_numpy(sf.assemble_dense(
        sf.grad_state(_t(u), _tfields(fields))))
    out["auto"] = tuple(type(auto_sharded(build(n).form, comm)).__name__
                        for n in ("obstacle1_16", "obstacle1"))

    cases = {"minres": build("obstacle1"), "schur": build("obstacle1_8")}
    if high is not None:
        for solver, pb in cases.items():
            out[f"pg/{solver}"] = pg_run(ShardedForm(pb.form, high), pb,
                                         solver, _zeros(pb), pb.rhs)
        return out
    pb = build("poisson7")
    out["assembly/poisson7/2"] = products(ShardedForm(pb.form, low), pb, 7,
                                          1.0)
    pb = build("dofpg7")
    out["assembly/dofpg7/2"] = products(ShardedForm(pb.form, low), pb, 8,
                                        0.1, 1.0)
    for name, seed in (("obstacle2_7", 11), ("obstacle2_8", 3)):
        pb = build(name)
        out[f"schur/{name}"] = sharded_direction(ShardedForm(pb.form, low),
                                                 pb, seed)
    pb = build("gobstacle4")
    out["lumped/gobstacle4"] = sharded_direction(
        ShardedForm(pb.form, low), pb, 5, lumped=True)
    solver = ("minres", "schur")[comm.rank]
    pb = cases[solver]
    out[f"serial/pg/{solver}"] = pg_run(pb.form, pb, solver, _zeros(pb),
                                        pb.rhs)
    return out


# ---------------------------------------------------------------------------
# tests/test_torch_halo.py
# ---------------------------------------------------------------------------


def halo_ranks(comm):
    """HaloShardedForm's scenarios (test_halo.py's).  On 4 ranks: the
    layout, the assemblies and their bytes, Newton-CG against
    ShardedForm's, the Schur direction and the collectives it makes.
    Then, at once, on ranks 0-1 the PG run on the halo form, then
    ``par_template`` and the port's serial PG reference on rank 0; on
    ranks 2-3 the Schur Newton solve on the halo form, the two-process
    ShardedForm case (test_multiprocess.py's) and the dry run."""
    out = {}
    low, high = comm.subgroup([0, 1]), comm.subgroup([2, 3])
    pb = build("poisson8")
    hf = HaloShardedForm(pb.form, comm)
    u, v, _ = case_inputs(pb, 0, 1.0)
    out["layout"] = (to_numpy(hf.dist_array(u)), hf.from_dist(hf.to_dist(u)),
                     float(hf.dot(hf.dist_array(u), hf.dist_array(v))))
    out["assembly/poisson8"] = products(hf, pb, 1, 1.0)
    out["halo_bytes"] = (hf.halo_bytes_per_matvec(),
                         HaloShardedForm(build("poisson8r1").form,
                                         comm).halo_bytes_per_matvec())
    for name in ("obstacle2_8", "gobstacle4r1"):
        pb = build(name)
        out[f"assembly/{name}"] = products(HaloShardedForm(pb.form, comm),
                                           pb, 2, 0.1, 2.0)

    pb = build("poisson8r1")
    opts = NewtonOptions(**POISSON_OPTS)
    hf = HaloShardedForm(pb.form, comm)
    res_h = newton(hf, hf.dist_array(np.zeros(pb.form.ndof)),
                   b=hf.dist_array(pb.rhs.numpy()), opts=opts)
    res_s = newton(ShardedForm(pb.form, comm), _zeros(pb), b=pb.rhs,
                   opts=opts)
    x_h = to_numpy(hf.canonical(res_h.x))
    out["newton"] = (x_h, to_numpy(res_s.x), res_h.converged,
                     res_s.converged,
                     l2_error(pb.space, x_h, poisson.exact_fn))

    pb = build("obstacle1_8")
    zero_latent = torch.zeros(pb.latent_space.ndof, dtype=torch.float64)
    hf = HaloShardedForm(pb.form, comm)
    x, _, _ = case_inputs(pb, 0, 0.1)
    fields = {"alpha": 1.0, "latent_k0": zero_latent}
    xd = hf.dist_array(x)
    r = torch.where(hf.ess_mask, 0.0,
                    hf.mult(xd, fields) - hf.dist_array(pb.rhs.numpy()))
    state = hf.grad_state(xd, fields)
    comm.reset()
    dx, _ = schur_solve(hf, state, r, 1e-12, 400)
    out["schur"] = (to_numpy(dx), dict(comm.bytes), dict(comm.calls))

    pair = low or high
    hf = HaloShardedForm(pb.form, pair)
    x0 = hf.dist_array(np.zeros(pb.form.ndof))
    rhs = hf.dist_array(pb.rhs.numpy())
    if low is not None:
        out["pg"] = pg_run(hf, pb, "schur", x0, rhs)
        from mfem_ad_tpu_torch.examples import par_template

        out["par_template"] = par_template.run(low, argparse.Namespace(
            order=2, ref=1, device="cpu", paraview=False))
        if comm.rank == 0:  # the port's serial PG reference
            out["serial/pg"] = pg_run(pb.form, pb, "schur", _zeros(pb),
                                      pb.rhs)
        return out
    res = newton(hf, x0, b=rhs, fields={"alpha": 0.5,
                                        "latent_k0": zero_latent},
                 opts=NewtonOptions(**PG_OPTS["schur"]))
    out["schur_newton"] = (to_numpy(res.x), res.converged, res.iterations)
    sf = ShardedForm(pb.form, high)
    out["mp/assembly"] = products(sf, pb, 0, 0.1, 1.0)
    out["mp/pg"] = pg_run(sf, pb, "schur", _zeros(pb), pb.rhs)
    out["dryrun"] = newton_step(high)
    return out


def failing_rank(comm):
    """Rank 1 raises: the launcher must fail."""
    if comm.rank == 1:
        raise RuntimeError("rank 1 fails on purpose")
    comm.barrier()
    return comm.rank
