"""The JAX side of tests/test_torch_parallel.py and tests/test_torch_halo.py:
the JAX package's serial problems, products and solves on the inputs that
``torch_parallel_ranks`` defines, computed in the test process while the
port's ranks run."""

from __future__ import annotations

import functools

import numpy as np

import jax.numpy as jnp

import torch_parallel_ranks as R
from mfem_ad_tpu import models as jmodels
from mfem_ad_tpu import solvers as JS
from mfem_ad_tpu.pg import PGSolver, PGStepSizeRule


@functools.lru_cache(maxsize=None)
def jbuild(name):
    """The JAX problem, built once: its forms' jitted methods are cached
    per form."""
    fn, kw = R.build_function(vars(jmodels), name)
    return fn(**kw)


def jfields(fields):
    return {k: jnp.asarray(v) for k, v in fields.items()}


def jproducts(name, seed, scale, alpha=None):
    """mult, grad_mult, grad_diag and energy of the serial form on the
    seeded inputs of ``R.case_inputs``."""
    pb = jbuild(name)
    form = pb.form
    u, v, fields = R.case_inputs(pb, seed, scale, alpha)
    f = jfields(fields)
    st = form.grad_state(jnp.asarray(u), f)
    return {"r": np.asarray(form.mult(jnp.asarray(u), f)),
            "y": np.asarray(form.grad_mult(st, jnp.asarray(v))),
            "d": np.asarray(form.grad_diag(st)),
            "e": float(form.energy(jnp.asarray(u), f))}


def jpg_run(name, solver):
    """``R.pg_run``'s capped PG solve on JAX's serial form: (x, PG
    iterations, Newton iterations, lambda diff)."""
    pb = jbuild(name)
    res = PGSolver(
        pb.form, PGStepSizeRule(*R.PG_RULE), latent_block=1,
        latent_space=pb.latent_space,
        newton_opts=JS.NewtonOptions(**R.PG_OPTS[solver]),
        max_iter=R.PG_ITERS, tol=1e-8,
    ).solve(jnp.zeros(pb.form.ndof), pb.rhs)
    return (np.asarray(res.x), res.iterations, list(res.newton_iters),
            float(res.lambda_diff))


def jnewton(name):
    """Newton-CG on JAX's serial Poisson form (``R.POISSON_OPTS``)."""
    pb = jbuild(name)
    return np.asarray(JS.newton(
        pb.form, jnp.zeros(pb.form.ndof), b=pb.rhs,
        opts=JS.NewtonOptions(**R.POISSON_OPTS)).x)


def check_pg(got, ref, x_tol, lam_rtol):
    """A port PG run (``R.pg_run``'s tuple, x canonical) against a
    reference's: the same PG and Newton counts, x within ``x_tol``, the
    lambda diff within ``lam_rtol`` relative."""
    x, its, newton_its, lam = got
    jx, jits, jnewton_its, jlam = ref
    assert (its, newton_its) == (jits, jnewton_its)
    assert np.abs(x - jx).max() < x_tol
    assert abs(lam - jlam) <= lam_rtol * abs(jlam)
