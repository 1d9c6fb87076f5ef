"""Port parity, the multi-device layer: ``mfem_ad_tpu_torch.parallel``'s
``ShardedForm`` and ``auto_sharded`` on gloo ranks on the CPU, held
against the JAX package's serial forms (``tests/test_parallel.py`` shows
JAX's sharded forms equal to them).

One spawn of 4 ranks (``tests/torch_parallel_ranks.parallel_ranks``, one
torch thread each, a 120 s timeout) runs every scenario while the JAX
references are computed.  A counterpart of each ``test_parallel.py``
scenario, at K = 4 (assemblies, Newton-CG, the dense fallback,
``auto_sharded``) or on 2-rank subgroups (the rest):

- assembly at a divisible and a non-divisible element count (7 x 7 = 49:
  the JAX test's 6 x 6 over 8 devices divides among 2 and 4 ranks), and
  the gather-free paths on quads and triangles with a field;
- the Schur direction (non-divisible, and at 8 x 8) and the lumped one
  (at a MINRES tolerance of 1e-3: the JAX test's 1e-12 costs 4,355
  matvecs, 1e-3 1,139);
- Newton-CG, and the PG loop with MINRES and with the Schur direction,
  2 PG iterations of the JAX tests' 15-20, held to JAX's serial
  ``PGSolver`` with the same options (and to the port's serial runs);
- the dense fallback and ``auto_sharded``'s choice.

ShardedForm's replicated results are the same bits on every rank.
"""

from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest

import jax
import jax.numpy as jnp

import torch_parallel_ranks as R
from mfem_ad_tpu import solvers as JS
from mfem_ad_tpu.parallel import auto_sharded as jauto
from mfem_ad_tpu_torch.parallel import spawn
from torch_parallel_jax import (
    check_pg,
    jbuild,
    jfields,
    jnewton,
    jpg_run,
    jproducts,
)

K = 4
TIMEOUT = 120.0


def jdirection(name, seed, lumped=False):
    pb = jbuild(name)
    form = pb.form
    x, fields = R.direction_case(pb, seed)
    x, f = jnp.asarray(x), jfields(fields)
    r = jnp.where(form.ess_mask, 0.0, form.mult(x, f) - pb.rhs)
    state = form.grad_state(x, f)
    tol = R.LUMPED_TOL if lumped else 1e-13
    run = jax.jit(lambda t, e, s, rr: JS._schur_solve_traced(
        form, t, e, s, rr, tol, 2000, lumped=lumped))
    return np.asarray(run(form._tables(), form.ess_mask, state, r))


def jax_references():
    out = {}
    for name, seed, scale, alpha in (
            ("poisson10", 0, 1.0, None), ("poisson7", 7, 1.0, None),
            ("dofpg7", 8, 0.1, 1.0), ("obstacle2_8", 0, 0.1, 1.0),
            ("gobstacle4", 0, 0.1, 1.0), ("tet3", 9, 0.1, 1.0)):
        out[f"assembly/{name}"] = jproducts(name, seed, scale, alpha)
    for name, seed in (("obstacle2_7", 11), ("obstacle2_8", 3)):
        out[f"schur/{name}"] = jdirection(name, seed)
    out["lumped/gobstacle4"] = jdirection("gobstacle4", 5, lumped=True)
    out["newton"] = jnewton("poisson_r1")
    out["pg/minres"] = jpg_run("obstacle1", "minres")
    out["pg/schur"] = jpg_run("obstacle1_8", "schur")
    pb = jbuild("obstacle1")
    u, _, fields = R.case_inputs(pb, 1, 0.1, 1.0)
    fields["latent_k0"] = np.zeros(pb.latent_space.ndof)
    out["dense"] = np.asarray(pb.form.assemble_dense(
        pb.form.grad_state(jnp.asarray(u), jfields(fields))))
    devs = jax.devices()[:K]
    out["auto"] = tuple(type(jauto(jbuild(n).form, devices=devs)).__name__
                        for n in ("obstacle1_16", "obstacle1"))
    return out


@pytest.fixture(scope="module")
def runs():
    """(the ranks' results, rank 0 first; the JAX references)."""
    with ThreadPoolExecutor(1) as ex:
        fut = ex.submit(spawn, R.parallel_ranks, K, device="cpu",
                        timeout=TIMEOUT, limit=TIMEOUT)
        refs = jax_references()
        return fut.result(), refs


def rel(a, b) -> float:
    a, b = np.asarray(a), np.asarray(b)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1.0))


def same_on_every_rank(ranks, key):
    """ShardedForm's replicated results: the same bits on every rank."""
    holders = [r for r in ranks if key in r]
    first = holders[0][key]
    for r in holders[1:]:
        other = r[key]
        if isinstance(first, dict):
            for k in ("r", "y", "d"):
                assert np.array_equal(first[k], other[k]), (key, k)
            assert first["e"] == other["e"], key
        elif isinstance(first, tuple):
            assert np.array_equal(first[0], other[0]), key
            assert first[1:] == other[1:], key
        else:
            assert np.array_equal(first, other), key
    return first


def check_products(got, ref, atol, e_atol):
    for k in ("r", "y", "d"):
        assert np.abs(got[k] - ref[k]).max() <= atol, k
    assert abs(got["e"] - ref["e"]) <= e_atol


def test_sharded_assembly_matches_serial(runs):
    ranks, refs = runs
    got = same_on_every_rank(ranks, "assembly/poisson10")
    check_products(got, refs["assembly/poisson10"], 1e-12, 1e-10)
    # one ndof-length sum all-reduce per matvec, nothing else
    ndof = refs["assembly/poisson10"]["r"].size
    assert got["bytes"] == {"sum": 8 * ndof}


def test_sharded_assembly_nondivisible_elements(runs):
    """49 elements over 4 and over 2 ranks: copy-padded bands, also of a
    DofPG integrator's nodal tables (the dof-level PG obstacle); 162 tets
    over 4 ranks: the band's own edof gather and the transpose-gather
    scatter of the embedded band."""
    ranks, refs = runs
    for key, ref in (("assembly/poisson7", "assembly/poisson7"),
                     ("assembly/poisson7/2", "assembly/poisson7"),
                     ("assembly/dofpg7/2", "assembly/dofpg7"),
                     ("assembly/tet3", "assembly/tet3")):
        got = same_on_every_rank(ranks, key)
        check_products(got, refs[ref], 1e-12, 1e-10)


@pytest.mark.parametrize("name", ["obstacle2_7", "obstacle2_8"])
def test_sharded_schur_direction_matches_serial(runs, name):
    """The Schur direction (tol 1e-13): non-divisible (7 x 7) and 8 x 8."""
    ranks, refs = runs
    got = same_on_every_rank(ranks, f"schur/{name}")
    assert rel(got, refs[f"schur/{name}"]) < 1e-10


def test_sharded_schur_lumped_direction_matches_serial(runs):
    """The lumped (H1^2 latent, ex5) direction: node-block sums across the
    ranks."""
    ranks, refs = runs
    got = same_on_every_rank(ranks, "lumped/gobstacle4")
    assert rel(got, refs["lumped/gobstacle4"]) < 1e-8


def test_sharded_newton_solve(runs):
    ranks, refs = runs
    x, converged, err = same_on_every_rank(ranks, "newton")
    assert converged and err < 2e-5
    assert np.abs(x - refs["newton"]).max() < 1e-9


@pytest.mark.parametrize("key", ["pg/minres", "pg/schur"])
def test_sharded_pg_obstacle(runs, key):
    """PG with Jacobi-MINRES (order 1, 10 x 10) and with the Schur
    direction (8 x 8) on 2 ranks: counts equal to JAX's serial PGSolver's
    with the same options, iterates to 1e-8, the lambda diff to 1e-6
    relative; the same against the port's serial run."""
    ranks, refs = runs
    got = same_on_every_rank(ranks, key)
    check_pg(got, refs[key], 1e-8, 1e-6)
    check_pg(got, same_on_every_rank(ranks, f"serial/{key}"), 1e-8, 1e-6)


def test_sharded_assemble_dense_structured(runs):
    ranks, refs = runs
    got = same_on_every_rank(ranks, "dense")
    assert np.abs(got - refs["dense"]).max() < 1e-12


@pytest.mark.parametrize("name", ["obstacle2_8", "gobstacle4"])
def test_sharded_fast_path_matches_serial(runs, name):
    """Gather-free bands with a field (latent_k0): quads and structured
    triangles."""
    ranks, refs = runs
    got = same_on_every_rank(ranks, f"assembly/{name}")
    check_products(got, refs[f"assembly/{name}"], 1e-12, 1e-12)


def test_auto_sharded_selects_by_constraints(runs):
    """16 outer cells divide among 4 ranks (halo), 10 do not."""
    ranks, refs = runs
    assert ranks[0]["auto"] == refs["auto"] == ("HaloShardedForm",
                                                "ShardedForm")
