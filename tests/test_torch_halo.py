"""Port parity, the halo layout: ``mfem_ad_tpu_torch.parallel``'s
``HaloShardedForm`` on gloo ranks on the CPU, the two-process
``ShardedForm`` run, ``examples/par_template`` and ``parallel/dryrun``,
held against the JAX package's serial forms; the distributed layout is
held byte for byte to JAX's ``HaloShardedForm.to_dist``/``from_dist``
(host numpy, built on 4 or 2 of the test session's CPU devices; no
``shard_map`` program is compiled here).

One spawn of 4 ranks (``tests/torch_parallel_ranks.halo_ranks``, one
torch thread each, a 120 s timeout) runs every scenario while the JAX
references are computed.  A counterpart of each ``test_halo.py`` and
``test_multiprocess.py`` scenario, at K = 4 (the layout, the assemblies
and the bytes they exchange, Newton-CG, the Schur direction) or on 2-rank
subgroups (the iterative solves, whose collectives' latency two ranks
keep lower): the Schur Newton solve, the PG loop (2 PG iterations of the
JAX test's 20, held to JAX's serial ``PGSolver`` with the same options and
to the port's serial run), the two-process ShardedForm case,
``par_template`` and the dry run.  A last spawn checks that a failing rank
fails the launcher.
"""

import functools
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import torch_parallel_ranks as R
from mfem_ad_tpu import models as jmodels
from mfem_ad_tpu import solvers as JS
from mfem_ad_tpu.parallel import HaloShardedForm as JHalo
from mfem_ad_tpu_torch.convert import (
    dist_blocks_from_numpy,
    numpy_from_dist_blocks,
)
from mfem_ad_tpu_torch.parallel import spawn
from torch_parallel_jax import check_pg, jbuild, jnewton, jpg_run, jproducts

K = 4
TIMEOUT = 120.0


@functools.lru_cache(maxsize=None)
def jhalo(name, k=K):
    """JAX's halo layout of a problem over k devices (host conversions)."""
    return JHalo(jbuild(name).form, devices=jax.devices()[:k])


def jax_references():
    out = {}
    out["assembly/poisson8"] = jproducts("poisson8", 1, 1.0)
    for name in ("obstacle2_8", "gobstacle4r1"):
        out[f"assembly/{name}"] = jproducts(name, 2, 0.1, 2.0)
    out["mp/assembly"] = jproducts("obstacle1_8", 0, 0.1, 1.0)

    pb = jbuild("obstacle1_8")
    form = pb.form
    x, _, _ = R.case_inputs(pb, 0, 0.1)
    lk = jnp.zeros(pb.latent_space.ndof)
    fields = {"alpha": jnp.asarray(1.0), "latent_k0": lk}
    r = jnp.where(form.ess_mask, 0.0,
                  form.mult(jnp.asarray(x), fields) - pb.rhs)
    st = form.grad_state(jnp.asarray(x), fields)
    out["schur"] = np.asarray(jax.jit(
        lambda t, e, s, rr: JS._schur_solve_traced(form, t, e, s, rr, 1e-12,
                                                   400)
    )(form._tables(), form.ess_mask, st, r))
    out["schur_newton"] = np.asarray(JS.newton(
        form, jnp.zeros(form.ndof), b=pb.rhs,
        fields={"alpha": jnp.asarray(0.5), "latent_k0": lk},
        opts=JS.NewtonOptions(**R.PG_OPTS["schur"])).x)
    out["newton"] = jnewton("poisson8r1")
    out["pg"] = jpg_run("obstacle1_8", "schur")
    return out


@pytest.fixture(scope="module")
def runs():
    """(the ranks' results, rank 0 first; the JAX references)."""
    with ThreadPoolExecutor(1) as ex:
        fut = ex.submit(spawn, R.halo_ranks, K, device="cpu",
                        timeout=TIMEOUT, limit=TIMEOUT)
        refs = jax_references()
        return fut.result(), refs


def gathered(ranks, key, field=None, members=range(K)):
    """The global distributed vector of the ranks' slot blocks."""
    blocks = [ranks[k][key] if field is None else ranks[k][key][field]
              for k in members]
    return np.concatenate(blocks)


def check_products(ranks, name, ref, atol, e_atol):
    jh = jhalo(name)
    for k in ("r", "y", "d"):
        got = jh.from_dist(gathered(ranks, f"assembly/{name}", k))
        assert np.abs(got - ref[k]).max() <= atol, k
    e = [r[f"assembly/{name}"]["e"] for r in ranks]
    assert e.count(e[0]) == K  # one all-reduce: the same on every rank
    assert abs(e[0] - ref["e"]) <= e_atol


def test_halo_layout_roundtrip(runs):
    """The ranks' slot blocks are JAX's distributed vector byte for byte;
    the round trip is exact and the distributed dot the canonical one."""
    ranks, _ = runs
    pb = jbuild("poisson8")
    u, v, _ = R.case_inputs(pb, 0, 1.0)
    jh = jhalo("poisson8")
    ud = jh.to_dist(u)
    got = numpy_from_dist_blocks([r["layout"][0] for r in ranks])
    assert got.tobytes() == ud.tobytes()
    for r, b in zip(ranks, dist_blocks_from_numpy(ud, K, "cpu",
                                                  torch.float64)):
        assert np.array_equal(r["layout"][0], b.numpy())
    for r in ranks:
        assert np.array_equal(r["layout"][1], u)
        assert np.isclose(r["layout"][2], np.dot(u, v))


def test_halo_assembly_matches_serial(runs):
    ranks, refs = runs
    check_products(ranks, "poisson8", refs["assembly/poisson8"], 1e-13,
                   1e-10)
    # O(surface): two interface planes per rank boundary
    nbytes, nbytes_r1 = ranks[0]["halo_bytes"]
    NX = jbuild("poisson8").form.spaces[0].grid[2][1]
    assert nbytes == 2 * (K - 1) * NX * 8 == jhalo(
        "poisson8").halo_bytes_per_matvec()
    assert nbytes_r1 < 2.1 * nbytes  # refining doubles the interface


def test_halo_mixed_block_system(runs):
    """H1 x L2 saddle form: the L2 latent exchanges nothing."""
    ranks, refs = runs
    check_products(ranks, "obstacle2_8", refs["assembly/obstacle2_8"],
                   1e-12, 1e-12)


def test_halo_matvec_has_no_dof_allreduce(runs):
    """A grad_mult moves exactly ``halo_bytes_per_matvec`` bytes, all in
    the neighbour exchange: no all-reduce at all."""
    ranks, _ = runs
    for name in ("poisson8", "obstacle2_8"):
        moved = [r[f"assembly/{name}"]["bytes"] for r in ranks]
        assert all(set(m) == {"exchange"} for m in moved), moved
        total = sum(m["exchange"] for m in moved)
        assert total == jhalo(name).halo_bytes_per_matvec()


def test_halo_newton_matches_sharded(runs):
    """Newton-CG on the halo form and on ShardedForm: both JAX's serial
    solve to 1e-9, and each other's."""
    ranks, refs = runs
    x_h, x_s, conv_h, conv_s, err = ranks[0]["newton"]
    assert conv_h and conv_s
    assert np.abs(x_h - refs["newton"]).max() < 1e-9
    assert np.abs(x_s - refs["newton"]).max() < 1e-9
    assert np.abs(x_h - x_s).max() < 1e-9
    assert err < 5e-5  # p2 MMS error on the 16 x 16 mesh


def test_halo_triangle_mesh(runs):
    """Structured triangles (h1t) band the same way."""
    ranks, refs = runs
    check_products(ranks, "gobstacle4r1", refs["assembly/gobstacle4r1"],
                   1e-12, 1e-12)


def test_halo_schur_direction_matches_serial(runs):
    """The Schur direction on the halo form: JAX's serial direction to
    1e-10, and between the ranks only interface exchanges and scalar
    all-reduces, never a dof-length one."""
    ranks, refs = runs
    dx = jhalo("obstacle1_8").from_dist(
        np.concatenate([r["schur"][0] for r in ranks]))
    ref = refs["schur"]
    assert np.abs(dx - ref).max() / max(1.0, np.abs(ref).max()) < 1e-10
    for _, moved, calls in (r["schur"] for r in ranks):
        assert moved["exchange"] > 0
        for kind in ("sum", "max"):
            assert moved.get(kind, 0) == 8 * calls.get(kind, 0), kind


def test_halo_schur_full_lvpp_solve(runs):
    """Newton with the Schur direction at alpha 0.5 on the halo form over
    2 ranks, against JAX's serial solve."""
    ranks, refs = runs
    x, converged, _ = ranks[2]["schur_newton"]
    assert converged and ranks[3]["schur_newton"][1]
    x = jhalo("obstacle1_8", 2).from_dist(
        np.concatenate([ranks[k]["schur_newton"][0] for k in (2, 3)]))
    assert np.abs(x - refs["schur_newton"]).max() < 1e-8


def test_halo_full_pg_solver_matches_serial(runs):
    """PGSolver on the halo form over 2 ranks (the latent through
    ``canonical``) against JAX's serial PGSolver with the same options and
    against the port's serial run: the same counts, x to 1e-8, the lambda
    diff to 1e-6 relative."""
    ranks, refs = runs
    x = jhalo("obstacle1_8", 2).from_dist(
        np.concatenate([ranks[k]["pg"][0] for k in (0, 1)]))
    got = (x,) + tuple(ranks[0]["pg"][1:])
    check_pg(got, refs["pg"], 1e-8, 1e-6)
    check_pg(got, ranks[0]["serial/pg"], 1e-8, 1e-6)


def test_two_process_sharded_assembly(runs):
    """test_multiprocess.py's case on 2 ranks: ShardedForm's products are
    the same on both and JAX's serial ones; the PG loop's iterate is the
    same on both, and its run matches JAX's serial PGSolver and the port's
    serial run."""
    ranks, refs = runs
    a, b = ranks[2]["mp/assembly"], ranks[3]["mp/assembly"]
    for k in ("r", "y", "d"):
        assert np.array_equal(a[k], b[k])
        assert np.abs(a[k] - refs["mp/assembly"][k]).max() < 1e-12
    got = ranks[2]["mp/pg"]
    assert np.array_equal(got[0], ranks[3]["mp/pg"][0])
    check_pg(got, refs["pg"], 1e-8, 1e-6)
    check_pg(got, ranks[0]["serial/pg"], 1e-8, 1e-6)


def test_par_template_and_dryrun(runs):
    """par_template's solve on 2 ranks (the JAX sharded Newton test's
    bound) and the dry run's Schur Newton step on 2 ranks: finite, of the
    slot-block shape, the same iterate norm on both."""
    ranks, _ = runs
    for k in (0, 1):
        converged, err, _ = ranks[k]["par_template"]
        assert converged and err < 2e-5
    (s2, its2, n2), (s3, its3, n3) = ranks[2]["dryrun"], ranks[3]["dryrun"]
    jslots = JHalo(jmodels.obstacle.build(order=1, ref_levels=0, n0=4).form,
                   devices=jax.devices()[:2]).slots
    assert s2 == s3 == jslots and its2 == its3 and n2 == n3
    assert np.isfinite(n2)


def test_spawn_fails_when_a_rank_raises():
    """A rank that raises fails the launcher (its traceback in the error)
    and every rank is stopped."""
    with pytest.raises(RuntimeError, match="rank 1 fails on purpose"):
        spawn(R.failing_rank, 2, device="cpu", timeout=TIMEOUT,
              limit=TIMEOUT)
