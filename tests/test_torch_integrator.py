"""Port parity, AD core and integrator: energies and their derivatives, the
integrator's tables, and residual / Hessian state / matrix-free Jacobian /
diagonal / element matrices of mfem_ad_tpu_torch against mfem_ad_tpu, in
f64 on small structured meshes.  Both packages compute from the very same
tables (``convert.tables_from_numpy``) and the same seeded inputs.

Tolerance: rtol 1e-12 with an absolute floor of 1e-12 * max|reference|
(the two packages sum in different orders; entries near zero through
cancellation need the floor)."""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import mfem_ad_tpu.ad as jad
from mfem_ad_tpu import mesh as JM
from mfem_ad_tpu.adeval import ADEval as JADEval
from mfem_ad_tpu.fespace import FESpace as JFESpace
from mfem_ad_tpu.integrator import ADBlockIntegrator as JIntegrator
from mfem_ad_tpu_torch import ad as pad
from mfem_ad_tpu_torch import mesh as PM
from mfem_ad_tpu_torch.adeval import ADEval as PADEval
from mfem_ad_tpu_torch.convert import tables_from_numpy, vector_from_numpy
from mfem_ad_tpu_torch.fespace import FESpace as PFESpace
from mfem_ad_tpu_torch.integrator import ADBlockIntegrator as PIntegrator

F64 = torch.float64
ENERGIES = {"neohookean": ("NeoHookeanEnergy", 1.3, 0.7),
            "elasticity": ("LinearElasticityEnergy", 1.3, 0.7)}
CONFIGS = [(2, 1), (2, 2), (3, 1)]
CASES = [(e, d, p) for e in ENERGIES for d, p in CONFIGS]


def _close(actual, ref):
    actual = np.asarray(actual)
    ref = np.asarray(ref)
    np.testing.assert_allclose(
        actual, ref, rtol=1e-12, atol=1e-12 * max(np.abs(ref).max(), 1e-300)
    )


def _jax_reference(ji, u, v):
    """Every JAX quantity the tests compare against, in one jitted call."""

    def run(u, v):
        Hf = ji.hess_state([u])
        Hs = ji.hess_state([u], sym=True)
        return {
            "residual": ji.residual([u])[0],
            "energy": ji.energy([u]),
            "hess": Hf,
            "planes": Hs.planes,
            "sym_full": Hs.full(),
            "mult": ji.hess_mult(Hf, [v])[0],
            "mult_sym": ji.hess_mult(Hs, [v])[0],
            "diag": ji.diagonal(Hf)[0],
            "diag_sym": ji.diagonal(Hs)[0],
            "elmat": ji.element_matrices(Hf, 0, 0),
        }

    out = jax.jit(run)(jnp.asarray(u), jnp.asarray(v))
    return {k: np.asarray(a) for k, a in out.items()}


@functools.lru_cache(maxsize=None)
def _problem(energy, dim, order):
    """JAX integrator and its reference outputs, port integrators (own
    tables and JAX tables), and seeded state/direction vectors, shared by
    the tests of this module."""
    cls, lam, mu = ENERGIES[energy]
    n = 4 if dim == 2 else 2
    jm = JM.make_cartesian_2d(n, n) if dim == 2 else JM.make_cartesian_3d(
        n, n, n)
    pm = PM.make_cartesian_2d(n, n) if dim == 2 else PM.make_cartesian_3d(
        n, n, n)
    jf, pf = JFESpace(jm, order, vdim=dim), PFESpace(pm, order, vdim=dim)
    ji = JIntegrator(getattr(jad, cls)(dim, lam, mu), [jf],
                     [JADEval.GRAD | JADEval.VECTOR])
    mode = PADEval.GRAD | PADEval.VECTOR
    own = PIntegrator(getattr(pad, cls)(dim, lam, mu), [pf], [mode],
                      device="cpu")
    jt = jax.tree_util.tree_map(np.asarray, ji.tables)
    shared = PIntegrator(getattr(pad, cls)(dim, lam, mu), [pf], [mode],
                         device="cpu",
                         tables=tables_from_numpy(jt, "cpu", F64))
    rng = np.random.default_rng(7)
    u = (0.1 / (n * order)) * rng.standard_normal(jf.ndof)
    v = rng.standard_normal(jf.ndof)
    return jt, _jax_reference(ji, u, v), own, shared, _vec(u), _vec(v)


def _vec(a):
    return vector_from_numpy(a, "cpu", F64)


@pytest.mark.parametrize("energy,dim,order", CASES)
def test_tables_equal_and_same_factors_installed(energy, dim, order):
    jt, _, own, _, _, _ = _problem(energy, dim, order)
    pt = own.tables
    for key in ("B", "edof", "R", "D0"):
        assert len(jt[key]) == len(pt[key])
        for a, b in zip(jt[key], pt[key]):
            assert np.array_equal(a, b.numpy()), key
    assert ("R0" in jt) == ("R0" in pt)
    for key in ("W", "W0", "static"):
        assert sorted(jt[key]) == sorted(pt[key]), key
        for k in jt[key]:
            assert np.array_equal(jt[key][k], pt[key][k].numpy()), (key, k)
    assert np.array_equal(jt["w"], pt["w"].numpy())


@pytest.mark.parametrize("energy,dim,order", CASES)
def test_residual_and_energy_match_jax(energy, dim, order):
    _, ref, own, shared, u, _ = _problem(energy, dim, order)
    _close(shared.residual([u])[0], ref["residual"])
    _close(own.residual([u])[0], ref["residual"])
    _close(float(shared.energy([u])), ref["energy"])


@pytest.mark.parametrize("energy,dim,order", CASES)
def test_hess_state_full_and_symhess_match_jax(energy, dim, order):
    _, ref, _, shared, u, _ = _problem(energy, dim, order)
    _close(shared.hess_state([u]), ref["hess"])
    Sp = shared.hess_state([u], sym=True)
    assert Sp.planes.shape == ref["planes"].shape  # plane-major [K, ne, nq]
    _close(Sp.planes, ref["planes"])
    _close(Sp.full(), ref["sym_full"])


@pytest.mark.parametrize("energy,dim,order", CASES)
def test_hess_mult_and_diagonal_match_jax(energy, dim, order):
    _, ref, _, shared, u, v = _problem(energy, dim, order)
    for sym, tag in ((False, ""), (True, "_sym")):
        Hp = shared.hess_state([u], sym=sym)
        _close(shared.hess_mult(Hp, [v])[0], ref["mult" + tag])
        _close(shared.diagonal(Hp)[0], ref["diag" + tag])


@pytest.mark.parametrize("energy,dim,order", CASES)
def test_element_matrices_match_jax_two_stage(energy, dim, order):
    _, ref, _, shared, u, _ = _problem(energy, dim, order)
    _close(shared.element_jacobians([u], route="two_stage"), ref["elmat"])
    _close(shared.element_matrices(shared.hess_state([u], sym=True), 0, 0),
           ref["elmat"])


@pytest.mark.parametrize("energy,dim,order", [("neohookean", 2, 1),
                                              ("neohookean", 3, 1)])
def test_closed_forms_match_ad_in_the_integrator(energy, dim, order):
    _, _, _, shared, u, _ = _problem(energy, dim, order)
    closed = PIntegrator(shared.f, shared.spaces, shared.modes,
                         device="cpu", tables=shared.tables, closed=True)
    _close(closed.hess_state([u]), shared.hess_state([u]))
    _close(closed.residual([u])[0], shared.residual([u])[0])


# ---------------------------------------------------------------------------
# AD core: energies, gradients, Hessians, closed forms
# ---------------------------------------------------------------------------


def _energy_pairs():
    return [
        ("mass", jad.MassEnergy(3), pad.MassEnergy(3), {}),
        ("diffusion", jad.DiffusionEnergy(2), pad.DiffusionEnergy(2), {}),
        ("diffusion_k1", jad.DiffusionEnergy(2, 2.0),
         pad.DiffusionEnergy(2, 2.0), {"K": [2.0]}),
        ("diffusion_kd", jad.DiffusionEnergy(2, [2.0, 3.0]),
         pad.DiffusionEnergy(2, [2.0, 3.0]), {"K": [2.0, 3.0]}),
        ("diffusion_kdd", jad.DiffusionEnergy(2, [2.0, 0.5, 0.3, 3.0]),
         pad.DiffusionEnergy(2, [2.0, 0.5, 0.3, 3.0]),
         {"K": [2.0, 0.5, 0.3, 3.0]}),
        ("elasticity2", jad.LinearElasticityEnergy(2, 1.3, 0.7),
         pad.LinearElasticityEnergy(2, 1.3, 0.7),
         {"lambda": [1.3], "mu": [0.7]}),
        ("elasticity3", jad.LinearElasticityEnergy(3, 1.3, 0.7),
         pad.LinearElasticityEnergy(3, 1.3, 0.7),
         {"lambda": [1.3], "mu": [0.7]}),
        ("neohookean2", jad.NeoHookeanEnergy(2, 1.3, 0.7),
         pad.NeoHookeanEnergy(2, 1.3, 0.7), {"lambda": [1.3], "mu": [0.7]}),
        ("neohookean3", jad.NeoHookeanEnergy(3, 1.3, 0.7),
         pad.NeoHookeanEnergy(3, 1.3, 0.7), {"lambda": [1.3], "mu": [0.7]}),
    ]


@pytest.mark.parametrize("name", [p[0] for p in _energy_pairs()])
def test_energy_value_gradient_hessian_match_jax(name):
    _, fj, fp, params = next(p for p in _energy_pairs() if p[0] == name)
    rng = np.random.default_rng(3)
    x = 0.2 * rng.standard_normal(fj.n_input)
    pj = {k: jnp.asarray(v) for k, v in params.items()}
    pp = {k: torch.tensor(v, dtype=F64) for k, v in params.items()}
    xt = torch.tensor(x)
    _close(float(fp(xt, pp)), float(fj(jnp.asarray(x), pj)))
    _close(fp.gradient(xt, pp), fj.gradient(jnp.asarray(x), pj))
    Hp = fp.hessian(xt, pp)
    _close(Hp, fj.hessian(jnp.asarray(x), pj))
    if callable(fp.gradient_closed):
        _close(fp.gradient_closed(xt, pp), fp.gradient(xt, pp))
    if callable(fp.hessian_closed):
        _close(fp.hessian_closed(xt, pp), Hp)
    if callable(fp.hessian_closed_entries):
        rows = fp.hessian_closed_entries(xt, pp)
        _close(torch.stack([torch.stack([torch.as_tensor(h, dtype=F64)
                                         for h in r]) for r in rows]), Hp)


def test_admax_admin_tie_averaging():
    a = torch.tensor([1.0, 2.0, 3.0], requires_grad=True)
    b = torch.tensor([2.0, 2.0, 1.0], requires_grad=True)
    pad.admax(a, b).sum().backward()
    assert a.grad.tolist() == [0.0, 0.5, 1.0]
    assert b.grad.tolist() == [1.0, 0.5, 0.0]
    aj, bj = jnp.asarray([1.0, 2.0, 3.0]), jnp.asarray([2.0, 2.0, 1.0])
    for fj, fp in ((jad.admax, pad.admax), (jad.admin, pad.admin)):
        gj = jax.grad(lambda x: fj(x, bj).sum())(aj)
        gp = torch.func.grad(lambda x: fp(x, b.detach()).sum())(a.detach())
        assert np.array_equal(np.asarray(gj), gp.numpy())
