"""Port parity, generic AD element-Jacobian op (``ops/ad_jacobian.py``) and
its code generator (``ops/energy_codegen.py``), on a host without a GPU:

- the generated C++ energy and ``csrc/ad_jacobian.cuh``'s nested duals,
  built with g++ into a throwaway host library, against ``torch.func`` and
  ``jax.hessian`` of the same energy (1e-12 relative, f64);
- the plain PyTorch version of the kernel against the JAX package's Pallas
  ``_kernel`` in interpret mode, closed branch (Mass, Diffusion) and
  generic branch (test-only energies, neo-Hookean), at atol
  1e-10 * max(1, max|A|) in f64 as tests/test_ops.py holds that kernel;
- the router's rules, ``UnsupportedEnergy``, the newly ported AD-core
  classes against JAX, and the entry points' default device.
"""

import ctypes
import functools
import inspect
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch
from torch.func import grad, jacfwd

import jax
import jax.numpy as jnp

import mfem_ad_tpu.ad as jad
from mfem_ad_tpu import mesh as JM
from mfem_ad_tpu.adeval import ADEval as JADEval
from mfem_ad_tpu.fespace import FESpace as JFESpace
from mfem_ad_tpu.integrator import ADBlockIntegrator as JIntegrator
from mfem_ad_tpu.ops.fused_jacobian import (
    element_jacobian_via_pallas,
    fused_element_jacobian as jax_fused_element_jacobian,
)
from mfem_ad_tpu_torch import ad as pad
from mfem_ad_tpu_torch import mesh as PM
from mfem_ad_tpu_torch.adeval import ADEval as PADEval
from mfem_ad_tpu_torch.convert import tables_from_numpy, vector_from_numpy
from mfem_ad_tpu_torch.fespace import FESpace as PFESpace
from mfem_ad_tpu_torch.forms import BlockNonlinearForm, NonlinearForm
from mfem_ad_tpu_torch.integrator import ADBlockIntegrator as PIntegrator
from mfem_ad_tpu_torch.models import elasticity as pex3
from mfem_ad_tpu_torch.models import poisson as pex1
from mfem_ad_tpu_torch.ops import ad_jacobian as adj
from mfem_ad_tpu_torch.ops import nvcc
from mfem_ad_tpu_torch import parallel as ppar
from mfem_ad_tpu_torch.parallel import dryrun as pdry
from mfem_ad_tpu_torch.ops.energy_codegen import (
    UnsupportedEnergy,
    trace_energy,
)

F64 = torch.float64
PKG = os.path.dirname(adj.__file__).rsplit(os.sep, 1)[0]


# ---------------------------------------------------------------------------
# Test-only energies, written once for each package
# ---------------------------------------------------------------------------


def _mixed(lib):
    """Every emitted operation: log exp sqrt sin cos tanh abs, a constant
    power, division, and admax/admin through where."""
    admax = pad.admax if lib is torch else jad.admax
    admin = pad.admin if lib is torch else jad.admin

    def energy(x, p):
        a, b = x[0], x[1]
        return (lib.log(1.0 + a * a) * lib.exp(0.3 * b)
                + lib.sqrt(2.0 + b * b) / (1.5 + lib.cos(a))
                + lib.sin(a * b) - lib.tanh(a - b) ** 3
                + 0.25 * lib.abs(a + 0.1) ** 1.5
                + admax(a, b) * admin(a * b, 0.2) - (-a) / 3.0)
    return energy


def _minimal_surface(eps):
    def energy(g, p):
        gg = g[0] * g[0] + g[1] * g[1]
        return (gg + 1.0) ** 0.5 + eps * gg
    return energy


def _param_energy(lib):
    """A two-parameter energy: p["k"] scales, p["c"] shifts."""
    def energy(g, p):
        s = g[0] - p["c"][0]
        return p["k"][0] * lib.exp(0.5 * s) + p["k"][1] * g[1] * g[1] * s
    return energy


def _port_energies():
    """name -> (port energy, JAX energy, param sizes, param values)."""
    al_p = pad.ALFunctional(pad.MassEnergy(2))
    al_p.add_eq_constraint(pad.ADFunction(2, lambda x, p: x[0] * x[1]), 0.5)
    al_p.set_multipliers([0.3])
    al_p.set_penalty(2.0)
    al_j = jad.ALFunctional(jad.MassEnergy(2))
    al_j.add_eq_constraint(jad.ADFunction(2, lambda x, p: x[0] * x[1]), 0.5)
    al_j.set_multipliers([0.3])
    al_j.set_penalty(2.0)
    lg_p = pad.Lagrangian(pad.MassEnergy(2), 1).add_eq_constraint(
        pad.ADFunction(2, lambda x, p: x[0] * x[0] - x[1]))
    lg_j = jad.Lagrangian(jad.MassEnergy(2), 1).add_eq_constraint(
        jad.ADFunction(2, lambda x, p: x[0] * x[0] - x[1]))
    K = [1.2, 0.3, 0.4, 0.9]
    return {
        "neohookean": (pad.NeoHookeanEnergy(2, 1.0, 1.0),
                       jad.NeoHookeanEnergy(2, 1.0, 1.0),
                       {"lambda": 1, "mu": 1}, {"lambda": [1.3], "mu": [0.7]}),
        "neohookean3d": (pad.NeoHookeanEnergy(3, 1.0, 1.0),
                         jad.NeoHookeanEnergy(3, 1.0, 1.0),
                         {"lambda": 1, "mu": 1},
                         {"lambda": [1.3], "mu": [0.7]}),
        "elasticity": (pad.LinearElasticityEnergy(2, 1.0, 1.0),
                       jad.LinearElasticityEnergy(2, 1.0, 1.0),
                       {"lambda": 1, "mu": 1}, {"lambda": [1.3], "mu": [0.7]}),
        "diffusion_K": (pad.DiffusionEnergy(2, K), jad.DiffusionEnergy(2, K),
                        {"K": 4}, {"K": K}),
        "mass": (pad.MassEnergy(3), jad.MassEnergy(3), {}, {}),
        "mixed": (pad.ADFunction(2, _mixed(torch)),
                  jad.ADFunction(2, _mixed(jnp)), {}, {}),
        "minimal_surface": (pad.ADFunction(2, _minimal_surface(0.05)),
                            jad.ADFunction(2, _minimal_surface(0.05)), {},
                            {}),
        "params": (pad.ADFunction(2, _param_energy(torch)),
                   jad.ADFunction(2, _param_energy(jnp)),
                   {"c": 1, "k": 2}, {"c": [0.2], "k": [1.1, 0.6]}),
        "diff": (pad.DiffEnergy(pad.MassEnergy(2), [0.4, -0.2]),
                 jad.DiffEnergy(jad.MassEnergy(2), [0.4, -0.2]),
                 {"target": 2}, {"target": [0.4, -0.2]}),
        "lagrangian": (lg_p, lg_j, {}, {}),
        "al": (al_p, al_j, {}, {}),
        "empty": (pad.EmptyEnergy(2), jad.EmptyEnergy(2), {}, {}),
    }


ENERGIES = _port_energies()


# ---------------------------------------------------------------------------
# Code generation: host build of the generated energies with g++
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def host_lib(tmp_path_factory):
    """One host library with every test energy: for energy ``name``,
    ``name_vgh(x, p, val, grad, hess)`` evaluates the value with the plain
    scalar type and the derivatives with ``ad::point_gradient`` and
    ``ad::point_hessian``, and ``name_entries(x, p, hess)`` the kernel's
    entries stage ``ad::HessianEntries<E>::eval``."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++")
    parts = ['#include "ad_jacobian.cuh"', ""]
    for name, (f, _, sizes, _) in ENERGIES.items():
        code = trace_energy(f, sizes, name=f"energy_{name}")
        parts += [
            code.source,
            f"struct E_{name} {{",
            f"  static constexpr int kInputs = {code.n_input};",
            f"  static constexpr int kParams = {code.n_params};",
            "  template <typename T> static T eval(const T* x, const T* p)",
            f"  {{ return energy_{name}<T>(x, p); }}",
            "};",
            f'extern "C" void {name}_vgh(const double* x, const double* p, '
            "double* val, double* g, double* h) {",
            f"  *val = E_{name}::eval<double>(x, p);",
            f"  ad::point_gradient<double, E_{name}>(x, p, g);",
            f"  ad::point_hessian<double, E_{name}>(x, p, h);",
            "}",
            f'extern "C" void {name}_entries(const double* x, '
            "const double* p, double* h) {",
            f"  ad::HessianEntries<E_{name}>::eval<double>(x, p, h);",
            "}",
            "",
        ]
    d = tmp_path_factory.mktemp("adhost")
    src, lib = d / "energies.cc", d / "libenergies.so"
    src.write_text("\n".join(parts))
    proc = subprocess.run(
        [gxx, "-O2", "-std=c++17", "-shared", "-fPIC", "-Wall", "-Werror",
         "-Wno-unused-local-typedefs", "-I", nvcc.CSRC, "-o", str(lib),
         str(src)],
        capture_output=True, text=True)
    assert proc.returncode == 0, proc.stderr
    return ctypes.CDLL(str(lib))


def _point(name, seed):
    f = ENERGIES[name][0]
    rng = np.random.default_rng(seed)
    return 0.3 * rng.standard_normal(f.n_input)


def _host_params(name):
    _, _, sizes, pvals = ENERGIES[name]
    return np.concatenate([np.asarray(pvals[k], float) for k in sorted(sizes)]
                          + [np.zeros(1)])


def _ptr(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_double))


def _host_eval(lib, name, x):
    n = ENERGIES[name][0].n_input
    p = _host_params(name)
    val = np.zeros(1)
    g, h = np.zeros(n), np.zeros(n * n)
    fn = getattr(lib, f"{name}_vgh")
    fn(_ptr(np.ascontiguousarray(x)), _ptr(p), _ptr(val), _ptr(g), _ptr(h))
    return val[0], g, h.reshape(n, n)


def _host_entries(lib, name, x):
    n = ENERGIES[name][0].n_input
    h = np.full(n * n, np.nan)
    getattr(lib, f"{name}_entries")(_ptr(np.ascontiguousarray(x)),
                                    _ptr(_host_params(name)), _ptr(h))
    return h.reshape(n, n)


@pytest.mark.parametrize("name", sorted(ENERGIES))
def test_generated_energy_matches_torch_func_and_jax(host_lib, name):
    f, fj, _, pvals = ENERGIES[name]
    pt = {k: torch.tensor(v, dtype=F64) for k, v in pvals.items()}
    pj = {k: jnp.asarray(v, dtype=jnp.float64) for k, v in pvals.items()}
    for seed in (0, 1, 2):
        x = _point(name, seed)
        val, g, h = _host_eval(host_lib, name, x)
        xt = torch.as_tensor(x, dtype=F64)
        ref_t = (float(f.energy(xt, pt)), grad(f.energy)(xt, pt).numpy(),
                 jacfwd(grad(f.energy))(xt, pt).numpy())
        xj = jnp.asarray(x)
        ej = lambda y: fj.energy(y, pj)  # noqa: E731
        ref_j = (float(ej(xj)), np.asarray(jax.grad(ej)(xj)),
                 np.asarray(jax.hessian(ej)(xj)))
        for ref in (ref_t, ref_j):
            for got, want in zip((val, g, h), ref):
                scale = max(1e-300, float(np.abs(want).max()))
                np.testing.assert_allclose(got, want, rtol=0,
                                           atol=1e-12 * scale)


@pytest.mark.parametrize("name", sorted(ENERGIES))
def test_hessian_entries_match_point_hessian_and_jax(host_lib, name):
    """``ad::HessianEntries<E>::eval``, the AD kernel's entries stage,
    writes every entry of ``point_hessian`` (the same bits) and matches
    ``jax.hessian`` (1e-12 relative, f64)."""
    _, fj, _, pvals = ENERGIES[name]
    pj = {k: jnp.asarray(v, dtype=jnp.float64) for k, v in pvals.items()}
    for seed in (0, 1, 2):
        x = _point(name, seed)
        h = _host_entries(host_lib, name, x)
        np.testing.assert_array_equal(h, _host_eval(host_lib, name, x)[2])
        want = np.asarray(jax.hessian(lambda y: fj.energy(y, pj))(
            jnp.asarray(x)))
        scale = max(1e-300, float(np.abs(want).max()))
        np.testing.assert_allclose(h, want, rtol=0, atol=1e-12 * scale)


def test_unsupported_energy_names_the_operation():
    dot = pad.ADFunction(2, lambda x, p: torch.dot(x, x))
    with pytest.raises(UnsupportedEnergy, match="dot"):
        trace_energy(dot, {})
    branch = pad.ADFunction(2, lambda x, p: x[0] if x[0] > 0 else x[1])
    with pytest.raises(UnsupportedEnergy, match="branch"):
        trace_energy(branch, {})
    reshape = pad.ADFunction(4, lambda x, p: x.reshape(2, 2)[0, 0])
    with pytest.raises(UnsupportedEnergy, match="reshape"):
        trace_energy(reshape, {})


def test_kernel_source_names_every_compiled_size():
    """The AD library instantiates the blocked kernel's GEMM at vdim = 1,
    sd = n with the nested-dual entries stage, in f32 and f64; nde is a
    run-time argument, and a width outside FULL_WIDTHS is refused."""
    f, _, sizes, _ = ENERGIES["minimal_surface"]
    src = adj.kernel_source(trace_energy(f, sizes))
    for t in ("float", "double"):
        assert (f"bj::launch<{t}, 1, 2, ad::HessianEntries<Energy>>"
                in src)
    assert "__global__" not in src
    a = adj.library_path(trace_energy(f, sizes))
    b = adj.library_path(trace_energy(pad.ADFunction(
        2, _minimal_surface(0.1)), sizes))
    assert a != b and a.startswith(nvcc.BUILD_DIR)
    wide = pad.ADFunction(5, lambda x, p: x[0] * x[4])
    with pytest.raises(ValueError, match="compiled widths"):
        adj.kernel_source(trace_energy(wide, {}))


# ---------------------------------------------------------------------------
# The plain version against JAX's _kernel in interpret mode
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _pair(energy, n, order=1, dim=2):
    """(JAX integrator, port integrator on the same tables, seeded u)."""
    jm = JM.make_cartesian_2d(n, n) if dim == 2 else JM.make_cartesian_3d(
        n, n, n)
    pm = PM.make_cartesian_2d(n, n) if dim == 2 else PM.make_cartesian_3d(
        n, n, n)
    vdim = dim if energy in ("neohookean", "elasticity") else 1
    if energy == "mass":
        fj, fp = jad.MassEnergy(1), pad.MassEnergy(1)
        jmode, pmode = JADEval.VALUE, PADEval.VALUE
    elif energy == "diffusion":
        fj, fp = jad.DiffusionEnergy(dim), pad.DiffusionEnergy(dim)
        jmode, pmode = JADEval.GRAD, PADEval.GRAD
    elif energy == "minimal_surface":
        fj = jad.ADFunction(2, _minimal_surface(0.05))
        fp = pad.ADFunction(2, _minimal_surface(0.05))
        jmode, pmode = JADEval.GRAD, PADEval.GRAD
    else:
        cls = {"neohookean": "NeoHookeanEnergy",
               "elasticity": "LinearElasticityEnergy"}[energy]
        fj = getattr(jad, cls)(dim, 1.3, 0.7)
        fp = getattr(pad, cls)(dim, 1.3, 0.7)
        jmode = JADEval.GRAD | JADEval.VECTOR
        pmode = PADEval.GRAD | PADEval.VECTOR
    ji = JIntegrator(fj, [JFESpace(jm, order, vdim=vdim)], [jmode])
    jt = jax.tree_util.tree_map(np.asarray, ji.tables)
    pi = PIntegrator(fp, [PFESpace(pm, order, vdim=vdim)], [pmode],
                     device="cpu", tables=tables_from_numpy(jt, "cpu", F64))
    rng = np.random.default_rng(13)
    u = (0.1 / n) * rng.standard_normal(ji.spaces[0].ndof)
    return ji, pi, u


def _tol(A):
    return 1e-10 * max(1.0, float(np.abs(A).max()))


def _plain(pi, u):
    args = pi.kernel_inputs([vector_from_numpy(u, "cpu", F64)])
    return adj.ad_element_jacobian_plain(pi.f, *args).numpy(), args


@pytest.mark.parametrize("energy,order", [
    ("diffusion", 1), ("diffusion", 2), ("mass", 1), ("mass", 2)])
def test_plain_matches_jax_closed_branch_interpret(energy, order):
    """JAX routes Mass and Diffusion (hessian_closed, no entries) through
    the closed branch of _kernel."""
    ji, pi, u = _pair(energy, 3, order)
    assert getattr(ji.f, "hessian_closed_entries", None) is None
    A_pallas = np.asarray(element_jacobian_via_pallas(
        ji, [jnp.asarray(u)], interpret=True, block=8))
    A, _ = _plain(pi, u)
    nde = (order + 1) ** 2
    assert A.shape == (9, nde, nde)
    np.testing.assert_allclose(A, A_pallas, rtol=0, atol=_tol(A_pallas))


@pytest.mark.parametrize("energy,order", [
    ("minimal_surface", 1), ("minimal_surface", 2), ("neohookean", 1)])
def test_plain_matches_jax_generic_branch_interpret(energy, order):
    """hess=None, hess_entries=None: JAX traces jax.grad of the energy
    into _kernel (n HVP rows per point)."""
    ji, pi, u = _pair(energy, 3, order)
    A, args = _plain(pi, u)
    ue, R, W, wq = (jnp.asarray(a.numpy()) for a in args[:4])
    params = {k: jnp.asarray(v.numpy()) for k, v in args[4].items()}
    A_pallas = np.asarray(jax_fused_element_jacobian(
        ue, R, W, wq, ji.f.energy, params, pi.nq, pi.n_input, ue.shape[1],
        block=8, interpret=True, hess=None, hess_entries=None))
    np.testing.assert_allclose(A, A_pallas, rtol=0, atol=_tol(A_pallas))


@pytest.mark.parametrize("energy,order,dim,n,nde", [
    ("neohookean", 2, 2, 4, 18),  # generic branch, 2D p2 vector
    ("diffusion", 2, 3, 3, 27),   # closed branch, 3D Q2 scalar
])
def test_plain_matches_jax_at_the_new_full_w_sizes(energy, order, dim, n,
                                                   nde):
    """Sizes the AD kernel serves since its entries stage joined the GEMM
    kernel (nde > 9): the plain version against JAX's ``_kernel`` in
    interpret mode, generic branch (hess=None, hess_entries=None) and
    closed branch (Diffusion's hessian_closed), within 1e-12 of max|A|."""
    ji, pi, u = _pair(energy, 2, order, dim)
    assert (pi.n_input, pi.vdim[0] * pi.nd[0]) == (n, nde)
    # 0.01/n: at 0.1/n, neo-Hookean at p2 has det F <= 0 at some points,
    # where both packages give NaN
    A, args = _plain(pi, u / 10)
    assert np.isfinite(A).all()
    ue, R, W, wq = (jnp.asarray(a.numpy()) for a in args[:4])
    params = {k: jnp.asarray(v.numpy()) for k, v in args[4].items()}
    hess = None if energy == "neohookean" else ji.f.hessian_closed
    A_pallas = np.asarray(jax_fused_element_jacobian(
        ue, R, W, wq, ji.f.energy, params, pi.nq, n, nde, block=8,
        interpret=True, hess=hess, hess_entries=None))
    assert A.shape == (2 ** dim, nde, nde)
    np.testing.assert_allclose(A, A_pallas, rtol=0,
                               atol=1e-12 * float(np.abs(A_pallas).max()))


@pytest.mark.parametrize("energy,order,dim", [
    ("diffusion", 1, 3), ("minimal_surface", 2, 2), ("elasticity", 1, 2)])
def test_plain_matches_two_stage(energy, order, dim):
    _, pi, u = _pair(energy, 2, order, dim)
    A, _ = _plain(pi, u)
    A_two = pi.element_jacobians([vector_from_numpy(u, "cpu", F64)],
                                 route="two_stage").numpy()
    np.testing.assert_allclose(A, A_two, rtol=0, atol=_tol(A_two))


def test_wrapper_takes_plain_version_for_cpu_tensors():
    _, pi, u = _pair("diffusion", 3, 2)
    A, args = _plain(pi, u)
    before = adj.ad_element_jacobian.launches
    assert np.array_equal(adj.ad_element_jacobian(pi.f, *args).numpy(), A)
    assert adj.ad_element_jacobian.launches == before
    meta = [a.to("meta") for a in args[:4]]
    with pytest.raises(ValueError, match="device"):
        adj.ad_element_jacobian(pi.f, *meta, {})


# ---------------------------------------------------------------------------
# Routing
# ---------------------------------------------------------------------------


def test_kernel_ad_route_raises_on_cpu_and_auto_takes_two_stage():
    _, pi, u = _pair("diffusion", 3, 1)
    ut = vector_from_numpy(u, "cpu", F64)
    assert "CUDA" in pi.route_refusal("kernel_ad")
    with pytest.raises(ValueError, match="CUDA"):
        pi.element_jacobians([ut], route="kernel_ad")
    assert torch.equal(pi.element_jacobians([ut]),
                       pi.element_jacobians([ut], route="two_stage"))


@pytest.mark.parametrize("energy,n,order,dim,refusal", [
    ("diffusion", 2, 1, 2, None),
    ("diffusion", 2, 2, 2, None),
    ("mass", 2, 1, 2, None),
    ("diffusion", 2, 1, 3, None),
    ("neohookean", 2, 1, 2, None),
    ("neohookean", 2, 2, 2, None),
    ("elasticity", 2, 1, 3, None),
    ("diffusion", 2, 2, 3, None),
    ("neohookean", 1, 2, 3, "W0"),
])
def test_ad_route_rules_with_tables_taken_for_cuda(monkeypatch, energy, n,
                                                   order, dim, refusal):
    """The rules after the device check, with the device check stubbed:
    every full-W size takes the AD kernel, among them 2D p2 vector
    (n=4, nde=18), 3D Q1 and Q2 scalar (3, 8) and (3, 27) and 3D p1
    vector (9, 24); W0-only configs are refused, naming their reason."""
    _, pi, _ = _pair(energy, n, order, dim)
    monkeypatch.setattr(PIntegrator, "_tables_on_cuda", lambda self: True)
    why = pi.route_refusal("kernel_ad")
    if refusal is None:
        assert why is None
    else:
        assert refusal in why


def test_auto_takes_ad_kernel_where_it_applies_else_two_stage(monkeypatch):
    """auto after the closed-entries kernel's refusal: the AD kernel where
    it applies, else two-stage.  With the AD kernel's device check stubbed, CPU
    tensors reach its plain version, which must equal two-stage."""
    monkeypatch.setattr(PIntegrator, "_tables_on_cuda", lambda self: True)
    taken = []
    real = adj.ad_element_jacobian
    monkeypatch.setattr(adj, "ad_element_jacobian",
                        lambda *a: taken.append(1) or real(*a))
    _, pi, u = _pair("minimal_surface", 3, 2)
    ut = vector_from_numpy(u, "cpu", F64)
    A = pi.element_jacobians([ut])
    assert taken == [1]
    A_two = pi.element_jacobians([ut], route="two_stage")
    np.testing.assert_allclose(A.numpy(), A_two.numpy(), rtol=0,
                               atol=_tol(A_two.numpy()))
    dot = pad.ADFunction(2, lambda x, p: torch.dot(x, x))
    pi_dot = PIntegrator(dot, [pi.spaces[0]], [PADEval.GRAD], device="cpu")
    assert "torch.dot" in pi_dot.route_refusal("kernel_ad")
    pi_dot.element_jacobians([ut])
    assert taken == [1]  # the refused energy went to two-stage


def test_energy_is_traced_once_per_energy_object(monkeypatch):
    """The AD route looks the energy's trace up: a second refusal check or
    element_jacobians call on one integrator does not trace it again, and
    an energy that does not trace is not traced again either."""
    monkeypatch.setattr(PIntegrator, "_tables_on_cuda", lambda self: True)
    calls = []
    real = adj.trace_energy
    monkeypatch.setattr(adj, "trace_energy",
                        lambda f, sizes: calls.append(f) or real(f, sizes))
    _, pi, u = _pair("minimal_surface", 3, 2)
    f = pad.ADFunction(2, _minimal_surface(0.05))
    intg = PIntegrator(f, pi.spaces, pi.modes, device="cpu",
                       tables=pi.tables)
    ut = vector_from_numpy(u, "cpu", F64)
    assert intg.route_refusal("kernel_ad") is None
    A = intg.element_jacobians([ut])
    assert torch.equal(A, intg.element_jacobians([ut], route="kernel_ad"))
    assert calls == [f]
    assert adj.energy_code(f, {}) is adj.energy_code(f, {})
    assert calls == [f]
    dot = pad.ADFunction(2, lambda x, p: torch.dot(x, x))
    pi_dot = PIntegrator(dot, pi.spaces, pi.modes, device="cpu",
                         tables=pi.tables)
    for _ in range(2):
        assert "torch.dot" in pi_dot.route_refusal("kernel_ad")
    assert calls == [f, dot]


def test_ad_wrapper_takes_no_trace_argument():
    params = inspect.signature(adj.ad_element_jacobian).parameters
    assert list(params) == ["f", "ue", "R", "W", "wq", "params"]


def test_entry_points_default_to_the_card():
    for fn in (PIntegrator.__init__, NonlinearForm.__init__,
               BlockNonlinearForm.__init__, pex1.build, pex1.solve,
               pex3.build, pex3.solve, ppar.Comm.__init__, ppar.world,
               ppar.init, ppar.spawn, pdry.dryrun_multichip):
        assert inspect.signature(fn).parameters["device"].default == "cuda"


def test_new_modules_import_without_nvcc_triton_or_jax():
    code = (
        "import sys\n"
        "sys.modules['triton'] = None\n"
        "sys.modules['jax'] = None\n"
        "from mfem_ad_tpu_torch.ops import ad_jacobian, energy_codegen\n"
        "from mfem_ad_tpu_torch.examples import ex0\n"
        "from mfem_ad_tpu_torch import ad\n"
        "assert max(ex0.main(verbose=False).values()) < 1e-12\n"
        "print('ok')\n"
    )
    out = subprocess.run([sys.executable, "-c", code],
                         env=dict(os.environ, PYTHONPATH=os.path.dirname(PKG)),
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


# ---------------------------------------------------------------------------
# The newly ported AD-core classes
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", ["diff", "lagrangian", "al", "empty"])
def test_ad_core_classes_match_jax(name):
    f, fj, _, pvals = ENERGIES[name]
    pt = {k: torch.tensor(v, dtype=F64) for k, v in pvals.items()}
    pj = {k: jnp.asarray(v, dtype=jnp.float64) for k, v in pvals.items()}
    modes = [None]
    if name in ("lagrangian", "al"):
        modes = ["objective_mode", "eq_constraint_mode", None]
    for mode in modes:
        for g in (f, fj):
            if mode == "eq_constraint_mode":
                g.eq_constraint_mode(0)
            elif mode is not None:
                getattr(g, mode)()
            else:
                (g.al_mode if name == "al" else getattr(
                    g, "full_mode", lambda: None))()
        x = _point(name, 7)
        v, gr, h = f.value_grad_hess(torch.as_tensor(x, dtype=F64), pt)
        vj, grj, hj = fj.value_grad_hess(jnp.asarray(x), pj)
        for got, want in ((v, vj), (gr, grj), (h, hj)):
            np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                                       rtol=1e-13, atol=1e-15)


def test_vector_function_matches_jax():
    def fn(lib):
        stack = torch.stack if lib is torch else jnp.stack
        return lambda x, p: stack([lib.sin(x[0] * x[1]),
                                   lib.cos(x[0] * x[1] * x[2])])
    fp = pad.ADVectorFunction(3, 2, fn(torch))
    fj = jad.ADVectorFunction(3, 2, fn(jnp))
    x = np.array([0.5, 1.0, -1.0])
    for a, b in ((fp(x), fj(x)), (fp.gradient(x), fj.gradient(x)),
                 (fp.hessian(x), fj.hessian(x))):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=1e-13,
                                   atol=1e-15)
