"""Port parity, blocked-W0 element-Jacobian op (``ops/blocked_jacobian.py``)
and the closed-entries code generator (``energy_codegen.trace_entries``),
on a host without a GPU:

- the plain PyTorch version of the kernel against the JAX package's Pallas
  ``_kernel_tile_blocked`` in interpret mode and against JAX's two-stage
  route, at 2D p2 (3x3: a ragged block), 3D p1 and 3D p2 (2^3), for
  neo-Hookean and linear elasticity, at atol 1e-10 * max(1, max|A|) in f64
  as tests/test_ops.py holds the Pallas kernels;
- the generated C++ entries, built with g++ into a throwaway host library,
  against ``hessian_closed_entries`` in torch and in JAX (1e-12 relative);
- the router's choice between the full-W and the blocked-W0 kernel, its
  refusals, and the wrapper's device rule.

Random states are u = 0.01/n * N(0, 1): at 0.1/n, 3D p2 neo-Hookean has
det F <= 0 at some points (min -0.07 on 2^3), where both JAX routes give
NaN.  Every test input asserts min det F > 0.5.
"""

import ctypes
import functools
import os
import shutil
import subprocess
import sys

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
from mfem_ad_tpu.ops.fused_jacobian import element_jacobian_via_pallas
from mfem_ad_tpu_torch import ad as pad
from mfem_ad_tpu_torch import mesh as PM
from mfem_ad_tpu_torch.adeval import ADEval as PADEval
from mfem_ad_tpu_torch.convert import tables_from_numpy, vector_from_numpy
from mfem_ad_tpu_torch.fespace import FESpace as PFESpace
from mfem_ad_tpu_torch.integrator import ADBlockIntegrator as PIntegrator
from mfem_ad_tpu_torch.ops import blocked_jacobian as bj
from mfem_ad_tpu_torch.ops import nvcc
from mfem_ad_tpu_torch.ops.energy_codegen import (
    UnsupportedEnergy,
    trace_entries,
)

F64 = torch.float64
PKG = os.path.dirname(bj.__file__).rsplit(os.sep, 1)[0]
ENERGIES = {"neohookean": "NeoHookeanEnergy",
            "elasticity": "LinearElasticityEnergy"}
PARAMS = {"lambda": 1, "mu": 1}
# (dim, order, n): 2D p2 on 3x3 (9 elements: a ragged block of 16), 3D p1
# and 3D p2 on 2x2x2
CONFIGS = [(2, 2, 3), (3, 1, 2), (3, 2, 2)]
AMP = 0.01


def _vector_energy(dim):
    """A vector energy with no closed entries: 0.5 |grad u|^2 + |grad u|^4."""
    def energy(g, p):
        s = sum(g[k] * g[k] for k in range(dim * dim))
        return 0.5 * s + s * s
    return energy


@functools.lru_cache(maxsize=None)
def _pair(energy, dim, order, n):
    """(JAX integrator, port integrator on the same tables, seeded u)."""
    jm = JM.make_cartesian_2d(n, n) if dim == 2 else JM.make_cartesian_3d(
        n, n, n)
    pm = PM.make_cartesian_2d(n, n) if dim == 2 else PM.make_cartesian_3d(
        n, n, n)
    if energy == "no_entries":
        fjx = jad.ADFunction(dim * dim, _vector_energy(dim))
        fpt = pad.ADFunction(dim * dim, _vector_energy(dim))
    else:
        fjx = getattr(jad, ENERGIES[energy])(dim, 1.3, 0.7)
        fpt = getattr(pad, ENERGIES[energy])(dim, 1.3, 0.7)
    ji = JIntegrator(fjx, [JFESpace(jm, order, vdim=dim)],
                     [JADEval.GRAD | JADEval.VECTOR])
    jt = jax.tree_util.tree_map(np.asarray, ji.tables)
    pi = PIntegrator(fpt, [PFESpace(pm, order, vdim=dim)],
                     [PADEval.GRAD | PADEval.VECTOR], device="cpu",
                     tables=tables_from_numpy(jt, "cpu", F64))
    rng = np.random.default_rng(17)
    u = (AMP / n) * rng.standard_normal(ji.spaces[0].ndof)
    return ji, pi, u


def _min_det_f(pi, u):
    d = pi.sd[0]
    g = pi.x_qp([vector_from_numpy(u, "cpu", F64)])
    F = torch.eye(d, dtype=F64) + g.reshape(*g.shape[:2], d, d)
    return float(torch.linalg.det(F).min())


def _tol(A):
    return 1e-10 * max(1.0, float(np.abs(A).max()))


def _plain(pi, u):
    args = pi.blocked_inputs([vector_from_numpy(u, "cpu", F64)])
    return bj.blocked_element_jacobian_plain(
        pi.f, *args, pi.vdim[0], pi.sd[0]).numpy()


# ---------------------------------------------------------------------------
# The plain version against JAX's _kernel_tile_blocked and two-stage route
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("energy", sorted(ENERGIES))
@pytest.mark.parametrize("dim,order,n", CONFIGS)
def test_plain_matches_jax_blocked_kernel_interpret_and_two_stage(
        energy, dim, order, n):
    ji, pi, u = _pair(energy, dim, order, n)
    assert _min_det_f(pi, u) > 0.5
    assert pi.uses_blocked_kernel()
    uj = [jnp.asarray(u)]
    A_pallas = np.asarray(element_jacobian_via_pallas(
        ji, uj, interpret=True, block=16))
    A_two = np.asarray(ji.element_matrices(ji.hess_state(uj), 0, 0))
    A = _plain(pi, u)
    nde = dim * (order + 1) ** dim
    assert A.shape == (n ** dim, nde, nde)
    assert np.isfinite(A_pallas).all() and np.isfinite(A_two).all()
    np.testing.assert_allclose(A, A_pallas, rtol=0, atol=_tol(A_pallas))
    np.testing.assert_allclose(A, A_two, rtol=0, atol=_tol(A_two))


# ---------------------------------------------------------------------------
# trace_entries: the generated C++ against the closed entries
# ---------------------------------------------------------------------------

ENTRY_CASES = [(e, d) for e in sorted(ENERGIES) for d in (2, 3)]


@pytest.fixture(scope="module")
def entries_lib(tmp_path_factory):
    """One host library with ``<energy><dim>(x, p, h)`` for every case,
    from the generated entries and ``csrc/blocked_jacobian.cuh`` (which
    compiles as host C++ without its kernel)."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++")
    parts = ['#include "blocked_jacobian.cuh"', ""]
    for energy, dim in ENTRY_CASES:
        f = getattr(pad, ENERGIES[energy])(dim, 1.0, 1.0)
        name = f"{energy}{dim}"
        code = trace_entries(f, PARAMS, name=f"entries_{name}")
        parts += [
            code.source,
            f'extern "C" void {name}(const double* x, const double* p, '
            "double* h) {",
            f"  entries_{name}<double>(x, p, h);",
            "}",
            "",
        ]
    d = tmp_path_factory.mktemp("entries")
    src, lib = d / "entries.cc", d / "libentries.so"
    src.write_text("\n".join(parts))
    proc = subprocess.run(
        [gxx, "-O2", "-std=c++17", "-shared", "-fPIC", "-Wall", "-Werror",
         "-Wno-unused-local-typedefs", "-I", nvcc.CSRC, "-o", str(lib),
         str(src)],
        capture_output=True, text=True)
    assert proc.returncode == 0, proc.stderr
    return ctypes.CDLL(str(lib))


@pytest.mark.parametrize("energy,dim", ENTRY_CASES)
def test_trace_entries_match_closed_entries(entries_lib, energy, dim):
    cls = ENERGIES[energy]
    fp = getattr(pad, cls)(dim, 1.0, 1.0)
    fjx = getattr(jad, cls)(dim, 1.0, 1.0)
    n = dim * dim
    lam, mu = 1.3, 0.7
    fn = getattr(entries_lib, f"{energy}{dim}")
    ptr = lambda a: a.ctypes.data_as(ctypes.POINTER(ctypes.c_double))  # noqa
    for seed in range(4):
        x = 0.2 * np.random.default_rng(seed).standard_normal(n)
        h = np.zeros(n * n)
        fn(ptr(x), ptr(np.array([lam, mu])), ptr(h))
        rows_t = fp.hessian_closed_entries(
            [torch.tensor(v, dtype=F64) for v in x],
            {"lambda": [torch.tensor(lam, dtype=F64)],
             "mu": [torch.tensor(mu, dtype=F64)]})
        rows_j = fjx.hessian_closed_entries(
            jnp.asarray(x), {"lambda": jnp.asarray([lam]),
                             "mu": jnp.asarray([mu])})
        for rows in (rows_t, rows_j):
            want = np.array([[float(v) for v in r] for r in rows]).ravel()
            np.testing.assert_allclose(
                h, want, rtol=0, atol=1e-12 * np.abs(want).max())


def test_trace_entries_share_subexpressions_and_refuse_by_name():
    code = trace_entries(pad.NeoHookeanEnergy(3, 1.0, 1.0), PARAMS)
    assert code.n_input == 9 and code.n_params == 2
    # one log(det F) and one reciprocal serve all 81 entries
    assert code.source.count("ad::log(") == 1
    assert code.source.count("(S(0x1.0000000000000p+0) /") == 1
    assert all(f"  h[{k}] = " in code.source for k in range(81))
    # linear elasticity's entries are parameters only; all are written
    lin = trace_entries(pad.LinearElasticityEnergy(2, 1.0, 1.0), PARAMS)
    assert "x[" not in lin.source and lin.source.count("  h[") == 16
    with pytest.raises(UnsupportedEnergy, match="no hessian_closed_entries"):
        trace_entries(pad.DiffusionEnergy(2), {})

    class DotEntries(pad.ADFunction):
        def __init__(self):
            super().__init__(2)

        def hessian_closed_entries(self, x, p):
            return [[torch.dot(x, x), 0.0], [0.0, 1.0]]

    with pytest.raises(UnsupportedEnergy, match="dot"):
        trace_entries(DotEntries(), {})


def test_kernel_source_and_library_name():
    code = bj.entries_code(pad.NeoHookeanEnergy(3, 1.0, 1.0), PARAMS)
    src = bj.kernel_source(code, 3, 3)
    assert "bj::launch<float, 3, 3, Entries>" in src
    assert "bj::launch<double, 3, 3, Entries>" in src
    with pytest.raises(ValueError, match="not among"):
        bj.kernel_source(code, 2, 2)
    path = nvcc.library_path("blocked_jacobian", src, bj.HEADERS)
    other = nvcc.library_path("blocked_jacobian",
                              bj.kernel_source(bj.entries_code(
                                  pad.LinearElasticityEnergy(3, 1.0, 1.0),
                                  PARAMS), 3, 3), bj.HEADERS)
    assert path != other and path.startswith(nvcc.BUILD_DIR)
    f = pad.NeoHookeanEnergy(2, 1.0, 1.0)
    assert bj.entries_code(f, PARAMS) is bj.entries_code(f, dict(PARAMS))


# The shapes the kernel serves, keyed for the test ids: "dim-order" for the
# blocked factor W0 at 2D p2/p3 and 3D p1/p2/p3 (vdim = sd = dim); the
# full-W instantiations (vdim = 1, sd = n, nd = nde) at the main path's
# shapes and the AD route's sizes: the 2D p1 vector headline (n=4, nde=8),
# Poisson Q1 and Q2 (2, 4) and (2, 9), Mass Q1 (1, 4), 2D p2 vector
# (4, 18), 3D Q1 and Q2 scalar (3, 8) and (3, 27), 3D p1 vector (9, 24)
# and 2D p2 vector VALUE|GRAD (6, 18).
PLAN_SHAPES = ["2-2", "2-3", "3-1", "3-2", "3-3"]
FULL_W_CASES = {  # key -> (energy, dim, order, mode, vdim)
    "full-headline": ("elasticity", 2, 1, "vector", 2),
    "full-poisson-q1": ("diffusion", 2, 1, "grad", 1),
    "full-poisson-q2": ("diffusion", 2, 2, "grad", 1),
    "full-mass-q1": ("mass", 2, 1, "value", 1),
    "full-2d-p2-vector": ("elasticity", 2, 2, "vector", 2),
    "full-3d-q1": ("diffusion", 3, 1, "grad", 1),
    "full-3d-q2": ("diffusion", 3, 2, "grad", 1),
    "full-3d-p1-vector": ("elasticity", 3, 1, "vector", 3),
    "full-2d-p2-value-grad": ("value_grad", 2, 2, "value_grad", 2),
}


def _shape(dim, order):
    """(nd, nq) of a GRAD|VECTOR integrator at the default rule."""
    m = PM.make_cartesian_2d(1, 1) if dim == 2 else PM.make_cartesian_3d(
        1, 1, 1)
    pi = PIntegrator(pad.LinearElasticityEnergy(dim, 1.0, 1.0),
                     [PFESpace(m, order, vdim=dim)],
                     [PADEval.GRAD | PADEval.VECTOR], device="cpu")
    return pi.nd[0], pi.nq


@functools.lru_cache(maxsize=None)
def _plan_shape(case):
    """(vdim, sd, nd, nq) of the kernel at ``case``, with the full W
    installed for the full-W cases."""
    if not case.startswith("full"):
        dim, order = map(int, case.split("-"))
        return (dim, dim, *_shape(dim, order))
    energy, dim, order, mode, vdim = FULL_W_CASES[case]
    f = {"elasticity": lambda: pad.LinearElasticityEnergy(dim, 1.0, 1.0),
         "diffusion": lambda: pad.DiffusionEnergy(dim),
         "mass": lambda: pad.MassEnergy(1),
         "value_grad": lambda: pad.ADFunction(
             2 * (1 + dim), lambda x, p: 0.5 * (x * x).sum())}[energy]()
    ev = {"vector": PADEval.GRAD | PADEval.VECTOR, "grad": PADEval.GRAD,
          "value": PADEval.VALUE,
          "value_grad": PADEval.VALUE | PADEval.GRAD | PADEval.VECTOR}[mode]
    m = PM.make_cartesian_2d(1, 1) if dim == 2 else PM.make_cartesian_3d(
        1, 1, 1)
    pi = PIntegrator(f, [PFESpace(m, order, vdim=vdim)], [ev], device="cpu")
    assert "0_0" in pi.tables["W"]
    return 1, pi.n_input, pi.vdim[0] * pi.nd[0], pi.nq


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("case", PLAN_SHAPES + list(FULL_W_CASES))
def test_launch_plan_fits_the_card_and_the_kernel_checks(case, dtype):
    """The plan the wrapper passes satisfies every check of
    ``bj::launch``: whole warps of LM x LN groups, at least 4 warps, the
    232,448 bytes a block may use, whole ring slots of quadrature points,
    and the kernel's own shared-memory formula; for the blocked factor and
    for the full-W instantiations."""
    vdim, sd, nd, nq = _plan_shape(case)
    p = bj.launch_plan(vdim, sd, nd, nq, dtype)
    elem = torch.empty((), dtype=dtype).element_size()
    groups = p.col_tile // bj.TILE_N
    vd2 = vdim * vdim
    assert p.col_tile % bj.TILE_N == 0
    assert p.threads % 32 == 0 and p.threads >= 128
    assert p.threads <= max(bj.THREAD_CHOICES[dtype])
    assert p.threads % groups == 0
    assert p.threads // groups % (32 // bj.lanes_n(groups)) == 0
    assert 0 < p.elem_tile * vd2 <= p.row_tile
    assert p.row_tile - p.elem_tile * vd2 < vd2  # padding only
    assert 2 <= p.stages <= 4
    assert nq % p.quad_stage == 0
    assert p.quad_chunk % p.quad_stage == 0 and p.quad_chunk <= nq
    assert p.threads % p.col_tile == 0  # one write-out column per thread
    sd2 = sd * sd
    nde2 = (vdim * nd) ** 2
    contiguous = nd * nd <= p.col_tile and nde2 * elem % 16 == 0
    staged = (p.elem_tile * nde2 if contiguous
              else p.row_tile // 2 * (p.col_tile + 4))
    ring = max(p.stages * p.quad_stage * sd2 * p.col_tile, staged)
    assert p.smem_bytes == bj.BAR_BYTES + elem * (
        ring + p.quad_chunk * sd2 * p.row_tile + p.elem_tile * vdim * nd)
    assert p.smem_bytes <= bj.SMEM_LIMIT == 232_448
    assert p.padded_cols(nd) >= nd * nd
    assert p.padded_cols(nd) % p.col_tile == 0


@pytest.mark.parametrize("case", ["2-2", "3-1", "3-2", "full-headline",
                                  "full-poisson-q1", "full-poisson-q2",
                                  "full-2d-p2-vector"])
def test_launch_plan_computes_entries_once_per_element_on_the_main_path(
        case):
    """At the main path's shapes in f32 (the blocked factor at 2D p2, 3D
    p1 and 3D p2; the full W at the headline, Poisson Q1 and Q2 and 2D p2
    vector) the entries of an element are computed once per call:
    resident for every column tile, or one column tile for every chunk of
    points."""
    vdim, sd, nd, nq = _plan_shape(case)
    p = bj.launch_plan(vdim, sd, nd, nq, torch.float32)
    assert p.quad_chunk == nq or p.padded_cols(nd) == p.col_tile


@pytest.mark.parametrize("case,threads,blocks,slots", [
    ("full-headline", 128, 3, 3),    # K = 144: three blocks, 3 slots
    ("full-poisson-q1", 128, 2, 1),  # K = 36: one slot of all 9 points
    ("full-poisson-q2", 192, 2, 1),  # K = 64: one slot of all 16 points
])
def test_full_w_plans_fill_an_sm_with_small_blocks(case, threads, blocks,
                                                   slots):
    """At vdim = 1 in f32 the plan takes 128-thread blocks where a column
    tile allows, as many blocks of them an SM as 12 warps make where
    shared memory allows (else one fewer), and few, large ring slots."""
    vdim, sd, nd, nq = _plan_shape(case)
    p = bj.launch_plan(vdim, sd, nd, nq, torch.float32)
    assert p.threads == threads
    per_sm = bj.SMEM_SM // (p.smem_bytes + 1024)
    assert min(per_sm, bj.WARPS_F32 * 32 // p.threads) == blocks
    assert nq // p.quad_stage == slots
    assert p.quad_stage * sd * sd >= bj.FULL_W_STAGE_ROWS or slots == 1


# ---------------------------------------------------------------------------
# Routing and the wrapper
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("energy,dim,order,n,blocked,refusal", [
    ("neohookean", 2, 2, 2, True, None),
    ("elasticity", 2, 3, 1, True, None),
    ("neohookean", 3, 1, 1, True, None),
    ("elasticity", 3, 2, 1, True, None),
    ("neohookean", 3, 3, 1, True, None),
    ("neohookean", 2, 1, 2, False, None),
    ("no_entries", 2, 2, 2, False, "ADFunction has no closed Hessian"),
    ("no_entries", 3, 2, 1, False, "ADFunction has no closed Hessian"),
])
def test_route_rules_with_tables_taken_for_cuda(monkeypatch, energy, dim,
                                                order, n, blocked, refusal):
    """The rules after the device check, with the device check stubbed:
    every W0 config with closed entries takes the blocked kernel, the 2D p1
    headline (no W0) keeps the full-W kernel, and an energy without closed
    entries is refused by name."""
    _, pi, _ = _pair(energy, dim, order, n)
    monkeypatch.setattr(PIntegrator, "_tables_on_cuda", lambda self: True)
    assert pi.uses_blocked_kernel() == blocked
    why = pi.route_refusal("kernel")
    if refusal is None:
        assert why is None
    else:
        assert refusal in why


def test_kernel_route_takes_blocked_kernel_with_tables_taken_for_cuda(
        monkeypatch):
    """route="kernel" and auto both reach blocked_element_jacobian at a W0
    config; with the device check stubbed, CPU tensors get its plain
    version, which must equal two-stage."""
    monkeypatch.setattr(PIntegrator, "_tables_on_cuda", lambda self: True)
    taken = []
    real = bj.blocked_element_jacobian
    monkeypatch.setattr(bj, "blocked_element_jacobian",
                        lambda *a, **k: taken.append(1) or real(*a, **k))
    _, pi, u = _pair("neohookean", 2, 2, 3)
    ut = vector_from_numpy(u, "cpu", F64)
    A_two = pi.element_jacobians([ut], route="two_stage").numpy()
    for route in ("kernel", "auto"):
        A = pi.element_jacobians([ut], route=route).numpy()
        np.testing.assert_allclose(A, A_two, rtol=0, atol=_tol(A_two))
    assert taken == [1, 1]


def test_kernel_route_raises_on_cpu_and_auto_takes_two_stage():
    _, pi, u = _pair("elasticity", 3, 2, 2)
    ut = vector_from_numpy(u, "cpu", F64)
    assert "CUDA" in pi.route_refusal("kernel")
    with pytest.raises(ValueError, match="CUDA"):
        pi.element_jacobians([ut], route="kernel")
    assert torch.equal(pi.element_jacobians([ut]),
                       pi.element_jacobians([ut], route="two_stage"))


def test_wrapper_takes_plain_version_for_cpu_tensors_and_rejects_others():
    _, pi, u = _pair("neohookean", 3, 1, 2)
    args = pi.blocked_inputs([vector_from_numpy(u, "cpu", F64)])
    before = bj.blocked_element_jacobian.launches
    A = bj.blocked_element_jacobian(pi.f, *args, 3, 3)
    assert torch.equal(A, bj.blocked_element_jacobian_plain(pi.f, *args,
                                                            3, 3))
    ue, B0, W0, w, params = args
    meta = {k: v.to("meta") for k, v in params.items()}
    with pytest.raises(ValueError, match="device"):
        bj.blocked_element_jacobian(pi.f, ue.to("meta"), B0.to("meta"),
                                    W0.to("meta"), w.to("meta"), meta, 3, 3)
    assert bj.blocked_element_jacobian.launches == before


def test_blocked_kernel_refuses_entries_that_do_not_trace(monkeypatch):
    """A W0 config whose closed entries the code generator cannot emit is
    refused by name; auto then takes two-stage."""

    class DotEntries(pad.NeoHookeanEnergy):
        def hessian_closed_entries(self, gradu, p):
            rows = super().hessian_closed_entries(gradu, p)
            rows[0][0] = rows[0][0] + torch.dot(gradu[:2], gradu[:2])
            return rows

    _, pi, u = _pair("neohookean", 2, 2, 2)
    dot = PIntegrator(DotEntries(2, 1.3, 0.7), pi.spaces, pi.modes,
                      device="cpu", tables=pi.tables)
    monkeypatch.setattr(PIntegrator, "_tables_on_cuda", lambda self: True)
    assert dot.uses_blocked_kernel()
    why = dot.route_refusal("kernel")
    assert "do not trace" in why and "torch.dot" in why
    ut = vector_from_numpy(u, "cpu", F64)
    with pytest.raises(ValueError, match="do not trace"):
        dot.element_jacobians([ut], route="kernel")
    assert torch.equal(dot.element_jacobians([ut]),
                       dot.element_jacobians([ut], route="two_stage"))


def test_new_modules_import_without_nvcc_triton_or_jax():
    code = (
        "import sys\n"
        "sys.modules['triton'] = None\n"
        "sys.modules['jax'] = None\n"
        "import torch\n"
        "from mfem_ad_tpu_torch import ad, mesh\n"
        "from mfem_ad_tpu_torch.adeval import ADEval\n"
        "from mfem_ad_tpu_torch.fespace import FESpace\n"
        "from mfem_ad_tpu_torch.integrator import ADBlockIntegrator\n"
        "from mfem_ad_tpu_torch.ops import blocked_jacobian as bj, nvcc\n"
        "fes = FESpace(mesh.make_cartesian_3d(1, 1, 1), 2, vdim=3)\n"
        "i = ADBlockIntegrator(ad.NeoHookeanEnergy(3, 1.0, 1.0), [fes],\n"
        "    [ADEval.GRAD | ADEval.VECTOR], device='cpu')\n"
        "u = torch.zeros(fes.ndof, dtype=torch.float64)\n"
        "A = bj.blocked_element_jacobian(i.f, *i.blocked_inputs([u]),"
        " 3, 3)\n"
        "assert A.shape == (1, 81, 81)\n"
        "assert torch.allclose(A, i.element_jacobians([u]), atol=1e-12)\n"
        "print('ok')\n"
    )
    out = subprocess.run([sys.executable, "-c", code],
                         env=dict(os.environ, PYTHONPATH=os.path.dirname(PKG)),
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"
