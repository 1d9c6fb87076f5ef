"""Port parity, substrate: the numpy FE substrate of mfem_ad_tpu_torch
(quadrature, basis, mesh, geometry, FE space, shape tensors) must equal the
JAX package's exactly, and the port must import neither jax nor the JAX
package, nor need nvcc or triton to import."""

import os
import re
import subprocess
import sys

import numpy as np
import pytest

import mfem_ad_tpu.ad as jad
from mfem_ad_tpu import adeval as JE
from mfem_ad_tpu import coefficients as JC
from mfem_ad_tpu import fespace as JF
from mfem_ad_tpu import geometry as JG
from mfem_ad_tpu import mesh as JM
from mfem_ad_tpu import native as JN
from mfem_ad_tpu import quadrature as JQ
from mfem_ad_tpu_torch import ad as pad
from mfem_ad_tpu_torch import adeval as PE
from mfem_ad_tpu_torch import coefficients as PC
from mfem_ad_tpu_torch import fespace as PF
from mfem_ad_tpu_torch import geometry as PG
from mfem_ad_tpu_torch import mesh as PM
from mfem_ad_tpu_torch import native as PN
from mfem_ad_tpu_torch import quadrature as PQ

PKG = os.path.join(os.path.dirname(os.path.dirname(__file__)),
                   "mfem_ad_tpu_torch")


def _same(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and np.array_equal(a, b)


@pytest.mark.parametrize("geom", ["segment", "square", "cube", "triangle",
                                  "tetrahedron"])
def test_quadrature_rules_equal(geom):
    g = getattr(JQ, geom.upper())
    for order in range(1, 9):
        rj, rp = JQ.get_rule(g, order), PQ.get_rule(g, order)
        _same(rj.points, rp.points)
        _same(rj.weights, rp.weights)
    assert [JQ.default_ad_order(p) for p in range(1, 5)] == [
        PQ.default_ad_order(p) for p in range(1, 5)
    ]


@pytest.mark.parametrize("dim,n,refs", [(2, 3, 1), (3, 2, 1)])
def test_cartesian_mesh_equal(dim, n, refs):
    make = "make_cartesian_2d" if dim == 2 else "make_cartesian_3d"
    args = (n,) * dim
    mj = getattr(JM, make)(*args).uniform_refine(refs)
    mp = getattr(PM, make)(*args).uniform_refine(refs)
    for name in ("vertices", "elements", "attributes", "bdr_elements",
                 "bdr_attributes"):
        _same(getattr(mj, name), getattr(mp, name))
    assert mj.structured == mp.structured
    assert mj.uniform_jacobian and mp.uniform_jacobian


# MFEM v1.0 files: two quads, or a quad and a triangle sharing an edge
_QUADS = """MFEM mesh v1.0

dimension
2

elements
2
1 3 0 1 4 3
2 3 1 2 5 4

boundary
6
1 1 0 1
1 1 1 2
2 1 2 5
3 1 5 4
3 1 4 3
4 1 3 0

vertices
6
2
0 0
1 0
2 0
0 1
1 1.5
2 1
"""
_MIXED = _QUADS.replace("2 3 1 2 5 4", "2 2 1 2 4")
_CURVED = _QUADS.split("vertices")[0] + """vertices
6

nodes
FiniteElementSpace
FiniteElementCollection: H1_2D_P2
VDim: 2
Ordering: 1
"""


def test_mfem_mesh_reader_matches_jax_on_a_straight_file(tmp_path):
    path = tmp_path / "quads.mesh"
    path.write_text(_QUADS)
    mj, mp = JM.read_mfem_mesh(str(path)), PM.read_mfem_mesh(str(path))
    assert mp.geom == mj.geom == PM.SQUARE
    for name in ("vertices", "elements", "attributes", "bdr_elements",
                 "bdr_attributes"):
        _same(getattr(mj, name), getattr(mp, name))


@pytest.mark.parametrize("text,cause", [
    (_MIXED, "mixed meshes are not supported"),
    (_CURVED, "curved meshes are not supported"),
])
def test_mfem_mesh_reader_names_what_it_refuses(tmp_path, text, cause):
    path = tmp_path / "refused.mesh"
    path.write_text(text)
    with pytest.raises(ValueError, match=cause):
        PM.read_mfem_mesh(str(path))


@pytest.mark.parametrize(
    "dim,order,vdim", [(2, 1, 2), (2, 2, 2), (2, 3, 1), (3, 1, 3), (3, 2, 1)]
)
def test_fespace_and_shape_tables_equal(dim, order, vdim):
    n = 4 if dim == 2 else 2
    mj = JM.make_cartesian_2d(n, n) if dim == 2 else JM.make_cartesian_3d(
        n, n, n)
    mp = PM.make_cartesian_2d(n, n) if dim == 2 else PM.make_cartesian_3d(
        n, n, n)
    fj = JF.FESpace(mj, order, vdim=vdim)
    fp = PF.FESpace(mp, order, vdim=vdim)
    _same(fj.edof, fp.edof)
    _same(fj.node_coords, fp.node_coords)
    assert fj.grid == fp.grid and fj.ndof == fp.ndof
    _same(fj.boundary_dofs(), fp.boundary_dofs())
    for a in range(mj.max_bdr_attribute()):
        mask = np.zeros(mj.max_bdr_attribute())
        mask[a] = 1
        _same(fj.essential_mask(mask), fp.essential_mask(mask))
        _same(fj.essential_dofs(mask), fp.essential_dofs(mask))
    ir_j = JQ.get_rule(mj.geom, JQ.default_ad_order(order))
    ir_p = PQ.get_rule(mp.geom, PQ.default_ad_order(order))
    gj, gp = JG.geom_factors(mj, ir_j), PG.geom_factors(mp, ir_p)
    for name in ("xq", "jac", "detj", "invj", "w"):
        _same(getattr(gj, name), getattr(gp, name))
    mode_j = JE.ADEval.GRAD | (JE.ADEval.VECTOR if vdim > 1 else 0)
    mode_p = PE.ADEval.GRAD | (PE.ADEval.VECTOR if vdim > 1 else 0)
    _same(JE.build_B(fj, mode_j, ir_j, gj), PE.build_B(fp, mode_p, ir_p, gp))
    _same(fj.elem.eval(ir_j.points), fp.elem.eval(ir_p.points))
    _same(fj.elem.grad(ir_j.points), fp.elem.grad(ir_p.points))


def test_l2_space_equal():
    fj = JF.FESpace(JM.make_cartesian_2d(3, 3), 2, JF.L2)
    fp = PF.FESpace(PM.make_cartesian_2d(3, 3), 2, PF.L2)
    _same(fj.edof, fp.edof)
    assert fj.grid == fp.grid == ("l2",)


def test_native_unique_rows_equal():
    rng = np.random.default_rng(0)
    rows = rng.integers(0, 6, size=(200, 3))
    for a, b in zip(JN.unique_rows(rows), PN.unique_rows(rows)):
        _same(a, b)
    uj, ij = np.unique(rows, axis=0, return_inverse=True)
    up, ip = PN.unique_rows(rows)
    _same(uj, up)
    assert np.array_equal(ij.ravel(), ip.ravel())


@pytest.mark.parametrize("deriv", [0, 1, 2])
def test_differentiable_coefficient_matches_jax(deriv):
    """DifferentiableCoefficient evaluates through torch.func in the port."""
    mesh_j, mesh_p = JM.make_cartesian_2d(2, 2), PM.make_cartesian_2d(2, 2)
    ir = JQ.get_rule(mesh_j.geom, 3)

    def gradu(x):
        return np.stack([0.1 * x[0], 0.05 * x[1], -0.02 * x[0] * x[1],
                         0.07 * x[1] ** 2])

    cj = JC.DifferentiableCoefficient(
        jad.NeoHookeanEnergy(2, 1.3, 0.7), [JC.FunctionCoefficient(gradu, 4)],
        deriv=deriv)
    cp = PC.DifferentiableCoefficient(
        pad.NeoHookeanEnergy(2, 1.3, 0.7), [PC.FunctionCoefficient(gradu, 4)],
        deriv=deriv)
    vj = cj.eval_qp(JC.qp_context(mesh_j, ir))
    vp = cp.eval_qp(PC.qp_context(mesh_p, PQ.get_rule(mesh_p.geom, 3)))
    np.testing.assert_allclose(vp, vj, rtol=1e-12,
                               atol=1e-12 * np.abs(vj).max())


def test_port_sources_import_neither_jax_nor_the_jax_package():
    bad = re.compile(r"^\s*(import|from)\s+(jax|mfem_ad_tpu)(\s|\.|$)", re.M)
    scanned = 0
    for root, _, files in os.walk(PKG):
        for name in files:
            if name.endswith(".py"):
                with open(os.path.join(root, name)) as f:
                    src = f.read()
                assert not bad.search(src), os.path.join(root, name)
                scanned += 1
    assert scanned >= 15


def test_port_imports_without_nvcc_triton_or_jax():
    """A fresh interpreter with no nvcc on PATH, triton and jax blocked,
    imports every module of the port and assembles on the CPU."""
    code = (
        "import sys\n"
        "sys.modules['triton'] = None\n"
        "sys.modules['jax'] = None\n"
        "import numpy as np, torch\n"
        "import mfem_ad_tpu_torch as P\n"
        "from mfem_ad_tpu_torch import convert, forms, solvers\n"
        "from mfem_ad_tpu_torch.models import elasticity, poisson\n"
        "from mfem_ad_tpu_torch.ops import (ad_jacobian, blocked_jacobian,"
        " energy_codegen, fused_jacobian, nvcc)\n"
        "m = P.mesh.make_cartesian_2d(2, 2)\n"
        "fes = P.fespace.FESpace(m, 1, vdim=2)\n"
        "intg = P.ADBlockIntegrator(P.NeoHookeanEnergy(2, 1.0, 1.0), [fes],"
        " [P.ADEval.GRAD | P.ADEval.VECTOR], device='cpu')\n"
        "u = torch.zeros(fes.ndof, dtype=torch.float64)\n"
        "assert intg.element_jacobians([u]).shape == (4, 8, 8)\n"
        "assert 'jax' not in sys.modules or sys.modules['jax'] is None\n"
        "print('ok')\n"
    )
    env = dict(os.environ)
    env["PATH"] = os.pathsep.join(
        p for p in env.get("PATH", "").split(os.pathsep)
        if not os.path.exists(os.path.join(p, "nvcc"))
    )
    env["PYTHONPATH"] = os.path.dirname(PKG)
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"
