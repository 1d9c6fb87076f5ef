"""Port parity, the GLVis client, the template driver and LinearForm's
chunked path.

Against ``mfem_ad_tpu`` on the CPU:

- ``_mesh_ascii`` and ``_gridfunction_ascii`` byte for byte, on quads,
  triangles and hexes, H1 p = 1..3 (the conforming H1 encodings), L2 and
  a vdim-3 hex field (the L2_T1 encoding);
- the bytes a loopback server receives from ``GLVis.update`` (a probe
  connection, then one per field);
- ``_h1_conforming_layout`` on a triangle mesh (``tests/test_utils.py``'s
  exact-field check) and the L2 fallback;
- ``GLVis`` is a no-op without a server;
- ``examples.template.main`` with ``-vis`` streams what JAX's
  ``examples/template.py`` streams;
- ``LinearForm.assemble`` at 300x240 (72,000 elements, above the chunked
  path's 2^16): a ``FunctionCoefficient`` takes the chunked path, a
  ``QuadratureCoefficient`` the whole-mesh one; both equal JAX's to
  1e-12 relative.
"""

import functools
import importlib.util
import os
import socket
import sys
import threading
from contextlib import redirect_stdout
import io

import numpy as np
import pytest

import mfem_ad_tpu.utils.glvis as jg
from mfem_ad_tpu import mesh as JM
from mfem_ad_tpu.coefficients import QuadratureCoefficient as JQC
from mfem_ad_tpu.fespace import L2 as JL2
from mfem_ad_tpu.fespace import FESpace as JFESpace
from mfem_ad_tpu.forms import LinearForm as JLinearForm
from mfem_ad_tpu.quadrature import get_rule as jget_rule
from mfem_ad_tpu_torch import mesh as PM
from mfem_ad_tpu_torch.coefficients import QuadratureCoefficient as PQC
from mfem_ad_tpu_torch.examples import template
from mfem_ad_tpu_torch.fespace import L2 as PL2
from mfem_ad_tpu_torch.fespace import FESpace as PFESpace
from mfem_ad_tpu_torch.forms import LinearForm as PLinearForm
from mfem_ad_tpu_torch.quadrature import SQUARE, TRIANGLE
from mfem_ad_tpu_torch.utils import GLVis
from mfem_ad_tpu_torch.utils import glvis as pg

MESHES = {
    "quad": lambda M: M.make_cartesian_2d(3, 2),
    "tri": lambda M: M.make_cartesian_2d(2, 3, TRIANGLE),
    "hex": lambda M: M.make_cartesian_3d(2, 1, 2),
}


def field(x):
    return x[0] ** 3 - x[1] * x[0] + 0.5


@pytest.mark.parametrize("kind", list(MESHES))
def test_mesh_and_gridfunction_ascii_match_jax(kind):
    jm, pm = MESHES[kind](JM), MESHES[kind](PM)
    assert pg._mesh_ascii(pm) == jg._mesh_ascii(jm)
    spaces = [(p, None, 1) for p in (1, 2, 3)] + [(0, "L2", 1), (2, "L2", 1)]
    if kind == "hex":
        spaces = [(1, None, 1), (2, None, 3), (1, "L2", 1)]
    for order, fe, vdim in spaces:
        if fe is None:
            jf, pf = JFESpace(jm, order, vdim=vdim), PFESpace(pm, order,
                                                              vdim=vdim)
        else:
            jf, pf = JFESpace(jm, order, JL2), PFESpace(pm, order, PL2)
        u = np.random.default_rng(order).standard_normal(jf.ndof)
        assert pg._gridfunction_ascii(pf, u) == jg._gridfunction_ascii(jf, u)


def _serve(n_conn):
    """A loopback server thread accepting ``n_conn`` connections; returns
    (port, thread, received byte strings)."""
    srv = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
    srv.bind(("127.0.0.1", 0))
    srv.listen(4)
    received = []

    def run():
        with srv:
            for _ in range(n_conn):
                conn, _ = srv.accept()
                with conn:
                    chunks = []
                    while (b := conn.recv(65536)):
                        chunks.append(b)
                if chunks:
                    received.append(b"".join(chunks))

    t = threading.Thread(target=run, daemon=True)
    t.start()
    return srv.getsockname()[1], t, received


def test_loopback_server_receives_jax_bytes():
    """Two fields (H1 p2, L2 p1): one probe and two data connections."""
    out = {}
    for name, M, FES, L2, client in (("jax", JM, JFESpace, JL2, jg.GLVis),
                                     ("port", PM, PFESpace, PL2, GLVis)):
        m = M.make_cartesian_2d(3, 3)
        h1, l2 = FES(m, 2), FES(m, 1, L2)
        port, t, received = _serve(3)
        g = client(host="127.0.0.1", port=port)
        assert g._enabled
        g.append(h1, h1.project(field), "u")
        g.append(l2, l2.project(field), "psi", keys="")
        g.update()
        t.join(timeout=10.0)
        assert not t.is_alive()
        out[name] = received
    assert len(out["port"]) == 2 and out["port"] == out["jax"]
    assert out["port"][0].startswith(b"solution\nMFEM mesh v1.0")
    assert b"window_title 'psi'" in out["port"][1]


def test_conforming_triangle_layout_and_l2_fallback():
    jm, pm = JM.make_cartesian_2d(2, 2, TRIANGLE), PM.make_cartesian_2d(
        2, 2, TRIANGLE)
    n, gids, ref = pg._h1_conforming_layout(pm, 3)
    jn, jgids, jref = jg._h1_conforming_layout(jm, 3)
    assert n == jn
    np.testing.assert_array_equal(gids, jgids)
    np.testing.assert_array_equal(ref, jref)
    fes = PFESpace(pm, 3)
    txt = pg._gridfunction_ascii(fes, fes.project(field))
    assert "FiniteElementCollection: H1_2D_P3" in txt
    rows = txt.split("Ordering: 1\n\n", 1)[1].strip().splitlines()
    vals = np.array([float(r) for r in rows])
    verts = pm.vertices[pm.elements]  # [ne, 3, 2]
    s, t = ref[:, 0], ref[:, 1]
    xy = np.einsum("jc,ecd->ejd", np.stack([1 - s - t, s, t], axis=1), verts)
    np.testing.assert_allclose(vals[gids], field(xy.transpose(2, 0, 1)),
                               atol=1e-12)
    l2 = PFESpace(pm, 1, PL2)
    assert "FiniteElementCollection: L2_T1_2D_P1" in pg._gridfunction_ascii(
        l2, l2.project(field))


def test_glvis_is_a_noop_without_a_server():
    srv = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
    srv.bind(("127.0.0.1", 0))
    port = srv.getsockname()[1]
    srv.close()  # a free port, nothing listening
    fes = PFESpace(PM.make_cartesian_2d(2, 2), 1)
    g = GLVis(host="127.0.0.1", port=port)
    assert not g._enabled
    g.append(fes, np.zeros(fes.ndof), "x")
    g.update()  # must not raise


def _jax_template():
    path = os.path.join(os.path.dirname(__file__), "..", "examples",
                        "template.py")
    spec = importlib.util.spec_from_file_location("jax_template", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_template_main_streams_what_jax_streams(monkeypatch):
    """``-n 4 -o 2 -vis`` against a loopback server, in both packages (the
    port's on the CPU); the port's ``main`` returns its field as a
    tensor on the device it was given."""
    flags = ["-n", "4", "-o", "2", "-vis"]
    out = {}
    monkeypatch.setattr(sys, "argv", ["template"] + flags)
    for name, mod, run in (
            ("jax", jg, lambda: _jax_template().main()),
            ("port", template, lambda: template.main(
                flags + ["--device", "cpu"]))):
        port, t, received = _serve(2)
        monkeypatch.setattr(mod, "GLVis", functools.partial(
            mod.GLVis, host="127.0.0.1", port=port))
        buf = io.StringIO()
        with redirect_stdout(buf):
            ret = run()
        t.join(timeout=10.0)
        assert not t.is_alive()
        out[name] = (received, buf.getvalue())
    assert out["port"] == out["jax"]
    fes, u = ret
    assert u.device.type == "cpu" and u.shape == (fes.ndof,)
    assert b"FiniteElementCollection: H1_2D_P2" in out["port"][0][0]


def load(x):
    return np.sin(3 * x[0]) * np.cos(2 * x[1]) + x[0] * x[1]


@pytest.mark.parametrize("coeff", ["function", "quadrature"])
def test_linearform_at_72000_elements_matches_jax(coeff, monkeypatch):
    jm, pm = JM.make_cartesian_2d(300, 240), PM.make_cartesian_2d(300, 240)
    js, ps = JFESpace(jm, 1), PFESpace(pm, 1)
    if coeff == "function":
        jc = pc = load
    else:
        ir = jget_rule(jm.geom, 4)
        vals = np.random.default_rng(5).standard_normal(
            (jm.num_elements, ir.npoints, 1))
        jc, pc = JQC(vals), PQC(vals)
    chunked = []
    orig = PLinearForm._assemble_uniform_chunked
    monkeypatch.setattr(
        PLinearForm, "_assemble_uniform_chunked",
        lambda self, ir, phi: chunked.append(1) or orig(self, ir, phi))
    b = PLinearForm(ps, pc, ir_order=4).assemble()
    jb = JLinearForm(js, jc, ir_order=4).assemble()
    assert len(chunked) == (coeff == "function")
    np.testing.assert_allclose(b, jb, rtol=0, atol=1e-12 * np.abs(jb).max())
    assert pm.geom == SQUARE
