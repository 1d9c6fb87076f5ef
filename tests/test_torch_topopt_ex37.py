"""MFEM ex37's density-filtered SiMPL in the port (``mmto.FilteredSiMPL``,
``models.topopt.build_ex37``) and the GMG's per-level fields, f64, CPU:

- at ref 2 (12 x 4 Q2 cells, alpha 10), 3 design iterations of the port's
  loop against the benchmark's plain reference
  (``fembench/reference/topopt-ex37.py``), whose loop solves densely: the
  filtered density, the state, w and the next latent to 1e-9 relative
  and the compliance to 1e-10.  The port's CGs run to 1e-13 here, so
  both loops solve the same systems to rounding (observed: 4e-12 and
  2e-12 after 3 iterations); the volume's bisection stops at a width of
  1e-12 against the reference's machine precision, 1e-13 of the shift.
  A lost term or a wrong step moves these by orders of magnitude more;
- the volume holds theta after every projection, and the result's
  counters (state CG, both filter CGs, bisection steps) are filled;
- ``GMG.inject_field`` gives every coarse level the nodal interpolant of
  the fine field, and a V-cycle of a GMG linearized with per-level fields
  (``set_fields``) equals one whose levels were linearized by hand, its
  level tensors written in place; one shared dict is the list of it;
- the grid apply's route takes the field-backed packed state on every
  level (its plain version equals the eager apply), and the grid-state
  route refuses the runtime field by name;
- ``PDEFilter``'s point derivatives, with and without the latent;
- the grid-state route on the filter's levels: it refuses the latent
  field of level 0 by name, and on the coarser levels (the operator
  alone) its plain version equals the state the GMG holds;
- the example's ``--ex37``.

    python -m pytest tests/test_torch_topopt_ex37.py -q
"""

import functools
import importlib.util
import io
import math
import os
from contextlib import redirect_stdout

import numpy as np
import pytest
import torch

from mfem_ad_tpu_torch import mmto
from mfem_ad_tpu_torch.examples import topopt as example
from mfem_ad_tpu_torch.models import topopt
from mfem_ad_tpu_torch.multigrid import GMG
from mfem_ad_tpu_torch.ops import grid_hess_mult as ghm
from mfem_ad_tpu_torch.ops import grid_hess_state as ghs

F64 = torch.float64
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CFG = {"lambda": 1.0, "mu": 1.0, "rho_min": 1e-6, "filter_radius": 0.01,
       "volume_fraction": 0.5, "alpha": 10.0}
TOL = 1e-9          # iterates (see the module docstring)
TOL_C = 1e-10       # compliance


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@functools.lru_cache(maxsize=None)
def _ref():
    path = os.path.join(ROOT, "fembench", "reference", "topopt-ex37.py")
    spec = importlib.util.spec_from_file_location("ref_ex37", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def rel(a, b) -> float:
    return float((a - b).abs().max() / b.abs().max())


def _build(**kw):
    return topopt.build_ex37(2, alpha=CFG["alpha"], device="cpu", **kw)


@pytest.fixture(scope="module")
def runs():
    ref = _ref().solve_dense(4, 2, 3, 3, CFG)
    pb = _build(lin_tol=1e-13)
    its = []
    res = pb.opt.solve(3, callback=lambda k, *a: its.append(a))
    return ref, its, res, pb


@pytest.mark.parametrize("k", [0, 1, 2])
def test_loop_matches_the_reference(runs, k):
    ref, its, res, _ = runs
    psi_r, rho_r, u_r, w_r, next_r, c_r = ref[k]
    psi, rho, u, w, psi_next = its[k]
    assert rel(rho, rho_r) < TOL
    assert rel(u, u_r) < TOL
    assert rel(w, w_r) < TOL
    assert rel(psi_next, next_r) < TOL
    assert abs(res.compliance_history[k] - c_r) / abs(c_r) < TOL_C


def test_volume_and_counters(runs):
    _, its, res, pb = runs
    for (*_, psi_next), vol in zip(its, res.volume_history):
        assert abs(pb.opt.volume(psi_next) / pb.opt.total_volume
                   - CFG["volume_fraction"]) < 1e-12
        assert vol == pytest.approx(CFG["volume_fraction"], abs=1e-12)
    assert len(res.cg_iterations) == 3 and min(res.cg_iterations) > 0
    assert [len(p) for p in res.filter_cg_iterations] == [2, 2, 2]
    # the bracket logit(theta) -+ max|psi| halves to 1e-12
    assert all(30 < s < 80 for s in res.bisection_steps)
    assert res.compliance_history[2] < res.compliance_history[0]


def _state_gmg():
    """ex37's state hierarchy at ref 2 down to 3 x 1 cells: Q2 12x4, Q1
    12x4, Q1 6x2, Q1 3x1."""
    pb = _build(coarse_ny=1)
    return pb, pb.opt.state_gmg


def test_inject_field_is_the_nodal_interpolant():
    pb, gmg = _state_gmg()
    assert gmg.factors == [2, 2, 2]

    def f(xy):
        return np.sin(2.0 * xy[:, 0]) + xy[:, 0] * xy[:, 1] ** 2

    fine = torch.as_tensor(f(pb.filter_space.node_coords), dtype=F64)
    levels = gmg.inject_field("rho", fine)
    assert len(levels) == 4
    for form, fl in zip(gmg.forms, levels):
        design = form.integrators[0].f.params["rho"].space
        want = torch.as_tensor(f(design.node_coords), dtype=F64)
        assert torch.equal(fl["rho"], want)


def test_per_level_fields_vcycle_equals_one_built_by_hand():
    pb, gmg = _state_gmg()
    gen = torch.Generator().manual_seed(5)
    rho = 0.05 + 0.9 * torch.rand(pb.filter_space.ndof, generator=gen,
                                  dtype=F64)
    fields = gmg.inject_field("rho", rho)
    held = [s[0].planes.data_ptr() for s in gmg.states] + [
        gmg.coarse_inv.data_ptr()]
    gmg.set_fields(fields)
    assert held == [s[0].planes.data_ptr() for s in gmg.states] + [
        gmg.coarse_inv.data_ptr()]
    # by hand: every level's state, diagonal and the coarse inverse
    hand = GMG(gmg.forms, fields=fields)
    for lvl, (form, fl) in enumerate(zip(gmg.forms, fields)):
        zero = torch.zeros(form.ndof, dtype=F64)
        st = form.grad_state(zero, fl)
        hand.states[lvl], hand.diags[lvl] = st, form.grad_diag(st)
    hand.coarse_inv = torch.linalg.inv(gmg.forms[-1].assemble_dense(
        hand.states[-1]))
    b = torch.randn(gmg.forms[0].ndof, generator=gen, dtype=F64)
    b[gmg.forms[0].ess_mask] = 0.0
    assert torch.equal(gmg.vcycle(0, b), hand.vcycle(0, b))
    # one shared dict (newton's, pg2's) is the list of it on every level
    forms = pb.opt.filter_gmg.forms[1:]
    shared, listed = GMG(forms), GMG(forms, fields=[{}] * len(forms))
    b = torch.randn(forms[0].ndof, generator=gen, dtype=F64)
    assert torch.equal(shared.vcycle(0, b), listed.vcycle(0, b))


def test_grid_route_takes_the_field_backed_state():
    pb, gmg = _state_gmg()
    gen = torch.Generator().manual_seed(7)
    gmg.set_fields(gmg.inject_field("rho", torch.rand(
        pb.filter_space.ndof, generator=gen, dtype=F64)))
    for form, st in zip(gmg.forms[:-1], gmg.states):
        intg = form.integrators[0]
        assert intg.route_refusal("grid", st[0]) is None
        assert "runtime field parameters (rho)" in intg.route_refusal(
            "grid_state")
        v = torch.randn(form.ndof, generator=gen, dtype=F64)
        plain = ghm.grid_grad_mult_plain(v, form.ess_mask, st[0].planes,
                                         *intg.grid_operands())
        eager = form.grad_mult(st, v)
        assert float((plain - eager).abs().max()) <= 1e-13 * float(
            eager.abs().max())


def test_pde_filter_point_derivatives():
    eps = 0.3
    x = torch.tensor([0.7, -0.2, 0.5], dtype=F64)
    psi = torch.tensor([0.4], dtype=F64)
    full = mmto.PDEFilter(2, eps, latent_space=_build().latent_space)
    op = mmto.PDEFilter(2, eps)
    s = torch.sigmoid(psi)[0]
    g = torch.tensor([x[0] - s, eps**2 * x[1], eps**2 * x[2]], dtype=F64)
    H = torch.diag(torch.tensor([1.0, eps**2, eps**2], dtype=F64))
    assert torch.allclose(full.gradient(x, {"psi": psi}), g, atol=1e-15)
    assert torch.allclose(full.hessian(x, {"psi": psi}), H, atol=1e-15)
    assert torch.allclose(op.hessian(x), H, atol=1e-15)
    assert op.energy(x, {}) == pytest.approx(
        0.5 * eps**2 * (0.04 + 0.25) + 0.5 * 0.49, rel=1e-15)


def test_filter_levels_grid_state_is_the_held_state():
    gmg = _build(coarse_ny=1).opt.filter_gmg
    assert "runtime field parameters (psi)" in gmg.forms[0].integrators[
        0].route_refusal("grid_state")
    gen = torch.Generator().manual_seed(9)
    for form, st in zip(gmg.forms[1:], gmg.states[1:]):
        intg = form.integrators[0]
        assert intg.route_refusal("grid_state") == (
            "the grid-state kernel runs on CUDA tables only")
        u = torch.randn(form.ndof, generator=gen, dtype=F64)
        planes = ghs.grid_hess_state_plain(intg.f, u,
                                           *intg.grid_state_operands())
        assert rel(planes, st[0].planes) <= 1e-13


def test_example_runs_ex37():
    out = io.StringIO()
    with redirect_stdout(out):
        res, pb = example.main(["--device", "cpu", "--ex37", "-r", "2",
                                "-a", "10", "-mi", "2"])
    text = out.getvalue()
    assert "ex37 it   2" in text and "ex37 finished" in text
    assert "topopt/gmg_refresh" in text
    assert len(res.compliance_history) == 2
    assert math.isfinite(res.compliance_history[-1])
