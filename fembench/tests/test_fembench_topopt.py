"""CPU tests of the ex37 cell (``topopt-ex37.design``) at a tiny size, with
the clock stubbed: a whole run traced and untraced prints a well-formed
line; the plain reference imports nothing of the program or of JAX;
planted faults (the adjoint filter solve skipped, the filter in float32,
the volume's bisection stopped early) come out not correct.

    python -m pytest fembench/tests/test_fembench_topopt.py -q
"""

import json
import os
import subprocess
import sys

import pytest
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
BENCH = os.path.dirname(HERE)
ROOT = os.path.dirname(BENCH)
sys.path[:0] = [BENCH, ROOT]

import harness  # noqa: E402
import run  # noqa: E402
from mfem_ad_tpu_torch import mmto  # noqa: E402
from mfem_ad_tpu_torch.solvers import cg  # noqa: E402

from test_fembench_harness import StubClock  # noqa: E402

CELL = "topopt-ex37.design"
# 12 x 4 Q2 cells, a GMG of four levels down to 3 x 1 Q1
TINY = {"ref_levels": 2, "gmg": {"coarse_ny": 1}}


@pytest.fixture(autouse=True, scope="module")
def few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _run(trace: bool) -> dict:
    out = run.run_cell(CELL, 2**31 + 17, 0.5, trace, "cpu",
                       cfg_override=TINY, clock=StubClock())
    return json.loads(json.dumps(out))


@pytest.mark.parametrize("trace", [0, 1])
def test_cell_prints_a_well_formed_line(trace):
    line = _run(bool(trace))
    assert list(line)[-1] == "check"
    assert line["correct"] is True and line["failed"] == 0
    assert line["attempted"] == 1
    bench = harness.benchmark()
    got = set(line["metrics"])
    if trace:
        # no device here: the device reader stays silent
        want = {m["name"] for m in harness.metrics_of(bench, CELL, True)}
        assert got == want - {"device_idle.topopt"}
        assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
        m = line["metrics"]
        assert m["state_cg_per_iter.topopt"]["value"] >= 1
        for name in ("gmg_refresh_ms.topopt", "filter_solve_ms.topopt",
                     "projection_ms.topopt"):
            assert m[name]["value"] > 0
    else:
        assert got == {"setup_s", "solve_s"}
    assert set(line["check"]) == {"state_residual", "filter_residual",
                                  "adjoint_residual", "step",
                                  "iterations_missing"}
    for c in line["check"].values():
        assert c["value"] <= c["limit"]


def test_reference_imports_nothing_of_the_program():
    path = os.path.join(BENCH, "reference", "topopt-ex37.py")
    code = ("import importlib.util, sys\n"
            "s = importlib.util.spec_from_file_location('r', %r)\n"
            "s.loader.exec_module(importlib.util.module_from_spec(s))\n"
            "print(sorted({m.split('.')[0] for m in sys.modules} & "
            "{'mfem_ad_tpu_torch', 'mfem_ad_tpu', 'jax', 'harness'}))\n"
            % path)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip() == "[]"


def test_an_adjoint_solve_skipped_is_not_correct(monkeypatch):
    solve = mmto.FilteredSiMPL.solve

    def skipped(self, *a, **k):
        filter_solve = self.filter_solve
        calls = []

        def every_other(b):
            calls.append(1)
            if len(calls) % 2 == 0:     # the adjoint: w stays zero
                return torch.zeros_like(b), 0
            return filter_solve(b)

        self.filter_solve = every_other
        try:
            return solve(self, *a, **k)
        finally:
            del self.filter_solve

    monkeypatch.setattr(mmto.FilteredSiMPL, "solve", skipped)
    assert _run(False)["correct"] is False


def test_a_float32_filter_is_not_correct(monkeypatch):
    def f32(self, b):
        """Both filter solves' CG in float32 (the operator and the V-cycle
        computed in float64, their results rounded)."""
        st = self.filter_gmg.states[0]
        x, its = cg(lambda v: self.filter_form.grad_mult(
            st, v.double()).float(), b.float(),
            M=lambda r: self.filter_gmg(r.double()).float(),
            tol=self.lin_tol, maxiter=self.lin_maxiter)
        return x.double(), its

    monkeypatch.setattr(mmto.FilteredSiMPL, "filter_solve", f32)
    line = _run(False)
    assert line["correct"] is False
    assert line["check"]["filter_residual"]["value"] > \
        line["check"]["filter_residual"]["limit"]


def test_a_bisection_stopped_early_is_not_correct(monkeypatch):
    project = mmto.FilteredSiMPL.project

    def early(self, psi):
        tol, self.proj_tol = self.proj_tol, 1e-6
        try:
            return project(self, psi)
        finally:
            self.proj_tol = tol

    monkeypatch.setattr(mmto.FilteredSiMPL, "project", early)
    line = _run(False)
    assert line["correct"] is False
    assert line["check"]["step"]["value"] > line["check"]["step"]["limit"]
