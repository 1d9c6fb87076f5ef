"""The output check fails what it has to fail.

- The control of each cell (the reference in the program's place in the
  precision below the configuration's, or the program's own float32 path)
  reads over the cell's limit, at a tiny size on the CPU; the program at
  the same size reads under it.  ``test_control_at_the_cells_size`` does
  the same at the cell's own size on a card.
- A whole run with the timed path broken underneath comes out not
  correct, once for each fault a cell can have: a solve that returns its
  state unchanged, half of an assembly's elements left out, an answer
  altered where it is produced.  (No cell spans chips, so there is no
  exchange to leave out.)

    python -m pytest fembench/tests -q
"""

import os
import sys

import pytest
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
BENCH = os.path.dirname(HERE)
sys.path[:0] = [BENCH, os.path.dirname(BENCH)]

import readings  # noqa: E402
import run  # noqa: E402
from mfem_ad_tpu_torch import pg, solvers  # noqa: E402
from mfem_ad_tpu_torch.integrator import ADBlockIntegrator  # noqa: E402

from test_fembench_harness import CELLS, StubClock, tiny  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return "cuda"


def _over(rec) -> bool:
    """Some compared number over its limit (NaN counts as over)."""
    return any(not c["value"] <= c["limit"] for c in rec["check"].values())


@pytest.mark.parametrize("cell", CELLS)
def test_control_fails_program_passes(cell):
    seeds = [2**31 + 3, 2**31 + 4, 2**31 + 5]
    prog = list(readings.readings(cell, seeds, False, 1, "cpu", tiny(cell)))
    ctl = list(readings.readings(cell, seeds, True, 1, "cpu", tiny(cell)))
    assert not any(_over(r) for r in prog), prog
    assert all(_over(r) for r in ctl), ctl


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_control_at_the_cells_size(cell, card):
    seeds = [2**31 + 7, 2**31 + 8, 2**31 + 9]
    assert not any(_over(r) for r in readings.readings(
        cell, seeds, False, 1, card))
    assert all(_over(r) for r in readings.readings(
        cell, seeds, True, 1, card))


def _broken_run(cell, monkeypatch, obj, name, wrapper):
    monkeypatch.setattr(obj, name, wrapper(getattr(obj, name)))
    return run.run_cell(cell, 2**31 + 11, 0.5, False, "cpu",
                        cfg_override=tiny(cell), clock=StubClock())


def _unchanged(newton):
    def broken(form, x0, b=None, fields=None, opts=None):
        return solvers.NewtonResult(x=x0, converged=True, iterations=0,
                                    final_norm=0.0)
    return broken


def _altered(newton):
    def broken(*args, **kwargs):
        res = newton(*args, **kwargs)
        x = res.x.clone()
        x[x.numel() // 2] += 1e-4 * float(x.abs().max())
        res.x = x
        return res
    return broken


FAULTS = [
    ("neohookean-q1-512.newton", solvers, "newton", _unchanged),
    ("neohookean-q1-512.newton", solvers, "newton", _altered),
    ("obstacle-ex4.pg2", pg, "newton", _unchanged),
    ("obstacle-ex4.pg2", pg, "newton", _altered),
]


@pytest.mark.parametrize("cell,obj,name,fault", FAULTS,
                         ids=[f"{c}-{f.__name__}" for c, _, _, f in FAULTS])
def test_a_broken_solve_is_not_correct(cell, obj, name, fault, monkeypatch):
    assert run.run_cell(cell, 2**31 + 11, 0.5, False, "cpu",
                        cfg_override=tiny(cell),
                        clock=StubClock())["correct"] is True
    assert _broken_run(cell, monkeypatch, obj, name, fault)["correct"] is False


def _half_left_out(element_jacobians):
    def broken(self, *args, **kwargs):
        A = element_jacobians(self, *args, **kwargs).clone()
        A[A.shape[0] // 2:] = 0.0
        return A
    return broken


def _entry_altered(element_jacobians):
    def broken(self, *args, **kwargs):
        A = element_jacobians(self, *args, **kwargs).clone()
        A[A.shape[0] // 3, 1, 2] += 1e-3 * float(A.abs().max())
        return A
    return broken


@pytest.mark.parametrize("fault", [_half_left_out, _entry_altered])
def test_a_broken_assembly_is_not_correct(fault, monkeypatch):
    cell = "neohookean-3d-q2-32.assemble"
    out = _broken_run(cell, monkeypatch, ADBlockIntegrator,
                      "element_jacobians", fault)
    assert out["correct"] is False
