"""CPU tests of the ex5 cell (``gradient-obstacle-ex5.pg4``) at a tiny
size, with the clock stubbed: a whole run traced and untraced prints a
well-formed line; the plain reference imports nothing of the program or
of JAX; a planted fault (the Hellinger term's sign flipped) comes out not
correct.

    python -m pytest fembench/tests/test_fembench_ex5.py -q
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
from mfem_ad_tpu_torch import pg  # noqa: E402

from test_fembench_harness import StubClock  # noqa: E402

CELL = "gradient-obstacle-ex5.pg4"
TINY = {"ref_levels": 1, "n0": 2, "n": 4}


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
        # no device here: the device and span readers stay silent
        want = {m["name"] for m in harness.metrics_of(bench, CELL, True)}
        assert got == want - {"device_idle.ex5", "ldu_apply_ms.ex5"}
        assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
        m = line["metrics"]
        assert m["fgmres_per_direction.ex5"]["value"] >= 1
        assert m["ldu_cg_per_apply.ex5"]["value"] >= 3
        assert m["sigma_factor_s.ex5"]["value"] > 0
    else:
        assert got == {"setup_s"}
    assert set(line["check"]) == {"residual", "iterations_missing"}
    for c in line["check"].values():
        assert c["value"] <= c["limit"]


def test_reference_imports_nothing_of_the_program():
    path = os.path.join(BENCH, "reference", "gradient-obstacle-ex5.py")
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


def test_a_flipped_hellinger_sign_is_not_correct(monkeypatch):
    energy = pg.HellingerEntropy.energy
    monkeypatch.setattr(pg.HellingerEntropy, "energy",
                        lambda self, x, p: -energy(self, x, p))
    assert _run(False)["correct"] is False
