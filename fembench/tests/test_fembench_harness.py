"""CPU tests of the benchmark harness: every cell end to end at a tiny size
with the clock stubbed, the pieces found by name, the frozen counts, and
the module checks (nothing of JAX or the JAX package loaded; no reference
importing the program).

    python -m pytest fembench/tests -q
"""

import ast
import glob
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

# tiny sizes of each configuration, for the CPU
TINY = {"neohookean-q1-512": {"n": 8, "gmg": {"coarse_n": 2, "levels": 3}},
        "neohookean-3d-q2-32": {"n": 2},
        "obstacle-ex4": {"ref_levels": 1, "n0": 2, "n": 4}}
CELLS = [w["name"] for w in harness.benchmark()["workloads"]]


def tiny(cell):
    return TINY[harness.load_json("workloads", cell)["config"]]


class StubClock:
    """A clock that moves one second per reading: the window holds one
    unit, and no number depends on this host's speed."""

    def __init__(self):
        self.t = 0.0

    def __call__(self):
        self.t += 1.0
        return self.t


@pytest.fixture(autouse=True, scope="module")
def few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("cell", CELLS)
def test_cell_prints_a_well_formed_line(cell, trace):
    out = run.run_cell(cell, 2**31 + 17, 0.5, bool(trace), "cpu",
                       cfg_override=tiny(cell), clock=StubClock())
    line = json.loads(json.dumps(out))
    assert list(line)[-1] == "check"
    assert {"correct", "attempted", "failed", "metrics", "device"} <= set(line)
    assert line["correct"] is True and line["failed"] == 0
    assert line["attempted"] == 1
    bench = harness.benchmark()
    want = {m["name"] for m in harness.metrics_of(bench, cell, bool(trace))}
    got = set(line["metrics"])
    if trace:
        # no device here: the device readers find nothing and stay silent
        assert got <= want
        assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
        assert {"busy_s", "window_s"} <= set(line["device"])
    else:
        # without a card the readings of the device are silent here too
        assert got == {m["name"] for m in harness.metrics_of(bench, cell, False)
                       if m["source"] != "device_trace"}
    for m in line["metrics"].values():
        assert set(m) == {"value", "unit"} and m["value"] == m["value"]
    for c in line["check"].values():
        assert set(c) == {"value", "limit"} and c["value"] <= c["limit"]


def test_pieces_are_found_by_name():
    bench = harness.benchmark()
    assert set(bench) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    for c in bench["configs"]:
        assert os.path.isfile(os.path.join(ROOT, c["file"]))
        assert harness.load_json("configs", c["name"])["name"] == c["name"]
        cfg = harness.load_json("configs", c["name"])
        assert hasattr(harness.load_module(
            "reference", cfg.get("reference", c["name"])), "__file__")
    for w in bench["workloads"]:
        wl = harness.load_json("workloads", w["name"])
        assert wl["config"] == w["config"] and wl["traffic"] == w["traffic"]
        assert hasattr(harness.load_module("traffic", w["traffic"]),
                       "Traffic")
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert callable(harness.load_module("metrics", m["name"]).read)
    for m in bench["per_layer"]:
        assert m["moves"] in {e["name"] for e in bench["end_to_end"]}
    with pytest.raises(FileNotFoundError):
        harness.load_module("metrics", "no_such_metric")
    # a dotted name falls back to the reader of the part before the dot
    assert (harness.load_module("metrics", "vcycle_ms.pg")
            is harness.load_module("metrics", "vcycle_ms"))
    with pytest.raises(FileNotFoundError):
        harness.load_module("metrics", "no_such_metric.pg")


def test_metrics_of_a_cell():
    bench = harness.benchmark()
    cell = "neohookean-3d-q2-32.assemble"
    assert {m["name"] for m in harness.metrics_of(bench, cell, False)} == {
        "jacobians_per_s", "setup_s"}
    assert "jacobian_roofline" in {
        m["name"] for m in harness.metrics_of(bench, cell, True)}
    assert "vcycle_ms.newton" not in {
        m["name"] for m in harness.metrics_of(bench, cell, True)}


def test_counts_at_the_headline():
    counts = harness.load_module("counts", "jacobian")
    cfg = harness.load_json("configs", "neohookean-q1-512")
    s = counts.shapes(cfg)
    assert counts.fma_per_element(s) == 2448
    assert counts.bytes_per_call(s, "float32") == (
        262144 * 64 * 4 + 526338 * 4)
    least, what = counts.least_seconds(cfg, "float32")
    assert what == "bytes"
    assert least == pytest.approx((262144 * 64 * 4 + 526338 * 4) / 3.35e12)
    # 3D Q2 at 32^3: 4^3 points, 27 nodes, vdim 3, 81 x 81 matrices
    cfg = harness.load_json("configs", "neohookean-3d-q2-32")
    s = counts.shapes(cfg)
    assert counts.fma_per_element(s) == 64 * (9 * 27 * 27 * 9 + 3 * 3 * 27)
    assert counts.fma_per_element(s) == 3794688
    assert counts.bytes_per_call(s, "float32") == (
        32768 * 81 * 81 * 4 + 3 * 65 ** 3 * 4)
    least, what = counts.least_seconds(cfg, "float32")
    assert what == "operations"
    assert least == pytest.approx(2 * 3794688 * 32768 / 67e12)


def test_forbidden_names_compare_whole_top_level_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "mfem_ad_tpu_torch_fake", sys)
    monkeypatch.setitem(sys.modules, "jaxtyping_fake.sub", sys)
    assert harness.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "mfem_ad_tpu.sub", sys)
    assert harness.forbidden_modules() == ["mfem_ad_tpu"]


def test_a_run_loads_no_jax():
    """A whole tiny run in a fresh process loads nothing of JAX, Flax or
    the JAX package."""
    code = (
        "import sys; sys.path[:0] = [%r, %r]\n"
        "import torch; torch.set_num_threads(2)\n"
        "import run, harness\n"
        "run.run_cell('neohookean-3d-q2-32.assemble', 5, 0.1, True, 'cpu',"
        " cfg_override={'n': 2})\n"
        "run.run_cell('obstacle-ex4.pg2', 5, 0.1, False, 'cpu',"
        " cfg_override={'ref_levels': 1, 'n0': 2, 'n': 4})\n"
        "print(harness.forbidden_modules())\n"
        "print('mfem_ad_tpu_torch' in sys.modules)\n" % (BENCH, ROOT))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.split() == ["[]", "True"]


def _imported_top_names(path):
    names = set()
    for node in ast.walk(ast.parse(open(path).read())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module:
            names.add(node.module.split(".")[0])
    return names


def test_references_import_nothing_of_the_program():
    refs = glob.glob(os.path.join(BENCH, "reference", "*.py"))
    assert refs
    for path in refs:
        assert not _imported_top_names(path) & {
            "mfem_ad_tpu_torch", "mfem_ad_tpu", "jax", "harness"}, path
    code = ("import importlib.util, sys, glob\n"
            "for p in sorted(glob.glob(%r)):\n"
            "    s = importlib.util.spec_from_file_location('r', p)\n"
            "    s.loader.exec_module(importlib.util.module_from_spec(s))\n"
            "print(sorted(m for m in sys.modules if m.split('.')[0] in "
            "('mfem_ad_tpu_torch', 'mfem_ad_tpu', 'jax')))\n"
            % os.path.join(BENCH, "reference", "*.py"))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip() == "[]"


def test_no_card_no_result():
    """Without a CUDA device the command fails and prints no result."""
    out = subprocess.run(
        [sys.executable, os.path.join(BENCH, "run.py"), "--workload",
         CELLS[0], "--seed", "1", "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, timeout=120, cwd=ROOT,
        env={**os.environ, "CUDA_VISIBLE_DEVICES": ""})
    assert out.returncode != 0
    assert out.stdout == ""
