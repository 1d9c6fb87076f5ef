"""The port's tracing and profiling (``mfem_ad_tpu_torch.utils.profiling``):
the per-phase cost table, its synchronisation, the torch.profiler trace
(of a whole block, or of the second iteration a block marks) and the
phases Newton records, as ``tests/test_profiling.py`` checks them for the
JAX package."""

import json
import os
import time

import numpy as np
import torch

from mfem_ad_tpu_torch.models import poisson
from mfem_ad_tpu_torch.utils import profiling


def test_phase_accumulates_and_nests():
    profiling.reset()
    with profiling.phase("outer"):
        with profiling.phase("inner"):
            time.sleep(0.02)
        with profiling.phase("inner"):
            time.sleep(0.02)
        time.sleep(0.01)
    stats = profiling.cost_table()
    assert stats["inner"].count == 2
    assert stats["outer"].count == 1
    assert stats["inner"].total_s >= 0.04
    assert stats["outer"].total_s >= stats["inner"].total_s
    # exclusive time excludes the nested phases
    assert stats["outer"].self_s <= (
        stats["outer"].total_s - stats["inner"].total_s + 1e-6
    )
    table = profiling.format_cost_table()
    assert "outer" in table and "inner" in table and "per-call" in table
    profiling.reset()
    assert profiling.cost_table() == {}
    assert "no phases" in profiling.format_cost_table()


def test_phase_sync_takes_tensors_and_containers():
    profiling.reset()
    x = torch.ones((64, 64))
    with profiling.phase("matmul", sync=x @ x):
        pass
    with profiling.phase("matmul", sync={"a": [x, (x,)]}):
        pass
    assert profiling.cost_table()["matmul"].count == 2


def test_trace_none_is_noop_and_dir_traces(tmp_path):
    with profiling.trace(None):
        pass
    d = str(tmp_path / "trace")
    with profiling.trace(d):
        with profiling.phase("traced/matmul"):
            _ = torch.ones((32, 32)) @ torch.ones((32, 32))
    path = os.path.join(d, "trace.json")
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    assert any(e.get("name") == "traced/matmul" for e in events)


def test_trace_keeps_the_second_marked_iteration(tmp_path):
    """Where the traced block marks its outer iterations with ``step()``
    (``PGSolver`` does), the trace holds the second one only."""
    d = str(tmp_path / "trace")
    with profiling.trace(d):
        for i in range(3):
            with profiling.phase(f"outer/{i}"):
                _ = torch.ones((16, 16)) @ torch.ones((16, 16))
            profiling.step()
    with open(os.path.join(d, "trace.json")) as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    assert "outer/1" in names
    assert "outer/0" not in names and "outer/2" not in names
    profiling.step()  # no active trace: a no-op


def test_newton_records_phases():
    """Newton annotates its residual, direction and line-search phases."""
    profiling.reset()
    _res, err, _pb = poisson.solve(ref_levels=0, n0=8, order=1, device="cpu")
    assert err < 2e-2
    stats = profiling.cost_table()
    for name in ("newton/residual", "newton/direction", "newton/line_search"):
        assert stats[name].count >= 1
    total = sum(s.total_s for s in stats.values())
    assert np.isfinite(total) and total > 0.0
