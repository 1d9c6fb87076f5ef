"""Port parity, the models, examples, utilities and bench of the port.

- ``models.minimal_surface`` (eps a runtime field) against the JAX
  package's with the dense direct solver: the same Newton iterations per
  continuation pass, areas and iterates to 1e-10;
- ``models.poisson`` and ``models.elasticity`` with ``lin_solver="dense"``
  against the JAX package's;
- the ex1-ex3 examples' ``main()`` with ``--device cpu`` (ParaView export
  included);
- ``utils``: TableLogger, checkpoint and VTU round trips, tensors
  accepted;
- ``bench``: the headline line's four keys and a sweep row at a tiny size
  on the CPU, with ``bench.call_ms`` (CUDA events) stubbed.
"""

import json
import os

import numpy as np
import pytest
import torch

from mfem_ad_tpu import mesh as JM
from mfem_ad_tpu.fespace import FESpace as JFESpace
from mfem_ad_tpu.models import elasticity as jelasticity
from mfem_ad_tpu.models import minimal_surface as jms
from mfem_ad_tpu.models import poisson as jpoisson
from mfem_ad_tpu.utils import write_vtu as jwrite_vtu
from mfem_ad_tpu_torch import bench
from mfem_ad_tpu_torch import mesh as PM
from mfem_ad_tpu_torch.examples import ex1, ex2, ex3
from mfem_ad_tpu_torch.fespace import FESpace as PFESpace
from mfem_ad_tpu_torch.models import elasticity, minimal_surface, poisson
from mfem_ad_tpu_torch.utils import (
    TableLogger,
    load_checkpoint,
    save_checkpoint,
    write_vtu,
)
from mfem_ad_tpu_torch.utils.logger import _is_root


def _rel(actual, ref):
    actual, ref = np.asarray(actual), np.asarray(ref)
    return np.abs(actual - ref).max() / max(np.abs(ref).max(), 1e-300)


def test_minimal_surface_continuation_matches_jax():
    kw = dict(order=1, ref_levels=1, continuation_steps=3,
              lin_solver="dense")
    xj, hj, _ = jms.solve(**kw)
    xp, hp, pb = minimal_surface.solve(**kw, device="cpu")
    assert pb.form.integrators[0].field_kinds == {"eps": ("scalar", 1)}
    assert [(h.eps, h.iterations) for h in hp] == [(e, i) for e, i, _ in hj]
    for h, (_, _, area) in zip(hp, hj):
        assert h.converged and h.lin_iters == []
        assert abs(h.area - area) <= 1e-10 * area
    assert hp[0].area > hp[1].area > hp[2].area
    assert _rel(xp.numpy(), xj) <= 1e-10


def test_poisson_dense_matches_jax():
    rj, ej, _ = jpoisson.solve(order=2, ref_levels=0, lin_solver="dense",
                               n0=4)
    rp, ep, _ = poisson.solve(order=2, ref_levels=0, lin_solver="dense",
                              n0=4, device="cpu")
    assert rp.converged and rp.iterations == rj.iterations
    assert _rel(rp.x.numpy(), rj.x) <= 1e-12
    assert abs(ep - ej) <= 1e-10 * ej


def test_elasticity_dense_matches_jax():
    rj, _ = jelasticity.solve(order=1, ref_levels=0, lin_solver="dense")
    rp, _ = elasticity.solve(order=1, ref_levels=0, lin_solver="dense",
                             device="cpu")
    assert rp.converged and rp.iterations == rj.iterations
    assert _rel(rp.x.numpy(), rj.x) <= 1e-12


@pytest.mark.parametrize("solver", ["cg", "dense", "minres", "gmres"])
def test_ex1_main_on_cpu(solver, capsys):
    res, err, _ = ex1.main(["-o", "2", "-r", "0", "--solver", solver,
                            "--device", "cpu"])
    assert res.converged and 0 < err < 1e-3
    assert "Error:" in capsys.readouterr().out


def test_ex1_solvers_agree():
    xs = {s: ex1.main(["-r", "0", "--solver", s, "--device", "cpu"])[0].x
          for s in ("cg", "dense", "minres")}
    for s in ("dense", "minres"):
        assert _rel(xs[s].numpy(), xs["cg"].numpy()) <= 1e-8


def test_ex2_main_on_cpu(capsys, tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    x, hist, pb = ex2.main(["-r", "0", "-n", "2", "--solver", "minres",
                            "-pv", "--device", "cpu"])
    out = capsys.readouterr().out
    assert "pass  1: eps=5.000e-01" in out and "pass  2" in out
    assert all(h.converged for h in hist) and hist[0].lin_iters
    assert (tmp_path / "ad-minimalsurface.vtu").exists()


@pytest.mark.parametrize("dim", [2, 3])
def test_ex3_main_on_cpu(dim, capsys):
    args = ["-r", "0", "-d", str(dim), "--device", "cpu"]
    res, pb = ex3.main(args + ["--solver", "minres"])
    ref, _ = ex3.main(args + ["--solver", "cg"])
    assert res.converged and ref.converged
    assert _rel(res.x.numpy(), ref.x.numpy()) <= 1e-8
    assert pb.space.vdim == dim
    assert "converged: True" in capsys.readouterr().out


def test_table_logger_csv(tmp_path, capsys):
    assert _is_root()  # no torch.distributed group here
    vals = {"it": 0, "res": 1.0}
    csv = str(tmp_path / "log.csv")
    tl = TableLogger().append("it", (vals, "it")).append(
        "res", lambda: torch.tensor(vals["res"]).item())
    tl.save_when_print(csv)
    for i in range(3):
        vals["it"], vals["res"] = i, 10.0 ** (-i)
        tl.print()
    tl.close()
    out = capsys.readouterr().out
    assert "it" in out and f"{1e-2:14.6e}" in out
    lines = open(csv).read().strip().splitlines()
    assert lines[0] == "it,res" and len(lines) == 4


def test_checkpoint_roundtrip_with_tensors(tmp_path):
    path = str(tmp_path / "state")
    u = torch.as_tensor(np.random.default_rng(0).standard_normal(17))
    final = save_checkpoint(path, {"u": u, "psi": 2 * u.numpy()},
                            {"alpha": 2.0, "iter": 3})
    assert final.endswith(".npz") and os.path.exists(final + ".json")
    arrays, meta = load_checkpoint(path)
    np.testing.assert_array_equal(arrays["u"], u.numpy())
    np.testing.assert_array_equal(arrays["psi"], 2 * u.numpy())
    assert meta == {"alpha": 2.0, "iter": 3}


def test_write_vtu_matches_jax(tmp_path):
    """The same mesh and field written by both packages are the same
    file; the port takes a tensor."""
    fns = lambda x: x[0] + 2.0 * x[1]  # noqa: E731
    pm = PM.make_cartesian_2d(3, 2)
    pfes = PFESpace(pm, 2, vdim=2)
    jm = JM.make_cartesian_2d(3, 2)
    jfes = JFESpace(jm, 2, vdim=2)
    u = pfes.project(lambda x: np.stack([fns(x), -fns(x)]))
    jwrite_vtu(str(tmp_path / "j.vtu"), jm, {"u": u}, {"u": jfes})
    write_vtu(str(tmp_path / "p.vtu"), pm, {"u": torch.as_tensor(u)},
              {"u": pfes})
    text = (tmp_path / "p.vtu").read_text()
    assert text == (tmp_path / "j.vtu").read_text()
    assert 'NumberOfComponents="2"' in text and f"{3.0:.16g} " in text


def _stub_timer(monkeypatch):
    """``bench.call_ms`` times by CUDA events: on the CPU, call once and
    take 1 ms."""
    calls = []

    def call_ms(fn, reps=20, warmup=3):
        fn()
        calls.append(fn)
        return 1.0

    monkeypatch.setattr(bench, "call_ms", call_ms)
    return calls


def test_bench_headline_line_on_cpu(monkeypatch):
    calls = _stub_timer(monkeypatch)
    line = bench.headline(device="cpu", n=4)
    assert len(calls) == 1
    assert set(line) == {"metric", "value", "unit", "vs_baseline"}
    assert line["metric"] == "element_jacobians_per_sec"
    assert line["unit"] == "elem/s" and line["value"] == 16 / 1e-3
    assert line["vs_baseline"] == line["value"] / 1e7
    json.dumps(line)


def test_bench_sweep_row_on_cpu(monkeypatch):
    calls = _stub_timer(monkeypatch)
    assert len(bench.SWEEP) == 6
    assert bench.SWEEP[2] == (3, 2, 256) and bench.SWEEP[5] == (3, 3, 16)
    row = bench.sweep_row(2, 3, 2, device="cpu")
    assert row["elems"] == 8 and row["route"] == "two_stage"
    assert row["residual"] == row["jacobian"] == 8 / 1e-3
    assert len(calls) == 2  # residual and Jacobian; the AD route refuses
    # on the CPU both kernel routes refuse: the AD rate is not measured
    assert row["ad"] is None and "CUDA" in row["ad_refusal"]
    # 3D p2 two-stage takes the W0 GEMM: vdim^2 nd^2 nq sd^2 + nq vdim sd nd
    intg, _ = bench.build(2, 3, 2, device="cpu")
    fmas = 64 * (9 * 27 * 27 * 9 + 3 * 3 * 27)
    assert bench.fmas_per_element(intg, "two_stage") == fmas
    assert row["share"] == row["jacobian"] * 2 * fmas / 67e12
    text = bench.format_row(row)
    assert text.startswith("| p=2 | 3D | 8 |") and "refused" in text
