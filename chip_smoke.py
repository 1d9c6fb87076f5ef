"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the hand-written CUDA kernel from the sources in this checkout and
drives the port's main path through its public entry points:

  A. the element-Jacobian kernel against its plain PyTorch version at
     3x3 and 511x509 Q1 elements, f64 and f32, neo-Hookean and linear
     elasticity;
  B. headline assembly: 512x512 Q1 quads, vdim=2, neo-Hookean, f32
     (262,144 elements) through ``ADBlockIntegrator.element_jacobians``
     with the default route, then kernel and plain timings;
  C. Newton–CG (Jacobi-preconditioned, matrix-free) on the same 512x512
     mesh in f64 with ex3's boundary conditions and a scaled load, and the
     ex3 model at its default size.

Every phase checks its results and raises on failure.  The kernel's launch
count is reset just before the main path (B and C) and read just after.
The last line of output is a JSON object naming the device; the line
before it lists the kernels with their launch counts and timings.  There
is no CPU path: without a CUDA device the script exits with an error.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

from mfem_ad_tpu_torch import mesh as M
from mfem_ad_tpu_torch.ad import LinearElasticityEnergy, NeoHookeanEnergy
from mfem_ad_tpu_torch.adeval import ADEval
from mfem_ad_tpu_torch.fespace import FESpace
from mfem_ad_tpu_torch.forms import LinearForm, NonlinearForm
from mfem_ad_tpu_torch.integrator import ADBlockIntegrator
from mfem_ad_tpu_torch.models import elasticity
from mfem_ad_tpu_torch.ops import fused_jacobian as fj
from mfem_ad_tpu_torch.solvers import NewtonOptions, newton

MODE = ADEval.GRAD | ADEval.VECTOR
TOL = {torch.float64: 1e-12, torch.float32: 1e-5}  # x max|A|
HEADLINE_N = 512
NH_SCALE = 0.05  # body-force scale for phase C: max |grad u| ~ 0.1
# Random states u = AMP/n * N(0, 1) on an n x n mesh.  bench.py's 0.2/n
# gives det F <= 0 at some quadrature points of the 512x512 mesh (seed 0:
# min det F = -0.47), where log det F is NaN; 0.1/n keeps min det F near
# 0.2 at 511x509 and 512x512.
AMP = 0.1


def log(msg: str):
    print(msg, flush=True)


def cuda_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    """Median of per-call CUDA-event timings, in ms, after warm-up."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def seeded(n: int, scale: float, seed: int, dtype, device):
    rng = np.random.default_rng(seed)
    return torch.as_tensor(scale * rng.standard_normal(n), dtype=dtype,
                           device=device)


def phase_a(dev):
    """Kernel against plain version, ragged and large, both types and
    energies."""
    worst = 0.0
    for nx, ny in ((3, 3), (511, 509)):
        fes = FESpace(M.make_cartesian_2d(nx, ny), 1, vdim=2)
        for energy in (NeoHookeanEnergy, LinearElasticityEnergy):
            for dtype in (torch.float64, torch.float32):
                intg = ADBlockIntegrator(energy(2, 1.0, 1.0), [fes], [MODE],
                                         device=dev, dtype=dtype)
                u = seeded(fes.ndof, AMP / max(nx, ny), 1, dtype, dev)
                before = fj.fused_element_jacobian.launches
                A = intg.element_jacobians([u], route="kernel")
                A_plain = fj.fused_element_jacobian_plain(
                    intg.f, *fj.kernel_inputs(intg, [u]))
                torch.cuda.synchronize()
                if fj.fused_element_jacobian.launches != before + 1:
                    raise RuntimeError("kernel launch was not counted")
                if not bool(torch.isfinite(A).all()):
                    raise RuntimeError("kernel output is not finite")
                scale = float(A_plain.abs().max())
                err = float((A - A_plain).abs().max())
                rel = err / scale
                log(f"A {energy.__name__} {str(dtype)[6:]} {nx}x{ny}: "
                    f"max|A-plain| = {err:.3e} = {rel:.3e} max|A| "
                    f"(tol {TOL[dtype]:.0e})")
                if not rel <= TOL[dtype]:
                    raise AssertionError("kernel disagrees with plain")
                worst = max(worst, rel)
    torch.cuda.synchronize()
    log(f"phase A ok: worst relative error {worst:.3e}")


def headline_integrator(dev):
    fes = FESpace(M.make_cartesian_2d(HEADLINE_N, HEADLINE_N), 1, vdim=2)
    intg = ADBlockIntegrator(NeoHookeanEnergy(2, 1.0, 1.0), [fes], [MODE],
                             device=dev, dtype=torch.float32)
    u = seeded(fes.ndof, AMP / HEADLINE_N, 0, torch.float32, dev)
    return intg, u


def phase_b_main(intg, u):
    """Headline assembly through the default route."""
    A = intg.element_jacobians([u])
    torch.cuda.synchronize()
    ne = intg.tables["edof"][0].shape[0]
    if tuple(A.shape) != (ne, 8, 8) or not bool(torch.isfinite(A).all()):
        raise AssertionError(f"bad headline output {tuple(A.shape)}")
    scale = float(A.abs().max())
    asym = float((A - A.transpose(1, 2)).abs().max())
    if not asym <= TOL[torch.float32] * scale:
        raise AssertionError(f"A not symmetric: {asym:.3e} vs {scale:.3e}")
    return A, asym / scale


def neohookean_ex3(dev):
    """ex3's clamped-left boundary and body force (scaled by NH_SCALE),
    neo-Hookean, 16x16 refined 5 times = 512x512 Q1, f64."""
    m = M.make_cartesian_2d(16, 16).uniform_refine(5)
    fes = FESpace(m, 1, vdim=2)
    form = NonlinearForm(fes, device=dev, dtype=torch.float64)
    form.add_ad_integrator(NeoHookeanEnergy(2, 1.0, 1.0), MODE)
    ess = np.zeros(m.max_bdr_attribute())
    ess[3] = 1
    form.set_essential_bc([ess])
    load = NH_SCALE * LinearForm(fes, lambda x: np.ones(2)).assemble()
    load[np.asarray(fes.essential_dofs(ess))] = 0.0
    return form, fes, torch.as_tensor(load, device=dev)


def phase_c_main(form, fes, b):
    opts = NewtonOptions(
        abs_tol=0.0, rel_tol=1e-10, max_iter=6, lin_solver="cg",
        lin_tol=1e-10, lin_maxiter=20000, preconditioner="jacobi",
        # the default 200-iteration/1% floor exit stops Jacobi-CG on this
        # 512x512 problem before its residual starts to fall
        lin_stall_window=None,
    )
    x0 = torch.zeros(fes.ndof, dtype=torch.float64, device=b.device)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = newton(form, x0, b=b, opts=opts)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    h = res.history
    log(f"C newton 512x512 f64: history {[f'{v:.6e}' for v in h]}")
    log(f"C cg iterations per step {res.lin_iters}; converged "
        f"{res.converged}; wall {wall:.3f} s")
    if not (res.converged or h[-1] <= 1e-8 * h[0]):
        raise AssertionError("Newton–CG neither converged nor dropped 1e-8")
    g = form.integrators[0].x_qp([res.x])
    det = (1 + g[..., 0]) * (1 + g[..., 3]) - g[..., 1] * g[..., 2]
    if not bool(torch.isfinite(det).all()) or float(det.min()) <= 0:
        raise AssertionError(f"det F <= 0: min {float(det.min())}")
    log(f"C det F in [{float(det.min()):.6f}, {float(det.max()):.6f}], "
        f"max|grad u| {float(g.abs().max()):.4f}")
    return res, wall


def phase_c_breakdown(form, x):
    """Per-call device times of the Newton pieces at the solution."""
    state = form.grad_state(x)
    v = seeded(x.numel(), 1.0, 2, x.dtype, x.device)
    ms = {
        "mult": cuda_ms(lambda: form.mult(x), reps=5),
        "grad_state": cuda_ms(lambda: form.grad_state(x), reps=5),
        "grad_diag": cuda_ms(lambda: form.grad_diag(state), reps=5),
        "grad_mult": cuda_ms(lambda: form.grad_mult(state, v)),
    }
    log("C per call: " + ", ".join(f"{k} {t:.4f} ms" for k, t in ms.items()))


def phase_b_timing(intg, u, A_main):
    """Kernel vs plain version at the headline shape, and the routes."""
    ne = intg.tables["edof"][0].shape[0]
    args = fj.kernel_inputs(intg, [u])
    A_k = fj.fused_element_jacobian(intg.f, *args)
    A_p = fj.fused_element_jacobian_plain(intg.f, *args)
    torch.cuda.synchronize()
    err = float((A_k - A_p).abs().max())
    scale = float(A_p.abs().max())
    if not err <= TOL[torch.float32] * scale:
        raise AssertionError(f"headline kernel vs plain {err:.3e}")
    if not torch.equal(A_k, A_main):
        raise AssertionError("repeat kernel call differs from the main path")
    del A_k, A_p
    # order: plain, kernel, kernel, plain
    p1 = cuda_ms(lambda: fj.fused_element_jacobian_plain(intg.f, *args))
    k1 = cuda_ms(lambda: fj.fused_element_jacobian(intg.f, *args))
    k2 = cuda_ms(lambda: fj.fused_element_jacobian(intg.f, *args))
    p2 = cuda_ms(lambda: fj.fused_element_jacobian_plain(intg.f, *args))
    k_ms, p_ms = min(k1, k2), min(p1, p2)
    e2e_k = cuda_ms(lambda: intg.element_jacobians([u]))
    e2e_t = cuda_ms(lambda: intg.element_jacobians([u], route="two_stage"))
    log(f"B kernel {k1:.4f}/{k2:.4f} ms, plain {p1:.4f}/{p2:.4f} ms "
        f"({ne} elements)")
    log(f"B element_jacobians_per_sec kernel {ne / (k_ms / 1e3):.6e}, "
        f"plain {ne / (p_ms / 1e3):.6e}")
    log(f"B element_jacobians end to end: route auto {e2e_k:.4f} ms "
        f"({ne / (e2e_k / 1e3):.6e}/s), two_stage {e2e_t:.4f} ms "
        f"({ne / (e2e_t / 1e3):.6e}/s)")
    return err, k_ms, p_ms


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()
    log(f"gpu: {smi[0]}")
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)}")
    if torch.backends.cuda.matmul.allow_tf32:
        raise AssertionError("TF32 matmuls are on")
    if torch.get_float32_matmul_precision() != "highest":
        raise AssertionError("float32 matmul precision is not 'highest'")

    t0 = time.perf_counter()
    report = fj.build_library()
    ptxas = [ln.strip() for ln in report.splitlines()
             if "registers" in ln or "spill" in ln]
    log(f"build {time.perf_counter() - t0:.1f} s: " + " | ".join(ptxas))

    phase_a(dev)

    intg, u = headline_integrator(dev)
    form, fes, b = neohookean_ex3(dev)
    fj.fused_element_jacobian.launches = 0
    A_main, asym = phase_b_main(intg, u)
    res, wall = phase_c_main(form, fes, b)
    torch.cuda.synchronize()
    launches = fj.fused_element_jacobian.launches
    if launches < 1:
        raise AssertionError("the main path never launched the kernel")
    log(f"phase B ok: {tuple(A_main.shape)} finite, symmetric to "
        f"{asym:.3e} max|A|, kernel launches on the main path {launches}")
    log("phase C ok")

    phase_c_breakdown(form, res.x)
    err, k_ms, p_ms = phase_b_timing(intg, u, A_main)
    del A_main

    ex3, _ = elasticity.solve(device=dev)
    torch.cuda.synchronize()
    log(f"C ex3 model (default size): history {ex3.history} cg "
        f"{ex3.lin_iters} converged {ex3.converged}")
    if not ex3.converged:
        raise AssertionError("ex3 did not converge")

    print(json.dumps({"kernels": [{
        "name": "fused_element_jacobian",
        "route": "cuda",
        "source": "mfem_ad_tpu_torch/csrc/fused_jacobian.cu",
        "replaces": "mfem_ad_tpu/ops/fused_jacobian.py:80",
        "launches": launches,
        "max_abs_err": err,
        "ms": k_ms,
        "plain_ms": p_ms,
    }]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
