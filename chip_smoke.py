"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the hand-written CUDA element-Jacobian kernel from the sources in
this checkout (one nvcc per generated source, all started together): one
GEMM template, csrc/blocked_jacobian.cuh, instantiated three ways: closed
entries against the full W (vdim 1, sd n: the full-W kernel), the
nested-dual AD entries against the full W (the AD kernel), closed entries
against the blocked W0 (the blocked kernel).  Then it drives the port's
main paths through their public entry points:

  A. the full-W closed-entries instantiation against its plain PyTorch
     version at 3x3 and 511x509 Q1 elements, f64 and f32, neo-Hookean and
     linear elasticity;
  B. headline assembly: 512x512 Q1 quads, vdim=2, neo-Hookean, f32
     (262,144 elements) through ``ADBlockIntegrator.element_jacobians``
     with the default route (the full-W instantiation), then kernel and
     plain timings;
  C. Newton–CG (Jacobi-preconditioned, matrix-free) on the same 512x512
     mesh in f64 with ex3's boundary conditions and a scaled load, and the
     ex3 model at its default size;
  D. the AD instantiation (energies code-generated and differentiated by
     nested dual numbers):
     D1 against its plain PyTorch version at 3x3 and 511x509, f64 and f32,
        for Diffusion at p1 and p2, Mass, neo-Hookean on route="kernel_ad"
        (also against the closed-entries kernel) and a minimal-surface
        energy defined only in this script; an energy that does not trace
        is refused by name and the default route takes two-stage;
     D2 main path: ex1 Poisson at 512x512 Q1 and Q2, f32, through
        ``element_jacobians`` with the default route, and the headline
        neo-Hookean and 2D p2 vector neo-Hookean at 512x512 (n=4, nde=18)
        on route="kernel_ad";
     D3 kernel, plain, end-to-end and two-stage timings for each D2
        configuration, beside each one's bound and cuBLAS's time for the
        contraction GEMM alone;
     H  the host work around three ``element_jacobians`` calls (headline
        full-W and AD, Poisson Q2): CUDA-event time minus kernel device
        time, with the operands derived from the tables kept across calls
        and with them rebuilt on every call;
  E. the blocked-W0 instantiation (closed entries contracted per
     vdim-block pair with W0; 2D p>=2 and 3D):
     E1 against its plain PyTorch version in f64 and f32, neo-Hookean and
        linear elasticity, at 2D p2 3x3 and 511x509, 2D p3 3x3, 3D p1 3^3,
        63x64x65 and 29x31x33, 3D p2 3x2x2 and 13x11x9, and 3D p3 2^3 (the
        small ones also against the two-stage route), with min det F > 0.2
        asserted; and the two full-W instantiations at 37x29 and
        13x11x9, element counts that are multiples of none of their
        element tiles, f64 and f32;
     E2 main path: 2D p2 neo-Hookean 512x512, 3D p1 neo-Hookean 64^3 and
        ex3's 3D p2 linear elasticity at 32^3 (``models.elasticity``), f32,
        through ``element_jacobians`` with the default route;
     E3 kernel, plain, two-stage and bound for each E2 configuration, and
        cuBLAS's time for the contraction GEMM alone as a yardstick, beside
        the kernel's launch plan; every instantiation's registers and
        spills, and the register-bank conflicts of their main loops
        (``cuobjdump -sass``);
  F. the modules around the kernels:
     F1 ex2's minimal surface (eps a runtime field parameter) at 512x512
        p1 (263,169 dofs), f64, Jacobi-CG, 3 continuation passes through
        ``models.minimal_surface.solve``: Newton and CG iterations, area
        and wall time per pass; every pass converges, the area decreases;
     F2 two-stage element Jacobians (``hess_state`` then
        ``element_matrices``, whose GEMM is against W0) at 3D p1 64^3 and
        3D p2 32^3, f32, against the blocked kernel's A, with the end-to-
        end time, its two parts and cuBLAS's bare W0 GEMM;
     F3 the ex1-ex3 examples' ``main``: ex1's MMS rates at p = 1, 2, 3 over
        three refinements; ex1, ex2 (10 passes), ex3 2D and ex3 3D p1 with
        ``--solver dense`` and ``minres`` against ``cg``; the dense
        Jacobian against the matrix-free action at 3D p2;
     F4 the bench (``mfem_ad_tpu_torch.bench``): its sweep table (with
        the unstructured triangle and tet rows) and its headline line;
  G. geometric multigrid and the LVPP obstacle path (no kernel):
     G1 Newton on phase C's problem (512x512 neo-Hookean, f64) with CG
        preconditioned by a nonlinear GMG over 6 levels (512 -> 16 cells):
        CG iterations per step and wall time against phase C's Jacobi-CG,
        the largest difference of the two solutions, one V-cycle's time;
     G2 ex4's problem at the reference defaults with the smoke flags
        (order 2, ref 3, 83,681 dofs, -rule 2 -a0 0.1 -ar 2), Schur + the
        shifted hp-GMG, its first 10 PG iterations (of 38: PR 9 ran it to
        convergence three times with equal counts): Newton iterations,
        CG per Newton step, the lambda-diff trajectory, wall time; and
        ex4's ``main`` with the smoke flags and the dense solver at order
        2 ref 0, run to convergence within the bounds;
     G3 ex4's problem at ref 5 (1,333,121 dofs), 3 PG iterations: time per
        iteration, CG per Newton step against G2's, and one direction's
        grad_state, Schur arrays and CG;
     G4 the Schur direction against the dense direct solver, order 2 ref
        1, 6 fixed PG iterations (12 in PR 9);
  H. unstructured assembly and the gradient-constrained obstacle (no
     kernel: element-varying geometry and two-space forms take two-stage):
     H1 512^2 cells of triangles (524,288), p1 vdim 2 neo-Hookean f32: the
        h1t dof exchange against the same mesh with its structure dropped
        and Morton-sorted (generic gather, transpose-gather scatter, the
        geometry pullback): residual and element Jacobians equal after
        the permutation, both timed; the transpose-gather scatter against
        ``index_add_``; the routes ``auto_route`` names and why;
     H2 Kuhn tets 32^3 p1 and 16^3 p2, vdim 3 neo-Hookean f32: residual
        and two-stage times, element Jacobians against ``hess_mult``;
     H3 perturbed quads 512^2, p1 vdim 2 (element-varying _invj and w):
        at zero perturbation the pullback on an unstructured copy against
        the structured path; at the tests' perturbation a central-
        difference check of the Jacobian (f64);
     H4 ex1's MMS rates on triangles at p = 1, 2, 3; ex3 with --geom tri
        and --geom tet (cg against dense); ex4's obstacle on tets at the
        JAX test's size (Schur and dense, bounds asserted);
     H5 ex5's ``main`` at the reference defaults (order 2, ref 3, 39,043
        dofs, -rule 2 -a0 1 -ar 2) run to lambda diff < 1e-8: the LDU-
        FGMRES direction with the dense dual-Schur factor; PG, Newton and
        FGMRES counts, the factor's refreshes and their time, wall time,
        and the JAX regression test's checks of the constraint;
     H6 ex5's problem at ref 4 (154,883 dofs, 51,842 latent dofs: the
        Woodbury mode): the first Newton direction with FGMRES cut to 8
        iterations (a whole Woodbury direction runs hundreds, PERF.md):
        time per iteration and the residual they reach, beside H5's.

Kernel and plain times in the kernels line are device time per call from
torch.profiler (the kernel alone; every kernel of the plain version); the
log also gives CUDA-event times of whole calls, host work included.

Every phase checks its results and raises on failure.  Each kernel's
launch count is reset just before its main path (B and C for the full-W
instantiation, D2 for the AD one, E2 for the blocked one) and read just
after.  The last line of output is a JSON object naming the device; the
line before it lists the kernels with their launch counts, timings and
bounds.  There is no CPU path: without a CUDA device the script exits
with an error.
"""

from __future__ import annotations

import contextlib
import io
import json
import os
import re
import shutil
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from mfem_ad_tpu_torch import bench
from mfem_ad_tpu_torch.bench import call_ms
from mfem_ad_tpu_torch import mesh as M
from mfem_ad_tpu_torch.ad import (
    ADFunction,
    DiffusionEnergy,
    LinearElasticityEnergy,
    MassEnergy,
    NeoHookeanEnergy,
)
from mfem_ad_tpu_torch.adeval import ADEval
from mfem_ad_tpu_torch.fespace import FESpace
from mfem_ad_tpu_torch.forms import LinearForm, NonlinearForm
from mfem_ad_tpu_torch.integrator import ADBlockIntegrator
from mfem_ad_tpu_torch import solvers
from mfem_ad_tpu_torch.examples import ex1, ex2, ex3, ex4, ex5
from mfem_ad_tpu_torch.geometry import geom_factors, phys_dshape
from mfem_ad_tpu_torch.models import (
    elasticity,
    gradient_obstacle,
    minimal_surface,
    obstacle,
    poisson,
)
from mfem_ad_tpu_torch.multigrid import GMG, build_hierarchy
from mfem_ad_tpu_torch.ops import ad_jacobian as adj
from mfem_ad_tpu_torch.ops import blocked_jacobian as bj
from mfem_ad_tpu_torch.ops import fused_jacobian as fj
from mfem_ad_tpu_torch.ops import nvcc
from mfem_ad_tpu_torch.pg import PGStepSizeRule
from mfem_ad_tpu_torch.quadrature import TETRAHEDRON, TRIANGLE, get_rule
from mfem_ad_tpu_torch.solvers import NewtonOptions, newton
from mfem_ad_tpu_torch.utils import profiling

MODE = ADEval.GRAD | ADEval.VECTOR
TOL = {torch.float64: 1e-12, torch.float32: 1e-5}  # x max|A|
HEADLINE_N = 512
NH_SCALE = 0.05  # body-force scale for phase C: max |grad u| ~ 0.1
# Random states u = AMP/n * N(0, 1) on an n x n mesh.  bench.py's 0.2/n
# gives det F <= 0 at some quadrature points of the 512x512 mesh (seed 0:
# min det F = -0.47), where log det F is NaN; 0.1/n keeps min det F near
# 0.2 at 511x509 and 512x512.
AMP = 0.1
# Phase E's states: at 0.1/n, neo-Hookean at p>=2 has det F <= 0 at some
# points (3D p2 on 2^3: min det F = -0.07); 0.01/n keeps it above 0.6 at
# every E shape, and phase E1 asserts it for every neo-Hookean input.
AMP_BLOCKED = 0.01
# H100 SXM published peaks (NVIDIA data sheet, at 700 W): f32 and f64
# arithmetic outside the tensor cores (the bench's), and HBM3 bandwidth
PEAK_FLOPS = bench.PEAK_FLOPS
PEAK_BYTES = 3.35e12


class MinimalSurfaceEnergy(ADFunction):
    """sqrt(1 + g.g) + eps g.g with a static eps, scalar-unrolled: ex2's
    minimal-surface density, an energy the port's library does not
    define."""

    def __init__(self, eps: float = 0.05):
        super().__init__(2)
        self.eps = eps

    def energy(self, g, p):
        gg = g[0] * g[0] + g[1] * g[1]
        return torch.sqrt(gg + 1.0) + self.eps * gg


class DotEnergy(ADFunction):
    """0.5 g.g through torch.dot: the code generator refuses it."""

    def __init__(self):
        super().__init__(2)

    def energy(self, g, p):
        return 0.5 * torch.dot(g, g)


# D1 cases: name -> (energy factory, order, mode, vdim)
AD_CASES = {
    "diffusion_p1": (lambda: DiffusionEnergy(2), 1, ADEval.GRAD, 1),
    "diffusion_p2": (lambda: DiffusionEnergy(2), 2, ADEval.GRAD, 1),
    "mass_p1": (lambda: MassEnergy(1), 1, ADEval.VALUE, 1),
    "neohookean_p1": (lambda: NeoHookeanEnergy(2, 1.0, 1.0), 1, MODE, 2),
    "minimal_surface_p2": (lambda: MinimalSurfaceEnergy(), 2, ADEval.GRAD, 1),
}
D1_SIZES = ((3, 3), (511, 509))  # a ragged tile, and full width
# the trace of every energy D runs: (energy, parameter sizes)
AD_TRACES = (
    (DiffusionEnergy(2), {}),
    (DiffusionEnergy(3), {}),
    (MassEnergy(1), {}),
    (NeoHookeanEnergy(2, 1.0, 1.0), {"lambda": 1, "mu": 1}),
    (MinimalSurfaceEnergy(), {}),
)
# the closed-entries energies of the full-W instantiation (vdim = 1, sd = 4)
FULL_W_ENERGIES = (NeoHookeanEnergy(2, 1.0, 1.0),
                   LinearElasticityEnergy(2, 1.0, 1.0))


def log(msg: str):
    print(msg, flush=True)


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


def neohookean_ex3(dev, m=None):
    """ex3's clamped-left boundary and body force (scaled by NH_SCALE),
    neo-Hookean, Q1, f64, on ``m`` (default 16x16 refined 5 times =
    512x512)."""
    if m is None:
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
        "mult": call_ms(lambda: form.mult(x), reps=5),
        "grad_state": call_ms(lambda: form.grad_state(x), reps=5),
        "grad_diag": call_ms(lambda: form.grad_diag(state), reps=5),
        "grad_mult": call_ms(lambda: form.grad_mult(state, v)),
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
    p1 = call_ms(lambda: fj.fused_element_jacobian_plain(intg.f, *args))
    k1 = call_ms(lambda: fj.fused_element_jacobian(intg.f, *args))
    k2 = call_ms(lambda: fj.fused_element_jacobian(intg.f, *args))
    p2 = call_ms(lambda: fj.fused_element_jacobian_plain(intg.f, *args))
    k_ms, p_ms = min(k1, k2), min(p1, p2)
    e2e_k = call_ms(lambda: intg.element_jacobians([u]))
    e2e_t = call_ms(lambda: intg.element_jacobians([u], route="two_stage"))
    log(f"B kernel {k1:.4f}/{k2:.4f} ms, plain {p1:.4f}/{p2:.4f} ms "
        f"({ne} elements)")
    log(f"B element_jacobians_per_sec kernel {ne / (k_ms / 1e3):.6e}, "
        f"plain {ne / (p_ms / 1e3):.6e}")
    log(f"B element_jacobians end to end: route auto {e2e_k:.4f} ms "
        f"({ne / (e2e_k / 1e3):.6e}/s), two_stage {e2e_t:.4f} ms "
        f"({ne / (e2e_t / 1e3):.6e}/s)")
    return err, k_ms, p_ms


# ---------------------------------------------------------------------------
# Build
# ---------------------------------------------------------------------------


def ptxas_lines(report: str) -> list[str]:
    """One line per compiled kernel: its registers and spills."""
    out, entry, spills = [], None, ""
    for ln in report.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", ln)
        if m:
            entry = m.group(1)
        elif "spill stores" in ln:
            spills = ln.strip()
        elif "Used" in ln and "registers" in ln and entry:
            regs = re.search(r"Used (\d+) registers", ln).group(1)
            out.append((entry, f"{regs} registers, {spills}"))
    names = [e for e, _ in out]
    cxxfilt = shutil.which("c++filt")
    if cxxfilt and names:
        names = subprocess.run([cxxfilt], input="\n".join(names),
                               capture_output=True, text=True,
                               check=True).stdout.splitlines()
    return [f"{n}: {r}" for n, (_, r) in zip(names, out)]


# registers and spills of every instantiation of the GEMM kernel
GEMM_PTXAS: list[str] = []


def sass_bank_report(lib_path: str) -> list[str]:
    """For each f32 blocked kernel in a built library: the loop densest in
    FFMAs in cuobjdump's SASS, its instruction count, and how many of
    its FFMAs read two registers of one parity without the operand reuse
    cache (one register bank of two: an extra issue cycle each)."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not os.path.exists(tool):
        return ["cuobjdump not found: SASS not read"]
    sass = subprocess.run([tool, "-sass", lib_path], capture_output=True,
                          text=True, check=True).stdout
    out = []
    for body in sass.split("Function : ")[1:]:
        if "blocked_kernelIf" not in body.split("\n", 1)[0]:
            continue
        ins = [(int(m.group(1), 16), m.group(2).strip()) for m in re.finditer(
            r"/\*([0-9a-f]{4,})\*/\s+([^;]*);", body)]
        best = None
        for addr, text in ins:
            m = re.search(r"BRA (0x[0-9a-f]+)", text)
            if m and int(m.group(1), 16) < addr:
                loop = [t for a, t in ins if int(m.group(1), 16) <= a <= addr]
                n = sum(t.startswith("FFMA") for t in loop)
                if n >= 64 and (best is None
                                or n / len(loop) > best[0] / len(best[1])):
                    best = (n, loop)
        if best is None:
            continue
        same = 0
        for t in best[1]:
            m = re.match(r"FFMA R\d+, (R\d+)(\.reuse)?, (R\d+)(\.reuse)?, "
                         r"(R\d+)(\.reuse)?", t)
            if m:
                live = [int(m.group(k)[1:]) for k in (1, 3, 5)
                        if not m.group(k + 1)]
                same += len({r % 2 for r in live}) < len(live)
        out.append(f"main loop {len(best[1])} instructions, {best[0]} FFMA, "
                   f"{same} FFMA with two operands in one register bank")
    return out


def build_all():
    """Compile every kernel source at once, one nvcc each."""
    jobs = {}
    for f in FULL_W_ENERGIES:
        code = bj.entries_code(f, {"lambda": 1, "mu": 1})
        jobs[f"blocked_jacobian.cuh (full W) + {type(f).__name__}"] = (
            lambda code=code: bj.build_library(code, 1, 4))
    for f, sizes in AD_TRACES:
        code = adj.energy_code(f, sizes)
        jobs[f"blocked_jacobian.cuh (AD) + {type(f).__name__}"
             f"({getattr(f, 'dim', 1)})"] = (
            lambda code=code: adj.build_library(code))
    for f in BLOCKED_ENERGIES:
        code = bj.entries_code(f, {"lambda": 1, "mu": 1})
        jobs[f"blocked_jacobian.cuh + {type(f).__name__}({f.dim})"] = (
            lambda code=code, d=f.dim: bj.build_library(code, d, d))

    def timed(fn):
        t0 = time.perf_counter()
        report = fn()
        return report, time.perf_counter() - t0

    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(jobs)) as pool:
        futures = {k: pool.submit(timed, fn) for k, fn in jobs.items()}
        results = {k: f.result() for k, f in futures.items()}
    log(f"build: {len(jobs)} nvcc in parallel, "
        f"{time.perf_counter() - t0:.1f} s wall")
    for k, (report, sec) in results.items():
        log(f"build {k}: {sec:.1f} s")
        for line in ptxas_lines(report):
            log(f"  ptxas {line}")
            if "blocked_kernel" in line:
                GEMM_PTXAS.append(f"{k}: {line}")


# ---------------------------------------------------------------------------
# D: the AD kernel
# ---------------------------------------------------------------------------


def retyped(intg, dtype):
    """The same integrator with its tables in another type."""
    t = {}
    for key, val in intg.tables.items():
        if isinstance(val, tuple):
            t[key] = tuple(v.to(dtype) if v.is_floating_point() else v
                           for v in val)
        elif isinstance(val, dict):
            t[key] = {k: v.to(dtype) for k, v in val.items()}
        else:
            t[key] = val.to(dtype)
    return ADBlockIntegrator(intg.f, intg.spaces, intg.modes,
                             device=t["w"].device, dtype=dtype, tables=t)


def phase_d1(dev):
    """AD kernel against its plain version, ragged and large, both types."""
    worst = 0.0
    for nx, ny in D1_SIZES:
        spaces = {}
        for name, (make, order, mode, vdim) in AD_CASES.items():
            key = (order, vdim)
            if key not in spaces:
                spaces[key] = FESpace(M.make_cartesian_2d(nx, ny), order,
                                      vdim=vdim)
            fes = spaces[key]
            i64 = ADBlockIntegrator(make(), [fes], [mode], device=dev,
                                    dtype=torch.float64)
            for dtype in (torch.float64, torch.float32):
                intg = i64 if dtype == torch.float64 else retyped(i64, dtype)
                why = adj.ad_kernel_route_refusal(intg)
                if why is not None:
                    raise AssertionError(f"{name}: AD kernel refused: {why}")
                u = seeded(fes.ndof, AMP / max(nx, ny), 3, dtype, dev)
                before = adj.ad_element_jacobian.launches
                A = intg.element_jacobians([u], route="kernel_ad")
                A_plain = adj.ad_element_jacobian_plain(
                    intg.f, *fj.kernel_inputs(intg, [u]))
                torch.cuda.synchronize()
                if adj.ad_element_jacobian.launches != before + 1:
                    raise RuntimeError("AD kernel launch was not counted")
                nde = vdim * fes.nd
                if (tuple(A.shape) != (nx * ny, nde, nde)
                        or not bool(torch.isfinite(A).all())):
                    raise AssertionError(f"{name}: bad output {A.shape}")
                scale = float(A_plain.abs().max())
                rel = float((A - A_plain).abs().max()) / scale
                msg = (f"D1 {name} {str(dtype)[6:]} {nx}x{ny}: "
                       f"|A-plain| = {rel:.3e} max|A|")
                if name.startswith("neohookean"):
                    A_closed = intg.element_jacobians([u], route="kernel")
                    rc = float((A - A_closed).abs().max()) / scale
                    msg += f", |A-closed kernel| = {rc:.3e} max|A|"
                    rel = max(rel, rc)
                log(f"{msg} (tol {TOL[dtype]:.0e})")
                if not rel <= TOL[dtype]:
                    raise AssertionError(f"{name}: AD kernel disagrees")
                worst = max(worst, rel)
            del i64, intg, A, A_plain
    # an energy the code generator refuses: a named refusal, two-stage
    fes = FESpace(M.make_cartesian_2d(3, 3), 1)
    intg = ADBlockIntegrator(DotEnergy(), [fes], [ADEval.GRAD], device=dev,
                             dtype=torch.float64)
    why = adj.ad_kernel_route_refusal(intg)
    if why is None or "torch.dot" not in why:
        raise AssertionError(f"torch.dot energy not refused: {why}")
    u = seeded(fes.ndof, 1.0, 4, torch.float64, dev)
    before = adj.ad_element_jacobian.launches
    A = intg.element_jacobians([u])
    if adj.ad_element_jacobian.launches != before:
        raise AssertionError("a refused energy launched the AD kernel")
    A_two = intg.element_jacobians([u], route="two_stage")
    if not torch.equal(A, A_two):
        raise AssertionError("auto did not take two-stage for a refusal")
    log(f"D1 refusal of DotEnergy: {why}; auto took two-stage")
    log(f"phase D1 ok: worst relative error {worst:.3e}")


def d2_configs(dev):
    """name -> (integrator, state, route) of the D2 main path."""
    out = {}
    for order in (1, 2):
        pb = poisson.build(order=order, ref_levels=5, n0=16, device=dev,
                           dtype=torch.float32)
        intg = pb.form.integrators[0]
        u = seeded(pb.space.ndof, 1.0, 5, torch.float32, dev)
        out[f"poisson_q{order}"] = (intg, u, "auto")
    intg, u = bench.build(1, 2, HEADLINE_N, dev)
    out["neohookean_q1_ad"] = (intg, u, "kernel_ad")
    # 2D p2 vector (n=4, nde=18; A is 340 MB in f32): the closed entries
    # would take the blocked-W0 kernel, so the AD route is asked for
    fes = FESpace(M.make_cartesian_2d(HEADLINE_N, HEADLINE_N), 2, vdim=2)
    intg = ADBlockIntegrator(NeoHookeanEnergy(2, 1.0, 1.0), [fes], [MODE],
                             device=dev, dtype=torch.float32)
    u = seeded(fes.ndof, AMP_BLOCKED / HEADLINE_N, 14, torch.float32, dev)
    out["neohookean_p2_ad"] = (intg, u, "kernel_ad")
    return out


def phase_d2_main(configs):
    """The AD kernel's main path: Poisson Q1/Q2 on the default route, the
    headline and 2D p2 vector neo-Hookean on the AD kernel."""
    results = {}
    for name, (intg, u, route) in configs.items():
        A = intg.element_jacobians([u], route=route)
        torch.cuda.synchronize()
        ne = intg.tables["edof"][0].shape[0]
        nde = intg.vdim[0] * intg.nd[0]
        if tuple(A.shape) != (ne, nde, nde) or not bool(
                torch.isfinite(A).all()):
            raise AssertionError(f"{name}: bad output {tuple(A.shape)}")
        scale = float(A.abs().max())
        asym = float((A - A.transpose(1, 2)).abs().max()) / scale
        if not asym <= TOL[torch.float32]:
            raise AssertionError(f"{name}: A not symmetric ({asym:.3e})")
        note = f"symmetric to {asym:.3e} max|A|"
        if name.startswith("poisson"):
            # constants are in the Laplacian's kernel: A_e 1 = 0
            rows = float(A.sum(dim=2).abs().max()) / scale
            if not rows <= 1e-5:
                raise AssertionError(f"{name}: A 1 != 0 ({rows:.3e})")
            note += f", |A 1| = {rows:.3e} max|A|"
        results[name] = A
        log(f"D2 {name} ({ne} elements, route {route}): "
            f"{tuple(A.shape)} finite, {note}")
    return results


def bound(ne, nq, n, nde, n_params, dtype):
    """(least ms, what bounds it) for one element-Jacobian pass: the
    contraction and interpolation FMAs over the card's peak arithmetic
    rate, or each operand read once and A written once over its memory
    rate, whichever is longer.  The energy's own derivative arithmetic is
    left out, so this is a lower bound for both kernels."""
    elem = torch.empty((), dtype=dtype).element_size()
    fma = ne * bench.full_w_fmas(nq, n, nde)
    ops_ms = 2.0 * fma / PEAK_FLOPS[dtype] * 1e3
    nbytes = elem * (ne * nde + ne * nde * nde + nq * n * nde
                     + nq * n * n * nde * nde + nq + nq * n_params)
    bytes_ms = nbytes / PEAK_BYTES * 1e3
    return (ops_ms, "operations") if ops_ms >= bytes_ms else (
        bytes_ms, "bytes")


def device_profile(fn, reps: int = 10) -> list[tuple[str, float]]:
    """Device time per call by kernel name, from torch.profiler over
    ``reps`` calls (empty when the profiler sees no device time)."""
    fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    rows = []
    for ev in prof.key_averages():
        t = getattr(ev, "device_time_total", None)
        if t is None:
            t = getattr(ev, "cuda_time_total", 0.0)
        if t > 0 and ev.device_type == torch.autograd.DeviceType.CUDA:
            rows.append((ev.key, t / 1e3 / reps))
    return sorted(rows, key=lambda r: -r[1])


def device_ms(fn, match: str | None = None, events_ms: float | None = None):
    """Device time per call of the kernels whose name holds ``match`` (all
    kernels when None), by torch.profiler over 20 calls; the CUDA-event
    time ``events_ms`` of the whole call where the profiler sees none."""
    rows = device_profile(fn, reps=20)
    sel = [t for k, t in rows if match is None or match in k]
    if sel:
        return sum(sel)
    log("torch.profiler shows no device time: using CUDA-event time")
    return events_ms


def contraction_gemm_ms(ne, nq, n, nde, dev) -> float:
    """cuBLAS's time for the full-W kernels' contraction alone,
    [ne, nq n^2] @ [nq n^2, nde^2] in f32 at highest precision, on seeded
    operands: a yardstick only (the port never calls it)."""
    H = seeded(ne * nq * n * n, 1.0, 12, torch.float32, dev).reshape(
        ne, nq * n * n)
    W = seeded(nq * n * n * nde * nde, 1.0, 13, torch.float32, dev).reshape(
        nq * n * n, nde * nde)
    ms = call_ms(lambda: H @ W)
    del H, W
    return ms


def phase_d3_timing(configs, main):
    """AD kernel vs plain (plain, kernel, kernel, plain) and the routes end
    to end, for each D2 configuration."""
    rows = {}
    for name, (intg, u, route) in configs.items():
        ne = intg.tables["edof"][0].shape[0]
        args = fj.kernel_inputs(intg, [u])
        A_k = adj.ad_element_jacobian(intg.f, *args)
        A_p = adj.ad_element_jacobian_plain(intg.f, *args)
        torch.cuda.synchronize()
        err = float((A_k - A_p).abs().max())
        scale = float(A_p.abs().max())
        if not err <= TOL[torch.float32] * scale:
            raise AssertionError(f"{name}: AD kernel vs plain {err:.3e}")
        if not torch.equal(A_k, main[name]):
            raise AssertionError(f"{name}: repeat call differs from D2")
        del A_k, A_p
        p1 = call_ms(lambda: adj.ad_element_jacobian_plain(intg.f, *args))
        k1 = call_ms(lambda: adj.ad_element_jacobian(intg.f, *args))
        k2 = call_ms(lambda: adj.ad_element_jacobian(intg.f, *args))
        p2 = call_ms(lambda: adj.ad_element_jacobian_plain(intg.f, *args))
        e2e = {r: call_ms(lambda r=r: intg.element_jacobians([u], route=r))
               for r in ("auto", "kernel_ad", "two_stage")}
        b_ms, b_by = bound(ne, intg.nq, intg.n_input,
                           intg.vdim[0] * intg.nd[0],
                           sum(adj.param_sizes(args[4]).values()),
                           torch.float32)
        k_ms = device_ms(lambda: adj.ad_element_jacobian(intg.f, *args),
                         "blocked_kernel", min(k1, k2))
        p_ms = device_ms(
            lambda: adj.ad_element_jacobian_plain(intg.f, *args),
            None, min(p1, p2))
        lib_ms = contraction_gemm_ms(args[0].shape[0], args[3].shape[0],
                                     intg.n_input, args[0].shape[1], u.device)
        log(f"D3 {name}: AD kernel device {k_ms:.4f} ms "
            f"({ne / (k_ms / 1e3):.6e} elem/s), bound {b_ms:.4f} ms "
            f"({b_by}), {b_ms / k_ms:.1%} of bound; plain device "
            f"{p_ms:.4f} ms; cuBLAS contraction GEMM {lib_ms:.4f} ms")
        log(f"D3 {name} calls by CUDA events: AD kernel wrapper "
            f"{k1:.4f}/{k2:.4f} ms, plain {p1:.4f}/{p2:.4f} ms")
        log(f"D3 {name} element_jacobians end to end: " + ", ".join(
            f"{r} {t:.4f} ms ({ne / (t / 1e3):.6e}/s)"
            for r, t in e2e.items()))
        prof = device_profile(
            lambda: intg.element_jacobians([u], route="kernel_ad"))
        log(f"D3 {name} kernel_ad device time per call by kernel: " + (
            "; ".join(f"{k[:60]} {t:.4f} ms" for k, t in prof[:6])
            or "not visible to torch.profiler"))
        rows[name] = dict(err=err, ms=k_ms, plain_ms=p_ms, bound_ms=b_ms,
                          bound_by=b_by, library_ms=lib_ms)
    return rows


# ---------------------------------------------------------------------------
# E: the blocked-W0 kernel
# ---------------------------------------------------------------------------

BLOCKED_ENERGIES = (
    NeoHookeanEnergy(2, 1.0, 1.0), NeoHookeanEnergy(3, 1.0, 1.0),
    LinearElasticityEnergy(2, 1.0, 1.0), LinearElasticityEnergy(3, 1.0, 1.0),
)
# E1 shapes: (dim, order, mesh dims, also against two-stage).  511x509,
# 29x31x33 and 13x11x9 give element counts that are multiples of none of
# the f32 launch plans' element tiles (32, 21, 7), and nd^2 = 81 and 729
# are multiples of neither column tile (96, 384).
E1_CASES = (
    (2, 2, (3, 3), True), (2, 2, (511, 509), False), (2, 3, (3, 3), True),
    (3, 1, (3, 3, 3), True), (3, 1, (63, 64, 65), False),
    (3, 1, (29, 31, 33), False), (3, 2, (3, 2, 2), True),
    (3, 2, (13, 11, 9), False), (3, 3, (2, 2, 2), True),
)


def vector_integrator(energy, dim, order, dims, dtype, dev, seed):
    """A GRAD|VECTOR integrator on a structured mesh and a seeded state
    u = AMP_BLOCKED/n N(0, 1)."""
    m = M.make_cartesian_2d(*dims) if dim == 2 else M.make_cartesian_3d(
        *dims)
    fes = FESpace(m, order, vdim=dim)
    intg = ADBlockIntegrator(energy(dim, 1.0, 1.0), [fes], [MODE],
                             device=dev, dtype=dtype)
    return intg, seeded(fes.ndof, AMP_BLOCKED / max(dims), seed, dtype, dev)


def min_det_f(intg, u) -> float:
    d = intg.sd[0]
    g = intg.x_qp([u])
    F = torch.eye(d, dtype=g.dtype, device=g.device) + g.reshape(
        *g.shape[:2], d, d)
    return float(torch.linalg.det(F.double()).min())


def phase_e1(dev):
    """Blocked kernel against its plain version (and, small, two-stage)."""
    worst = 0.0
    for dim, order, dims, small in E1_CASES:
        for energy in (NeoHookeanEnergy, LinearElasticityEnergy):
            for dtype in (torch.float64, torch.float32):
                intg, u = vector_integrator(energy, dim, order, dims, dtype,
                                            dev, 7)
                why = fj.kernel_route_refusal(intg)
                if why is not None or not fj.uses_blocked_kernel(intg):
                    raise AssertionError(f"E1 blocked kernel refused: {why}")
                tag = (f"E1 {energy.__name__} {dim}D p{order} "
                       f"{'x'.join(map(str, dims))} {str(dtype)[6:]}")
                if energy is NeoHookeanEnergy:
                    det = min_det_f(intg, u)
                    log(f"{tag}: min det F {det:.4f}")
                    if not det > 0.2:
                        raise AssertionError(f"{tag}: min det F {det}")
                before = bj.blocked_element_jacobian.launches
                A = intg.element_jacobians([u], route="kernel")
                A_plain = bj.blocked_element_jacobian_plain(
                    intg.f, *bj.blocked_inputs(intg, [u]), dim, dim)
                torch.cuda.synchronize()
                if bj.blocked_element_jacobian.launches != before + 1:
                    raise RuntimeError("blocked kernel launch not counted")
                nde = dim * intg.nd[0]
                ne = intg.tables["edof"][0].shape[0]
                if (tuple(A.shape) != (ne, nde, nde)
                        or not bool(torch.isfinite(A).all())):
                    raise AssertionError(f"{tag}: bad output {A.shape}")
                scale = float(A_plain.abs().max())
                rel = float((A - A_plain).abs().max()) / scale
                msg = f"{tag}: |A-plain| = {rel:.3e} max|A|"
                if small:
                    A_two = intg.element_jacobians([u], route="two_stage")
                    rt = float((A - A_two).abs().max()) / scale
                    msg += f", |A-two-stage| = {rt:.3e} max|A|"
                    rel = max(rel, rt)
                log(f"{msg} (tol {TOL[dtype]:.0e})")
                if not rel <= TOL[dtype]:
                    raise AssertionError(f"{tag}: blocked kernel disagrees")
                worst = max(worst, rel)
                del intg, u, A, A_plain
    log(f"phase E1 ok: worst relative error {worst:.3e}")


# E1 cases of the full-W instantiations (vdim = 1, sd = n): (label, energy
# factory, dim, order, mode, vdim, mesh dims, route).  37x29 = 1,073 and
# 13x11x9 = 1,287 elements are multiples of none of their launch plans'
# element tiles (f32 / f64: 192 / 256 at the headline and 3D Q1, 768 /
# 1,024 at Poisson Q1, 128 at Q2, 64 at 2D p2 vector and 3D Q2).
E1_FULL_W_CASES = (
    ("full-W NeoHookean 2D p1", lambda: NeoHookeanEnergy(2, 1.0, 1.0), 2,
     1, MODE, 2, (37, 29), "kernel"),
    ("full-W LinearElasticity 2D p1",
     lambda: LinearElasticityEnergy(2, 1.0, 1.0), 2, 1, MODE, 2, (37, 29),
     "kernel"),
    ("AD NeoHookean 2D p1", lambda: NeoHookeanEnergy(2, 1.0, 1.0), 2, 1,
     MODE, 2, (37, 29), "kernel_ad"),
    ("AD NeoHookean 2D p2", lambda: NeoHookeanEnergy(2, 1.0, 1.0), 2, 2,
     MODE, 2, (37, 29), "kernel_ad"),
    ("AD Diffusion 2D Q1", lambda: DiffusionEnergy(2), 2, 1, ADEval.GRAD,
     1, (37, 29), "kernel_ad"),
    ("AD Diffusion 2D Q2", lambda: DiffusionEnergy(2), 2, 2, ADEval.GRAD,
     1, (37, 29), "kernel_ad"),
    ("AD Diffusion 3D Q1", lambda: DiffusionEnergy(3), 3, 1, ADEval.GRAD,
     1, (13, 11, 9), "kernel_ad"),
    ("AD Diffusion 3D Q2", lambda: DiffusionEnergy(3), 3, 2, ADEval.GRAD,
     1, (13, 11, 9), "kernel_ad"),
)


def phase_e1_full_w(dev):
    """The full-W instantiations (closed entries and AD) against their
    plain versions at ragged element counts, f64 and f32."""
    worst = 0.0
    for label, make, dim, order, mode, vdim, dims, route in E1_FULL_W_CASES:
        m = M.make_cartesian_2d(*dims) if dim == 2 else M.make_cartesian_3d(
            *dims)
        fes = FESpace(m, order, vdim=vdim)
        for dtype in (torch.float64, torch.float32):
            intg = ADBlockIntegrator(make(), [fes], [mode], device=dev,
                                     dtype=dtype)
            u = seeded(fes.ndof, AMP_BLOCKED / max(dims), 15, dtype, dev)
            wrapper, plain = (
                (fj.fused_element_jacobian, fj.fused_element_jacobian_plain)
                if route == "kernel" else
                (adj.ad_element_jacobian, adj.ad_element_jacobian_plain))
            if fj.uses_blocked_kernel(intg) and route == "kernel":
                raise AssertionError(f"{label}: the blocked kernel serves")
            before = wrapper.launches
            A = intg.element_jacobians([u], route=route)
            A_plain = plain(intg.f, *fj.kernel_inputs(intg, [u]))
            torch.cuda.synchronize()
            if wrapper.launches != before + 1:
                raise RuntimeError(f"{label}: launch not counted")
            nde = vdim * intg.nd[0]
            if (tuple(A.shape) != (fes.mesh.num_elements, nde, nde)
                    or not bool(torch.isfinite(A).all())):
                raise AssertionError(f"{label}: bad output {A.shape}")
            scale = float(A_plain.abs().max())
            rel = float((A - A_plain).abs().max()) / scale
            plan = bj.launch_plan(1, intg.n_input, nde, intg.nq, dtype)
            log(f"E1 {label} {'x'.join(map(str, dims))} {str(dtype)[6:]} "
                f"(n={intg.n_input}, nde={nde}, element tile "
                f"{plan.elem_tile}): |A-plain| = {rel:.3e} max|A| "
                f"(tol {TOL[dtype]:.0e})")
            if not rel <= TOL[dtype]:
                raise AssertionError(f"{label}: kernel disagrees")
            worst = max(worst, rel)
            del intg, u, A, A_plain
    log(f"phase E1 full-W ok: worst relative error {worst:.3e}")


def e2_configs(dev):
    """name -> (integrator, state) of the E2 main path, f32."""
    out = {}
    fes = FESpace(M.make_cartesian_2d(HEADLINE_N, HEADLINE_N), 2, vdim=2)
    intg = ADBlockIntegrator(NeoHookeanEnergy(2, 1.0, 1.0), [fes], [MODE],
                             device=dev, dtype=torch.float32)
    out["neohookean_2d_p2"] = (intg, seeded(
        fes.ndof, AMP_BLOCKED / HEADLINE_N, 8, torch.float32, dev))
    out["neohookean_3d_p1"] = vector_integrator(
        NeoHookeanEnergy, 3, 1, (64, 64, 64), torch.float32, dev, 9)
    pb = elasticity.build(order=2, dim=3, n0=4, ref_levels=3, device=dev,
                          dtype=torch.float32)
    out["elasticity_3d_p2"] = (pb.form.integrators[0], seeded(
        pb.space.ndof, AMP_BLOCKED / 32, 10, torch.float32, dev))
    return out


def phase_e2_main(configs):
    """The blocked kernel's main path: each configuration through
    ``element_jacobians`` on the default route."""
    results = {}
    for name, (intg, u) in configs.items():
        A = intg.element_jacobians([u])
        torch.cuda.synchronize()
        ne = intg.tables["edof"][0].shape[0]
        nde = intg.vdim[0] * intg.nd[0]
        if tuple(A.shape) != (ne, nde, nde) or not bool(
                torch.isfinite(A).all()):
            raise AssertionError(f"{name}: bad output {tuple(A.shape)}")
        scale = float(A.abs().max())
        asym = float((A - A.transpose(1, 2)).abs().max()) / scale
        if not asym <= TOL[torch.float32]:
            raise AssertionError(f"{name}: A not symmetric ({asym:.3e})")
        results[name] = A
        log(f"E2 {name} ({ne} elements, nde {nde}): {tuple(A.shape)} "
            f"finite, symmetric to {asym:.3e} max|A|")
    return results


def blocked_bound(ne, nq, vdim, sd, nd, n_params, dtype):
    """(least ms, what bounds it) for one blocked-W0 pass: the contraction
    (vdim^2 nd^2 nq sd^2) and interpolation from B0 (nq vdim sd nd) FMAs
    per element over the card's peak arithmetic rate, or each operand read
    once and A written once over its memory rate, whichever is longer.
    The entries' own arithmetic is left out, so this is a lower bound."""
    elem = torch.empty((), dtype=dtype).element_size()
    nde = vdim * nd
    fma = ne * bench.blocked_fmas(nq, vdim, sd, nd)
    ops_ms = 2.0 * fma / PEAK_FLOPS[dtype] * 1e3
    nbytes = elem * (ne * nde + ne * nde * nde + nq * nd * sd
                     + nq * sd * sd * nd * nd + nq + nq * n_params)
    bytes_ms = nbytes / PEAK_BYTES * 1e3
    return (ops_ms, "operations") if ops_ms >= bytes_ms else (
        bytes_ms, "bytes")


def phase_e3_timing(configs, main):
    """Blocked kernel vs plain (plain, kernel, kernel, plain), two-stage
    end to end, the bound and cuBLAS's contraction GEMM, per E2 config."""
    rows = {}
    for name, (intg, u) in configs.items():
        ne = intg.tables["edof"][0].shape[0]
        vdim, sd, nd, nq = intg.vdim[0], intg.sd[0], intg.nd[0], intg.nq
        args = bj.blocked_inputs(intg, [u])

        def kernel():
            return bj.blocked_element_jacobian(intg.f, *args, vdim, sd)

        def plain():
            return bj.blocked_element_jacobian_plain(intg.f, *args, vdim, sd)

        A_k, A_p = kernel(), plain()
        torch.cuda.synchronize()
        err = float((A_k - A_p).abs().max())
        scale = float(A_p.abs().max())
        if not err <= TOL[torch.float32] * scale:
            raise AssertionError(f"{name}: blocked kernel vs plain {err:.3e}")
        if not torch.equal(A_k, main[name]):
            raise AssertionError(f"{name}: repeat call differs from E2")
        del A_k, A_p
        reps = 5 if nd < 27 else 3
        p1 = call_ms(plain, reps=reps, warmup=1)
        k1 = call_ms(kernel)
        k2 = call_ms(kernel)
        p2 = call_ms(plain, reps=reps, warmup=1)
        two = call_ms(lambda: intg.element_jacobians([u], route="two_stage"),
                      reps=reps, warmup=1)
        auto = call_ms(lambda: intg.element_jacobians([u]))
        b_ms, b_by = blocked_bound(ne, nq, vdim, sd, nd,
                                   sum(adj.param_sizes(args[4]).values()),
                                   torch.float32)
        k_ms = device_ms(kernel, "blocked_kernel", min(k1, k2))
        p_ms = device_ms(plain, None, min(p1, p2))
        # cuBLAS's time for the contraction alone, [ne vdim^2, nq sd^2] @
        # [nq sd^2, nd^2] in f32 at highest precision: a yardstick only
        Hk = seeded(ne * vdim * vdim * nq * sd * sd, 1.0, 11, torch.float32,
                    u.device).reshape(ne * vdim * vdim, nq * sd * sd)
        Wk = args[2]
        lib_ms = call_ms(lambda: Hk @ Wk)
        del Hk
        log(f"E3 {name}: blocked kernel device {k_ms:.4f} ms "
            f"({ne / (k_ms / 1e3):.6e} elem/s), bound {b_ms:.4f} ms "
            f"({b_by}), {b_ms / k_ms:.1%} of bound; plain device "
            f"{p_ms:.4f} ms; cuBLAS contraction GEMM {lib_ms:.4f} ms")
        plan = bj.launch_plan(vdim, sd, nd, nq, torch.float32)
        held = ("resident" if plan.quad_chunk == nq
                else f"in chunks of {plan.quad_chunk} points")
        log(f"E3 {name} tiling: {plan.elem_tile} elements x "
            f"{plan.col_tile} of {nd * nd} columns "
            f"({plan.padded_cols(nd) // plan.col_tile} tiles), "
            f"{plan.threads} threads, {plan.stages} ring stages (TMA) of "
            f"{plan.quad_stage * sd * sd} rows, entries {held}, "
            f"{plan.smem_bytes} bytes of shared memory")
        log(f"E3 {name} calls by CUDA events: blocked kernel wrapper "
            f"{k1:.4f}/{k2:.4f} ms, plain {p1:.4f}/{p2:.4f} ms")
        log(f"E3 {name} element_jacobians end to end: auto {auto:.4f} ms "
            f"({ne / (auto / 1e3):.6e}/s), two_stage {two:.4f} ms "
            f"({ne / (two / 1e3):.6e}/s)")
        prof = device_profile(lambda: intg.element_jacobians([u]))
        log(f"E3 {name} auto device time per call by kernel: " + (
            "; ".join(f"{k[:60]} {t:.4f} ms" for k, t in prof[:6])
            or "not visible to torch.profiler"))
        rows[name] = dict(err=err, ms=k_ms, plain_ms=p_ms, bound_ms=b_ms,
                          bound_by=b_by, library_ms=lib_ms)
    return rows


def host_work(calls):
    """Event time minus kernel device time of ``element_jacobians`` calls:
    with the operands derived from the tables (B0 from R, the weighted
    tile-major factor) built once and kept, and with them built again on
    every call (``blocked_jacobian.DERIVED`` cleared first, as every call
    did before the cache), in turns: kept, rebuilt, rebuilt, kept."""
    for name, (fn, dev_ms) in calls.items():
        def rebuilt(fn=fn):
            bj.DERIVED.clear()
            return fn()

        k1, r1, r2, k2 = (call_ms(fn), call_ms(rebuilt), call_ms(rebuilt),
                          call_ms(fn))
        kept, rb = min(k1, k2), min(r1, r2)
        log(f"H {name}: events {k1:.4f}/{k2:.4f} ms kept, {r1:.4f}/"
            f"{r2:.4f} ms rebuilt per call; kernel device {dev_ms:.4f} ms; "
            f"host work {kept - dev_ms:.4f} ms kept, {rb - dev_ms:.4f} ms "
            "rebuilt")


# ---------------------------------------------------------------------------
# F: field-backed Newton, the W0 two-stage route, the examples, the bench
# ---------------------------------------------------------------------------


F1_N0, F1_REFS = 64, 3  # 512x512 p1: 263,169 dofs


def phase_f1(dev):
    """Minimal surface (eps a runtime field) at 512x512 p1 (n0 64, 3
    refinements), f64, Jacobi-CG, 3 continuation passes."""
    x, hist, pb = minimal_surface.solve(order=1, ref_levels=F1_REFS,
                                        n0=F1_N0, continuation_steps=3,
                                        lin_solver="cg", device=dev)
    ndof = pb.space.ndof
    if ndof != (F1_N0 * 2 ** F1_REFS + 1) ** 2 or pb.form.integrators[
            0].field_kinds != {"eps": ("scalar", 1)}:
        raise AssertionError(f"F1: unexpected problem ({ndof} dofs)")
    for i, h in enumerate(hist):
        log(f"F1 pass {i + 1}: eps {h.eps:.4e}, newton iterations "
            f"{h.iterations}, cg iterations per step {h.lin_iters}, area "
            f"{h.area:.12f}, converged {h.converged}, wall {h.seconds:.3f} s")
    if not all(h.converged for h in hist):
        raise AssertionError("F1: a continuation pass did not converge")
    areas = [h.area for h in hist]
    if not all(a > b for a, b in zip(areas, areas[1:])):
        raise AssertionError(f"F1: the area does not decrease: {areas}")
    ess = pb.form.ess_mask
    if not bool(torch.isfinite(x).all()) or not torch.equal(x[ess],
                                                            pb.x0[ess]):
        raise AssertionError("F1: solution not finite or boundary moved")
    log(f"phase F1 ok: {ndof} dofs, wall "
        f"{sum(h.seconds for h in hist):.3f} s")


F2_CASES = {"3d_p1_64": (1, (64, 64, 64)), "3d_p2_32": (2, (32, 32, 32))}


def phase_f2(dev):
    """Two-stage element Jacobians through the W0 GEMM, f32, against the
    blocked kernel's A (E1's bound), with the end-to-end time and its
    parts, and cuBLAS's time for the bare W0 GEMM."""
    for name, (order, dims) in F2_CASES.items():
        intg, u = vector_integrator(NeoHookeanEnergy, 3, order, dims,
                                    torch.float32, dev, 16)
        if "0_0" not in intg.tables["W0"]:
            raise AssertionError(f"F2 {name}: no W0 installed")
        A_two = intg.element_matrices(intg.hess_state([u]), 0, 0)
        A_k = intg.element_jacobians([u], route="kernel")
        torch.cuda.synchronize()
        if not bool(torch.isfinite(A_two).all()):
            raise AssertionError(f"F2 {name}: two-stage A not finite")
        scale = float(A_k.abs().max())
        rel = float((A_two - A_k).abs().max()) / scale
        log(f"F2 {name}: |A two-stage (W0 GEMM) - A blocked kernel| = "
            f"{rel:.3e} max|A| (tol 2e-06)")
        if not rel <= 2e-6:
            raise AssertionError(f"F2 {name}: two-stage disagrees")
        del A_two, A_k
        ne, nq = intg.tables["edof"][0].shape[0], intg.nq
        e2e = call_ms(lambda: intg.element_jacobians([u], route="two_stage"),
                      reps=5, warmup=1)
        hs = call_ms(lambda: intg.hess_state([u]), reps=5, warmup=1)
        Hq = intg.hess_state([u])
        em = call_ms(lambda: intg.element_matrices(Hq, 0, 0), reps=5,
                     warmup=1)
        W0 = intg.tables["W0"]["0_0"]
        Hp = Hq.reshape(ne, nq, 3, 3, 3, 3).permute(0, 2, 4, 1, 3, 5).reshape(
            ne * 9, nq * 9)
        lib = call_ms(lambda: Hp @ W0)
        del Hq, Hp
        log(f"F2 {name} ({ne} elements): two-stage end to end {e2e:.4f} ms "
            f"({ne / (e2e / 1e3):.6e} elem/s): hess_state {hs:.4f} ms, "
            f"element_matrices (W0 GEMM) {em:.4f} ms; library_ms (cuBLAS "
            f"bare [ne vdim^2, nq sd^2] @ W0) {lib:.4f} ms")
        del intg, u
        torch.cuda.empty_cache()
    log("phase F2 ok")


def rel_l2(a, b) -> float:
    return float(torch.linalg.vector_norm(a - b)
                 / torch.linalg.vector_norm(b))


def phase_f3(dev):
    """The ex1-ex3 examples: ex1's MMS rates, every example with dense and
    minres against cg, and the dense Jacobian against the matrix-free
    action at 3D p2."""
    dv = ["--device", str(dev)]
    for p in (1, 2, 3):
        errs = [ex1.main(["-o", str(p), "-r", str(r)] + dv)[1]
                for r in (1, 2, 3)]
        rates = [float(np.log2(a / b)) for a, b in zip(errs, errs[1:])]
        log(f"F3 ex1 p={p}: L2 errors {errs}, rates {rates}")
        if not all(abs(r - (p + 1)) <= 0.1 for r in rates):
            raise AssertionError(f"F3 ex1 p={p}: rates {rates}")
    runs = {
        "ex1": (lambda s: ex1.main(["--solver", s] + dv)[0],
                lambda r: (r.x, r.converged)),
        # 10 continuation passes (ex2's default is 30): the cg and minres
        # runs are host-bound, and phase G needs the time
        "ex2": (lambda s: ex2.main(["-n", "10", "--solver", s] + dv),
                lambda r: (r[0], all(h.converged for h in r[1]))),
        "ex3 2D": (lambda s: ex3.main(["--solver", s] + dv)[0],
                   lambda r: (r.x, r.converged)),
        "ex3 3D p1 ref 0": (
            lambda s: ex3.main(["-d", "3", "-r", "0", "--solver", s] + dv)[0],
            lambda r: (r.x, r.converged)),
    }
    for name, (run, read) in runs.items():
        xs = {}
        for solver in ("cg", "dense", "minres"):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            x, ok = read(run(solver))
            torch.cuda.synchronize()
            log(f"F3 {name} --solver {solver}: converged {ok}, wall "
                f"{time.perf_counter() - t0:.3f} s")
            if not ok or not bool(torch.isfinite(x).all()):
                raise AssertionError(f"F3 {name} {solver}: not converged")
            xs[solver] = x
        for solver in ("dense", "minres"):
            rel = rel_l2(xs[solver], xs["cg"])
            log(f"F3 {name}: |x {solver} - x cg| = {rel:.3e} |x cg|")
            if not rel <= 1e-8:
                raise AssertionError(f"F3 {name}: {solver} disagrees")
    pb = elasticity.build(order=2, ref_levels=0, n0=2, dim=3, device=dev)
    u = seeded(pb.space.ndof, 0.01, 17, torch.float64, dev)
    state = pb.form.grad_state(u)
    A = pb.form.assemble_dense(state)
    worst = 0.0
    for seed in range(4):
        v = seeded(pb.space.ndof, 1.0, 18 + seed, torch.float64, dev)
        ref = pb.form.grad_mult(state, v)
        worst = max(worst, float((A @ v - ref).abs().max() / ref.abs().max()))
    log(f"F3 assemble_dense 3D p2 2^3 ({pb.space.ndof} dofs): |A v - "
        f"grad_mult v| = {worst:.3e} max|grad_mult v| (tol 1e-12)")
    if not worst <= 1e-12:
        raise AssertionError("F3: assemble_dense disagrees with grad_mult")
    log("phase F3 ok")


def phase_f4(dev):
    """The bench: its sweep rows and its headline line."""
    log("F4 " + bench.HEADER.replace("\n", "\nF4 "))
    rows = [c + ("cart",) for c in bench.SWEEP] + list(
        bench.SWEEP_UNSTRUCTURED)
    for order, dim, n, mesh in rows:
        row = bench.sweep_row(order, dim, n, device=dev, mesh=mesh)
        log("F4 " + bench.format_row(row))
        if row["ad_refusal"] is not None:
            log(f"F4   AD route at p={order} {dim}D {mesh}: "
                f"{row['ad_refusal']}")
        torch.cuda.empty_cache()
    line = bench.headline(device=dev)
    log(f"F4 bench line: {json.dumps(line)}")
    if not line["value"] > 0:
        raise AssertionError("F4: no bench rate")
    log("phase F4 ok")


# ---------------------------------------------------------------------------
# G: geometric multigrid and the LVPP obstacle path (ex4)
# ---------------------------------------------------------------------------


G1_N0, G1_LEVELS = 16, 6  # GMG levels of phase C's mesh: 512 -> 16 cells
# ex4's smoke flags at the reference defaults (order 2, ref 3, n0 10)
EX4_FLAGS = ["-o", "2", "-r", "3", "-rule", "2", "-a0", "0.1", "-ar", "2",
             "-ma", "1e4"]
PG_LINE = re.compile(
    r"PG it (\d+): alpha=(\S+) newton=(\d+)(?: lin=(\d+))? "
    r"\|lam diff\|_L1=(\S+) \[(\S+)s\]")


def vcycle_ms(gmg) -> float:
    """CUDA-event ms of one V-cycle from the finest level."""
    f = gmg.forms[0]
    b = torch.where(f.ess_mask, 0.0, seeded(f.ndof, 1.0, 41, f.dtype,
                                            f.device))
    return call_ms(lambda: gmg.vcycle(0, b), reps=10)


def gmg_levels(gmg) -> str:
    return " -> ".join(f"{f.spaces[0].order}:{'x'.join(map(str, s))}"
                       for f, s in zip(gmg.forms, gmg.shapes))


def phase_g1(dev, c_x, c_lin, c_wall):
    """Newton on phase C's problem (512x512 neo-Hookean, f64, 526,338
    dofs) with CG preconditioned by a nonlinear GMG over 6 levels (512 ->
    16 cells), against phase C's Jacobi-CG run."""
    built = {}

    def level(n):
        built[n] = neohookean_ex3(dev, M.make_cartesian_2d(n, n))
        return built[n][0]

    forms = build_hierarchy(level, G1_N0, G1_LEVELS)
    form, fes, b = built[G1_N0 * 2 ** (G1_LEVELS - 1)]
    gmg = GMG(forms, nonlinear=True)
    log(f"G1 levels (order:grid) {gmg_levels(gmg)}, factors {gmg.factors}")
    opts = NewtonOptions(
        abs_tol=0.0, rel_tol=1e-10, max_iter=6, lin_solver="cg",
        lin_tol=1e-10, lin_maxiter=20000, lin_stall_window=None,
        preconditioner=gmg.as_preconditioner(),
    )
    x0 = torch.zeros(fes.ndof, dtype=torch.float64, device=dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = newton(form, x0, b=b, opts=opts)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    h = res.history
    log(f"G1 newton 512x512 f64 GMG-CG ({fes.ndof} dofs): history "
        f"{[f'{v:.6e}' for v in h]}")
    log(f"G1 cg iterations per step {res.lin_iters} (phase C Jacobi: "
        f"{c_lin}); converged {res.converged}; wall {wall:.3f} s (phase C: "
        f"{c_wall:.3f} s)")
    if not (res.converged or h[-1] <= 1e-8 * h[0]):
        raise AssertionError("G1: Newton-GMG neither converged nor dropped "
                             "1e-8")
    diff = float((res.x - c_x).abs().max() / c_x.abs().max())
    log(f"G1 |x GMG - x Jacobi (phase C)| = {diff:.3e} max|x| (tol 1e-6)")
    if not diff <= 1e-6:
        raise AssertionError("G1: the GMG solution disagrees with phase C's")
    log(f"G1 one V-cycle at 512x512 (6 levels): {vcycle_ms(gmg):.4f} ms")
    log("phase G1 ok")


def run_captured(fn):
    """fn() with its standard output captured; returns (result, text)."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        out = fn()
    return out, buf.getvalue()


def pg_lines(text: str, tag: str) -> list[dict]:
    """The PG iterations of a verbose LVPP run, logged under ``tag``."""
    rows = []
    for line in text.splitlines():
        log(f"{tag} | {line}")
        m = PG_LINE.search(line)
        if m:
            rows.append({"alpha": float(m[2]), "newton": int(m[3]),
                         "lin": int(m[4] or 0), "lam_diff": float(m[5]),
                         "s": float(m[6])})
    return rows


G2_ITERS = 10  # of the 38 to convergence, measured in three runs (PR 9)


def phase_g2(dev):
    """ex4's problem at the reference defaults with the smoke flags (order
    2, ref 3: 80x80 quads, H1 Q3 + L2 Q1, 83,681 dofs), Schur + the
    shifted hp-GMG, its first 10 PG iterations; and ex4's ``main`` with
    the smoke flags and the dense solver at order 2 ref 0, run to
    convergence."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    (res, pb), text = run_captured(lambda: obstacle.solve(
        order=2, ref_levels=3, rule_type=PGStepSizeRule.EXP, alpha0=0.1,
        ratio=2.0, max_alpha=1e4, max_pg_iter=G2_ITERS, tol=0.0,
        verbose=True, device=dev))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    rows = pg_lines(text, "G2")
    u = pb.form.split(res.x)[0]
    umin, umax = float(u.min()), float(u.max())
    cg_per_step = [r["lin"] / max(r["newton"], 1) for r in rows]
    log(f"G2 ex4 {' '.join(EX4_FLAGS)} ({pb.form.ndof} dofs), the first "
        f"{G2_ITERS} PG iterations: lambda diff {res.lambda_diff:.4e}, u in "
        f"[{umin:.6e}, {umax:.6f}]")
    log(f"G2 newton iterations per PG iteration {res.newton_iters}")
    log(f"G2 lin_iters (CG, refinement pass included) per PG iteration "
        f"{[r['lin'] for r in rows]}; CG per Newton step "
        f"{[round(c, 1) for c in cg_per_step]}")
    diffs = ", ".join(f"{r['lam_diff']:.4e}" for r in rows)
    log(f"G2 lambda diff per PG iteration [{diffs}]")
    log(f"G2 wall {wall:.3f} s, {wall / res.iterations:.3f} s per PG "
        f"iteration (per iteration {[r['s'] for r in rows]})")
    if len(rows) != res.iterations or res.iterations != G2_ITERS:
        raise AssertionError("G2: the run did not finish its iterations")
    if not bool(torch.isfinite(res.x).all()):
        raise AssertionError("G2: the iterate is not finite")
    gmg = obstacle._primal_gmg(2, 3, 10, device=dev).gmg
    log(f"G2 hp-GMG levels (order:grid) {gmg_levels(gmg)}; one V-cycle "
        f"{vcycle_ms(gmg):.4f} ms")
    flags = EX4_FLAGS[4:] + ["-o", "2", "-r", "0", "--solver", "dense",
                             "--device", str(dev)]
    (res, pb), text = run_captured(lambda: ex4.main(flags))
    pg_lines(text, "G2 ex4.main")
    u = pb.form.split(res.x)[0]
    umin, umax = float(u.min()), float(u.max())
    log(f"G2 ex4.main {' '.join(flags)}: PG {res.iterations}, converged "
        f"{res.converged}, u in [{umin:.6e}, {umax:.6f}]")
    if not (res.converged and umin > -1e-8 and umax < 0.5 + 5e-3):
        raise AssertionError("G2: ex4.main did not converge within bounds")
    log("phase G2 ok")
    return cg_per_step


G3_REFS, G3_ITERS = 5, 3  # 320x320 quads, H1 Q3 + L2 Q1: 1,333,121 dofs


def phase_g3(dev, g2_cg):
    """ex4's problem at ref 5 (1,333,121 dofs), 3 PG iterations with
    tol=0: time per iteration, CG per Newton step against G2's, and the
    parts of one Schur direction."""
    profiling.reset()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    (res, pb), text = run_captured(lambda: obstacle.solve(
        order=2, ref_levels=G3_REFS, rule_type=PGStepSizeRule.EXP,
        alpha0=0.1, ratio=2.0, max_pg_iter=G3_ITERS, tol=0.0, verbose=True,
        device=dev))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    rows = pg_lines(text, "G3")
    stats = profiling.cost_table()
    nd = stats["newton/direction"]
    cg = [r["lin"] / max(r["newton"], 1) for r in rows]
    log(f"G3 ex4 order 2 ref {G3_REFS} ({pb.form.ndof} dofs): "
        f"{res.iterations} PG iterations, newton {res.newton_iters}, wall "
        f"{wall:.3f} s, {wall / res.iterations:.3f} s per PG iteration")
    log(f"G3 CG per Newton step {[round(c, 1) for c in cg]} (G2's first "
        f"{G3_ITERS}: {[round(c, 1) for c in g2_cg[:G3_ITERS]]})")
    log(f"G3 newton/direction {1e3 * nd.total_s / nd.count:.1f} ms per "
        f"direction over {nd.count} directions")
    if res.iterations != G3_ITERS or not bool(torch.isfinite(res.x).all()):
        raise AssertionError("G3: the run did not finish its iterations")
    # the parts of one direction at the last iterate
    form = pb.form
    lo = int(form.offsets[1])
    fields = {"alpha": PGStepSizeRule(PGStepSizeRule.EXP, 0.1, 1e4,
                                      2.0).get(G3_ITERS - 1),
              "latent_k0": res.x[lo:]}
    gs = call_ms(lambda: form.grad_state(res.x, fields), reps=3, warmup=1)
    state = form.grad_state(res.x, fields)
    arr = call_ms(lambda: solvers._schur_arrays(form, state, 1e-6, True),
                  reps=3, warmup=1)
    r = torch.where(form.ess_mask, 0.0, form.mult(res.x, fields) - pb.rhs)
    fp = obstacle._primal_gmg(2, G3_REFS, 10, device=dev)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    dx, its = solvers.schur_solve(form, state, r, 1e-13, 2000, fp=fp)
    torch.cuda.synchronize()
    sol = 1e3 * (time.perf_counter() - t1)
    log(f"G3 one direction at the last iterate: grad_state {gs:.2f} ms, "
        f"Schur arrays {arr:.2f} ms, Schur solve {sol:.1f} ms ({its} CG "
        f"iterations, {(sol - arr) / max(its, 1):.2f} ms per CG iteration "
        f"with the shifted V-cycle); one V-cycle {vcycle_ms(fp.gmg):.4f} ms "
        f"({gmg_levels(fp.gmg)})")
    log("phase G3 ok")


G4_REFS, G4_ITERS = 1, 6  # 12 iterations in PR 9, equal in three runs


def phase_g4(dev):
    """Schur + hp-GMG against the dense direct solver on the card: order
    2, ref 1, the first 6 of the 12 fixed PG iterations of the JAX
    package's test_inexact_schur_matches_tight_dense_obstacle."""
    kw = dict(order=2, ref_levels=G4_REFS, rule_type=PGStepSizeRule.EXP,
              alpha0=0.1, ratio=2.0, max_pg_iter=G4_ITERS, tol=0.0,
              device=dev)
    walls = {}
    for solver in ("schur", "dense"):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        walls[solver] = obstacle.solve(lin_solver=solver, **kw)
        torch.cuda.synchronize()
        walls[solver] += (time.perf_counter() - t0,)
    (res_s, pb, t_s), (res_d, _, t_d) = walls["schur"], walls["dense"]
    nu = pb.primal_space.ndof
    rel = rel_l2(res_s.x[:nu], res_d.x[:nu])

    def mirror(x):
        return 0.5 / (1.0 + torch.exp(-0.5 * x[nu:]))

    mdiff = float((mirror(res_s.x) - mirror(res_d.x)).abs().max())
    log(f"G4 order 2 ref {G4_REFS} ({pb.form.ndof} dofs), {G4_ITERS} PG "
        f"iterations: newton "
        f"schur {res_s.newton_iters} dense {res_d.newton_iters}; |u schur - "
        f"u dense| = {rel:.3e} |u dense| (tol 1e-4), max mirror difference "
        f"{mdiff:.3e} (tol 1e-3); wall schur {t_s:.1f} s, dense {t_d:.1f} s")
    if res_s.iterations != G4_ITERS or res_d.iterations != G4_ITERS:
        raise AssertionError("G4: a run stopped early")
    if not (rel < 1e-4 and mdiff < 1e-3):
        raise AssertionError("G4: the Schur direction disagrees with dense")
    log("phase G4 ok")


# ---------------------------------------------------------------------------
# H: unstructured assembly and the gradient-constrained obstacle (ex5)
# ---------------------------------------------------------------------------


H1_N = 512  # 512^2 cells, 524,288 triangles
H2_TETS = ((1, 32), (2, 16))  # (order, n): 196,608 and 24,576 Kuhn tets
H3_N, H3_AMP = 512, 0.15  # perturbed quads, the JAX tests' perturbation
# ex5 at the reference defaults (order 2, ref 3) with the smoke flags
EX5_FLAGS = ["-rule", "2", "-a0", "1", "-ar", "2"]
H6_REFS = 4  # 154,883 dofs, 51,842 latent: Woodbury mode
H6_BUDGET = 8  # FGMRES iterations of its first direction


def dof_map(fa, fb):
    """For every scalar dof of space ``fa`` the dof of ``fb`` at the same
    node (node coordinates on a common lattice)."""
    def keys(fes):
        q = np.rint(fes.node_coords * 4096 * fes.order).astype(np.int64)
        return (q[:, 0] << 32) + q[:, 1]

    ka, kb = keys(fa), keys(fb)
    ob = np.argsort(kb)
    pos = np.searchsorted(kb[ob], ka)
    if not np.array_equal(kb[ob][pos], ka):
        raise AssertionError("the two spaces' nodes differ")
    return ob[pos]


def element_map(ma, mb):
    """For every element of ``mb`` the element of ``ma`` with the same
    corners (in the same order)."""
    def keys(m):
        e = m.elements.astype(np.int64)
        nv = m.num_vertices
        k = np.zeros(e.shape[0], dtype=np.int64)
        for c in range(e.shape[1]):
            k = k * nv + e[:, c]
        return k

    ka, kb = keys(ma), keys(mb)
    oa = np.argsort(ka)
    pos = np.searchsorted(ka[oa], kb)
    if not np.array_equal(ka[oa][pos], kb):
        raise AssertionError("the two meshes' elements differ")
    return oa[pos]


def vec_map(v, dmap, fa_nds, vdim):
    """A byNODES dof vector of space a moved to space b's numbering."""
    out = torch.empty_like(v)
    idx = torch.as_tensor(dmap, device=v.device)
    for c in range(vdim):
        out[c * fa_nds + idx] = v[c * fa_nds:(c + 1) * fa_nds]
    return out


def rel_max(a, b) -> float:
    return float((a - b).abs().max() / b.abs().max())


def routes(tag: str, intg):
    log(f"{tag} auto_route {intg.auto_route()}; closed-entries kernel: "
        f"{fj.kernel_route_refusal(intg) or 'applies'}; AD kernel: "
        f"{adj.ad_kernel_route_refusal(intg) or 'applies'}; pullback "
        f"{intg.pullback}; exchange "
        f"{(intg._gridmeta[0] or ('generic',))[0]}")
    if intg.auto_route() != "two_stage":
        raise AssertionError(f"{tag}: an unstructured integrator left "
                             "two-stage")


def neohookean_integrator(fes, dtype, dev):
    return ADBlockIntegrator(NeoHookeanEnergy(fes.mesh.dim, 1.0, 1.0), [fes],
                             [MODE], device=dev, dtype=dtype)


def phase_h1(dev):
    """512^2 cells of triangles, p1 vdim 2 neo-Hookean f32: the h1t path
    against the same mesh with its structure dropped and Morton-sorted
    (generic path), and the transpose-gather scatter against
    ``index_add_``."""
    f32 = torch.float32
    ms = M.make_cartesian_2d(H1_N, H1_N, TRIANGLE)
    mu = bench.unstructured_triangles(H1_N)  # the bench's unstructured row
    fs, fu = FESpace(ms, 1, vdim=2), FESpace(mu, 1, vdim=2)
    i_s = neohookean_integrator(fs, f32, dev)
    i_u = neohookean_integrator(fu, f32, dev)
    routes("H1 h1t", i_s)
    routes("H1 generic", i_u)
    ne = ms.num_elements
    u_s = seeded(fs.ndof, AMP / H1_N, 51, f32, dev)
    dmap = dof_map(fs, fu)
    u_u = vec_map(u_s, dmap, fs.ndof_scalar, 2)
    emap = element_map(ms, mu)
    r_s = i_s.residual([u_s])[0]
    r_u = i_u.residual([u_u])[0]
    err_r = rel_max(r_u, vec_map(r_s, dmap, fs.ndof_scalar, 2))
    A_s = i_s.element_jacobians([u_s])
    A_u = i_u.element_jacobians([u_u])
    err_a = rel_max(A_u, A_s[torch.as_tensor(emap, device=dev)])
    log(f"H1 {ne} triangles: generic vs h1t residual {err_r:.3e}, element "
        f"Jacobians {err_a:.3e} max (tol 1e-5, f32)")
    if not (err_r <= 1e-5 and err_a <= 1e-5):
        raise AssertionError("H1: the generic path disagrees with h1t")
    del A_s, A_u
    for tag, intg, u in (("h1t", i_s, u_s), ("generic", i_u, u_u)):
        r_ms = call_ms(lambda: intg.residual([u]), reps=10)
        a_ms = call_ms(lambda: intg.element_jacobians([u]), reps=5)
        log(f"H1 {tag}: residual {r_ms:.4f} ms ({ne / r_ms * 1e3:.4e} "
            f"elem/s), two-stage Jacobian {a_ms:.4f} ms "
            f"({ne / a_ms * 1e3:.4e} elem/s)")
    re = seeded(ne * 3 * 2, 1.0, 52, f32, dev).reshape(ne, 3, 2)
    einv = i_u.tables["einv"][0]
    edof = i_u.tables["edof"][0]
    nds = fu.ndof_scalar
    idx = (edof[:, None, :] + torch.arange(2, device=dev)[None, :, None]
           * nds).reshape(-1)
    vals = re.permute(0, 2, 1).reshape(-1)  # byNODES (v, d) per element

    def transpose_gather():
        return i_u.scatter(0, re)

    def index_add():
        return torch.zeros(fu.ndof, dtype=f32, device=dev).index_add_(
            0, idx, vals)

    err_s = rel_max(transpose_gather(), index_add())
    tg = call_ms(transpose_gather)
    ia = call_ms(index_add)
    h1t = call_ms(lambda: i_s.scatter(0, re))
    log(f"H1 scatter of [{ne}, 3, 2] f32 (valence <= {einv.shape[1]}): "
        f"transpose-gather {tg:.4f} ms, index_add_ {ia:.4f} ms (agree to "
        f"{err_s:.3e}), h1t strided {h1t:.4f} ms")
    log("phase H1 ok")


def phase_h2(dev):
    """Kuhn tets, neo-Hookean f32: residual and two-stage times, and the
    element Jacobians against ``hess_mult`` on a random vector."""
    f32 = torch.float32
    for order, n in H2_TETS:
        fes = FESpace(M.make_cartesian_3d(n, n, n, geom=TETRAHEDRON), order,
                      vdim=3)
        intg = neohookean_integrator(fes, f32, dev)
        routes(f"H2 p{order} {n}^3", intg)
        ne = fes.mesh.num_elements
        # bench.build's states: larger ones invert p2 elements
        u = seeded(fes.ndof, (AMP if order == 1 else AMP_BLOCKED) / n, 53,
                   f32, dev)
        v = seeded(fes.ndof, 1.0, 54, f32, dev)
        A = intg.element_jacobians([u])
        ve = intg.gather(0, v).permute(0, 2, 1).reshape(ne, -1)
        Av = (A @ ve[..., None])[..., 0]
        y1 = intg.scatter(0, Av.reshape(ne, 3, -1).permute(0, 2, 1))
        y2 = intg.hess_mult(intg.hess_state([u], sym=True), [v])[0]
        if not bool(torch.isfinite(A).all()):
            raise AssertionError("H2: element Jacobians not finite")
        err = rel_max(y1, y2)
        r_ms = call_ms(lambda: intg.residual([u]), reps=5)
        a_ms = call_ms(lambda: intg.element_jacobians([u]), reps=3)
        log(f"H2 p{order} {n}^3 tets ({ne} elements, {fes.ndof} dofs, nq "
            f"{intg.nq}, valence <= {intg.tables['einv'][0].shape[1]}): "
            f"scatter(A_e v_e) vs hess_mult {err:.3e} (tol 1e-5); residual "
            f"{r_ms:.4f} ms ({ne / r_ms * 1e3:.4e} elem/s), two-stage "
            f"{a_ms:.4f} ms ({ne / a_ms * 1e3:.4e} elem/s)")
        if not err <= 1e-5:
            raise AssertionError("H2: element Jacobians disagree with "
                                 "hess_mult")
        del A, intg
        torch.cuda.empty_cache()
    log("phase H2 ok")


def perturbed_quads(n: int, amp: float, seed: int = 0):
    """Interior vertices of n x n quads moved by amp*h: every element a
    non-affine bilinear map (the JAX tests' ``_perturbed_quad_mesh``)."""
    m = M.make_cartesian_2d(n, n)
    v = np.array(m.vertices)
    interior = ~(np.isclose(v[:, 0], 0) | np.isclose(v[:, 0], 1)
                 | np.isclose(v[:, 1], 0) | np.isclose(v[:, 1], 1))
    rng = np.random.default_rng(seed)
    v[interior] += amp / n * rng.uniform(-1, 1, size=(interior.sum(), 2))
    return M.Mesh(geom=m.geom, vertices=v, elements=m.elements,
                  attributes=m.attributes, bdr_elements=m.bdr_elements,
                  bdr_attributes=m.bdr_attributes, structured=None)


def phase_h3(dev):
    """Perturbed quads 512^2, p1 vdim 2 neo-Hookean (element-varying _invj
    and w): at zero perturbation the pullback on an unstructured copy
    against the structured path (f32); at the tests' perturbation a
    directional finite-difference check of the Jacobian (f64)."""
    f32, f64 = torch.float32, torch.float64
    ms = M.make_cartesian_2d(H3_N, H3_N)
    mu = bench.drop_structure(ms, sort=False)
    fs, fu = FESpace(ms, 1, vdim=2), FESpace(mu, 1, vdim=2)
    i_s = neohookean_integrator(fs, f32, dev)
    i_u = neohookean_integrator(fu, f32, dev)
    routes("H3 unstructured copy", i_u)
    u_s = seeded(fs.ndof, AMP / H3_N, 55, f32, dev)
    dmap = dof_map(fs, fu)
    u_u = vec_map(u_s, dmap, fs.ndof_scalar, 2)
    err_r = rel_max(i_u.residual([u_u])[0],
                    vec_map(i_s.residual([u_s])[0], dmap, fs.ndof_scalar, 2))
    err_a = rel_max(i_u.element_jacobians([u_u]),
                    i_s.element_jacobians([u_s], route="two_stage"))
    log(f"H3 zero perturbation, pullback vs structured: residual "
        f"{err_r:.3e}, element Jacobians {err_a:.3e} max (tol 1e-5, f32)")
    if not (err_r <= 1e-5 and err_a <= 1e-5):
        raise AssertionError("H3: the pullback disagrees with the "
                             "structured path")
    del i_s, i_u
    fp_ = FESpace(perturbed_quads(H3_N, H3_AMP), 1, vdim=2)
    intg = neohookean_integrator(fp_, f64, dev)
    routes("H3 perturbed", intg)
    ne = fp_.mesh.num_elements
    u = seeded(fp_.ndof, AMP / H3_N, 56, f64, dev)
    v = seeded(fp_.ndof, 1.0 / H3_N, 57, f64, dev)
    A = intg.element_jacobians([u])
    ve = intg.gather(0, v).permute(0, 2, 1).reshape(ne, -1)
    Jv = intg.scatter(0, (A @ ve[..., None])[..., 0].reshape(ne, 2, -1)
                      .permute(0, 2, 1))
    eps = 1e-6
    fd = (intg.residual([u + eps * v])[0]
          - intg.residual([u - eps * v])[0]) / (2 * eps)
    err = rel_max(fd, Jv)
    a_ms = call_ms(lambda: intg.element_jacobians([u]), reps=3)
    log(f"H3 perturbed quads (amp {H3_AMP}, {ne} elements, w "
        f"{tuple(intg.tables['w'].shape)}, _invj "
        f"{tuple(intg.tables['static']['_invj'].shape)}): central "
        f"difference of the residual vs scatter(A_e v_e) {err:.3e} (tol "
        f"1e-6, f64); two-stage f64 {a_ms:.4f} ms")
    if not err <= 1e-6:
        raise AssertionError("H3: the Jacobian fails the finite-difference "
                             "check")
    log("phase H3 ok")


def phase_h4(dev):
    """Solves on simplices: ex1's MMS rates on triangles, ex3 on
    triangles and tets, ex4's obstacle on tets at the JAX test's size."""
    for p in (1, 2, 3):
        errs = [poisson.solve(order=p, ref_levels=r, geom=TRIANGLE,
                              device=dev)[1] for r in (1, 2, 3)]
        rates = [float(np.log2(a / b)) for a, b in zip(errs, errs[1:])]
        log(f"H4 ex1 triangles p={p}: L2 errors {errs}, rates {rates}")
        if not all(r > p + 0.7 for r in rates):
            raise AssertionError(f"H4 ex1 triangles p={p}: rates {rates}")
    dv = ["--device", str(dev)]
    # ex3's default ref 3 on triangles stalls Jacobi-CG's floor exit in
    # both packages (3 Newton steps, 200 CG each, unconverged); ref 2
    # converges
    for args in (["--geom", "tri", "-r", "2"],
                 ["-d", "3", "-r", "0", "--geom", "tet"]):
        xs = {}
        for solver in ("cg", "dense"):
            t0 = time.perf_counter()
            res, pb = ex3.main(args + ["--solver", solver] + dv)
            torch.cuda.synchronize()
            log(f"H4 ex3 {' '.join(args)} --solver {solver} "
                f"({pb.space.ndof} dofs, {pb.mesh.num_elements} "
                f"{pb.mesh.geom}s): converged {res.converged}, wall "
                f"{time.perf_counter() - t0:.3f} s")
            if not res.converged or not bool(torch.isfinite(res.x).all()):
                raise AssertionError(f"H4 ex3 {args} {solver}")
            xs[solver] = res.x
        rel = rel_l2(xs["dense"], xs["cg"])
        log(f"H4 ex3 {' '.join(args)}: |x dense - x cg| = {rel:.3e} |x cg|")
        if not rel <= 1e-8:
            raise AssertionError("H4 ex3: dense disagrees with cg")
    us = {}
    for solver in ("schur", "dense"):
        t0 = time.perf_counter()
        res, pb = obstacle.solve(
            order=1, ref_levels=1, n0=2, dim=3, geom="tet",
            rule_type=PGStepSizeRule.EXP, alpha0=0.1, ratio=2.0,
            max_pg_iter=40, tol=1e-6, lin_solver=solver, device=dev)
        torch.cuda.synchronize()
        nu = pb.primal_space.ndof
        u = res.x[:nu]
        mirror = 0.5 / (1.0 + torch.exp(-0.5 * res.x[nu:]))
        umin, umax = float(u.min()), float(u.max())
        log(f"H4 ex4 obstacle on tets (order 1 ref 1 n0 2, {pb.form.ndof} "
            f"dofs), {solver}: PG {res.iterations} converged "
            f"{res.converged}, newton {res.newton_iters}, u in "
            f"[{umin:.6e}, {umax:.6f}], wall "
            f"{time.perf_counter() - t0:.2f} s")
        if not (res.converged and umin > -1e-8 and 0.49 < umax < 0.56
                and float(mirror.min()) >= 0.0
                and float(mirror.max()) <= 0.5):
            raise AssertionError(f"H4 ex4 tets {solver}: bounds or "
                                 "convergence")
        us[solver] = u
    # the two stop at different alphas (both packages: Schur 19 PG
    # iterations, dense 10), so their solutions differ by more than the
    # directions' tolerance; each is held to the bounds above
    rel = rel_l2(us["schur"], us["dense"])
    log(f"H4 ex4 tets: |u schur - u dense| = {rel:.3e} |u dense|")
    log("phase H4 ok")


def ex5_checks(res, pb, tag: str):
    """The JAX package's test_gradient_obstacle_lvpp_regression checks:
    the integrated violation of ||grad u|| <= phi under 0.08 ||phi||, and
    the mirror map of the latent within phi at every point."""
    sp, lsp = pb.primal_space, pb.latent_space
    x = res.x.cpu().numpy()
    u, psi = x[:sp.ndof], x[sp.ndof:]
    ir = get_rule(sp.mesh.geom, 2 * sp.order)
    gfac = geom_factors(sp.mesh, ir)
    G = phys_dshape(sp.mesh, ir, sp.order)
    gnorm = np.linalg.norm(np.einsum("eqdk,ed->eqk", G,
                                     u[np.asarray(sp.edof)]), axis=-1)
    bound = gradient_obstacle.bound_fn(
        np.moveaxis(gfac.xq, -1, 0)).reshape(gnorm.shape)
    viol = np.sqrt((np.maximum(gnorm - bound, 0) ** 2 * gfac.w).sum())
    bnorm = np.sqrt((bound ** 2 * gfac.w).sum())
    phi = lsp.elem.eval(ir.points)
    idx = (np.asarray(lsp.edof)[:, :, None]
           + np.arange(lsp.vdim) * lsp.ndof_scalar)
    psiq = np.einsum("qd,edv->eqv", phi, psi[idx])
    mnorm = bound ** 2 * np.linalg.norm(psiq, axis=-1) / np.sqrt(
        1 + bound ** 2 * (psiq ** 2).sum(-1))
    ratio = float((mnorm / bound).max())
    log(f"{tag} integrated violation {viol / bnorm:.4e} ||phi|| (bound "
        f"0.08); max |mirror map| / phi {ratio:.12f} (bound 1 + 1e-9)")
    if not (viol / bnorm < 0.08 and ratio <= 1 + 1e-9):
        raise AssertionError(f"{tag}: the gradient constraint fails")


def ldu_report(tag: str, stats: dict) -> str:
    parts = []
    for k in sorted(stats):
        if k.startswith("ldu/"):
            st = stats[k]
            parts.append(f"{k} {st.count} x, {st.total_s:.3f} s")
    line = "; ".join(parts)
    log(f"{tag} {line}")
    return line


def phase_h5(dev):
    """ex5's ``main`` at the reference defaults (order 2, ref 3, 39,043
    dofs) with -rule 2 -a0 1 -ar 2, run to lambda diff < 1e-8: the LDU
    direction with the dense dual-Schur factor."""
    profiling.reset()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    (res, pb), text = run_captured(
        lambda: ex5.main(EX5_FLAGS + ["--device", str(dev)]))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    rows = pg_lines(text, "H5")
    fg = [r["lin"] / max(r["newton"], 1) for r in rows]
    nl = pb.latent_space.ndof
    log(f"H5 ex5 {' '.join(EX5_FLAGS)} ({pb.form.ndof} dofs, {nl} latent, "
        f"{pb.mesh.num_elements} triangles): PG iterations "
        f"{res.iterations} (reference's claim: 29), converged "
        f"{res.converged}, final lambda diff {res.lambda_diff:.4e} (claim: "
        f"9.995e-9)")
    log(f"H5 newton iterations per PG iteration {res.newton_iters}")
    log(f"H5 FGMRES iterations per PG iteration {[r['lin'] for r in rows]}"
        f"; per direction {[round(c, 1) for c in fg]}")
    diffs = ", ".join(f"{r['lam_diff']:.4e}" for r in rows)
    log(f"H5 lambda diff per PG iteration [{diffs}]")
    stats = profiling.cost_table()
    ldu_report("H5", stats)
    log(f"H5 wall {wall:.3f} s, {wall / res.iterations:.3f} s per PG "
        f"iteration (per iteration {[r['s'] for r in rows]})")
    if "ldu/fgmres_direct" not in stats:
        raise AssertionError("H5: the direction did not take sigma-direct")
    if len(rows) != res.iterations:
        raise AssertionError("H5: PG lines do not match the iterations")
    if not (res.converged and res.lambda_diff < 1e-8):
        raise AssertionError("H5: ex5 did not converge")
    ex5_checks(res, pb, "H5")
    log("phase H5 ok")
    fg = stats["ldu/fgmres_direct"]
    return rows, fg.total_s / max(sum(r["lin"] for r in rows), 1)


def phase_h6(dev, h5):
    """ex5's problem at ref 4 (154,883 dofs; 51,842 latent dofs exceed the
    dense factor's cap, so Sigma^-1 is the Woodbury apply): the first
    Newton direction (alpha 1, from zero) with FGMRES cut to its first 8
    iterations.  A whole Woodbury direction there runs hundreds of FGMRES
    iterations (``tools/ldu_probe_torch.py``, ``PERF.md``), so whole PG
    iterations do not fit this script; 8 iterations measure the time per
    iteration and the residual they reach."""
    pb = gradient_obstacle.build(2, H6_REFS, device=dev)
    fp = gradient_obstacle._primal_gmg(2, H6_REFS, 10, device=dev)
    form = pb.form
    n0 = pb.primal_space.ndof
    x = torch.zeros(form.ndof, dtype=torch.float64, device=dev)
    fields = {"alpha": 1.0, "latent_k0": x[n0:]}
    r = torch.where(form.ess_mask, 0.0, form.mult(x, fields) - pb.rhs)
    state = form.grad_state(x, fields)
    v = seeded(form.ndof, 1.0, 58, torch.float64, dev)
    log(f"H6 ref {H6_REFS} ({form.ndof} dofs, {pb.latent_space.ndof} "
        f"latent): saddle grad_mult {call_ms(lambda: form.grad_mult(state, v)):.3f}"
        f" ms, V-cycle {call_ms(lambda: fp.apply_primal(v[:n0])):.3f} ms "
        f"({gmg_levels(fp.gmg)})")
    opts = NewtonOptions(lin_solver="schur", lin_tol=1e-10,
                         lin_maxiter=H6_BUDGET)
    profiling.reset()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    dx, its = solvers.lumped_schur_solve(form, state, r, opts, fp=fp,
                                         alpha=1.0)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    stats = profiling.cost_table()
    ldu_report("H6", stats)
    res = float(torch.linalg.vector_norm(r - form.grad_mult(state, dx))
                / torch.linalg.vector_norm(r))
    rows, h5_fg = h5
    fg5 = [r_["lin"] / max(r_["newton"], 1) for r_ in rows[:3]]
    log(f"H6 Woodbury direction at ref {H6_REFS}, FGMRES cut at "
        f"{H6_BUDGET}: {its} "
        f"iterations in {wall:.3f} s ({wall / max(its, 1):.3f} s per "
        f"iteration), relative residual {res:.3e} (lin_tol 1e-10); H5 "
        f"(direct mode, ref 3): FGMRES per direction in its first 3 PG "
        f"iterations {[round(c_, 1) for c_ in fg5]}, {h5_fg:.3f} s per "
        f"FGMRES iteration")
    if "ldu/fgmres_wb" not in stats or "ldu/fgmres_direct" in stats:
        raise AssertionError("H6: the direction did not take Woodbury")
    if its > H6_BUDGET or not (res < 1.0
                                         and bool(torch.isfinite(dx).all())):
        raise AssertionError("H6: the FGMRES cycle did not reduce the "
                             "residual")
    log("phase H6 ok")


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

    build_all()

    phase_a(dev)

    intg, u = bench.build(1, 2, HEADLINE_N, dev)
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
    c_run = (res.x, res.lin_iters, wall)
    err, k_ms, p_ms = phase_b_timing(intg, u, A_main)
    b_ms, b_by = bound(intg.tables["edof"][0].shape[0], intg.nq,
                       intg.n_input, 8, 2, torch.float32)
    args = fj.kernel_inputs(intg, [u])
    k_dev = device_ms(lambda: fj.fused_element_jacobian(intg.f, *args),
                      "blocked_kernel", k_ms)
    p_dev = device_ms(
        lambda: fj.fused_element_jacobian_plain(intg.f, *args), None, p_ms)
    lib_b = contraction_gemm_ms(args[0].shape[0], intg.nq, intg.n_input, 8,
                                dev)
    log(f"B kernel device {k_dev:.4f} ms, plain device {p_dev:.4f} ms; "
        f"bound {b_ms:.4f} ms ({b_by}), kernel at {b_ms / k_dev:.1%} of it; "
        f"cuBLAS contraction GEMM {lib_b:.4f} ms")
    del args
    del A_main, form, res

    ex3, _ = elasticity.solve(device=dev)
    torch.cuda.synchronize()
    log(f"C ex3 model (default size): history {ex3.history} cg "
        f"{ex3.lin_iters} converged {ex3.converged}")
    if not ex3.converged:
        raise AssertionError("ex3 did not converge")

    phase_d1(dev)
    configs = d2_configs(dev)
    for name, (ci, _, route) in configs.items():
        log(f"D2 {name}: closed-entries kernel: "
            f"{fj.kernel_route_refusal(ci) or 'applies'}; AD kernel: "
            f"{adj.ad_kernel_route_refusal(ci) or 'applies'}; route {route}")
    adj.ad_element_jacobian.launches = 0
    main_out = phase_d2_main(configs)
    torch.cuda.synchronize()
    ad_launches = adj.ad_element_jacobian.launches
    if ad_launches < len(configs):
        raise AssertionError(
            f"the D2 main path launched the AD kernel {ad_launches} times")
    log(f"phase D2 ok: AD kernel launches on the main path {ad_launches}")
    rows = phase_d3_timing(configs, main_out)
    del main_out
    log("phase D3 ok")
    head = rows["neohookean_q1_ad"]
    q2, _, _ = configs["poisson_q2"]
    u_q2 = configs["poisson_q2"][1]
    host_work({
        "headline, full-W (route kernel)": (
            lambda: intg.element_jacobians([u], route="kernel"), k_dev),
        "headline, AD (route kernel_ad)": (
            lambda: intg.element_jacobians([u], route="kernel_ad"),
            head["ms"]),
        "Poisson Q2, AD (route auto)": (
            lambda: q2.element_jacobians([u_q2]), rows["poisson_q2"]["ms"]),
    })
    del configs, q2, u_q2

    phase_e1(dev)
    phase_e1_full_w(dev)
    e_configs = e2_configs(dev)
    for name, (ci, _) in e_configs.items():
        log(f"E2 {name}: closed-entries kernel: "
            f"{fj.kernel_route_refusal(ci) or 'applies'}, blocked-W0: "
            f"{fj.uses_blocked_kernel(ci)}")
    bj.blocked_element_jacobian.launches = 0
    e_main = phase_e2_main(e_configs)
    torch.cuda.synchronize()
    bj_launches = bj.blocked_element_jacobian.launches
    if bj_launches < len(e_configs):
        raise AssertionError(
            f"the E2 main path launched the blocked kernel {bj_launches} "
            "times")
    log(f"phase E2 ok: blocked kernel launches on the main path "
        f"{bj_launches}")
    for line in GEMM_PTXAS:
        log(f"E3 ptxas {line}")
    sass = {}
    for f in BLOCKED_ENERGIES:
        code = bj.entries_code(f, {"lambda": 1, "mu": 1})
        sass[f"blocked {type(f).__name__}({f.dim})"] = nvcc.library_path(
            "blocked_jacobian", bj.kernel_source(code, f.dim, f.dim),
            bj.HEADERS)
    for f in FULL_W_ENERGIES:
        code = bj.entries_code(f, {"lambda": 1, "mu": 1})
        sass[f"full-W {type(f).__name__}(2)"] = nvcc.library_path(
            "blocked_jacobian", bj.kernel_source(code, 1, 4), bj.HEADERS)
    for f, sizes in AD_TRACES:
        if isinstance(f, (NeoHookeanEnergy, DiffusionEnergy)) and (
                getattr(f, "dim", 2) == 2):
            sass[f"AD {type(f).__name__}(2)"] = adj.library_path(
                adj.energy_code(f, sizes))
    for name, path in sass.items():
        for line in sass_bank_report(path):
            log(f"E3 SASS {name} f32: {line}")
    e_rows = phase_e3_timing(e_configs, e_main)
    del e_main, e_configs
    log("phase E3 ok")
    blk = e_rows["neohookean_3d_p1"]

    for phase in (phase_f1, phase_f2, phase_f3, phase_f4):
        t0 = time.perf_counter()
        phase(dev)
        log(f"{phase.__name__}: {time.perf_counter() - t0:.1f} s")

    # no kernel lies on phase G's path: its launch counts stay 0
    kernels = (fj.fused_element_jacobian, adj.ad_element_jacobian,
               bj.blocked_element_jacobian)
    for k in kernels:
        k.launches = 0
    t0 = time.perf_counter()
    phase_g1(dev, *c_run)
    del c_run
    torch.cuda.empty_cache()
    log(f"phase_g1: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    g2_cg = phase_g2(dev)
    log(f"phase_g2: {time.perf_counter() - t0:.1f} s")
    for phase, args in ((phase_g3, (g2_cg,)), (phase_g4, ())):
        t0 = time.perf_counter()
        phase(dev, *args)
        torch.cuda.empty_cache()
        log(f"{phase.__name__}: {time.perf_counter() - t0:.1f} s")
    log("G kernel launches (full-W, AD, blocked): "
        f"{[k.launches for k in kernels]}")

    # no kernel lies on phase H's path either (element-varying geometry
    # and two-space forms take two-stage; H3's structured reference is
    # asked for two-stage)
    for k in kernels:
        k.launches = 0
    for phase in (phase_h1, phase_h2, phase_h3, phase_h4):
        t0 = time.perf_counter()
        phase(dev)
        torch.cuda.empty_cache()
        log(f"{phase.__name__}: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    h5 = phase_h5(dev)
    torch.cuda.empty_cache()
    log(f"phase_h5: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    phase_h6(dev, h5)
    log(f"phase_h6: {time.perf_counter() - t0:.1f} s")
    log("H kernel launches (full-W, AD, blocked): "
        f"{[k.launches for k in kernels]}")

    print(json.dumps({"kernels": [{
        "name": "fused_element_jacobian",
        "route": "cuda",
        "source": "mfem_ad_tpu_torch/csrc/blocked_jacobian.cuh (vdim 1, "
                  "sd n, full W) + closed entries from "
                  "mfem_ad_tpu_torch/ops/energy_codegen.py",
        "replaces": "mfem_ad_tpu/ops/fused_jacobian.py:80",
        "launches": launches,
        "max_abs_err": err,
        "ms": k_dev,
        "plain_ms": p_dev,
        "bound_ms": b_ms,
        "bound_by": b_by,
        "library_ms": lib_b,
    }, {
        "name": "ad_element_jacobian",
        "route": "cuda",
        "source": "mfem_ad_tpu_torch/csrc/blocked_jacobian.cuh (vdim 1, "
                  "sd n, full W) + ad::HessianEntries from "
                  "mfem_ad_tpu_torch/csrc/ad_jacobian.cuh",
        "replaces": "mfem_ad_tpu/ops/fused_jacobian.py:160 (_kernel: "
                    "closed branch :173, generic branch :194)",
        "launches": ad_launches,
        "max_abs_err": head["err"],
        "ms": head["ms"],
        "plain_ms": head["plain_ms"],
        "bound_ms": head["bound_ms"],
        "bound_by": head["bound_by"],
        "library_ms": head["library_ms"],
    }, {
        "name": "blocked_element_jacobian",
        "route": "cuda",
        "source": "mfem_ad_tpu_torch/csrc/blocked_jacobian.cuh (W0) + "
                  "closed entries from "
                  "mfem_ad_tpu_torch/ops/energy_codegen.py",
        "replaces": "mfem_ad_tpu/ops/fused_jacobian.py:119",
        "launches": bj_launches,
        "max_abs_err": blk["err"],
        "ms": blk["ms"],
        "plain_ms": blk["plain_ms"],
        "bound_ms": blk["bound_ms"],
        "bound_by": blk["bound_by"],
        "library_ms": blk["library_ms"],
    }]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
