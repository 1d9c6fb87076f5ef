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
     mesh in f64 with ex3's boundary conditions and a scaled load (each
     direction's state from the grid-state kernel, one launch a direction
     asserted; each CG matvec the grid apply), and the ex3 model at its
     default size;
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
  G. geometric multigrid and the LVPP obstacle path (no element-Jacobian
     kernel; the grid kernels' launches counted):
     G1 Newton on phase C's problem (512x512 neo-Hookean, f64) with CG
        preconditioned by a nonlinear GMG over 6 levels (512 -> 16 cells):
        CG iterations per step and wall time against phase C's Jacobi-CG,
        the largest difference of the two solutions, one V-cycle's time;
     G2 ex4's problem at the reference defaults with the smoke flags
        (order 2, ref 3, 83,681 dofs, -rule 2 -a0 0.1 -ar 2), Schur + the
        shifted hp-GMG, its first 3 PG iterations (of 38 to convergence,
        equal in three whole runs): Newton iterations,
        CG per Newton step, the lambda-diff trajectory, wall time; and
        ex4's ``main`` with the smoke flags and the dense solver at order
        2 ref 0, run to convergence within the bounds;
     G3 ex4's problem at ref 5 (1,333,121 dofs), 2 PG iterations: time per
        iteration, CG per Newton step against G2's, and one direction's
        grad_state, Schur arrays and CG;
     G4 the Schur direction against the dense direct solver, order 2 ref
        1, 3 of the JAX test's 12 fixed PG iterations;
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
        Woodbury mode): the first Newton direction with FGMRES cut to 4
        iterations (a whole Woodbury direction runs hundreds, PERF.md):
        time per iteration and the residual they reach, beside H5's;
  I. dof-level PG, SiMPL topology optimization, LinearForm's chunked path,
     the template driver and GLVis (no element-Jacobian kernel):
     I1 ex4 --dof-pg at the reference defaults (order 2, ref 3: H1 Q3 +
        the L2 Q3 dual, 160,481 dofs, Jacobi-MINRES, rule 0, alpha 1),
        with and without --spatial-bound, up to 6 PG iterations each:
        lambda diff, Newton iterations, MINRES per Newton step and wall
        per PG iteration, u against its bound; ex4's ``main`` with
        --dof-pg --spatial-bound and the dense solver at order 0 ref 0;
        the JAX package's slow test's case (6x6, dense) to convergence
        with its checks;
     I2 topopt's ``main`` at its defaults (48x24 p1, 60 iterations)
        against the JAX package's numbers from a CPU run; a 256x128
        cantilever (66,306 dofs), 5 iterations: CG per state solve and
        whether it reached lin_tol, sensitivity and wall per iteration;
     I3 LinearForm at 100^3 p1 hexes with a FunctionCoefficient on the
        host: the chunked path against the whole-mesh einsum, timed;
     I4 the template driver's ``main`` with -vis on the card against a
        loopback GLVis server in a thread: the stream it receives;
  J. the multi-device layer (``parallel``: no element-Jacobian kernel), 4
     ranks spawned as processes on this one card over gloo (NCCL refuses
     two ranks on one GPU), f64, each held against the serial form on the
     same card:
     J1 phase C's 512x512 neo-Hookean (526,338 dofs) and ex4's obstacle
        at the reference defaults (83,681 dofs): energy, mult,
        grad_state + grad_mult, grad_diag (and the obstacle's Schur
        arrays) on ``ShardedForm`` and on the halo form that
        ``auto_sharded`` picks and on ``HaloShardedForm`` built directly
        to 1e-10 relative; the bytes per grad_mult from the
        communicator (the halo's equal to ``halo_bytes_per_matvec``,
        ShardedForm's one ndof-length all-reduce); ms per grad_mult by
        CUDA events, serial against 4 ranks;
     J2 test_halo.py's LVPP configuration (Schur with the active-set
        Jacobi) at ex4's reference defaults on the halo form, capped at
        its first Newton step, against the serial run: PG, Newton and CG
        counts equal, iterates within 1e-8; then ``parallel.dryrun``'s
        Newton step on the same 4 ranks;
     J3 ``examples.par_template`` through its launcher (``--nproc 4``)
        and ``parallel.dryrun`` through its own at 8 ranks, as child
        processes.
  K. the grid Jacobian apply (``ops.grid_hess_mult``: the packed-Hessian
     J v of a structured 2D H1 form in one kernel of two passes) at the
     newton cell's discretisation, phase C's 512x512 Q1 vdim 2
     neo-Hookean form in f64 with its clamped edge: against the eager
     ``hess_mult`` body with the same elimination, bitwise equal over two
     calls; its device time (each pass) beside its bytes bound, the eager
     body's and the plain version's device time.
  L. the grid-state kernel (``ops.grid_hess_state``: the packed Newton
     state of a structured 2D H1 form in one kernel) at phase C's
     512x512 Q1 vdim 2 neo-Hookean form (by nested duals) and at pg2's
     primal Q3 level (80x80 Q3 diffusion), f64: against the eager
     ``hess_state`` body and the plain version, bitwise equal over two
     calls; its device time beside its bound (the larger of the bytes it
     writes and reads and the least f64 operations of the function: the
     lines of the traced closed entries where the energy has them), the
     plain version's and the eager body's device and CUDA-event times.

Kernel and plain times in the kernels line are device time per call from
torch.profiler (the kernel alone; every kernel of the plain version); the
log also gives CUDA-event times of whole calls, host work included.

Every phase checks its results and raises on failure (a rank that fails
fails its spawn, and the script with it).  Each kernel's
launch count is reset just before its main path (B for the full-W
instantiation, C for the grid state and the grid apply, D2 for the AD
one, E2 for the blocked one) and read just after.  The last line of output is a JSON object naming the device; the
line before it lists the kernels with their launch counts, timings and
bounds.  There is no CPU path: without a CUDA device the script exits
with an error.
"""

from __future__ import annotations

import contextlib
import functools
import hashlib
import io
import json
import os
import re
import shutil
import socket
import subprocess
import sys
import threading
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
from mfem_ad_tpu_torch.coefficients import Coefficient, FunctionCoefficient
from mfem_ad_tpu_torch.fespace import FESpace
from mfem_ad_tpu_torch.forms import LinearForm, NonlinearForm
from mfem_ad_tpu_torch.integrator import ADBlockIntegrator
from mfem_ad_tpu_torch import solvers
from mfem_ad_tpu_torch import mmto
from mfem_ad_tpu_torch.examples import ex1, ex2, ex3, ex4, ex5, template, topopt
from mfem_ad_tpu_torch.geometry import geom_factors, phys_dshape
from mfem_ad_tpu_torch.models import (
    elasticity,
    gradient_obstacle,
    minimal_surface,
    obstacle,
    poisson,
)
from mfem_ad_tpu_torch.multigrid import GMG, build_hierarchy
from mfem_ad_tpu_torch import parallel
from mfem_ad_tpu_torch.parallel import (
    HaloShardedForm,
    ShardedForm,
    auto_sharded,
)
from mfem_ad_tpu_torch.parallel.dryrun import newton_step
from mfem_ad_tpu_torch.ops import ad_jacobian as adj
from mfem_ad_tpu_torch.ops import blocked_jacobian as bj
from mfem_ad_tpu_torch.ops import fused_jacobian as fj
from mfem_ad_tpu_torch.ops import grid_hess_mult as ghm
from mfem_ad_tpu_torch.ops import grid_hess_state as ghs
from mfem_ad_tpu_torch.ops import nvcc
from mfem_ad_tpu_torch.ops.energy_codegen import UnsupportedEnergy
from mfem_ad_tpu_torch.pg import PGStepSizeRule
from mfem_ad_tpu_torch.quadrature import TETRAHEDRON, TRIANGLE, get_rule
from mfem_ad_tpu_torch.solvers import NewtonOptions, newton
from mfem_ad_tpu_torch.utils import glvis, profiling

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
                    intg.f, *intg.kernel_inputs([u]))
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
    args = intg.kernel_inputs([u])
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
                why = intg.route_refusal("kernel_ad")
                if why is not None:
                    raise AssertionError(f"{name}: AD kernel refused: {why}")
                u = seeded(fes.ndof, AMP / max(nx, ny), 3, dtype, dev)
                before = adj.ad_element_jacobian.launches
                A = intg.element_jacobians([u], route="kernel_ad")
                A_plain = adj.ad_element_jacobian_plain(
                    intg.f, *intg.kernel_inputs([u]))
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
    why = intg.route_refusal("kernel_ad")
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
        args = intg.kernel_inputs([u])
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
                why = intg.route_refusal("kernel")
                if why is not None or not intg.uses_blocked_kernel():
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
                    intg.f, *intg.blocked_inputs([u]), dim, dim)
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
            if intg.uses_blocked_kernel() and route == "kernel":
                raise AssertionError(f"{label}: the blocked kernel serves")
            before = wrapper.launches
            A = intg.element_jacobians([u], route=route)
            A_plain = plain(intg.f, *intg.kernel_inputs([u]))
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
        args = intg.blocked_inputs([u])

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


G2_ITERS = 3  # of the 38 to convergence, equal in three whole runs


def phase_g2(dev):
    """ex4's problem at the reference defaults with the smoke flags (order
    2, ref 3: 80x80 quads, H1 Q3 + L2 Q1, 83,681 dofs), Schur + the
    shifted hp-GMG, its first G2_ITERS PG iterations; and ex4's ``main``
    with the smoke flags and the dense solver at order 2 ref 0, run to
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


G3_REFS, G3_ITERS = 5, 2  # 320x320 quads, H1 Q3 + L2 Q1: 1,333,121 dofs


def phase_g3(dev, g2_cg):
    """ex4's problem at ref 5 (1,333,121 dofs), G3_ITERS PG iterations with
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


G4_REFS, G4_ITERS = 1, 3  # of the JAX test's 12, equal in three runs


def phase_g4(dev):
    """Schur + hp-GMG against the dense direct solver on the card: order
    2, ref 1, the first 3 of the 12 fixed PG iterations of the JAX
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
H6_BUDGET = 4  # FGMRES iterations of its first direction


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
        f"{intg.route_refusal('kernel') or 'applies'}; AD kernel: "
        f"{intg.route_refusal('kernel_ad') or 'applies'}; pullback "
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
    iterations do not fit this script; 4 iterations measure the time per
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


# ---------------------------------------------------------------------------
# I: dof-level PG, SiMPL topology optimization, LinearForm's chunked path,
#    the template driver and GLVis (no element-Jacobian kernel)
# ---------------------------------------------------------------------------


I1_ITERS = 6  # PG iterations of each reference-default dof-PG run
# the JAX package's examples/topopt.py at its defaults (48x24 p1, 60
# iterations) on a CPU: iterations, final compliance, volume fraction, rho's
# range and the elements at exactly rho = 1.0
JAX_TOPOPT = {"its": 60, "compliance": 5.501246242724507e-3, "volume": 0.5,
              "rho_min": 7.140014330108268e-10, "rho_max": 1.0,
              "saturated": 196}
TOPOPT_RTOL = 1e-8  # the port's CPU run: 1.6e-12 from JAX's after 60 steps
I2_N, I2_ITERS = 256, 5  # 256x128 cantilever: 32,768 elements
I3_N = 100  # 100^3 p1 hexes


def dofpg_bound(pb, spatial: bool):
    """The upper bound at the primal nodes."""
    x = torch.as_tensor(pb.primal_space.node_coords[:, 0],
                        dtype=torch.float64, device=pb.rhs.device)
    return 0.3 + 0.2 * x if spatial else torch.full_like(x, 0.5)


def phase_i1(dev):
    """ex4 --dof-pg at the reference defaults (order 2, ref 3: H1 Q3 on
    80x80 cells + the L2 Q3 dual, 160,481 dofs; Jacobi-MINRES, rule 0,
    alpha 1, tol 1e-6), its first I1_ITERS PG iterations with and without
    --spatial-bound; ex4's ``main`` with --dof-pg --spatial-bound and the
    dense solver at order 0 ref 0; the JAX package's slow test's case
    (6x6 cells, dense, EXP 1.4 to 30) run to convergence with its
    assertions."""
    for spatial in (False, True):
        tag = f"I1 {'--spatial-bound' if spatial else 'upper 0.5'}"
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        (res, pb), text = run_captured(lambda: obstacle.solve_dofpg(
            order=2, ref_levels=3, max_pg_iter=I1_ITERS, tol=1e-6,
            spatial_bound=spatial, verbose=True, device=dev))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        rows = pg_lines(text, tag)
        u = pb.form.split(res.x)[0]
        excess = float((u - dofpg_bound(pb, spatial)).max())
        minres = [round(r["lin"] / max(r["newton"], 1), 1) for r in rows]
        diffs = ", ".join(f"{r['lam_diff']:.4e}" for r in rows)
        log(f"{tag}: {pb.form.ndof} dofs, {res.iterations} PG iterations "
            f"({len(rows)} completed), converged {res.converged}, lambda "
            f"diff {res.lambda_diff:.4e}, wall {wall:.3f} s")
        log(f"{tag} newton per PG iteration {res.newton_iters}; MINRES per "
            f"Newton step {minres}; lambda diff [{diffs}]; s per PG "
            f"iteration {[r['s'] for r in rows]}")
        log(f"{tag} u in [{float(u.min()):.6e}, {float(u.max()):.6f}], "
            f"max(u - upper bound) {excess:.3e}")
        if not rows or not bool(torch.isfinite(res.x).all()):
            raise AssertionError(f"{tag}: no finite PG iteration")
    flags = ["--dof-pg", "--spatial-bound", "-o", "0", "-r", "0",
             "--solver", "dense", "-rule", "2", "-a0", "1", "-ar", "2",
             "-ma", "30", "--device", str(dev)]
    (res, pb), text = run_captured(lambda: ex4.main(flags))
    pg_lines(text, "I1 ex4.main")
    if not (res.converged and "(bounds [0, 0.3 + 0.2 x])" in text):
        raise AssertionError("I1: ex4.main --dof-pg did not converge")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res, pb = obstacle.solve_dofpg(
        order=1, ref_levels=0, n0=6, max_pg_iter=80, tol=1e-6,
        spatial_bound=True, rule_type=PGStepSizeRule.EXP, alpha0=1.0,
        ratio=1.4, max_alpha=30.0, lin_solver="dense", device=dev)
    wall = time.perf_counter() - t0
    u = pb.form.split(res.x)[0]
    ub = dofpg_bound(pb, True)
    log(f"I1 the JAX slow test's case: converged {res.converged} in "
        f"{res.iterations} PG iterations (JAX on a CPU: 12), newton "
        f"{res.newton_iters}, lambda diff {res.lambda_diff:.4e}, min u "
        f"{float(u.min()):.3e}, max(u - ub) {float((u - ub).max()):.3e}, "
        f"wall {wall:.3f} s")
    if not (res.converged and float(u.min()) > -1e-8
            and bool((u <= ub + 1e-8).all())
            and bool((u > ub - 1e-3).any())):
        raise AssertionError("I1: the slow test's case failed its checks")
    log("phase I1 ok")


def phase_i2(dev):
    """topopt's ``main`` at its defaults against the JAX package's numbers;
    then a 256x128 cantilever (66,306 dofs), 10 mirror-descent
    iterations: CG per state solve and its residual, sensitivity and
    wall per iteration."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    (res, opt), text = run_captured(lambda: topopt.main(
        ["--device", str(dev)]))
    wall = time.perf_counter() - t0
    for line in text.splitlines()[-2:]:
        log(f"I2 topopt.main | {line}")
    rho = res.rho
    got = {"its": len(res.compliance_history),
           "compliance": res.compliance_history[-1],
           "volume": res.volume_history[-1],
           "rho_min": float(rho.min()), "rho_max": float(rho.max()),
           "saturated": int((rho == 1.0).sum())}
    err = abs(got["compliance"] / JAX_TOPOPT["compliance"] - 1.0)
    log(f"I2 topopt defaults (48x24 p1): {got}; JAX's {JAX_TOPOPT}; "
        f"compliance {err:.3e} from JAX's (tol {TOPOPT_RTOL}); CG per state "
        f"solve {res.cg_iterations}; max state residual "
        f"{max(res.state_residuals):.3e}; wall {wall:.3f} s")
    if not (got["its"] == JAX_TOPOPT["its"] and err <= TOPOPT_RTOL
            and got["saturated"] == JAX_TOPOPT["saturated"]
            and abs(got["volume"] - JAX_TOPOPT["volume"]) < 1e-6
            and got["rho_max"] == 1.0 and got["rho_min"] >= 0.0):
        raise AssertionError("I2: topopt disagrees with the JAX package")
    form, design, b, m, disp = mmto.build_cantilever(
        nx=I2_N, ny=I2_N // 2, device=dev)
    opt = mmto.SiMPLTopopt(form, design, b, vol_frac=0.5, step=5.0)
    profiling.reset()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = opt.solve(max_iter=I2_ITERS, tol=0.0)
    wall = time.perf_counter() - t0
    stats = profiling.cost_table()
    ms = {k.split("/")[1]: 1e3 * v.total_s / v.count
          for k, v in stats.items() if k.startswith("topopt/")}
    c = res.compliance_history
    # a state solve reached lin_tol when its true residual is within
    # rounding of it; the others stopped at CG's floor exit (no 1% drop of
    # the best residual in 200 iterations), as the JAX package's CG does
    reached = [r <= 1.1 * opt.lin_tol for r in res.state_residuals]
    log(f"I2 cantilever {I2_N}x{I2_N // 2} p1 ({form.ndof} dofs, "
        f"{m.num_elements} elements), {len(c)} iterations: compliance "
        f"[{', '.join(f'{x:.6e}' for x in c)}]; CG per state solve "
        f"{res.cg_iterations} (lin_maxiter {opt.lin_maxiter}); relative "
        f"state residuals [{', '.join(f'{r:.2e}' for r in res.state_residuals)}]"
        f"; reached lin_tol {opt.lin_tol}: {reached}; ms per iteration: "
        f"state {ms['state']:.1f}, sensitivity {ms['sensitivity']:.2f}, "
        f"volume bisection {ms['volume']:.1f}; wall {wall:.3f} s, "
        f"{wall / len(c):.3f} s per iteration")
    if not (len(c) == I2_ITERS and np.isfinite(c).all()
            and bool(torch.isfinite(res.rho).all())
            and abs(res.volume_history[-1] - 0.5) < 1e-6):
        raise AssertionError("I2: the card-sized cantilever failed")
    log("phase I2 ok")


def phase_i3():
    """LinearForm at 100^3 p1 hexes (1,000,000 elements) with a
    FunctionCoefficient on the host: the chunked path against the
    whole-mesh einsum (the same coefficient behind an adapter that the
    chunked path does not take)."""
    m = M.make_cartesian_3d(I3_N, I3_N, I3_N)
    fes = FESpace(m, 1)
    fc = FunctionCoefficient(obstacle.load_fn_3d)

    class WholeMesh(Coefficient):
        def eval_qp(self, ctx):
            return fc.eval_qp(ctx)

    out = {}
    for name, coeff in (("chunked", fc), ("whole-mesh", WholeMesh())):
        t0 = time.perf_counter()
        out[name] = (LinearForm(fes, coeff).assemble(),
                     time.perf_counter() - t0)
    (bc, tc), (bw, tw) = out["chunked"], out["whole-mesh"]
    diff = float(np.abs(bc - bw).max() / np.abs(bw).max())
    log(f"I3 LinearForm {I3_N}^3 p1 hexes ({m.num_elements} elements, "
        f"{fes.ndof} dofs), FunctionCoefficient, host: chunked {tc:.3f} s, "
        f"whole-mesh einsum {tw:.3f} s; max difference {diff:.3e} max|b| "
        f"(tol 1e-12)")
    if diff > 1e-12:
        raise AssertionError("I3: the chunked load vector differs")
    log("phase I3 ok")


def phase_i4(dev):
    """The template driver's ``main`` with -vis on the card against a
    loopback GLVis server in a thread: the stream it receives."""
    srv = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
    srv.bind(("127.0.0.1", 0))
    srv.listen(2)
    received = []

    def serve():
        with srv:
            for _ in range(2):  # the probe, then the field
                conn, _ = srv.accept()
                with conn:
                    chunks = []
                    while (b := conn.recv(65536)):
                        chunks.append(b)
                if chunks:
                    received.append(b"".join(chunks).decode())

    th = threading.Thread(target=serve, daemon=True)
    th.start()
    client = template.GLVis
    template.GLVis = functools.partial(client, host="127.0.0.1",
                                       port=srv.getsockname()[1])
    try:
        (fes, u), text = run_captured(lambda: template.main(
            ["-n", "10", "-o", "2", "-vis", "--device", str(dev)]))
    finally:
        template.GLVis = client
    th.join(timeout=30.0)
    expect = ("solution\n" + glvis._mesh_ascii(fes.mesh)
              + glvis._gridfunction_ascii(fes, u)
              + "window_title 'u'\nwindow_geometry 0 0 400 350\nkeys Rjc\n")
    log(f"I4 template.main on {u.device}: {text.strip()!r}; GLVis server "
        f"received {len(received)} stream(s), {len(received[0]) if received else 0}"
        f" bytes, equal to the expected stream: "
        f"{bool(received) and received[0] == expect}")
    if th.is_alive() or received != [expect]:
        raise AssertionError("I4: the GLVis stream differs")
    log("phase I4 ok")


# ---------------------------------------------------------------------------
# J: the multi-device layer, 4 ranks on the one card over gloo (no
#    element-Jacobian kernel)
# ---------------------------------------------------------------------------


J_RANKS = 4
J_TIMEOUT = 600.0  # seconds, for the rendezvous, a collective, a spawn
J_MATVECS = 20  # grad_mult calls timed per form
J_TOL = 1e-10  # J1: relative to max|serial|
# J2: test_halo.py's LVPP configuration (Schur with the active-set Jacobi)
# at ex4's reference defaults, capped at J2_ITERS PG iterations of
# J2_NEWTON Newton steps each, each Schur CG at J2_CG iterations, the
# capped Newton iterate accepted.  On an NVIDIA H100 80GB HBM3 at 700 W,
# 2 PG iterations to convergence (7 + 4 Newton steps, 8,771 CG) took
# 189.0 s on 4 ranks and 48.0 s serial, 2 Newton steps (1,600 CG) 36.6 s
# and 7.7 s, 1 Newton step (800 CG) 12.0 s and 4.9 s (PERF.md, phase J)
J2_ITERS, J2_NEWTON, J2_CG = 1, 1, 200
J2_OPTS = dict(abs_tol=1e-9, max_iter=J2_NEWTON, lin_solver="schur",
               lin_tol=1e-12, lin_maxiter=J2_CG)
J2_RULE = (PGStepSizeRule.EXP, 0.1, 1e4, 2.0, 1.0)


def j_problems(dev):
    """J1's problems: phase C's 512x512 neo-Hookean (u 0.1/n N(0, 1)) and
    ex4's obstacle at the reference defaults (u 0.1 N(0, 1), alpha 1,
    latent_k0 0.1 N(0, 1)), each with a direction v ~ N(0, 1); and the
    obstacle's Problem (J2)."""
    f64 = torch.float64
    form, _, _ = neohookean_ex3(dev)
    n = form.ndof
    cases = {"nh512": (form, seeded(n, 0.1 / HEADLINE_N, 51, f64, dev),
                       seeded(n, 1.0, 52, f64, dev), {}, False)}
    pb = obstacle.build(order=2, ref_levels=3, device=dev)
    n = pb.form.ndof
    fields = {"alpha": 1.0,
              "latent_k0": seeded(pb.latent_space.ndof, 0.1, 55, f64, dev)}
    cases["ex4"] = (pb.form, seeded(n, 0.1, 53, f64, dev),
                    seeded(n, 1.0, 54, f64, dev), fields, True)
    return cases, pb


def j1_eval(f, u, v, fields, schur: bool, comm=None):
    """energy, mult, grad_state + grad_mult, grad_diag and (``schur``) the
    Schur arrays of a serial, sharded or halo form, as canonical host
    arrays; the bytes of each collective kind in one grad_mult; CUDA-event
    ms per grad_mult over J_MATVECS calls."""
    halo = isinstance(f, HaloShardedForm)

    def host(a):
        return (f.canonical(a) if halo else a).cpu().numpy()

    uu = f.dist_array(u.cpu().numpy()) if halo else u
    vv = f.dist_array(v.cpu().numpy()) if halo else v
    out = {"e": float(f.energy(uu, fields)), "r": host(f.mult(uu, fields))}
    st = f.grad_state(uu, fields)
    if comm is not None:
        comm.reset()
    y = f.grad_mult(st, vv)
    out["bytes"] = {} if comm is None else dict(comm.bytes)
    out["y"], out["d"] = host(y), host(f.grad_diag(st))
    if schur:
        arrays = solvers._schur_arrays(f, st, 1e-6, True)
        De_inv = arrays["De_inv"]
        if halo:  # the bands' element blocks, in element order
            De_inv = comm.sum_(f.bands[0].band.embed(De_inv))
            n0 = f.form.offsets[1]
            for k in ("dshift", "safe"):
                arrays[k] = f.canonical(f.pad_u(arrays[k]))[:n0]
        out["De_inv"] = De_inv.cpu().numpy()
        out["dshift"] = arrays["dshift"].cpu().numpy()
        out["safe"] = arrays["safe"].cpu().numpy()
    torch.cuda.synchronize()
    if comm is not None:
        comm.barrier()
    e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    e0.record()
    for _ in range(J_MATVECS):
        f.grad_mult(st, vv)
    e1.record()
    torch.cuda.synchronize()
    out["ms"] = e0.elapsed_time(e1) / J_MATVECS
    return out


def j2_run(form, pb, x0, rhs):
    """The capped LVPP run of J2 on ``form``: (x canonical, PG iterations,
    Newton per PG iteration, CG per PG iteration, lambda diff, wall)."""
    from mfem_ad_tpu_torch.pg import PGSolver

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res, text = run_captured(lambda: PGSolver(
        form, PGStepSizeRule(*J2_RULE), latent_block=1,
        latent_space=pb.latent_space, newton_opts=NewtonOptions(**J2_OPTS),
        max_iter=J2_ITERS, tol=1e-7, verbose=True,
        newton_accept=np.inf).solve(x0, rhs))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    lin = [int(m[4] or 0) for m in map(PG_LINE.search, text.splitlines())
           if m]
    x = form.canonical(res.x) if hasattr(form, "canonical") else res.x
    return (x.cpu().numpy(), res.iterations, list(res.newton_iters), lin,
            float(res.lambda_diff), wall)


def _digest(out: dict) -> str:
    h = hashlib.sha256()
    for k in ("r", "y", "d"):
        h.update(out[k].tobytes())
    h.update(repr(out["e"]).encode())
    return h.hexdigest()


def j_rank(comm):
    """One rank of phase J: J1 on both problems for ShardedForm, the halo
    form from ``auto_sharded`` and HaloShardedForm built directly, then
    J2's halo PG run and the dry run's Newton step.  Rank 0 returns the
    arrays; every rank returns digests of its J1 results, its timings
    and bytes, the dry run's result and its kernel launch counts."""
    cases, pb = j_problems(comm.device)
    kernels = (fj.fused_element_jacobian, adj.ad_element_jacobian,
               bj.blocked_element_jacobian)
    out = {}
    for name, (form, u, v, fields, schur) in cases.items():
        auto = auto_sharded(form, comm)
        direct = HaloShardedForm(form, comm)
        if not isinstance(auto, HaloShardedForm) or (
                direct.slots != auto.slots):
            raise AssertionError(f"J1 {name}: auto_sharded chose "
                                 f"{type(auto).__name__}")
        for kind, f in (("sharded", ShardedForm(form, comm)),
                        ("halo", auto), ("halo_direct", direct)):
            res = j1_eval(f, u, v, fields, schur, comm)
            res["digest"] = _digest(res)
            if comm.rank:
                res = {k: res[k] for k in ("digest", "ms", "bytes")}
            out[(name, kind)] = res
        out[(name, "halo_bytes")] = auto.halo_bytes_per_matvec()
        del auto, direct
    hf = HaloShardedForm(pb.form, comm)
    res = j2_run(hf, pb, hf.dist_array(np.zeros(pb.form.ndof)),
                 hf.dist_array(pb.rhs.cpu().numpy()))
    out["j2"] = res if comm.rank == 0 else res[1:]
    out["dryrun"] = newton_step(comm)
    out["launches"] = [k.launches for k in kernels]
    out["comm"] = f"{comm.backend}, {comm.device}"
    return out


def rel_np(a, b) -> float:
    """max|a - b| / max|b| of host arrays."""
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-300))


def phase_j12(dev):
    """J1 and J2: the serial references on this card in this process, then
    one spawn of J_RANKS ranks (gloo, every rank on this card, f64)."""
    cases, pb = j_problems(dev)
    serial = {name: j1_eval(form, u, v, fields, schur)
              for name, (form, u, v, fields, schur) in cases.items()}
    j2_serial = j2_run(pb.form, pb, torch.zeros_like(pb.rhs), pb.rhs)
    ndofs = {name: c[0].ndof for name, c in cases.items()}
    del cases, pb
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    ranks = parallel.spawn(j_rank, J_RANKS, device=dev, timeout=J_TIMEOUT,
                           limit=J_TIMEOUT)
    log(f"J spawn of {J_RANKS} ranks ({[r['comm'] for r in ranks]}): "
        f"{time.perf_counter() - t0:.1f} s")
    for name, ref in serial.items():
        for kind in ("sharded", "halo", "halo_direct"):
            got = ranks[0][(name, kind)]
            errs = {k: rel_np(got[k], ref[k]) for k in ref
                    if k not in ("e", "bytes", "ms")}
            errs["e"] = abs(got["e"] - ref["e"]) / abs(ref["e"])
            worst = max(errs.values())
            ms = [r[(name, kind)]["ms"] for r in ranks]
            moved = [r[(name, kind)]["bytes"] for r in ranks]
            log(f"J1 {name} ({ndofs[name]} dofs) {kind}: relative errors "
                f"{ {k: f'{e:.2e}' for k, e in errs.items()} }; grad_mult "
                f"{max(ms):.4f} ms on {J_RANKS} ranks (slowest; serial "
                f"{ref['ms']:.4f} ms); bytes per grad_mult per rank "
                f"{moved}")
            if not worst <= J_TOL:
                raise AssertionError(f"J1 {name} {kind}: {worst:.3e} from "
                                     "serial")
            digests = [r[(name, kind)]["digest"] for r in ranks]
            if kind == "sharded":
                if len(set(digests)) != 1:
                    raise AssertionError(f"J1 {name}: ShardedForm differs "
                                         "across ranks")
                if any(m != {"sum": 8 * ndofs[name]} for m in moved):
                    raise AssertionError(f"J1 {name}: ShardedForm moved "
                                         f"{moved}")
            else:
                want = ranks[0][(name, "halo_bytes")]
                total = sum(m.get("exchange", 0) for m in moved)
                if total != want or any(set(m) != {"exchange"}
                                        for m in moved):
                    raise AssertionError(
                        f"J1 {name}: the halo grad_mult moved {moved}, "
                        f"halo_bytes_per_matvec {want}")
                log(f"J1 {name} {kind}: {total} bytes per grad_mult over "
                    f"all ranks = halo_bytes_per_matvec")
                if kind == "halo_direct" and digests != [
                        r[(name, "halo")]["digest"] for r in ranks]:
                    raise AssertionError(
                        f"J1 {name}: the halo form built directly differs "
                        "from auto_sharded's")
    x_s, its_s, newton_s, lin_s, lam_s, wall_s = j2_serial
    x_h, its_h, newton_h, lin_h, lam_h, wall_h = ranks[0]["j2"]
    dx = float(np.abs(x_h - x_s).max())
    log(f"J2 ex4 reference defaults on HaloShardedForm, {J_RANKS} ranks "
        f"(caps: {J2_ITERS} PG iterations of {J2_NEWTON} Newton steps): PG "
        f"{its_h}, Newton {newton_h}, CG per PG iteration {lin_h}, lambda "
        f"diff {lam_h:.6e}, {wall_h:.1f} s; serial: PG {its_s}, Newton "
        f"{newton_s}, CG {lin_s}, lambda diff {lam_s:.6e}, {wall_s:.1f} s; "
        f"max|x halo - x serial| {dx:.3e}")
    if (its_h, newton_h, lin_h) != (its_s, newton_s, lin_s):
        raise AssertionError("J2: the halo run's counts differ from serial")
    if not dx <= 1e-8 or any(r["j2"][0] != its_s for r in ranks[1:]):
        raise AssertionError(f"J2: the iterates differ by {dx:.3e}")
    dry = [r["dryrun"] for r in ranks]
    log(f"J2 dryrun on the {J_RANKS} ranks: (slots, CG, |x1|) per rank "
        f"{dry}")
    if len(set(dry)) != 1 or not np.isfinite(dry[0][2]):
        raise AssertionError(f"J2: the dry run's ranks disagree: {dry}")
    launches = [sum(c) for c in zip(*(r["launches"] for r in ranks))]
    log(f"J kernel launches in the ranks (full-W, AD, blocked): {launches}")
    log("phase J1 J2 ok")


J3_LINE = re.compile(r"converged=(True|False) L2 error=(\S+)")


def run_cli(args, timeout: float) -> str:
    """A module's command line in a child process; its output, or an
    error with its tail when it fails."""
    t0 = time.perf_counter()
    p = subprocess.run([sys.executable, "-m", *args], capture_output=True,
                       text=True, timeout=timeout)
    text = p.stdout + p.stderr
    for line in p.stdout.splitlines():
        log(f"J3 {args[0].rsplit('.', 1)[-1]} | {line}")
    log(f"J3 {' '.join(args)}: exit {p.returncode}, "
        f"{time.perf_counter() - t0:.1f} s")
    if p.returncode != 0:
        raise AssertionError(f"J3 {' '.join(args)} failed:\n{text[-3000:]}")
    return p.stdout


def phase_j3():
    """par_template through its launcher at K = 4 and the dry run through
    its own at K = 8, both at once (one after the other such launches
    took 40-47 s each on the H100's host, mostly starting their ranks;
    the dry run at K = 4 runs in J's spawn)."""
    runs = [["mfem_ad_tpu_torch.examples.par_template", "--nproc",
             str(J_RANKS)],
            ["mfem_ad_tpu_torch.parallel.dryrun", "--nproc",
             str(2 * J_RANKS)]]
    with ThreadPoolExecutor(len(runs)) as ex:
        outs = list(ex.map(lambda a: run_cli(a, J_TIMEOUT), runs))
    m = J3_LINE.search(outs[0])
    if not (m and m[1] == "True" and float(m[2]) < 2e-5):
        raise AssertionError("J3: par_template did not converge")
    if "dryrun:" not in outs[1]:
        raise AssertionError("J3: the dry run printed no result")
    log("phase J3 ok")



def grid_apply_bound(intg, dtype) -> tuple[float, str]:
    """(least ms, what bounds it) for one grid Jacobian apply of ``intg``:
    its FMAs (x = B^T u, H x, the element vector) over the card's peak
    arithmetic rate, or the planes, the input, the output and the mask
    each moved once over its memory rate, whichever is longer."""
    vdim, nd, nq, sd = intg.vdim[0], intg.nd[0], intg.nq, intg.sd[0]
    n, ne, ndof = vdim * sd, bench.elements(intg), vdim * intg.nds[0]
    elem = torch.empty((), dtype=dtype).element_size()
    ops_ms = 2.0 * ne * nq * (2 * n * nd + n * n) / PEAK_FLOPS[dtype] * 1e3
    nbytes = elem * (n * (n + 1) // 2 * ne * nq + 2 * ndof) + ndof
    bytes_ms = nbytes / PEAK_BYTES * 1e3
    return (ops_ms, "operations") if ops_ms >= bytes_ms else (
        bytes_ms, "bytes")


def phase_k(dev) -> dict:
    """The grid Jacobian apply at phase C's discretisation (f64): the
    kernel against the eager body, its determinism, and its times."""
    form, _, _ = neohookean_ex3(dev)
    intg = form.integrators[0]
    state = form.grad_state(seeded(form.ndof, AMP / HEADLINE_N, 21,
                                   torch.float64, dev))
    v = seeded(form.ndof, 1.0, 22, torch.float64, dev)
    ess = form.ess_mask
    refusal = intg.route_refusal("grid", state[0])
    if refusal is not None:
        raise AssertionError(f"K: the route refuses the newton form: "
                             f"{refusal}")

    def kernel():
        return form.grad_mult(state, v)

    def eager():
        u = torch.where(ess, 0.0, v)
        return torch.where(ess, v, intg._hess_mult_eager(state[0], [u])[0])

    ops = intg.grid_operands()

    def plain():
        return ghm.grid_grad_mult_plain(v, ess, state[0].planes, *ops)

    ghm.grid_grad_mult.launches = 0
    y = kernel()
    err = rel_max(y, eager())
    again = torch.equal(y, kernel())
    err_plain = rel_max(plain(), eager())
    torch.cuda.synchronize()
    launches = ghm.grid_grad_mult.launches
    log(f"K kernel vs eager {err:.3e} max|Jv| (tol 1e-13), plain vs eager "
        f"{err_plain:.3e}, two calls bitwise equal: {again}, launches "
        f"{launches}")
    if err > 1e-13 or err_plain > 1e-13 or not again or launches != 2:
        raise AssertionError("K: the grid Jacobian apply disagrees")
    k_ms, e_ms, p_ms = call_ms(kernel), call_ms(eager), call_ms(plain)
    rows = device_profile(kernel, reps=20)
    for name, t in rows:
        log(f"K kernel device {t:.4f} ms  {name[:90]}")
    k_dev = sum(t for k, t in rows if "ghm::" in k) or k_ms
    e_dev = device_ms(eager, None, e_ms)
    p_dev = device_ms(plain, None, p_ms)
    b_ms, b_by = grid_apply_bound(intg, torch.float64)
    log(f"K grid_grad_mult 512x512 Q1 vdim 2 f64: kernel device "
        f"{k_dev:.4f} ms (events {k_ms:.4f}), eager hess_mult device "
        f"{e_dev:.4f} ms (events {e_ms:.4f}), plain device {p_dev:.4f} ms; "
        f"bound {b_ms:.4f} ms ({b_by}), kernel at {b_ms / k_dev:.1%} of it")
    return {"launches": launches, "err": err, "ms": k_dev, "plain_ms": p_dev,
            "eager_ms": e_dev, "bound_ms": b_ms, "bound_by": b_by}


_LINE = re.compile(r"const (?:T|bool) \w+ = (.*);$")


def trace_lines(code) -> int:
    """The operation lines of a trace (``EnergyCode.source``)."""
    return sum(1 for line in code.source.splitlines() if _LINE.search(line))


def state_flops(f, psizes: dict) -> int:
    """The f64 operations one point's packed Hessian needs, whatever
    algorithm computes it: the lines of the traced closed entries where
    the energy has them (each line one operation), else each line of the
    traced energy once for its value, n times for the gradient and
    n(n+1)/2 times for the Hessian's second parts.  The kernel's nested
    duals do more (every part of every line in each of n(n+1)/2
    evaluations); this counts what the function needs."""
    try:
        return trace_lines(bj.entries_code(f, psizes))
    except UnsupportedEnergy:
        code = adj.energy_code(f, psizes)
        n = code.n_input
        return trace_lines(code) * (1 + n + n * (n + 1) // 2)


def grid_state_bound(intg, psizes: dict, dtype):
    """(least ms, what bounds it, f64 operations, bytes) of one grid-state
    call of ``intg``: per point x = B^T u (2 N nd), the Hessian's least
    operations (``state_flops``) and the weight (K); the planes written,
    the dof vector and the tables read once."""
    vdim, nd, nq, sd = intg.vdim[0], intg.nd[0], intg.nq, intg.sd[0]
    n, ne, ndof = vdim * sd, bench.elements(intg), vdim * intg.nds[0]
    K = n * (n + 1) // 2
    elem = torch.empty((), dtype=dtype).element_size()
    flops = ne * nq * (2 * n * nd + state_flops(intg.f, psizes) + K)
    nbytes = elem * (K * ne * nq + ndof + nq * nd * sd + nq * (
        1 + sum(psizes.values())))
    ops_ms = flops / PEAK_FLOPS[dtype] * 1e3
    bytes_ms = nbytes / PEAK_BYTES * 1e3
    by = "operations" if ops_ms >= bytes_ms else "bytes"
    return max(ops_ms, bytes_ms), by, flops, nbytes


def phase_l(dev) -> dict:
    """The grid-state kernel at phase C's discretisation and at pg2's Q3
    level (f64): against the eager ``hess_state`` body and the plain
    version, its determinism, and its times."""
    nh, _, _ = neohookean_ex3(dev)
    q3 = NonlinearForm(FESpace(M.make_cartesian_2d(80, 80), 3), device=dev,
                       dtype=torch.float64)
    q3.add_ad_integrator(DiffusionEnergy(2), ADEval.GRAD)
    rows = {}
    for name, form, amp in (("512x512 Q1 vdim 2 neo-Hookean", nh,
                             AMP / HEADLINE_N),
                            ("80x80 Q3 diffusion", q3, 1.0)):
        intg = form.integrators[0]
        u = seeded(form.ndof, amp, 23, torch.float64, dev)
        refusal = intg.route_refusal("grid_state")
        if refusal is not None:
            raise AssertionError(f"L: the route refuses {name}: {refusal}")
        ops = intg.grid_state_operands()

        def kernel():
            return ghs.grid_hess_state(intg.f, u, *ops)

        def plain():
            return ghs.grid_hess_state_plain(intg.f, u, *ops)

        def eager():
            return intg._hess_state_eager([u], sym=True).planes

        ghs.grid_hess_state.launches = 0
        P = kernel()
        err = rel_max(P, eager())
        again = torch.equal(P, kernel())
        err_plain = rel_max(plain(), eager())
        torch.cuda.synchronize()
        launches = ghs.grid_hess_state.launches
        log(f"L {name}: kernel vs eager {err:.3e} max|H| (tol 1e-13), "
            f"plain vs eager {err_plain:.3e}, two calls bitwise equal: "
            f"{again}, launches {launches}")
        if err > 1e-13 or err_plain > 1e-13 or not again or launches != 2:
            raise AssertionError(f"L: the grid-state kernel disagrees on "
                                 f"{name}")
        del P
        k_ms, e_ms, p_ms = call_ms(kernel), call_ms(eager), call_ms(plain)
        k_rows = device_profile(kernel, reps=20)
        for kname, t in k_rows:
            log(f"L kernel device {t:.4f} ms  {kname[:90]}")
        k_dev = sum(t for k, t in k_rows if "ghs::" in k) or k_ms
        e_dev = device_ms(eager, None, e_ms)
        p_dev = device_ms(plain, None, p_ms)
        b_ms, b_by, flops, nbytes = grid_state_bound(
            intg, bj.param_sizes(ops[2]), torch.float64)
        log(f"L grid_hess_state {name} f64: kernel device {k_dev:.4f} ms "
            f"(events {k_ms:.4f}), eager hess_state device {e_dev:.4f} ms "
            f"(events {e_ms:.4f}), plain device {p_dev:.4f} ms (events "
            f"{p_ms:.4f}); bound {b_ms:.4f} ms ({b_by}: {flops:,} f64 "
            f"operations, {nbytes:,} bytes), kernel at {b_ms / k_dev:.1%} "
            "of it")
        rows[name] = {"launches": launches, "err": err, "ms": k_dev,
                      "events_ms": k_ms, "plain_ms": p_dev,
                      "eager_ms": e_dev, "eager_events_ms": e_ms,
                      "bound_ms": b_ms, "bound_by": b_by}
    return rows


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
    torch.cuda.synchronize()
    launches = fj.fused_element_jacobian.launches
    if launches < 1:
        raise AssertionError("the main path never launched the kernel")
    log(f"phase B ok: {tuple(A_main.shape)} finite, symmetric to "
        f"{asym:.3e} max|A|, kernel launches on the main path {launches}")
    # the Newton–CG main path: each direction linearizes once (the
    # grid-state kernel) and CG applies the Jacobian once before its loop
    # and once per loop pass (the grid apply)
    ghs.grid_hess_state.launches = 0
    ghm.grid_grad_mult.launches = 0
    res, wall = phase_c_main(form, fes, b)
    torch.cuda.synchronize()
    c_state = ghs.grid_hess_state.launches
    c_apply = ghm.grid_grad_mult.launches
    directions = len(res.lin_iters)
    log(f"C kernel launches on the main path: grid_hess_state {c_state} "
        f"({directions} directions), grid_grad_mult {c_apply} (CG "
        f"iterations {sum(res.lin_iters)})")
    if c_state != directions:
        raise AssertionError(
            f"the C main path launched the grid-state kernel {c_state} "
            f"times in {directions} Newton directions")
    if c_apply < sum(res.lin_iters) + directions:
        raise AssertionError(
            f"the C main path launched the grid apply {c_apply} times for "
            f"{sum(res.lin_iters)} CG iterations")
    log("phase C ok")

    phase_c_breakdown(form, res.x)
    c_run = (res.x, res.lin_iters, wall)
    err, k_ms, p_ms = phase_b_timing(intg, u, A_main)
    b_ms, b_by = bound(intg.tables["edof"][0].shape[0], intg.nq,
                       intg.n_input, 8, 2, torch.float32)
    args = intg.kernel_inputs([u])
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
            f"{ci.route_refusal('kernel') or 'applies'}; AD kernel: "
            f"{ci.route_refusal('kernel_ad') or 'applies'}; route {route}")
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
            f"{ci.route_refusal('kernel') or 'applies'}, blocked-W0: "
            f"{ci.uses_blocked_kernel()}")
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

    # no element-Jacobian kernel lies on phase G's path: their launch
    # counts stay 0; the grid kernels (apply, state) serve its structured
    # 2D H1 forms on the card and count what they launch
    kernels = (fj.fused_element_jacobian, adj.ad_element_jacobian,
               bj.blocked_element_jacobian, ghm.grid_grad_mult,
               ghs.grid_hess_state)
    tally = "(full-W, AD, blocked, grid apply, grid state)"
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
    log(f"G kernel launches {tally}: {[k.launches for k in kernels]}")

    # no element-Jacobian kernel lies on phase H's path either
    # (element-varying geometry and two-space forms take two-stage; H3's
    # structured reference is asked for two-stage)
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
    log(f"H kernel launches {tally}: {[k.launches for k in kernels]}")

    # nor on phase I's: the dof-PG form is a two-space form, SiMPL's state
    # solve is matrix-free, the load vector and GLVis are host work
    for k in kernels:
        k.launches = 0
    for phase, args in ((phase_i1, (dev,)), (phase_i2, (dev,)),
                        (phase_i3, ()), (phase_i4, (dev,))):
        t0 = time.perf_counter()
        phase(*args)
        torch.cuda.empty_cache()
        log(f"{phase.__name__}: {time.perf_counter() - t0:.1f} s")
    log(f"I kernel launches {tally}: {[k.launches for k in kernels]}")

    # nor on phase J's: its ranks are processes of their own and count
    # their own launches
    for k in kernels:
        k.launches = 0
    t0 = time.perf_counter()
    phase_j12(dev)
    torch.cuda.empty_cache()
    log(f"phase_j12: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    phase_j3()
    log(f"phase_j3: {time.perf_counter() - t0:.1f} s")
    log(f"J kernel launches in this process {tally}: "
        f"{[k.launches for k in kernels]}")

    t0 = time.perf_counter()
    grid = phase_k(dev)
    torch.cuda.empty_cache()
    log(f"phase_k: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    state = phase_l(dev)["512x512 Q1 vdim 2 neo-Hookean"]
    torch.cuda.empty_cache()
    log(f"phase_l: {time.perf_counter() - t0:.1f} s")

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
    }, {
        "name": "grid_grad_mult",
        "route": "cuda",
        "source": "mfem_ad_tpu_torch/csrc/grid_hess_mult.cuh",
        "replaces": "none: the JAX package's hess_mult "
                    "(mfem_ad_tpu/integrator.py:1212) is plain jnp",
        "launches": c_apply,
        "max_rel_err": grid["err"],
        "ms": grid["ms"],
        "plain_ms": grid["plain_ms"],
        "eager_ms": grid["eager_ms"],
        "bound_ms": grid["bound_ms"],
        "bound_by": grid["bound_by"],
    }, {
        "name": "grid_hess_state",
        "route": "cuda",
        "source": "mfem_ad_tpu_torch/csrc/grid_hess_state.cuh + "
                  "ad::HessianEntries from "
                  "mfem_ad_tpu_torch/csrc/ad_jacobian.cuh",
        "replaces": "none: the JAX package's hess_state "
                    "(mfem_ad_tpu/integrator.py:1165) is vmapped "
                    "jacfwd(grad), which XLA fuses",
        "launches": c_state,
        "max_rel_err": state["err"],
        "ms": state["ms"],
        "plain_ms": state["plain_ms"],
        "eager_ms": state["eager_ms"],
        "bound_ms": state["bound_ms"],
        "bound_by": state["bound_by"],
    }]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
