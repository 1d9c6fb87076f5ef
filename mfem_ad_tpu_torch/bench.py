"""Benchmark: AD element Jacobians assembled per second on one GPU.

    python -m mfem_ad_tpu_torch.bench                 # the headline line
    BENCH_SWEEP=1 python -m mfem_ad_tpu_torch.bench   # sweep table first

The headline is the JAX package's ``bench.py`` configuration: p=1 2D
vdim=2 neo-Hookean (GRAD|VECTOR) on 512x512 quads, f32, 262,144 elements,
through ``ADBlockIntegrator.element_jacobians`` on the default route (the
kernel the integrator selects).  The state is u = (0.1/n) N(0, 1) from seed
0 (0.2/n inverts elements at 512x512).  One call is timed by CUDA events;
the rate is elements over the median of 20 calls after 3 warm-up calls.

Prints ONE JSON line on stdout: {"metric", "value", "unit",
"vs_baseline"}, with ``vs_baseline`` the rate over 1.0e7 element
Jacobians/s, the CPU bracket the JAX package's bench normalizes by.

``BENCH_SWEEP=1`` first prints a markdown table to stderr: p = 1..3, 2D at
512^2 (p3 at 256^2) and 3D at 32^3 (p3 at 16^3), vector neo-Hookean f32,
and two unstructured rows at p1 (the JAX bench's): 2D on the triangles of
512^2 cells with their structure dropped and Morton-sorted
(``unstructured_triangles``, 524,288 elements, in place of the JAX bench's
sloped-rectangle file) and 3D on 16^3 Kuhn-split cubes (24,576 tets),
with the residual and Jacobian rates (default route) and the rate of the
AD kernel route, each Jacobian rate beside its share of the f32 FMA bound
at 67 TFLOP/s (H100 SXM): the contraction and interpolation FMAs its
route executes per element, times the rate, over the peak.  A size that
does not fit on the card fails.

Without a CUDA device ``main`` exits with an error.  The functions take
a ``device``, and time through ``call_ms``, so the tests can run them at a
tiny size on the CPU with a stubbed ``call_ms``.
"""

from __future__ import annotations

import json
import os
import statistics
import sys

import numpy as np
import torch

from . import mesh as M
from .ad import NeoHookeanEnergy
from .adeval import ADEval
from .fespace import FESpace
from .integrator import ADBlockIntegrator
from .quadrature import TETRAHEDRON, TRIANGLE
from .ops.ad_jacobian import ad_kernel_route_refusal
from .ops.fused_jacobian import uses_blocked_kernel

CPU_BASELINE = 1.0e7  # element Jacobians / s (the JAX bench's bracket)
# FLOP/s, H100 SXM outside the tensor cores (NVIDIA data sheet, 700 W)
PEAK_FLOPS = {torch.float32: 67e12, torch.float64: 34e12}
# (order, dim, n) of the sweep
SWEEP = tuple((p, 2, 256 if p == 3 else 512) for p in (1, 2, 3)) + tuple(
    (p, 3, 16 if p == 3 else 32) for p in (1, 2, 3))
# (order, dim, n, mesh) of the unstructured rows
SWEEP_UNSTRUCTURED = ((1, 2, 512, "unstructured"), (1, 3, 16, "tet"))


def drop_structure(m: M.Mesh, sort: bool = True) -> M.Mesh:
    """``m`` with its structure dropped (the generic dof exchange and the
    geometry pullback serve it), its elements Morton-sorted with
    ``sort``."""
    u = M.Mesh(geom=m.geom, vertices=m.vertices, elements=m.elements,
               attributes=m.attributes, bdr_elements=m.bdr_elements,
               bdr_attributes=m.bdr_attributes, structured=None)
    return M.spatial_sort(u) if sort else u


def unstructured_triangles(n: int) -> M.Mesh:
    """The n x n cells of the unit square split into triangles, with the
    structure dropped and the elements Morton-sorted."""
    return drop_structure(M.make_cartesian_2d(n, n, TRIANGLE))


def build(order: int, dim: int, n: int, device="cuda", mesh: str = "cart"):
    """Vector neo-Hookean integrator (f32) on an n^dim mesh, ``mesh``
    "cart" (structured quads or hexes), "unstructured"
    (``unstructured_triangles``, dim 2) or "tet" (Kuhn-split cubes, dim
    3), and a seeded state u = (a/n) N(0, 1), a = 0.1 at p1 and 0.01 at
    p >= 2 (larger states invert elements: det F <= 0 gives NaN)."""
    if mesh == "unstructured":
        m = unstructured_triangles(n)
    elif mesh == "tet":
        m = M.make_cartesian_3d(n, n, n, geom=TETRAHEDRON)
    else:
        m = M.make_cartesian_2d(n, n) if dim == 2 else M.make_cartesian_3d(
            n, n, n)
    fes = FESpace(m, order, vdim=dim)
    intg = ADBlockIntegrator(NeoHookeanEnergy(dim, 1.0, 1.0), [fes],
                             [ADEval.GRAD | ADEval.VECTOR], device=device,
                             dtype=torch.float32)
    rng = np.random.default_rng(0)
    amp = 0.1 if order == 1 else 0.01
    u = torch.as_tensor((amp / n) * rng.standard_normal(fes.ndof),
                        dtype=torch.float32, device=device)
    return intg, u


def call_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    """Median ms of one call by CUDA events, after ``warmup`` calls."""
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


def elements(intg) -> int:
    return int(intg.tables["edof"][0].shape[0])


def full_w_fmas(nq: int, n: int, nde: int) -> int:
    """FMAs per element of the full-W route: the GEMM against W = Bf (x)
    Bf (nq n^2 nde^2) and the interpolation x = R u (nq n nde)."""
    return nq * (n * n * nde * nde + n * nde)


def blocked_fmas(nq: int, vdim: int, sd: int, nd: int) -> int:
    """FMAs per element of the blocked-W0 route: one GEMM per (v, w)
    against W0 = b0 (x) b0 (vdim^2 nd^2 nq sd^2) and the interpolation
    from B0 (nq vdim sd nd)."""
    return nq * (vdim * vdim * nd * nd * sd * sd + vdim * sd * nd)


def fmas_per_element(intg, route: str) -> int:
    """Contraction and interpolation FMAs per element of ``route``: the
    blocked W0 GEMM, the full-W GEMM or the per-qp einsum; the energy's
    own arithmetic is left out."""
    t = intg.tables
    nq, n = intg.nq, intg.n_input
    v, nd, sd = intg.vdim[0], intg.nd[0], intg.sd[0]
    nde = v * nd
    blocked = (uses_blocked_kernel(intg) if route == "kernel"
               else route == "two_stage" and "0_0" in t["W0"])
    if blocked:
        return blocked_fmas(nq, v, sd, nd)
    if "0_0" in t["W"]:
        return full_w_fmas(nq, n, nde)
    return nq * (nde * n * n + nde * nde * n + n * nde)


def jacobian_rate(intg, u, route: str = "auto") -> float:
    """Element Jacobians per second of ``element_jacobians`` on
    ``route``."""
    ms = call_ms(lambda: intg.element_jacobians([u], route=route))
    return elements(intg) / (ms / 1e3)


def residual_rate(intg, u) -> float:
    """Element residuals per second of ``residual``."""
    ms = call_ms(lambda: intg.residual([u]))
    return elements(intg) / (ms / 1e3)


def fma_share(intg, route: str, rate: float) -> float:
    """The f32 FMA bound's time over the measured time per element."""
    return (rate * 2.0 * fmas_per_element(intg, route)
            / PEAK_FLOPS[torch.float32])


def headline(device="cuda", n: int = 512) -> dict:
    """The bench line at the headline configuration (n x n, p1 2D)."""
    intg, u = build(1, 2, n, device)
    rate = jacobian_rate(intg, u)
    return {"metric": "element_jacobians_per_sec", "value": rate,
            "unit": "elem/s", "vs_baseline": rate / CPU_BASELINE}


def sweep_row(order: int, dim: int, n: int, device="cuda",
              mesh: str = "cart") -> dict:
    """One sweep row: residual, default-route and AD-route rates (the AD
    rate None where that route refuses, with the reason)."""
    intg, u = build(order, dim, n, device, mesh)
    route = intg.auto_route()
    jac = jacobian_rate(intg, u)
    row = dict(order=order, dim=dim, mesh=mesh, elems=elements(intg),
               residual=residual_rate(intg, u), jacobian=jac, route=route,
               share=fma_share(intg, route, jac), ad=None, ad_share=None,
               ad_refusal=ad_kernel_route_refusal(intg))
    if row["ad_refusal"] is None:
        row["ad"] = jacobian_rate(intg, u, "kernel_ad")
        row["ad_share"] = fma_share(intg, "kernel_ad", row["ad"])
    del intg, u
    return row


def format_row(r: dict) -> str:
    ad = ("refused | —" if r["ad"] is None
          else f"{r['ad']:.6e} | {100 * r['ad_share']:.1f}%")
    label = "" if r.get("mesh", "cart") == "cart" else f" {r['mesh']}"
    return (f"| p={r['order']}{label} | {r['dim']}D | {r['elems']} | "
            f"{r['residual']:.6e} | {r['jacobian']:.6e} ({r['route']}) | "
            f"{100 * r['share']:.1f}% | {ad} |")


HEADER = ("| order | dim | elems | residual elem/s | jacobian elem/s "
          "(route) | FMA share | AD route elem/s | AD FMA share |\n"
          "| --- | --- | --- | --- | --- | --- | --- | --- |")


def main() -> int:
    if not torch.cuda.is_available():
        print("bench: no CUDA device", file=sys.stderr)
        return 1
    print(f"bench: {torch.cuda.get_device_name(0)}", file=sys.stderr)
    if os.environ.get("BENCH_SWEEP", "") == "1":
        print(HEADER, file=sys.stderr, flush=True)
        rows = [c + ("cart",) for c in SWEEP] + list(SWEEP_UNSTRUCTURED)
        for order, dim, n, mesh in rows:
            r = sweep_row(order, dim, n, mesh=mesh)
            print(format_row(r), file=sys.stderr, flush=True)
            if r["ad_refusal"] is not None:
                print(f"  AD route at p={order} {dim}D {mesh}: "
                      f"{r['ad_refusal']}", file=sys.stderr, flush=True)
            torch.cuda.empty_cache()
    print(json.dumps(headline()), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
