"""Generic AD element-Jacobian assembly: any point energy, code-generated
and differentiated by nested dual numbers in one hand-written CUDA kernel.

Replaces the TPU kernel ``mfem_ad_tpu/ops/fused_jacobian.py:_kernel``, both
branches (closed Hessian for Mass/Diffusion, generic HVP sweep for every
other energy).  For every element e of a structured single-space
integrator with a full contraction factor W

    A_e[i, j] = sum_q w_q sum_{a,b} R[(q,a), i] H_ab(x_q) R[(q,b), j],
    x_q = R_q ue_e,   H = d2 f.energy / dx2.

The kernel is the element-Jacobian GEMM of ``csrc/blocked_jacobian.cuh``
instantiated as the full-W kernel is (vdim = 1, sd = n, nd = nde, B0 = Bf,
factor W; ``ops/fused_jacobian.py``), with ``ad::HessianEntries`` of
``csrc/ad_jacobian.cuh`` as its entries stage: the nested-dual Hessian of
the energy that ``ops/energy_codegen.py`` turns into straight-line C++.
This module writes it into a small ``.cu``, which ``ops/nvcc.py`` compiles
for sm_90a into ``mfem_ad_tpu_torch/_build/`` under a name that hashes the
generated source, the headers and the flags, and binds through
``ctypes``.  The plain PyTorch version (``ad_element_jacobian_plain``)
computes H with ``torch.func`` and contracts it with one GEMM.
``ad_element_jacobian`` runs the plain version for tensors on the CPU and
the kernel for tensors on a CUDA device.
"""

from __future__ import annotations

import functools
import weakref

import torch
from torch.func import grad, jacfwd

from ..integrator import qpmap
from . import blocked_jacobian as bj
from . import nvcc
from .blocked_jacobian import param_sizes
from .energy_codegen import (
    EnergyCode,
    UnsupportedEnergy,
    cached_trace,
    trace_energy,
)
from .fused_jacobian import (
    check_full_w_operands,
    field_refusal,
    full_w_operands,
    full_w_refusal,
    geometry_refusal,
    kernel_inputs,
    supports_fused,
)

_TRACES: weakref.WeakKeyDictionary = weakref.WeakKeyDictionary()


def energy_code(f, psizes: dict) -> EnergyCode:
    """``trace_energy(f, psizes)``, once per energy object and parameter
    sizes (``energy_codegen.cached_trace``).  Raises ``UnsupportedEnergy``
    as ``trace_energy`` does."""
    return cached_trace(_TRACES, trace_energy, f, psizes)


@functools.lru_cache(maxsize=None)
def kernel_source(code: EnergyCode) -> str:
    """The ``.cu`` translation unit for one traced energy: the headers, the
    generated energy, and ``extern "C"`` launchers for f32 and f64 of the
    element-Jacobian GEMM with vdim = 1, sd = n and the energy's
    nested-dual Hessian as its entries stage (nde is an argument)."""
    n = code.n_input
    if n not in bj.FULL_WIDTHS:
        raise ValueError(f"n = {n} is not among the compiled widths "
                         f"{bj.FULL_WIDTHS}")
    return "\n".join([
        '#include "blocked_jacobian.cuh"',
        "",
        code.source,
        "struct Energy {",
        f"  static constexpr int kInputs = {n};",
        f"  static constexpr int kParams = {code.n_params};",
        "  template <typename T>",
        f"  static AD_HD T eval(const T* x, const T* p) {{ return "
        f"{code.name}<T>(x, p); }}",
        "};",
        "",
        *bj.launcher_source(1, n, "ad::HessianEntries<Energy>"),
    ])


def library_path(code: EnergyCode) -> str:
    """Where the energy's compiled kernel lives: the name hashes the
    generated source, the headers and the compiler flags."""
    return nvcc.library_path("ad_jacobian", kernel_source(code), bj.HEADERS)


def build_library(code: EnergyCode) -> str:
    """Compile the energy's kernel when its library is missing; returns the
    compiler's report (empty when the library already exists).  Raises
    when nvcc is missing or fails."""
    return nvcc.build_library("ad_jacobian", kernel_source(code),
                              bj.HEADERS)


def ad_element_jacobian_plain(f, ue, R, W, wq, params):
    """Plain PyTorch version of the kernel.

    Args:
        f: energy (``n_input``, ``energy(x, p)``).
        ue: [ne, nde] element dofs, byNODES (v, d) flat.
        R: [nq*n, nde] interpolation factor, rows (q, a).
        W: [nq*n*n, nde*nde] contraction factor, rows (q, a, b).
        wq: [nq] element-shared quadrature weights.
        params: name -> [nq, k] element-shared parameter values.

    Returns:
        A [ne, nde, nde].
    """
    ne, nde = ue.shape
    nq = wq.shape[0]
    n = R.shape[0] // nq
    x = (ue @ R.T).reshape(ne, nq, n)
    p = {k: v[None] for k, v in params.items()}
    # jacfwd(grad) may promote f32 to f64 (see integrator.hess_state)
    H = qpmap(jacfwd(grad(f.energy)), x, p).to(ue.dtype)
    return ((H * wq[:, None, None]).reshape(ne, -1) @ W).reshape(
        ne, nde, nde)


def ad_element_jacobian(f, ue, R, W, wq, params):
    """A [ne, nde, nde] = element Jacobians of energy ``f`` (arguments as in
    ``ad_element_jacobian_plain``).

    CPU tensors take the plain version.  CUDA tensors launch the kernel
    (counted in ``ad_element_jacobian.launches``) or raise: an energy that
    does not trace raises ``UnsupportedEnergy``, a shape no launch plan
    fits raises ``ValueError``; there is no fallback on the device."""
    if ue.device.type == "cpu":
        return ad_element_jacobian_plain(f, ue, R, W, wq, params)
    bj.check_cuda_operand(ue)
    code = energy_code(f, param_sizes(params))
    n = code.n_input
    ne, nde, nq = check_full_w_operands(ue, R, W, wq, n)
    prm = bj.packed_params(code, params, nq, ue)
    A = torch.empty((ne, nde, nde), dtype=ue.dtype, device=ue.device)
    if ne == 0:
        return A
    plan = bj.launch_plan(1, n, nde, nq, ue.dtype)
    B0, Ww = full_w_operands(R, W, wq, n, plan)
    lib = bj.load_library("ad_jacobian", kernel_source(code))
    bj.launch(lib, "ad_jacobian", ue, B0, Ww, prm, A, nq, nde, plan)
    ad_element_jacobian.launches += 1
    return A


ad_element_jacobian.launches = 0


def _tables_on_cuda(intg) -> bool:
    return intg.tables["w"].device.type == "cuda"


def ad_kernel_route_refusal(intg) -> str | None:
    """Why the AD kernel cannot assemble this integrator's element
    Jacobians, or None when it can.  The energy is traced once per energy
    object (``energy_code``)."""
    t = intg.tables
    if intg.vector_fn:
        return ("vector integrands (ADVectorFunction) have no scalar "
                "energy to differentiate")
    if intg.field_kinds:
        return field_refusal(intg)
    why = geometry_refusal(intg)
    if why is not None:
        return why
    if not _tables_on_cuda(intg):
        return "the AD kernel runs on CUDA tables only"
    if not supports_fused(intg):
        return "tables do not admit a fused kernel (supports_fused)"
    if "0_0" not in t["W"]:
        return ("no full W factor: blocked-W0 configurations take the "
                "blocked-W0 kernel or two-stage")
    why = full_w_refusal(intg)
    if why is not None:
        return why
    try:
        energy_code(intg.f, param_sizes(t["static"]))
    except UnsupportedEnergy as e:
        return f"the energy does not trace: {e}"
    return None


def element_jacobian_via_ad_kernel(intg, ublocks):
    """``intg.element_matrices(intg.hess_state(ublocks), 0, 0)`` through
    the AD kernel; raises where the kernel does not apply."""
    why = ad_kernel_route_refusal(intg)
    if why is not None:
        raise ValueError(f"AD kernel route unavailable: {why}")
    return ad_element_jacobian(intg.f, *kernel_inputs(intg, ublocks))
