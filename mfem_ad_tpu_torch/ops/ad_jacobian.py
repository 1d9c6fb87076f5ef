"""Generic AD element-Jacobian assembly: any point energy, code-generated
and differentiated by nested dual numbers in one hand-written CUDA kernel.

Replaces the TPU kernel ``mfem_ad_tpu/ops/fused_jacobian.py:_kernel``, both
branches (closed Hessian for Mass/Diffusion, generic HVP sweep for every
other energy).  For every element e of a structured single-space
integrator with a full contraction factor W

    A_e[i, j] = sum_q w_q sum_{a,b} R[(q,a), i] H_ab(x_q) R[(q,b), j],
    x_q = R_q ue_e,   H = d2 f.energy / dx2.

``ops/energy_codegen.py`` turns ``f.energy`` into straight-line C++; this
module writes it into a small ``.cu`` beside ``csrc/ad_jacobian.cuh`` (the
nested duals and the kernel template), which ``ops/nvcc.py`` compiles for
sm_90a into ``mfem_ad_tpu_torch/_build/`` under a name that hashes the
generated source, the header and the flags, and binds through
``ctypes``.  The plain PyTorch version (``ad_element_jacobian_plain``)
computes H with ``torch.func`` and contracts it with one GEMM.
``ad_element_jacobian`` runs the plain version for tensors on the CPU and
the kernel for tensors on a CUDA device.
"""

from __future__ import annotations

import ctypes
import weakref

import torch
from torch.func import grad, jacfwd

from ..integrator import qpmap
from . import nvcc
from .energy_codegen import (
    EnergyCode,
    UnsupportedEnergy,
    cached_trace,
    trace_energy,
)
from .fused_jacobian import (
    SMEM_LIMIT,
    check_operand,
    kernel_inputs,
    supports_fused,
)

HEADERS = ("ad_jacobian.cuh",)

# (n, nde) the kernel is compiled for: per-qp input width and element
# dofs.  Scalar Q1/Q2 in 2D with VALUE (n=1) or GRAD (n=2), scalar Q1 in
# 3D with GRAD (n=3), and the 2D Q1 vector GRAD headline (n=4).  One thread
# keeps nde^2 <= 81 sums in registers; larger elements need another design.
KERNEL_SIZES = ((1, 4), (1, 9), (2, 4), (2, 9), (3, 8), (4, 8))


def param_sizes(params: dict) -> dict:
    """name -> values per point, from [..., nq, k] parameter tensors."""
    return {k: int(v.shape[-1]) for k, v in params.items()}


_TRACES: weakref.WeakKeyDictionary = weakref.WeakKeyDictionary()


def energy_code(f, psizes: dict) -> EnergyCode:
    """``trace_energy(f, psizes)``, once per energy object and parameter
    sizes (``energy_codegen.cached_trace``).  Raises ``UnsupportedEnergy``
    as ``trace_energy`` does."""
    return cached_trace(_TRACES, trace_energy, f, psizes)


def kernel_source(code: EnergyCode) -> str:
    """The ``.cu`` translation unit for one traced energy: the header, the
    generated energy, and ``extern "C"`` launchers for f32 and f64 at every
    compiled nde for this energy's n."""
    ndes = [nde for n, nde in KERNEL_SIZES if n == code.n_input]
    if not ndes:
        raise ValueError(f"no compiled size for n={code.n_input}")
    lines = [
        '#include "ad_jacobian.cuh"',
        "",
        code.source,
        "struct Energy {",
        f"  static constexpr int kInputs = {code.n_input};",
        f"  static constexpr int kParams = {code.n_params};",
        "  template <typename T>",
        f"  static AD_HD T eval(const T* x, const T* p) {{ return "
        f"{code.name}<T>(x, p); }}",
        "};",
        "",
    ]
    for suffix, s in (("f32", "float"), ("f64", "double")):
        lines += [
            f'extern "C" int adj_launch_{suffix}(const void* ue, '
            "const void* R, const void* Ww, const void* prm, void* A, "
            "int64_t ne, int nq, int nde, void* stream) {",
            "  const cudaStream_t s = static_cast<cudaStream_t>(stream);",
            "  switch (nde) {",
        ]
        lines += [
            f"    case {nde}: return ad::launch<{s}, {nde}, Energy>("
            "ue, R, Ww, prm, A, ne, nq, s);"
            for nde in ndes
        ]
        lines += ["    default: return cudaErrorInvalidValue;", "  }", "}", ""]
    return "\n".join(lines)


def library_path(code: EnergyCode) -> str:
    """Where the energy's compiled kernel lives: the name hashes the
    generated source, the header and the compiler flags."""
    return nvcc.library_path("ad_jacobian", kernel_source(code), HEADERS)


def build_library(code: EnergyCode) -> str:
    """Compile the energy's kernel when its library is missing; returns the
    compiler's report (empty when the library already exists).  Raises
    when nvcc is missing or fails."""
    return nvcc.build_library("ad_jacobian", kernel_source(code), HEADERS)


_ARGTYPES = [ctypes.c_void_p] * 5 + [
    ctypes.c_int64, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]


def _library(code: EnergyCode):
    """The energy's loaded library, built at its first use."""
    return nvcc.load_library(
        "ad_jacobian", kernel_source(code), HEADERS,
        {"adj_launch_f32": _ARGTYPES, "adj_launch_f64": _ARGTYPES})


def smem_bytes(n: int, nde: int, nq: int, n_params: int, dtype) -> int:
    """Dynamic shared memory of one block: W, R and the parameters."""
    elem = torch.empty((), dtype=dtype).element_size()
    return (nq * n * n * nde * nde + nq * n * nde + nq * n_params) * elem


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
    does not trace raises ``UnsupportedEnergy``; there is no fallback on
    the device."""
    if ue.device.type == "cpu":
        return ad_element_jacobian_plain(f, ue, R, W, wq, params)
    if ue.device.type != "cuda":
        raise ValueError(f"unsupported device {ue.device}")
    if ue.dtype not in (torch.float32, torch.float64):
        raise ValueError(f"unsupported dtype {ue.dtype}")
    if ue.dim() != 2:
        raise ValueError(f"ue: shape {tuple(ue.shape)}, expected [ne, nde]")
    ne, nde = ue.shape
    nq = wq.shape[0]
    code = energy_code(f, param_sizes(params))
    n = code.n_input
    if (n, nde) not in KERNEL_SIZES:
        raise ValueError(
            f"(n, nde) = ({n}, {nde}) is not among the compiled sizes "
            f"{KERNEL_SIZES}")
    if smem_bytes(n, nde, nq, code.n_params, ue.dtype) > SMEM_LIMIT:
        raise ValueError(f"nq={nq} exceeds the kernel's shared memory")
    check_operand("ue", ue, (ne, nde), ue)
    check_operand("R", R, (nq * n, nde), ue)
    check_operand("W", W, (nq * n * n, nde * nde), ue)
    check_operand("wq", wq, (nq,), ue)
    if tuple(k for k, _ in code.param_sizes) != tuple(sorted(params)):
        raise ValueError(f"parameters {sorted(params)} differ from the "
                         f"trace's {[k for k, _ in code.param_sizes]}")
    for k, size in code.param_sizes:
        check_operand(k, params[k], (nq, size), ue)
    A = torch.empty((ne, nde, nde), dtype=ue.dtype, device=ue.device)
    if ne == 0:
        return A
    # fold the element-shared quadrature weights into W's rows
    Ww = (W * wq.repeat_interleave(n * n)[:, None]).contiguous()
    prm = (torch.cat([params[k] for k, _ in code.param_sizes], dim=1)
           .contiguous() if code.n_params else None)
    lib = _library(code)
    launch = lib.adj_launch_f32 if ue.dtype == torch.float32 else (
        lib.adj_launch_f64
    )
    with torch.cuda.device(ue.device):
        stream = torch.cuda.current_stream(ue.device).cuda_stream
        err = launch(
            ue.data_ptr(), R.data_ptr(), Ww.data_ptr(),
            None if prm is None else prm.data_ptr(), A.data_ptr(), ne, nq,
            nde, stream,
        )
    if err != 0:
        raise RuntimeError(
            f"ad_jacobian kernel launch failed: CUDA error {err}")
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
    if not _tables_on_cuda(intg):
        return "the AD kernel runs on CUDA tables only"
    if not supports_fused(intg):
        return "tables do not admit a fused kernel (supports_fused)"
    if "0_0" not in t["W"]:
        return ("no full W factor: blocked-W0 configurations take the "
                "blocked-W0 kernel or two-stage")
    n, nde = intg.n_input, intg.vdim[0] * intg.nd[0]
    if (n, nde) not in KERNEL_SIZES:
        return (f"(n, nde) = ({n}, {nde}) is not among the compiled sizes "
                f"{KERNEL_SIZES}")
    if intg.dtype not in (torch.float32, torch.float64):
        return f"unsupported dtype {intg.dtype}"
    psizes = param_sizes(t["static"])
    if smem_bytes(n, nde, intg.nq, sum(psizes.values()),
                  intg.dtype) > SMEM_LIMIT:
        return f"nq={intg.nq} does not fit in one block's shared memory"
    try:
        energy_code(intg.f, psizes)
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
