"""Fused element-Jacobian assembly: x = R ue, closed-form Hessian entries,
A = (w H) W, per element, in one hand-written CUDA kernel.

Replaces the TPU kernel ``mfem_ad_tpu/ops/fused_jacobian.py:_kernel_tile``.
For every element e of a structured single-space integrator

    A_e[i, j] = sum_q w_q sum_{a,b} R[(q,a), i] H_ab(x_q) R[(q,b), j],
    x_q = R_q ue_e,

computed as ``x = ue @ R.T``, the energy's ``hessian_closed_entries`` on
``[ne, nq]`` tiles, then ``(H * w).reshape(ne, -1) @ W`` with the full
factor W = Bf (x) Bf.  The kernel (``csrc/fused_jacobian.cu``) keeps H in
registers; the plain PyTorch version (``fused_element_jacobian_plain``)
materialises it.  ``fused_element_jacobian`` runs the plain version for
tensors on the CPU and the kernel for tensors on a CUDA device.

The kernel is compiled with ``nvcc`` for sm_90a at first use into
``mfem_ad_tpu_torch/_build/`` (rebuilt when the source is newer) and bound
through ``ctypes``.
"""

from __future__ import annotations

import ctypes
import functools
import os
import shutil
import subprocess

import torch

from ..ad import LinearElasticityEnergy, NeoHookeanEnergy

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join(_PKG, "csrc", "fused_jacobian.cu")
BUILD_DIR = os.path.join(_PKG, "_build")
LIBRARY = os.path.join(BUILD_DIR, "libfused_jacobian.so")
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

# Sizes the kernel is compiled for: 2D GRAD|VECTOR input (n = vdim*sd = 4)
# on Q1 quads (nde = vdim*nd = 8).
KERNEL_N = 4
KERNEL_NDE = 8
SMEM_LIMIT = 232_448  # dynamic shared memory one Hopper block may use

# energy class and dimension -> the kernel's Hessian entry function
_CUDA_ENERGIES = {
    (NeoHookeanEnergy, 2): 0,
    (LinearElasticityEnergy, 2): 1,
}


def cuda_energy_id(f) -> int | None:
    """The kernel's entry-function id for energy ``f``, or None when the
    kernel has no CUDA Hessian entries for it."""
    return _CUDA_ENERGIES.get((type(f), getattr(f, "dim", None)))


def supports_fused(intg, s: int = 0) -> bool:
    """True when the integrator's tables admit a fused element-Jacobian
    kernel for the (s, s) block: shared R plus a full W (or a blocked W0
    with closed-form entries and a pure-GRAD vector layout), one space,
    element-shared static parameters and quadrature weights."""
    t = intg.tables
    if "R" not in t:
        return False
    has_w = f"{s}_{s}" in t["W"]
    has_w0 = (
        f"{s}_{s}" in t["W0"]
        and intg.f.hessian_closed_entries is not None
        and intg.n_input == intg.vdim[s] * intg.sd[s]
    )
    if not (has_w or has_w0) or len(intg.spaces) != 1:
        return False
    if not all(v.shape[0] == 1 for v in t["static"].values()):
        return False
    return t["w"].shape[0] == 1


def kernel_route_refusal(intg) -> str | None:
    """Why the CUDA kernel cannot assemble this integrator's element
    Jacobians, or None when it can."""
    t = intg.tables
    if t["w"].device.type != "cuda":
        return "the kernel runs on CUDA tables only"
    if not supports_fused(intg):
        return "tables do not admit a fused kernel (supports_fused)"
    if cuda_energy_id(intg.f) is None:
        return f"no CUDA Hessian entries for {type(intg.f).__name__}"
    if "0_0" in t["W0"] or "0_0" not in t["W"]:
        return "the blocked-W0 kernel is not ported; only full-W configs"
    if intg.n_input != KERNEL_N or intg.vdim[0] * intg.nd[0] != KERNEL_NDE:
        return f"kernel is compiled for n={KERNEL_N}, nde={KERNEL_NDE}"
    if set(t["static"]) != {"lambda", "mu"}:
        return "kernel takes exactly the parameters lambda and mu"
    if any(v.shape[-1] != 1 for v in t["static"].values()):
        return "lambda and mu must be scalar per point"
    if intg.dtype not in (torch.float32, torch.float64):
        return f"unsupported dtype {intg.dtype}"
    if _smem_bytes(intg.nq, intg.dtype) > SMEM_LIMIT:
        return f"nq={intg.nq} does not fit in one block's shared memory"
    return None


def _smem_bytes(nq: int, dtype) -> int:
    n, nde = KERNEL_N, KERNEL_NDE
    elem = torch.empty((), dtype=dtype).element_size()
    return (nq * n * n * nde * nde + nq * n * nde + 2 * nq) * elem


def fused_element_jacobian_plain(f, ue, R, W, wq, params):
    """Plain PyTorch version of the kernel.

    Args:
        f: energy with ``hessian_closed_entries``.
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
    g = [x[..., m] for m in range(n)]
    pt = {k: [v[:, i] for i in range(v.shape[1])] for k, v in params.items()}
    rows = f.hessian_closed_entries(g, pt)
    H = torch.stack(
        [
            torch.as_tensor(h, dtype=ue.dtype, device=ue.device)
            .expand(ne, nq)
            for row in rows for h in row
        ],
        dim=-1,
    )  # [ne, nq, n*n]
    return ((H * wq[:, None]).reshape(ne, -1) @ W).reshape(ne, nde, nde)


def build_library() -> str:
    """Compile the kernel source into ``LIBRARY`` when it is missing or
    older than the source; returns the compiler's report (empty when the
    library was up to date)."""
    if (os.path.exists(LIBRARY)
            and os.path.getmtime(LIBRARY) >= os.path.getmtime(SOURCE)):
        return ""
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(nvcc):
        raise RuntimeError("nvcc not found: the CUDA kernel cannot be built")
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{LIBRARY}.{os.getpid()}.tmp"
    proc = subprocess.run(
        [nvcc, *NVCC_FLAGS, "-o", tmp, SOURCE],
        capture_output=True, text=True,
    )
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed:\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, LIBRARY)
    return proc.stdout + proc.stderr


@functools.lru_cache(maxsize=None)
def _library():
    build_library()
    lib = ctypes.CDLL(LIBRARY)
    for name in ("fj_launch_f32", "fj_launch_f64"):
        fn = getattr(lib, name)
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p] * 6 + [
            ctypes.c_int64, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
        ]
    return lib


def _check_operand(name, t, shape, like):
    if t.device != like.device or t.dtype != like.dtype:
        raise ValueError(
            f"{name}: {t.dtype} on {t.device}, expected {like.dtype} on "
            f"{like.device}"
        )
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected {shape}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def fused_element_jacobian(f, ue, R, W, wq, params):
    """A [ne, nde, nde] = fused element Jacobians (arguments as in
    ``fused_element_jacobian_plain``).

    CPU tensors take the plain version.  CUDA tensors launch the kernel
    (counted in ``fused_element_jacobian.launches``) or raise: there is no
    fallback on the device."""
    if ue.device.type == "cpu":
        return fused_element_jacobian_plain(f, ue, R, W, wq, params)
    if ue.device.type != "cuda":
        raise ValueError(f"unsupported device {ue.device}")
    energy = cuda_energy_id(f)
    if energy is None:
        raise ValueError(f"no CUDA Hessian entries for {type(f).__name__}")
    if ue.dtype not in (torch.float32, torch.float64):
        raise ValueError(f"unsupported dtype {ue.dtype}")
    if set(params) != {"lambda", "mu"}:
        raise ValueError("the kernel takes exactly lambda and mu")
    n, nde = KERNEL_N, KERNEL_NDE
    ne = ue.shape[0]
    nq = wq.shape[0]
    if _smem_bytes(nq, ue.dtype) > SMEM_LIMIT:
        raise ValueError(f"nq={nq} exceeds the kernel's shared memory")
    _check_operand("ue", ue, (ne, nde), ue)
    _check_operand("R", R, (nq * n, nde), ue)
    _check_operand("W", W, (nq * n * n, nde * nde), ue)
    _check_operand("wq", wq, (nq,), ue)
    for k in ("lambda", "mu"):
        _check_operand(k, params[k], (nq, 1), ue)
    A = torch.empty((ne, nde, nde), dtype=ue.dtype, device=ue.device)
    if ne == 0:
        return A
    # fold the element-shared quadrature weights into W's rows
    Ww = (W * wq.repeat_interleave(n * n)[:, None]).contiguous()
    lam = params["lambda"].reshape(nq)
    mu = params["mu"].reshape(nq)
    lib = _library()
    launch = lib.fj_launch_f32 if ue.dtype == torch.float32 else (
        lib.fj_launch_f64
    )
    with torch.cuda.device(ue.device):
        stream = torch.cuda.current_stream(ue.device).cuda_stream
        err = launch(
            ue.data_ptr(), R.data_ptr(), Ww.data_ptr(), lam.data_ptr(),
            mu.data_ptr(), A.data_ptr(), ne, nq, energy, stream,
        )
    if err != 0:
        raise RuntimeError(f"fused_jacobian kernel launch failed: CUDA error {err}")
    fused_element_jacobian.launches += 1
    return A


fused_element_jacobian.launches = 0


def kernel_inputs(intg, ublocks):
    """The operands (ue, R, W, wq, params) of ``fused_element_jacobian``
    for the (0, 0) block of a single-space integrator with a full W."""
    t = intg.tables
    ue = intg.gather(0, ublocks[0])  # [ne, nd, vdim]
    ue2 = ue.permute(0, 2, 1).reshape(ue.shape[0], -1).contiguous()
    params = {k: v[0].contiguous() for k, v in t["static"].items()}
    return (ue2, t["R"][0].contiguous(), t["W"]["0_0"].contiguous(),
            t["w"][0].contiguous(), params)


def element_jacobian_via_kernel(intg, ublocks):
    """``intg.element_matrices(intg.hess_state(ublocks), 0, 0)`` through
    the fused kernel; raises where the kernel does not apply."""
    why = kernel_route_refusal(intg)
    if why is not None:
        raise ValueError(f"kernel route unavailable: {why}")
    return fused_element_jacobian(intg.f, *kernel_inputs(intg, ublocks))
