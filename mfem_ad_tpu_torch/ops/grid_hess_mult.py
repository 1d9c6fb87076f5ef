"""Matrix-free Jacobian apply of a structured 2D H1 form from its packed
Hessian state, in one hand-written CUDA kernel of two passes.

For a single-space integrator on a structured 2D H1 dof grid with a
uniform Jacobian (element-shared B) and a packed Newton state (the
``SymHess`` planes), the Jacobian action of ``NonlinearForm.grad_mult``,

    y = where(ess, v, scatter(R^T (H (R gather(where(ess, 0, v)))))),

is ``grid_grad_mult``: on a CUDA tensor the kernel of
``csrc/grid_hess_mult.cuh`` (an element pass that gathers the element's
dofs, forms x = R u at each point, applies the packed symmetric Hessian
reading each plane once and forms the element vector; then a dof pass that
sums each dof's element values in the grid scatter's order and applies the
mask), on a CPU tensor the plain PyTorch version
``grid_grad_mult_plain``.  Neither uses atomics: the same input gives
bitwise the same output, in an eager call and in a CUDA graph's replay.

It replaces no TPU kernel.  The JAX package's ``hess_mult`` is plain jnp,
which XLA fuses on the TPU; eager PyTorch runs it as about 43 kernels and
streams about 2 GB of temporaries per apply at 512^2 Q1 vdim 2, where the
work needs the planes once (189 MB) and the vectors.

Both take tensors and the grid's integer shape.  The integrator decides
where the kernel serves (``ADBlockIntegrator.route_refusal("grid",
state)``) and builds its operands (``ADBlockIntegrator.grid_operands``).
The kernel template is instantiated per (vdim, nd, nq, sd), read from the
operands' shapes, in one small generated ``.cu`` that ``ops/nvcc.py``
compiles at its first use.  Nothing is built or loaded when the module is
imported.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from . import nvcc
from .blocked_jacobian import check_cuda_operand, check_operand

HEADERS = ("grid_hess_mult.cuh",)
ELEMS = 32  # elements per block of the element pass (ghm::kElems)
MAX_POINTS = 1024 // ELEMS  # one thread per (element, point) of a block

_ARGTYPES = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 3 + [
    ctypes.c_void_p, ctypes.c_void_p]


@functools.lru_cache(maxsize=None)
def kernel_source(vdim: int, nd: int, nq: int, sd: int) -> str:
    """The ``.cu`` translation unit of one instantiation: ``extern "C"``
    launchers ``ghm_launch_f32`` and ``ghm_launch_f64``."""
    lines = ['#include "grid_hess_mult.cuh"', ""]
    for suffix, s in (("f32", "float"), ("f64", "double")):
        lines += [
            f'extern "C" int ghm_launch_{suffix}(const void* v, '
            "const void* ess, const void* planes, const void* B0, void* re, "
            "void* out, int nx, int ny, int p, const int* offs, "
            "void* stream) {",
            f"  return ghm::launch<{s}, {vdim}, {nd}, {nq}, {sd}>(v, ess, "
            "planes, B0, re, out, nx, ny, p, offs, "
            "static_cast<cudaStream_t>(stream));",
            "}",
            "",
        ]
    return "\n".join(lines)


def load_library(vdim: int, nd: int, nq: int, sd: int):
    """The library of one instantiation, built at its first use."""
    return nvcc.load_library(
        "grid_hess_mult", kernel_source(vdim, nd, nq, sd), HEADERS,
        {"ghm_launch_f32": _ARGTYPES, "ghm_launch_f64": _ARGTYPES})


def element_dofs(u, offs, nx: int, ny: int, p: int, vdim: int):
    """The element dofs [vdim, nd, ne] of the dof vector ``u`` (byNODES)
    on the structured grid: element e = ey*nx + ex, node d at offset
    ``offs[d]`` (x, y) from the element's corner."""
    NX, NY = nx * p + 1, ny * p + 1
    dev = u.device
    ex = torch.arange(nx, device=dev).repeat(ny)
    ey = torch.arange(ny, device=dev).repeat_interleave(nx)
    o = torch.as_tensor(np.asarray(offs, dtype=np.int64), device=dev)
    dof = (ey[None] * p + o[:, 1, None]) * NX + ex[None] * p + o[:, 0, None]
    return u.reshape(vdim, NY * NX)[:, dof]


def grid_grad_mult_plain(v, ess, planes, B0, offs, nx: int, ny: int,
                         p: int, vdim: int):
    """Plain PyTorch version of the kernel.

    Args:
        v: [vdim*nds] dof vector, byNODES (c*nds + NX*gy + gx).
        ess: [vdim*nds] bool essential-dof mask, or None (no mask).
        planes: [K, ne, nq] packed Hessian planes, pair order (a, b),
            a <= b, K = n(n+1)/2, n = vdim*sd, weights folded in.
        B0: [nq, nd, sd] element-shared shape tensor.
        offs: [nd, 2] node offsets (x, y) on the dof grid.
        nx, ny, p: elements per row and column, and the order.
        vdim: components.

    Returns:
        [vdim*nds]: v at essential dofs, else the Jacobian action on v
        with the essential entries of v zeroed.
    """
    nq, nd, sd = B0.shape
    n, ne = vdim * sd, nx * ny
    NX, NY = nx * p + 1, ny * p + 1
    u = v if ess is None else torch.where(ess, 0.0, v)
    ue = element_dofs(u, offs, nx, ny, p, vdim)
    x = torch.einsum("qdk,cde->eqck", B0, ue).reshape(ne, nq, n)
    y = [torch.zeros_like(x[..., 0]) for _ in range(n)]
    k = 0
    for a in range(n):
        for b in range(a, n):
            y[a] = y[a] + planes[k] * x[..., b]
            if a != b:
                y[b] = y[b] + planes[k] * x[..., a]
            k += 1
    y = torch.stack(y, dim=-1).reshape(ne, nq, vdim, sd)
    re = torch.einsum("qdk,eqck->cde", B0, y)  # the element buffer
    out = torch.zeros((vdim, NY, NX), dtype=v.dtype, device=v.device)
    for d in range(nd):  # the dof pass's order
        ai, aj = int(offs[d][0]), int(offs[d][1])
        out[:, aj:aj + (ny - 1) * p + 1:p, ai:ai + (nx - 1) * p + 1:p] += (
            re[:, d].reshape(vdim, ny, nx))
    out = out.reshape(-1)
    return out if ess is None else torch.where(ess, v, out)


def grid_grad_mult(v, ess, planes, B0, offs, nx: int, ny: int, p: int,
                   vdim: int):
    """The Jacobian action on the dof vector ``v`` with ``ess`` (a bool
    mask over the dofs) eliminated as ``NonlinearForm.grad_mult`` does, or
    without elimination where ``ess`` is None
    (``ADBlockIntegrator.hess_mult``); arguments as in
    ``grid_grad_mult_plain``.

    CPU tensors take the plain version.  CUDA tensors launch the kernel
    (counted in ``grid_grad_mult.launches``) or raise; there is no
    fallback on the device."""
    if v.device.type == "cpu":
        return grid_grad_mult_plain(v, ess, planes, B0, offs, nx, ny, p,
                                    vdim)
    check_cuda_operand(v)
    nq, nd, sd = B0.shape
    if nq > MAX_POINTS:
        raise ValueError(f"{nq} points per element (at most {MAX_POINTS})")
    n, ne = vdim * sd, nx * ny
    ndof = vdim * (nx * p + 1) * (ny * p + 1)
    check_operand("v", v, (ndof,), v)
    check_operand("planes", planes, (n * (n + 1) // 2, ne, nq), v)
    check_operand("B0", B0, (nq, nd, sd), v)
    if ess is not None and (ess.dtype != torch.bool or ess.device != v.device
                            or tuple(ess.shape) != (ndof,)
                            or not ess.is_contiguous()):
        raise ValueError(f"ess: {ess.dtype} {tuple(ess.shape)} on "
                         f"{ess.device}, expected a contiguous bool "
                         f"({ndof},) on {v.device}")
    offs = np.ascontiguousarray(offs, dtype=np.int32)
    out = torch.empty_like(v)
    re = torch.empty((vdim * nd, ne), dtype=v.dtype, device=v.device)
    lib = load_library(vdim, nd, nq, sd)
    fn = lib.ghm_launch_f32 if v.dtype == torch.float32 else (
        lib.ghm_launch_f64)
    with torch.cuda.device(v.device):
        stream = torch.cuda.current_stream(v.device).cuda_stream
        err = fn(v.data_ptr(), None if ess is None else ess.data_ptr(),
                 planes.data_ptr(), B0.data_ptr(), re.data_ptr(),
                 out.data_ptr(), nx, ny, p, offs.ctypes.data, stream)
    if err != 0:
        raise RuntimeError(
            f"grid_hess_mult kernel launch failed: CUDA error {err}")
    grid_grad_mult.launches += 1
    return out


grid_grad_mult.launches = 0
