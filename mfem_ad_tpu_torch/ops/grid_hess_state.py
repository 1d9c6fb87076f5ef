"""The packed Newton state of a structured 2D H1 form, in one hand-written
CUDA kernel.

For a single-space integrator on a structured 2D H1 dof grid with a
uniform Jacobian (element-shared B), element-shared quadrature weights and
parameters, the packed state of ``ADBlockIntegrator.hess_state(...,
sym=True)``,

    planes[k(a, b), e, q] = w_q d2 f / dx_a dx_b (x_eq, p_q),  a <= b,
    x_eq = R_q gather(u)_e,

is ``grid_hess_state``: on a CUDA tensor the kernel of
``csrc/grid_hess_state.cuh`` (one thread per element point: it gathers the
element's dofs, forms x at its point, evaluates the Hessian by nested
duals of the traced energy, ``ad::HessianEntries`` of
``csrc/ad_jacobian.cuh``, and writes the weighted upper triangle), on a
CPU tensor the plain PyTorch version
``grid_hess_state_plain``.  The kernel uses no atomics: the same input
gives bitwise the same output.

It replaces no TPU kernel.  The JAX package's ``hess_state`` is
``vmap(jacfwd(grad(f)))``, which XLA fuses on the TPU; in eager PyTorch
the same ``torch.func`` program issues about 1,900 aten and prims calls
per state whatever the grid's size, and a six-level nonlinear multigrid
linearizes six levels per Newton direction.  The work is small: at 512^2
Q1 vdim 2 in float64 the state is 10 planes of 2,359,296 points (189 MB
written), and ten hyper-dual evaluations of a 22-operation energy per
point.

Both take the energy object, tensors and the grid's integer shape.  The
integrator decides where the kernel serves
(``ADBlockIntegrator.route_refusal("grid_state")``) and builds its
operands (``ADBlockIntegrator.grid_state_operands``).  The kernel template
is instantiated per traced energy and (vdim, nd, nq, sd), read from the
operands' shapes, in one small generated ``.cu`` that ``ops/nvcc.py``
compiles at its first use.  Nothing is built or loaded when the module is
imported.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch
from torch.func import grad, jacfwd

from ..ad import qpmap
from . import ad_jacobian as adj
from . import nvcc
from .blocked_jacobian import (
    check_cuda_operand,
    check_operand,
    packed_params,
    param_sizes,
)
from .energy_codegen import EnergyCode
from .grid_hess_mult import element_dofs

HEADERS = ("grid_hess_state.cuh", "ad_jacobian.cuh", "grid_hess_mult.cuh")

_ARGTYPES = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 3 + [
    ctypes.c_void_p, ctypes.c_void_p]


@functools.lru_cache(maxsize=None)
def kernel_source(code: EnergyCode, vdim: int, nd: int, nq: int,
                  sd: int) -> str:
    """The ``.cu`` translation unit of one traced energy
    (``ad_jacobian.energy_code``) and shape: ``extern "C"`` launchers
    ``ghs_launch_f32`` and ``ghs_launch_f64``."""
    n = code.n_input
    if n != vdim * sd:
        raise ValueError(f"the trace takes n = {n} inputs, not vdim*sd = "
                         f"{vdim * sd}")
    lines = [
        '#include "grid_hess_state.cuh"', "", code.source,
        "struct Energy {",
        f"  static constexpr int kInputs = {n};",
        f"  static constexpr int kParams = {code.n_params};",
        "  template <typename T>",
        f"  static AD_HD T eval(const T* x, const T* p) {{ return "
        f"{code.name}<T>(x, p); }}",
        "};",
        "",
    ]
    for suffix, s in (("f32", "float"), ("f64", "double")):
        lines += [
            f'extern "C" int ghs_launch_{suffix}(const void* u, '
            "const void* B0, const void* wq, const void* prm, void* planes, "
            "int nx, int ny, int p, const int* offs, void* stream) {",
            f"  return ghs::launch<{s}, {vdim}, {nd}, {nq}, {sd}, "
            "ad::HessianEntries<Energy>>(u, B0, wq, prm, planes, nx, ny, p, "
            "offs, static_cast<cudaStream_t>(stream));",
            "}",
            "",
        ]
    return "\n".join(lines)


def load_library(source: str):
    """The library of one instantiation, built at its first use."""
    return nvcc.load_library(
        "grid_hess_state", source, HEADERS,
        {"ghs_launch_f32": _ARGTYPES, "ghs_launch_f64": _ARGTYPES})


def grid_hess_state_plain(f, u, B0, wq, params, offs, nx: int, ny: int,
                          p: int, vdim: int):
    """Plain PyTorch version of the kernel.

    Args:
        f: energy (``n_input``, ``energy(x, p)``), n = vdim*sd inputs.
        u: [vdim*nds] dof vector, byNODES (c*nds + NX*gy + gx).
        B0: [nq, nd, sd] element-shared shape tensor.
        wq: [nq] element-shared quadrature weights.
        params: name -> [nq, k] element-shared parameter values.
        offs: [nd, 2] node offsets (x, y) on the dof grid.
        nx, ny, p: elements per row and column, and the order.
        vdim: components.

    Returns:
        [n(n+1)/2, ne, nq] packed weighted Hessian planes, pair order
        (a, b), a <= b.
    """
    nq, nd, sd = B0.shape
    n, ne = vdim * sd, nx * ny
    ue = element_dofs(u, offs, nx, ny, p, vdim)
    x = torch.einsum("qdk,cde->eqck", B0, ue).reshape(ne, nq, n)
    # jacfwd(grad) may promote f32 to f64 (see integrator.hess_state)
    H = qpmap(jacfwd(grad(f.energy)), x,
              {k: v[None] for k, v in params.items()}).to(u.dtype)
    h = [H[:, :, a, b] for a in range(n) for b in range(a, n)]
    return torch.stack(h) * wq


def grid_hess_state(f, u, B0, wq, params, offs, nx: int, ny: int, p: int,
                    vdim: int):
    """The packed weighted Hessian planes [n(n+1)/2, ne, nq] of energy
    ``f`` at the dof vector ``u`` (arguments as in
    ``grid_hess_state_plain``).

    CPU tensors take the plain version.  CUDA tensors launch the kernel
    (counted in ``grid_hess_state.launches``) or raise: an energy that
    does not trace raises ``UnsupportedEnergy``; there is no
    fallback on the device."""
    if u.device.type == "cpu":
        return grid_hess_state_plain(f, u, B0, wq, params, offs, nx, ny, p,
                                     vdim)
    check_cuda_operand(u)
    nq, nd, sd = B0.shape
    n, ne = vdim * sd, nx * ny
    check_operand("u", u, (vdim * (nx * p + 1) * (ny * p + 1),), u)
    check_operand("B0", B0, (nq, nd, sd), u)
    check_operand("wq", wq, (nq,), u)
    code = adj.energy_code(f, param_sizes(params))
    prm = packed_params(code, params, nq, u)
    offs = np.ascontiguousarray(offs, dtype=np.int32)
    planes = torch.empty((n * (n + 1) // 2, ne, nq), dtype=u.dtype,
                         device=u.device)
    lib = load_library(kernel_source(code, vdim, nd, nq, sd))
    fn = lib.ghs_launch_f32 if u.dtype == torch.float32 else (
        lib.ghs_launch_f64)
    with torch.cuda.device(u.device):
        stream = torch.cuda.current_stream(u.device).cuda_stream
        err = fn(u.data_ptr(), B0.data_ptr(), wq.data_ptr(),
                 None if prm is None else prm.data_ptr(), planes.data_ptr(),
                 nx, ny, p, offs.ctypes.data, stream)
    if err != 0:
        raise RuntimeError(
            f"grid_hess_state kernel launch failed: CUDA error {err}")
    grid_hess_state.launches += 1
    return planes


grid_hess_state.launches = 0
