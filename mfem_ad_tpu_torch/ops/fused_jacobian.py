"""Fused element-Jacobian assembly with the full factor W: x = R ue,
closed-form Hessian entries, A = (w H) W, per element, in one hand-written
CUDA kernel.

Replaces the TPU kernel ``mfem_ad_tpu/ops/fused_jacobian.py:_kernel_tile``.
For every element e of a structured single-space integrator

    A_e[i, j] = sum_q w_q sum_{a,b} R[(q,a), i] H_ab(x_q) R[(q,b), j],
    x_q = R_q ue_e,

with H the energy's ``hessian_closed_entries``.  This is the blocked
kernel's GEMM (``csrc/blocked_jacobian.cuh``, ``ops/blocked_jacobian.py``)
with vdim = 1, sd = n, nd = nde, B0 = Bf (R as [nq, nde, n]) and the full
W = Bf (x) Bf as its factor: the same interpolation, the same (i, j)
output layout and one GEMM over k = (q, a, b).  The entries are those
``energy_codegen.trace_entries`` writes for the blocked kernel, so any
energy whose closed entries trace takes this route wherever the tables
hold a full W and no blocked W0 (``ADBlockIntegrator.uses_blocked_kernel``;
the integrator's ``route_refusal`` decides the route and ``kernel_inputs``
builds the operands).  The plain
PyTorch version (``fused_element_jacobian_plain``) materialises H.
``fused_element_jacobian`` runs the plain version for tensors on the CPU
and the kernel for tensors on a CUDA device.
"""

from __future__ import annotations

import torch

from . import blocked_jacobian as bj
from .blocked_jacobian import check_operand


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


def full_w_operands(R, W, wq, n: int, plan):
    """The full-W instantiation's B0 = Bf [nq, nde, n] (R read as
    [nq, n, nde]) and its tile-major weighted factor, each built once per
    table (``blocked_jacobian.derived``)."""
    nq, nde = wq.shape[0], R.shape[1]
    B0 = bj.derived(R, ("B0", n), (), lambda: R.reshape(
        nq, n, nde).transpose(1, 2).contiguous())
    Ww = bj.derived(W, ("Ww", n, plan), (wq,),
                    lambda: bj.tiled_factor(W, wq, n, plan))
    return B0, Ww


def check_full_w_operands(ue, R, W, wq, n: int):
    """Check the full-W kernel's operands at input width ``n``; returns
    (ne, nde, nq)."""
    if n not in bj.FULL_WIDTHS:
        raise ValueError(f"n = {n} is not among the compiled widths "
                         f"{bj.FULL_WIDTHS}")
    if ue.dim() != 2:
        raise ValueError(f"ue: shape {tuple(ue.shape)}, expected [ne, nde]")
    ne, nde = ue.shape
    nq = wq.shape[0]
    check_operand("ue", ue, (ne, nde), ue)
    check_operand("R", R, (nq * n, nde), ue)
    check_operand("W", W, (nq * n * n, nde * nde), ue)
    check_operand("wq", wq, (nq,), ue)
    return ne, nde, nq


def fused_element_jacobian(f, ue, R, W, wq, params):
    """A [ne, nde, nde] = fused element Jacobians (arguments as in
    ``fused_element_jacobian_plain``).

    CPU tensors take the plain version.  CUDA tensors launch the kernel
    (counted in ``fused_element_jacobian.launches``) or raise: entries that
    do not trace raise ``UnsupportedEnergy``; there is no fallback on the
    device."""
    if ue.device.type == "cpu":
        return fused_element_jacobian_plain(f, ue, R, W, wq, params)
    bj.check_cuda_operand(ue)
    code = bj.entries_code(f, bj.param_sizes(params))
    n = code.n_input
    ne, nde, nq = check_full_w_operands(ue, R, W, wq, n)
    prm = bj.packed_params(code, params, nq, ue)
    A = torch.empty((ne, nde, nde), dtype=ue.dtype, device=ue.device)
    if ne == 0:
        return A
    plan = bj.launch_plan(1, n, nde, nq, ue.dtype)
    B0, Ww = full_w_operands(R, W, wq, n, plan)
    bj.launch(bj._library(code, 1, n), "fused_jacobian", ue, B0, Ww, prm, A,
              nq, nde, plan)
    fused_element_jacobian.launches += 1
    return A


fused_element_jacobian.launches = 0
