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
hold a full W and no blocked W0 (``uses_blocked_kernel``).  The plain
PyTorch version (``fused_element_jacobian_plain``) materialises H.
``fused_element_jacobian`` runs the plain version for tensors on the CPU
and the kernel for tensors on a CUDA device.
"""

from __future__ import annotations

import torch

from . import blocked_jacobian as bj
from .blocked_jacobian import check_operand


def uses_blocked_kernel(intg, s: int = 0) -> bool:
    """True when the closed-entries route takes the blocked-W0 kernel
    (``ops.blocked_jacobian``) for the (s, s) block rather than this
    module's full-W kernel: the energy has closed entries, the integrator
    installed ``W0["s_s"]`` and the input is pure GRAD|VECTOR,
    n = vdim*sd.  The JAX package makes the same choice
    (``fused_jacobian.py:403-416``) but checks n against vdim alone where
    sd is missing."""
    return (f"{s}_{s}" in intg.tables["W0"]
            and intg.f.hessian_closed_entries is not None
            and intg.n_input == intg.vdim[s] * intg.sd[s])


def supports_fused(intg, s: int = 0) -> bool:
    """True when the integrator's tables admit a fused element-Jacobian
    kernel for the (s, s) block: shared R plus a full W (or a blocked W0
    where ``uses_blocked_kernel``), one space, element-shared static
    parameters and quadrature weights."""
    t = intg.tables
    if "R" not in t:
        return False
    has_w = f"{s}_{s}" in t["W"]
    if not (has_w or uses_blocked_kernel(intg, s)) or len(intg.spaces) != 1:
        return False
    if not all(v.shape[0] == 1 for v in t["static"].values()):
        return False
    return t["w"].shape[0] == 1


def _tables_on_cuda(intg) -> bool:
    return intg.tables["w"].device.type == "cuda"


def full_w_refusal(intg) -> str | None:
    """Why the full-W instantiation of the element-Jacobian GEMM cannot
    serve an integrator whose tables admit a fused kernel with a full W,
    or None when it can: its input width must be compiled and a launch
    plan must fit.  Both the closed-entries and the AD route ask."""
    n, nde = intg.n_input, intg.vdim[0] * intg.nd[0]
    if n not in bj.FULL_WIDTHS:
        return f"n = {n} is not among the compiled widths {bj.FULL_WIDTHS}"
    if intg.dtype not in (torch.float32, torch.float64):
        return f"unsupported dtype {intg.dtype}"
    try:
        bj.launch_plan(1, n, nde, intg.nq, intg.dtype)
    except ValueError as e:
        return str(e)
    return None


def field_refusal(intg) -> str:
    """The refusal of both kernel routes for a field-backed integrator:
    the kernels take element-shared static parameters only, as the JAX
    package's kernel does."""
    return (f"runtime field parameters ({', '.join(intg.field_kinds)}) are "
            "not kernel inputs: field-backed integrators take two-stage")


def kernel_route_refusal(intg) -> str | None:
    """Why the closed-entries kernel the tables select (blocked-W0 where
    ``uses_blocked_kernel``, else full-W) cannot assemble this integrator's
    element Jacobians, or None when it can."""
    t = intg.tables
    if intg.vector_fn:
        return ("vector integrands (ADVectorFunction) have no closed "
                "Hessian entries: the state is the Jacobian of F")
    if intg.field_kinds:
        return field_refusal(intg)
    if not _tables_on_cuda(intg):
        return "the kernel runs on CUDA tables only"
    if intg.f.hessian_closed_entries is None:
        return f"{type(intg.f).__name__} has no closed Hessian entries"
    if not supports_fused(intg):
        return "tables do not admit a fused kernel (supports_fused)"
    if uses_blocked_kernel(intg):
        return bj.blocked_refusal(intg)
    why = full_w_refusal(intg)
    if why is not None:
        return why
    try:
        bj.entries_code(intg.f, bj.param_sizes(t["static"]))
    except bj.UnsupportedEnergy as e:
        return f"the closed entries do not trace: {e}"
    return None


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
    the closed-entries kernel the tables select; raises where it does not
    apply."""
    why = kernel_route_refusal(intg)
    if why is not None:
        raise ValueError(f"kernel route unavailable: {why}")
    if uses_blocked_kernel(intg):
        return bj.blocked_element_jacobian(
            intg.f, *bj.blocked_inputs(intg, ublocks), intg.vdim[0],
            intg.sd[0])
    return fused_element_jacobian(intg.f, *kernel_inputs(intg, ublocks))
