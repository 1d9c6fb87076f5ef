"""Blocked-W0 element-Jacobian assembly: x from B0, closed-form Hessian
entries, and the contraction with W0 = b0 (x) b0 per vdim-block pair, in one
hand-written CUDA kernel; and that kernel's shared machinery.

Replaces the TPU kernel
``mfem_ad_tpu/ops/fused_jacobian.py:_kernel_tile_blocked``.  For every
element e of a structured single-space integrator whose energy has
``hessian_closed_entries`` and whose input is pure GRAD|VECTOR
(n = vdim*sd), where the integrator installs ``W0["0_0"]`` (2D p>=2 and
every 3D configuration):

    A_e[v*nd+i, w*nd+j] = sum_q w_q sum_{a,b} W0[(q,a,b),(i,j)]
                          H_{(v,a),(w,b)}(x_q),
    x_q[v*sd+a]         = sum_i B0[q,i,a] ue_e[v*nd+i].

W0 is vdim^2 times smaller than the full factor W = Bf (x) Bf, and it is
the only factor the integrator installs at 3D p>=2.

The same kernel (``csrc/blocked_jacobian.cuh``) at vdim = 1, sd = n,
nd = nde, B0 = Bf and the full W as its factor is the full-W kernel
(``ops/fused_jacobian.py``, closed entries) and the AD kernel
(``ops/ad_jacobian.py``, nested-dual Hessian): this module holds what the
three share: the launch plan, the tile-major factor, the operand checks,
the launchers' source and the launch, and the operands derived once per
table (``derived``).

``ops/energy_codegen.trace_entries`` turns the energy's closed entries into
straight-line C++; this module writes it into a small ``.cu`` beside
``csrc/blocked_jacobian.cuh`` (the kernel template), which ``ops/nvcc.py``
compiles for sm_90a into ``mfem_ad_tpu_torch/_build/`` and binds through
``ctypes``.  The plain PyTorch version (``blocked_element_jacobian_plain``)
computes the same function with ``torch.matmul``.
``blocked_element_jacobian`` runs the plain version for tensors on the CPU
and the kernel for tensors on a CUDA device.  ``launch_plan`` chooses the
kernel's tiles, threads, ring stages and shared memory per shape; the
kernel checks the plan and refuses what it cannot run.
"""

from __future__ import annotations

import ctypes
import functools
import math
import weakref
from dataclasses import dataclass

import torch
from torch.utils.weak import WeakIdKeyDictionary

from . import nvcc
from .energy_codegen import EnergyCode, cached_trace, trace_entries

HEADERS = ("blocked_jacobian.cuh", "ad_jacobian.cuh")
# (vdim, sd) the blocked factor W0 is compiled for: 2D and 3D vector GRAD
BLOCKED_SHAPES = ((2, 2), (3, 3))
# Input widths n of the full-W instantiations (vdim = 1, sd = n, nd = nde,
# B0 = Bf, factor W): VALUE (1), 2D and 3D GRAD (2, 3), 2D vector GRAD
# (4), 2D vector VALUE|GRAD (6) and 3D vector GRAD (9).
FULL_WIDTHS = (1, 2, 3, 4, 6, 9)
KERNEL_SHAPES = BLOCKED_SHAPES + tuple((1, n) for n in FULL_WIDTHS)

# The kernel's fixed shape (csrc/blocked_jacobian.cuh): each thread owns
# TILE_M rows (e, v, w) x TILE_N columns (i, j) of the block's GEMM.
TILE_M = TILE_N = 8
# Threads per block, in the order tried: f32 compiles to at most 168
# registers a thread (bj::max_threads), so 12 warps fit an SM: two blocks
# of 192 threads where two fit in shared memory, else one of 384.
# Each is a multiple of 4 warps per SM, so each of an SM's four schedulers
# holds as many warps as the others.  f64 (255 registers) runs one block.
THREAD_CHOICES = {torch.float32: (192, 384, 256, 128),
                  torch.float64: (256, 128)}
# The full-W instantiations (vdim = 1): a block's contraction is short
# (K = nq n^2 = 36 to 144 on the main path), so its fixed costs (the dofs'
# load, the entries stage, the barriers, the write-out) weigh more, and
# more, smaller blocks hide them better: 128 threads first in f32, as
# many blocks per SM as registers allow (three), and few ring slots (one
# of all points where it fits, else of at least FULL_W_STAGE_ROWS rows),
# so fewer barriers per block.
FULL_W_THREAD_CHOICES = {torch.float32: (128, 192, 384, 256),
                         torch.float64: (256, 128)}
MAX_COL_TILE = 256  # columns (i, j) per column tile, before widening
STAGES = 2  # ring slots for Ww, filled by TMA bulk copies
BAR_BYTES = 128  # the ring's mbarriers (bj::kBarBytes)
MIN_STAGE_ROWS = 16  # Ww rows (q, a, b) per ring slot, at least
FULL_W_STAGE_ROWS = 32  # the same at vdim = 1
SMEM_LIMIT = 232_448  # dynamic shared memory one Hopper block may use
SMEM_SM = 233_472  # shared memory of one SM, 1 KB of it reserved per block
WARPS_F32 = 12  # warps an SM holds at 168 registers a thread
# per block, so that two blocks fit in an SM's 228 KB (1 KB reserved each)
SMEM_TWO_BLOCKS = SMEM_SM // 2 - 1024


@dataclass(frozen=True)
class LaunchPlan:
    """How the kernel runs one shape (the fields of ``bj::Plan``)."""

    elem_tile: int  # elements per block
    col_tile: int  # output columns (i, j) per column tile
    threads: int  # threads per block
    stages: int  # Ww ring slots
    quad_stage: int  # quadrature points per ring slot
    quad_chunk: int  # points whose entries the block holds at once
    smem_bytes: int  # dynamic shared memory per block

    @property
    def row_tile(self) -> int:
        """Rows (e, v, w) of the block's GEMM, padding included."""
        return self.threads // (self.col_tile // TILE_N) * TILE_M

    def padded_cols(self, nd: int) -> int:
        """nd^2 rounded up to whole column tiles."""
        return -(-nd * nd // self.col_tile) * self.col_tile


def lanes_n(col_groups: int) -> int:
    """Lanes of a warp along the columns (``bj::lanes_n``)."""
    return min(col_groups & -col_groups, 8)


def _col_tile(nd2: int, threads: int, slack: float,
              narrow: bool = False) -> int | None:
    """The narrowest column tile that tiles ``threads`` in whole warps of
    32 // LN row groups x LN column groups, gives every thread one column
    of the write-out and pads nd^2 at most ``slack`` times as far as tiles
    of base = min(nd^2 rounded up to TILE_N, MAX_COL_TILE) do, or None.
    Tiles of base to 2 base columns are tried; with ``narrow``, the widest
    tile narrower than base instead."""
    base = min(-(-nd2 // TILE_N) * TILE_N, MAX_COL_TILE)
    limit = slack * -(-nd2 // base) * base
    cols = (range(base - TILE_N, 0, -TILE_N) if narrow
            else range(base, 2 * base + 1, TILE_N))
    for col in cols:
        groups = col // TILE_N
        if (threads % col == 0 and -(-nd2 // col) * col <= limit
                and threads // groups % (32 // lanes_n(groups)) == 0):
            return col
    return None


def staged_values(vdim: int, nd: int, elem_tile: int, col_tile: int,
                  row_tile: int, elem: int) -> int:
    """Values of the output staged for the write-out (``bj::ring_values``):
    the block's whole output in A's layout where it is one contiguous run
    of A (one column tile, nde^2 values a whole number of 16-byte words),
    written by one TMA bulk copy; else half of the tile's rows, padded by
    4 values."""
    nde2 = (vdim * nd) ** 2
    if nd * nd <= col_tile and nde2 * elem % 16 == 0:
        return elem_tile * nde2
    return row_tile // 2 * (col_tile + 4)


@functools.lru_cache(maxsize=None)
def launch_plan(vdim: int, sd: int, nd: int, nq: int,
                dtype: torch.dtype) -> LaunchPlan:
    """The kernel's launch plan for element Jacobians of ``vdim`` x ``sd``
    GRAD inputs on ``nd`` nodes and ``nq`` points, in ``dtype``.

    - the first of THREAD_CHOICES (FULL_W_THREAD_CHOICES at vdim = 1)
      that tiles a column tile in whole warps padding at most 10% more
      columns (``_col_tile``), else the first that tiles one at all, else
      the first that tiles a narrower one (where a ring slot of one point
      of wide columns does not fit: the full W at n = 9 in f64); as many
      elements as its rows hold (the rest pad the tile); two blocks per
      SM's shared memory at 192 threads in f32 (at vdim = 1, the shared
      memory of as many blocks as 12 warps make, else of one fewer);
    - ring slots of the fewest whole points that give MIN_STAGE_ROWS rows
      (one point where those do not fit); at vdim = 1 one slot of all
      points where it fits, else slots of FULL_W_STAGE_ROWS rows;
    - every point's entries resident in shared memory where they fit,
      else the largest whole-slot chunk of points that fits.

    Raises ValueError for a shape no plan fits."""
    elem = torch.empty((), dtype=dtype).element_size()
    vd2, sd2, nd2 = vdim * vdim, sd * sd, nd * nd
    full_w = vdim == 1
    min_rows = FULL_W_STAGE_ROWS if full_w else MIN_STAGE_ROWS
    choices = (FULL_W_THREAD_CHOICES if full_w else THREAD_CHOICES)[dtype]
    preferred = next(d for d in range(1, nq + 1)
                     if nq % d == 0 and (d * sd2 >= min_rows or d == nq))
    # padding at most 10% more columns where a thread count allows it
    for narrow, slack, threads in [(w, x, t) for w in (False, True)
                                   for x in (1.1, 2.0) for t in choices]:
        col = _col_tile(nd2, threads, slack, narrow)
        rows = 0 if col is None else threads // (col // TILE_N) * TILE_M
        be = rows // vd2
        if be == 0:
            continue
        slots = (preferred, 1)  # one point per slot where a slot is big
        if dtype != torch.float32:
            budgets = [SMEM_LIMIT]
        elif full_w:
            # the shared memory of as many blocks as 12 warps make, or of
            # one block fewer; one ring slot of all points first
            most = WARPS_F32 * 32 // threads
            budgets = [min(SMEM_SM // b - 1024, SMEM_LIMIT)
                       for b in (most, most - 1) if b > 0]
            slots = (nq, preferred, 1)
        else:
            budgets = [SMEM_TWO_BLOCKS if threads <= 192 else SMEM_LIMIT]
        per_q = sd2 * rows * elem  # one point's entries for the block
        for qs, budget in [(q, b) for q in slots for b in budgets]:
            # the ring's mbarriers, the Ww ring (which holds the staged
            # output once a column tile is done) and the dofs
            ring = max(STAGES * qs * sd2 * col,
                       staged_values(vdim, nd, be, col, rows, elem))
            fixed = BAR_BYTES + (ring + be * vdim * nd) * elem
            qc = nq
            if fixed + nq * per_q > budget:
                qc = max(budget - fixed, 0) // per_q // qs * qs
            if qc >= qs:
                return LaunchPlan(be, col, threads, STAGES, qs, qc,
                                  fixed + qc * per_q)
    raise ValueError(f"no launch plan fits vdim={vdim}, nd={nd}, nq={nq}")


def launcher_source(vdim: int, sd: int, entries: str) -> list[str]:
    """The ``extern "C"`` launchers ``bj_launch_f32`` and ``bj_launch_f64``
    of the kernel instantiated with ``vdim``, ``sd`` and the entries stage
    ``entries`` (a C++ type with kInputs, kParams and eval(x, p, h))."""
    lines = []
    for suffix, s in (("f32", "float"), ("f64", "double")):
        lines += [
            f'extern "C" int bj_launch_{suffix}(const void* ue, '
            "const void* B0, const void* Ww, const void* prm, void* A, "
            "int64_t ne, int nq, int nd, int elem_tile, int col_tile, "
            "int threads, int stages, int quad_stage, int quad_chunk, "
            "int64_t smem_bytes, void* stream) {",
            "  const bj::Plan plan{elem_tile, col_tile, threads, stages, "
            "quad_stage, quad_chunk, smem_bytes};",
            f"  return bj::launch<{s}, {vdim}, {sd}, {entries}>(ue, B0, Ww, "
            "prm, A, ne, nq, nd, plan, static_cast<cudaStream_t>(stream));",
            "}",
            "",
        ]
    return lines


@functools.lru_cache(maxsize=None)
def kernel_source(code: EnergyCode, vdim: int, sd: int) -> str:
    """The ``.cu`` translation unit for one traced closed-entries energy: the
    header, the generated entries, and ``extern "C"`` launchers for f32 and
    f64 of the kernel at ``vdim`` x ``sd``: a blocked factor W0 at
    BLOCKED_SHAPES, the full W at vdim = 1, sd = n."""
    if (vdim, sd) not in KERNEL_SHAPES or code.n_input != vdim * sd:
        raise ValueError(f"(vdim, sd) = ({vdim}, {sd}) with n = "
                         f"{code.n_input} is not among {KERNEL_SHAPES}")
    return "\n".join([
        '#include "blocked_jacobian.cuh"',
        "",
        code.source,
        "struct Entries {",
        f"  static constexpr int kInputs = {code.n_input};",
        f"  static constexpr int kParams = {code.n_params};",
        "  template <typename T>",
        "  static AD_HD void eval(const T* x, const T* p, T* h) {",
        f"    {code.name}<T>(x, p, h);",
        "  }",
        "};",
        "",
        *launcher_source(vdim, sd, "Entries"),
    ])


def build_library(code: EnergyCode, vdim: int, sd: int) -> str:
    """Compile the energy's kernel when its library is missing; returns the
    compiler's report (empty when the library already exists).  Raises
    when nvcc is missing or fails."""
    return nvcc.build_library("blocked_jacobian",
                              kernel_source(code, vdim, sd), HEADERS)


_ARGTYPES = [ctypes.c_void_p] * 5 + [ctypes.c_int64] + [ctypes.c_int] * 8 + [
    ctypes.c_int64, ctypes.c_void_p]


def load_library(stem: str, source: str):
    """The library of one kernel instantiation (``source`` from
    ``launcher_source``), built at its first use."""
    return nvcc.load_library(
        stem, source, HEADERS,
        {"bj_launch_f32": _ARGTYPES, "bj_launch_f64": _ARGTYPES})


def _library(code: EnergyCode, vdim: int, sd: int):
    return load_library("blocked_jacobian", kernel_source(code, vdim, sd))


_TRACES: weakref.WeakKeyDictionary = weakref.WeakKeyDictionary()


def entries_code(f, psizes: dict) -> EnergyCode:
    """``trace_entries(f, psizes)``, once per energy object and parameter
    sizes (``energy_codegen.cached_trace``).  Raises ``UnsupportedEnergy``
    as ``trace_entries`` does."""
    return cached_trace(_TRACES, trace_entries, f, psizes)


def param_sizes(params: dict) -> dict:
    """name -> values per point, from [..., nq, k] parameter tensors."""
    return {k: int(v.shape[-1]) for k, v in params.items()}


def check_operand(name, t, shape, like):
    """Raise ValueError unless tensor ``t`` has ``like``'s device and type,
    the shape ``shape``, and is contiguous."""
    if t.device != like.device or t.dtype != like.dtype:
        raise ValueError(
            f"{name}: {t.dtype} on {t.device}, expected {like.dtype} on "
            f"{like.device}"
        )
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected {shape}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def check_cuda_operand(ue):
    """Raise ValueError unless ``ue`` is a CUDA tensor in f32 or f64."""
    if ue.device.type != "cuda":
        raise ValueError(f"unsupported device {ue.device}")
    if ue.dtype not in (torch.float32, torch.float64):
        raise ValueError(f"unsupported dtype {ue.dtype}")


def packed_params(code: EnergyCode, params: dict, nq: int, like):
    """The kernel's parameter operand [nq, kParams] (None without
    parameters), after checking ``params`` against the trace ``code``."""
    if tuple(k for k, _ in code.param_sizes) != tuple(sorted(params)):
        raise ValueError(f"parameters {sorted(params)} differ from the "
                         f"trace's {[k for k, _ in code.param_sizes]}")
    for k, size in code.param_sizes:
        check_operand(k, params[k], (nq, size), like)
    if not code.n_params:
        return None
    return torch.cat([params[k] for k, _ in code.param_sizes],
                     dim=1).contiguous()


def launch(lib, name: str, ue, B0, Ww, prm, A, nq: int, nd: int,
           plan: LaunchPlan):
    """Launch the kernel of ``lib`` on the current stream of ``ue``'s
    device.  Raises RuntimeError where the launch fails, also where the
    kernel refuses the plan; ``name`` names the kernel in the message."""
    fn = lib.bj_launch_f32 if ue.dtype == torch.float32 else (
        lib.bj_launch_f64)
    with torch.cuda.device(ue.device):
        stream = torch.cuda.current_stream(ue.device).cuda_stream
        err = fn(ue.data_ptr(), B0.data_ptr(), Ww.data_ptr(),
                 None if prm is None else prm.data_ptr(), A.data_ptr(),
                 ue.shape[0], nq, nd, plan.elem_tile, plan.col_tile,
                 plan.threads, plan.stages, plan.quad_stage,
                 plan.quad_chunk, plan.smem_bytes, stream)
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err}")


def blocked_element_jacobian_plain(f, ue, B0, W0, wq, params, vdim, sd):
    """Plain PyTorch version of the kernel.

    Args:
        f: energy with ``hessian_closed_entries``, input n = vdim*sd.
        ue: [ne, vdim*nd] element dofs, byNODES (v, i) flat.
        B0: [nq, nd, sd] element-shared shape gradients.
        W0: [nq*sd*sd, nd*nd] blocked contraction factor, rows (q, a, b),
            columns (i, j): W0[(q,a,b),(i,j)] = B0[q,i,a] B0[q,j,b].
        wq: [nq] element-shared quadrature weights.
        params: name -> [nq, k] element-shared parameter values.
        vdim, sd: components and spatial derivatives per component.

    Returns:
        A [ne, vdim*nd, vdim*nd], rows and columns (v, i).
    """
    ne = ue.shape[0]
    nq, nd, _ = B0.shape
    x = torch.einsum("evi,qia->eqva", ue.reshape(ne, vdim, nd), B0)
    g = [x[:, :, v, a] for v in range(vdim) for a in range(sd)]
    pt = {k: [v[:, i] for i in range(v.shape[1])] for k, v in params.items()}
    rows = f.hessian_closed_entries(g, pt)
    H = torch.stack(
        [
            torch.as_tensor(rows[v * sd + a][w * sd + b], dtype=ue.dtype,
                            device=ue.device).expand(ne, nq)
            for v in range(vdim) for w in range(vdim)
            for a in range(sd) for b in range(sd)
        ],
        dim=-1,
    ).reshape(ne, nq, vdim * vdim, sd * sd)  # [e, q, (v,w), (a,b)]
    Hk = H.permute(0, 2, 1, 3).reshape(ne * vdim * vdim, nq * sd * sd)
    Ww = W0 * wq.repeat_interleave(sd * sd)[:, None]
    A = (Hk @ Ww).reshape(ne, vdim, vdim, nd, nd)  # [e, v, w, i, j]
    return A.permute(0, 1, 3, 2, 4).reshape(ne, vdim * nd, vdim * nd)


def tiled_factor(W0, wq, sd, plan: LaunchPlan):
    """The kernel's contraction factor: W0 with the quadrature weights
    folded into its rows (q, a, b), zero-padded to whole column tiles and
    laid out tile-major, [column tiles, nq*sd*sd, col_tile], so that every
    ring slot is one contiguous block."""
    rows, cols = W0.shape
    nd = math.isqrt(cols)
    Ww = torch.zeros((rows, plan.padded_cols(nd)), dtype=W0.dtype,
                     device=W0.device)
    Ww[:, :cols] = W0 * wq.repeat_interleave(sd * sd)[:, None]
    return Ww.reshape(rows, -1, plan.col_tile).permute(1, 0, 2).contiguous()


# table tensor -> {key: (stamp, derived tensor)}: operands the kernels
# derive from the integrator's tables (the tile-major weighted factor, B0
# from R), built once per table and kept while the table lives.
# ``clear()`` makes the next calls build them again.
DERIVED = WeakIdKeyDictionary()


def derived(src, key, others, make):
    """``make()``, built once per table tensor ``src`` and ``key`` and kept
    while neither ``src`` nor any tensor of ``others`` changes: the stamp
    holds their versions and addresses, and the entry holds ``others``, so
    their memory cannot be reused under the same address."""
    stamp = (src._version,) + tuple((t.data_ptr(), t._version)
                                    for t in others)
    per = DERIVED.get(src)
    if per is None:
        per = DERIVED[src] = {}
    hit = per.get(key)
    if hit is None or hit[0] != stamp:
        hit = per[key] = (stamp, make(), others)
    return hit[1]


def blocked_element_jacobian(f, ue, B0, W0, wq, params, vdim, sd):
    """A [ne, vdim*nd, vdim*nd] = element Jacobians of energy ``f``
    (arguments as in ``blocked_element_jacobian_plain``).

    CPU tensors take the plain version.  CUDA tensors launch the kernel
    (counted in ``blocked_element_jacobian.launches``) or raise: entries
    that do not trace raise ``UnsupportedEnergy``; there is no fallback on
    the device."""
    if ue.device.type == "cpu":
        return blocked_element_jacobian_plain(f, ue, B0, W0, wq, params,
                                              vdim, sd)
    check_cuda_operand(ue)
    if (vdim, sd) not in BLOCKED_SHAPES:
        raise ValueError(f"(vdim, sd) = ({vdim}, {sd}) is not among the "
                         f"compiled shapes {BLOCKED_SHAPES}")
    if ue.dim() != 2 or B0.dim() != 3:
        raise ValueError(f"ue: shape {tuple(ue.shape)}, B0: shape "
                         f"{tuple(B0.shape)}; expected [ne, nde] and "
                         "[nq, nd, sd]")
    ne = ue.shape[0]
    nq, nd = B0.shape[0], B0.shape[1]
    check_operand("ue", ue, (ne, vdim * nd), ue)
    check_operand("B0", B0, (nq, nd, sd), ue)
    check_operand("W0", W0, (nq * sd * sd, nd * nd), ue)
    check_operand("wq", wq, (nq,), ue)
    code = entries_code(f, param_sizes(params))
    if code.n_input != vdim * sd:
        raise ValueError(f"the entries take n = {code.n_input} inputs, "
                         f"not vdim*sd = {vdim * sd}")
    prm = packed_params(code, params, nq, ue)
    A = torch.empty((ne, vdim * nd, vdim * nd), dtype=ue.dtype,
                    device=ue.device)
    if ne == 0:
        return A
    plan = launch_plan(vdim, sd, nd, nq, ue.dtype)
    Ww = derived(W0, ("Ww", sd, plan), (wq,),
                 lambda: tiled_factor(W0, wq, sd, plan))
    launch(_library(code, vdim, sd), "blocked_jacobian", ue, B0, Ww, prm, A,
           nq, nd, plan)
    blocked_element_jacobian.launches += 1
    return A


blocked_element_jacobian.launches = 0
