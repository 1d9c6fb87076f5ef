// The element-Jacobian GEMM for Hopper (sm_90a): x from B0, the Hessian
// entries of an energy, and their contraction with a factor W0, per
// vdim-block pair.
//
// For every element e of a structured single-space integrator (N =
// VDIM*SD inputs per point):
//
//   x_q[v*SD+a]        = sum_i B0[q,i,a] ue_e[v*nd+i]
//   H(q)               = the entries stage E at (x_q, p_q)
//   A_e[v*nd+i,w*nd+j] = sum_q sum_ab Ww[(q,a,b),(i,j)] H[v*SD+a][w*SD+b](q)
//
// with Ww = the factor with the quadrature weights folded into its rows.
// The entries stage is a struct E with kInputs, kParams and
//   template <typename T> static void eval(const T* x, const T* p, T* h).
// One kernel, three instantiations, each replacing one TPU kernel of
// mfem_ad_tpu/ops/fused_jacobian.py:
//   - _kernel_tile_blocked (:119): VDIM x SD = 2x2 or 3x3, the blocked
//     factor W0 = b0 (x) b0, E the closed entries that
//     mfem_ad_tpu_torch/ops/energy_codegen.py (trace_entries) writes
//     (ops/blocked_jacobian.py);
//   - _kernel_tile (:80): VDIM = 1, SD = n, nd = nde, B0 = Bf (the
//     vdim-block-diagonal basis, R read as [nq, nde, n]) and the full
//     W = Bf (x) Bf, E the same closed entries (ops/fused_jacobian.py);
//   - _kernel (:160, both branches): the same full-W shape, E =
//     ad::HessianEntries<Energy> (ad_jacobian.cuh), the nested-dual
//     Hessian of the generated energy (ops/ad_jacobian.py).
// At VDIM = 1 the interpolation and the (v,i,w,j) layout below reduce to
// the TPU kernels' x = R ue and A[e, i, j].
//
// What bounds it on the card: f32 FMA issue.  The contraction is
// VDIM^2 nd^2 nq SD^2 FMA per element (20,736 at 2D p2, 139,968 at 3D p1,
// 3,779,136 at 3D p2, 9,216 at the 2D Q1 vector headline, 5,184 at scalar
// Q2) against 4 (nde + nde^2) bytes in and out: more than 10 FMA per byte
// everywhere but scalar Q1 (576 FMA against 80 bytes, where device memory
// and the launch bound it).  It is a GEMM per block,
//
//   C[(e,v,w), (i,j)] = sum_k H[(e,v,w), k] Ww[k, (i,j)],   k = (q, a, b),
//
// with M = elem_tile * VDIM^2 rows, N = a column tile of (i, j), and
// K = nq SD^2, whose left operand is computed in the block.  Design:
//   - register-blocked microtiles: a thread owns 8 rows x 8 columns (64
//     sums), two groups of 4 rows (mg*4 and BM/2 + mg*4) and two of 4
//     columns (ng*4 and BN/2 + ng*4).  A warp is 4 row groups x 8 column
//     groups (8 x 4 where the column groups are not a multiple of 8), so
//     each of its 16-byte shared-memory loads touches at most 128 bytes.
//     Per k a thread issues 4 such loads (2 of H, 2 of Ww) for 64 FMAs: 16
//     FMAs per load in f32 (8 in f64, where 16 bytes hold two values).
//     Threads are split over rows (elements) and columns alike, so a
//     staged Ww value serves every row group of the block;
//   - Ww is staged in shared memory through a ring of `stages` slots of
//     quad_stage*SD^2 rows x col_tile columns, each filled by one TMA bulk
//     copy (cp.async.bulk) that one thread issues and whose bytes complete
//     the slot's mbarrier; the copy of slot s + stages - 1 is in flight
//     while slot s is contracted, so the L2 latency leaves the FMA pipe
//     and no other thread spends an instruction on it.  The wrapper lays
//     Ww out tile-major, zero-padded to whole column tiles, so a slot is
//     one contiguous block;
//   - x and the entries of the block's elements are computed once per
//     element per call: where they fit (quad_chunk == nq) they stay
//     resident in shared memory, laid out [k][(e,v,w)], while the block
//     walks every column tile.  Where they do not, the point range is cut
//     into chunks of quad_chunk points, recomputed per column tile; the
//     launch plan keeps one column tile there (3D p1), so recomputation
//     happens only where neither fits (3D p3, and 3D p2 in f64);
//   - the write-out: where a block's output is one contiguous run of A
//     (one column tile, as at 2D p2 and 3D p1), the sums are assembled in
//     A's layout in the ring's shared memory and written by one TMA bulk
//     store; else each finished column tile is staged there half of its
//     rows at a time and written with consecutive threads on consecutive
//     columns (runs of nd values); the next tile's copies start after it.
//     Either way A comes out in its (v,i,w,j) layout, no permute after it;
//   - plain FMAs in the working type: no tensor cores, no TF32 (the
//     reference contracts at Precision.HIGHEST).
// The launch plan (tiles, threads, stages, point chunk, shared-memory
// bytes) is chosen in Python, ops/blocked_jacobian.py:launch_plan, where
// the CPU tests reach it; launch() checks it and refuses (returns
// cudaErrorInvalidValue) anything this kernel cannot run.  f32 compiles to
// at most 168 registers a thread (max_threads; 127-168 measured, no
// spills), so 12 warps fit an SM.  The plan's choices in f32:
//   2D p2: 32 elements x 96 columns (81 padded), 192 threads, entries
//          resident, 2 stages of 16 rows, 76,672 bytes: two blocks (12
//          warps) per SM;
//   3D p1: 21 elements (189 of 192 rows) x 64 columns, 192 threads,
//          entries in chunks of 9 points (3 per call), 2 stages of 27
//          rows, 112,736 bytes: two blocks (12 warps) per SM;
//   3D p2: 7 elements (63 of 64 rows) x 384 columns (2 tiles, 729 padded
//          to 768), 384 threads, entries resident (147,456 bytes), 2
//          stages of 18 rows, 205,148 bytes: one block (12 warps) per SM.
//          The trade-off chosen: one block whose entries stay resident
//          over both column tiles, not two smaller blocks that would
//          recompute them for each tile.
//   3D p3 (nq = 125): the entries do not fit (324 KB at 7 elements);
//          chunks of 35 points, recomputed for each of the 11 column tiles.
//   full W (vdim = 1), where K = nq n^2 is short and more, smaller
//          blocks hide each block's fixed costs: the 2D Q1 vector
//          headline (n = 4, nde = 8, nq = 9): 128 elements x 64 columns,
//          128 threads, entries in chunks of 3 points, 2 stages of 48
//          rows, 61,568 bytes: three blocks (12 warps) per SM; scalar Q2
//          (n = 2, nde = 9, nq = 16): 128 elements x 96 columns (81
//          padded), 192 threads, entries resident, 2 stages of 32 rows,
//          63,104 bytes; scalar Q1 (2, 4, 9): 512 elements x 16 columns,
//          128 threads, entries resident, one slot of 36 rows, 114,816
//          bytes: two blocks (8 warps) per SM.
// The AD instantiation runs its n(n+1)/2 hyper-dual evaluations per point
// in the entries stage, under the same 168-register cap.
// Registers and spills are printed by nvcc -Xptxas -v (chip_smoke.py).

#pragma once

#include "ad_jacobian.cuh"

namespace bj {

constexpr int kTileM = 8;          // rows (e, v, w) of a thread's microtile
constexpr int kTileN = 8;          // columns (i, j) of a thread's microtile
constexpr int kMaxStages = 4;      // Ww ring slots
constexpr int kBarBytes = 128;     // the ring's mbarriers, first in smem
constexpr int64_t kSmemLimit = 232448;  // dynamic shared memory per block

// Threads per block, at most: 12 warps in f32 (168 registers a thread),
// 8 in f64 (255: 64 sums of 8 bytes take 128 registers alone).
template <typename T>
AD_HD constexpr int max_threads() {
  return sizeof(T) == 4 ? 384 : 256;
}

// What the wrapper chose (ops/blocked_jacobian.py:launch_plan).
struct Plan {
  int elem_tile;   // elements per block
  int col_tile;    // output columns (i, j) per column tile
  int threads;     // row groups x column groups; a multiple of 32
  int stages;      // Ww ring slots
  int quad_stage;  // quadrature points per ring slot
  int quad_chunk;  // quadrature points whose entries are held at once
  int64_t smem_bytes;
};

// Rows of the block's GEMM: kTileM per row group; those past
// elem_tile * VDIM^2 pad the tile and are never stored.
AD_HD int row_tile(const Plan& p) {
  return p.threads / (p.col_tile / kTileN) * kTileM;
}

// True when the block's output is one contiguous run of A that a TMA bulk
// copy can write: one column tile, and each element's nde^2 values a
// whole number of 16-byte words.
template <typename T, int VDIM>
AD_HD bool contiguous_out(const Plan& p, int nd) {
  const int nde = VDIM * nd;
  return nd * nd <= p.col_tile && nde * nde * sizeof(T) % 16 == 0;
}

// Values of the region shared by the Ww ring and, once a column tile is
// done, the output staged for the write-out: the block's whole output in
// A's layout where it is contiguous, else half of the tile's rows (padded
// by 4 values).
template <typename T, int VDIM, int SD>
AD_HD int64_t ring_values(const Plan& p, int nd) {
  const int64_t ring = static_cast<int64_t>(p.stages) * p.quad_stage * SD *
                       SD * p.col_tile;
  const int64_t nde = VDIM * nd;
  const int64_t staged =
      contiguous_out<T, VDIM>(p, nd)
          ? p.elem_tile * nde * nde
          : static_cast<int64_t>(row_tile(p) / 2) * (p.col_tile + 4);
  return ring > staged ? ring : staged;
}

// Shared memory of one block: the ring's mbarriers, the ring (or staged
// output), the entries of one point chunk and the block's element dofs.
template <typename T, int VDIM, int SD>
AD_HD int64_t smem_bytes(const Plan& p, int nd) {
  const int64_t entries =
      static_cast<int64_t>(p.quad_chunk) * SD * SD * row_tile(p);
  const int64_t dofs = static_cast<int64_t>(p.elem_tile) * VDIM * nd;
  return kBarBytes + (ring_values<T, VDIM, SD>(p, nd) + entries + dofs) *
                         static_cast<int64_t>(sizeof(T));
}

// Lanes of a warp along the columns: 8 where the column groups allow, so
// that a warp is 4 row groups x 8 column groups and each of its 16-byte
// shared-memory loads touches at most 128 bytes.
AD_HD int lanes_n(int col_groups) {
  const int low = col_groups & -col_groups;
  return low < 8 ? low : 8;
}

#ifdef __CUDACC__

template <typename T>
__device__ __forceinline__ void load4(const T* p, T v[4]);
template <>
__device__ __forceinline__ void load4<float>(const float* p, float v[4]) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
}
template <>
__device__ __forceinline__ void load4<double>(const double* p, double v[4]) {
  const double2 a = *reinterpret_cast<const double2*>(p);
  const double2 b = *reinterpret_cast<const double2*>(p + 2);
  v[0] = a.x; v[1] = a.y; v[2] = b.x; v[3] = b.y;
}
__device__ __forceinline__ void store4(float* p, const float v[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}
__device__ __forceinline__ void store4(double* p, const double v[4]) {
  *reinterpret_cast<double2*>(p) = make_double2(v[0], v[1]);
  *reinterpret_cast<double2*>(p + 2) = make_double2(v[2], v[3]);
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_addr(bar)),
               "r"(count)
               : "memory");
}

// Block until the phase of ``bar`` with this parity has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  asm volatile(
      "{\n"
      ".reg .pred P1;\n"
      "LAB_WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%0], %1;\n"
      "@P1 bra DONE;\n"
      "bra LAB_WAIT;\n"
      "DONE:\n"
      "}\n" ::"r"(smem_addr(bar)),
      "r"(parity)
      : "memory");
}

// Ring slot s of the walk over (column tile, k range): rows
// [ks*BK, ks*BK + BK) of column tile ct of the tile-major Ww, one
// contiguous block of BK*BN values, copied by one TMA bulk copy whose
// bytes complete the slot's mbarrier phase.  Called by one thread.
template <typename T>
__device__ __forceinline__ void stage_ww(const T* __restrict__ Ww, T* sW,
                                         uint64_t* bars, int s, int total,
                                         int nks, int BK, int BN, int K,
                                         int S) {
  if (s >= total) return;
  const int ct = s / nks;
  const int ks = s - ct * nks;
  const unsigned bytes = static_cast<unsigned>(BK * BN * sizeof(T));
  uint64_t* bar = bars + s % S;
  const T* src = Ww + (static_cast<int64_t>(ct) * K +
                       static_cast<int64_t>(ks) * BK) * BN;
  T* dst = sW + static_cast<size_t>(s % S) * BK * BN;
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// The fragments of row k of a slot: the thread's 8 rows of H (two
// 16-byte words) and 8 columns of Ww (two more).
template <typename T>
__device__ __forceinline__ void load_frag(const T* hs, const T* ws, int k,
                                          int BM, int BN, T a[kTileM],
                                          T b[kTileN]) {
  load4<T>(hs + k * BM, a);
  load4<T>(hs + k * BM + BM / 2, a + 4);
  load4<T>(ws + k * BN, b);
  load4<T>(ws + k * BN + BN / 2, b + 4);
}

// ue [ne, VDIM*nd] byNODES (v, i) flat, B0 [nq, nd, SD], Ww tile-major
// [n_ct][nq*SD*SD][col_tile] (w-folded rows (q,a,b); column tile ct holds
// columns (i,j) = ct*col_tile + 0..col_tile-1, zero past nd^2),
// prm [nq, kParams], A [ne, VDIM*nd, VDIM*nd].
template <typename T, int VDIM, int SD, class E>
__global__ void __launch_bounds__(max_threads<T>(), 1)
    blocked_kernel(const T* __restrict__ ue, const T* __restrict__ B0,
                   const T* __restrict__ Ww, const T* __restrict__ prm,
                   T* __restrict__ A, int64_t ne, int nq, int nd, Plan pl) {
  constexpr int N = VDIM * SD;
  constexpr int NN = N * N;
  constexpr int VD2 = VDIM * VDIM;
  constexpr int SD2 = SD * SD;
  constexpr int P = E::kParams;
  static_assert(E::kInputs == N, "entries take VDIM*SD inputs");
  const int BE = pl.elem_tile;
  const int BN = pl.col_tile;
  const int QS = pl.quad_stage;
  const int QC = pl.quad_chunk;
  const int S = pl.stages;
  const int BM = row_tile(pl);
  const int BK = QS * SD2;
  const int NG = BN / kTileN;
  const int nd2 = nd * nd;
  const int nde = VDIM * nd;
  const int n_ct = (nd2 + BN - 1) / BN;
  const int K = nq * SD2;
  const int nks = nq / QS;  // ring slots per column tile
  const int qcs = QC / QS;  // ring slots per entries chunk
  const bool resident = QC == nq;
  const int total = n_ct * nks;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem_raw);  // [S]
  T* sW = reinterpret_cast<T*>(smem_raw + kBarBytes);      // [S][BK][BN]
  T* sC = sW;  // between column tiles: [BM/2][LDC], the staged output
  const int LDC = BN + 4;  // staged rows: padded against bank conflicts
  T* sH = sW + ring_values<T, VDIM, SD>(pl, nd);  // [QC*SD2][BM]
  T* sU = sH + static_cast<size_t>(QC) * SD2 * BM;  // [BE][nde]
  const int tid = threadIdx.x;
  // warp = LM row groups x LN column groups; warps tile the block likewise
  const int LN = lanes_n(NG);
  const int LM = 32 / LN;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int WN = NG / LN;
  const int mg = warp / WN * LM + lane / LN;
  const int ng = warp % WN * LN + lane % LN;
  const int64_t e0 = static_cast<int64_t>(blockIdx.x) * BE;
  const int te = static_cast<int>(ne - e0 < BE ? ne - e0 : BE);

  if (tid == 0) {
    for (int i = 0; i < S; ++i) mbar_init(bars + i, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();  // the barriers are initialised
  if (tid == 0) {
    for (int s = 0; s < S - 1 && s < nks; ++s)  // the first column tile's
      stage_ww(Ww, sW, bars, s, total, nks, BK, BN, K, S);
  }
  for (int k = tid; k < BE * nde; k += blockDim.x)
    sU[k] = k < te * nde ? ue[e0 * nde + k] : T(0);

  T acc[kTileM][kTileN];
  AD_UNROLL for (int i = 0; i < kTileM; ++i) {
    AD_UNROLL for (int j = 0; j < kTileN; ++j) acc[i][j] = T(0);
  }

  for (int s = 0; s < total; ++s) {
    const int ct = s / nks;
    const int ks = s - ct * nks;
    const int kc = ks % qcs;  // slot within the entries chunk
    if (kc == 0 && (!resident || ct == 0)) {
      __syncthreads();  // sU is loaded; the previous chunk is consumed
      // x and the entries of every (element, point) pair of the chunk,
      // into sH[(ql, a, b)][(e, v, w)].  Elements past the end see
      // ue = 0; their sums are never stored.
      const int q0 = ks * QS;
      const int qn = nq - q0 < QC ? nq - q0 : QC;
      // pairs pr = ql * BE + e, walked by the block with the divisions
      // done once: a stride of blockDim.x pairs is step_q points and
      // step_e elements
      const int step_q = static_cast<int>(blockDim.x) / BE;
      const int step_e = static_cast<int>(blockDim.x) - step_q * BE;
      for (int e = tid % BE, ql = tid / BE; ql < qn;
           e += step_e, ql += step_q + (e >= BE), e -= (e >= BE) ? BE : 0) {
        const int q = q0 + ql;
        const T* u = sU + e * nde;
        const T* Bq = B0 + static_cast<size_t>(q) * nd * SD;
        T x[N];
        AD_UNROLL for (int m = 0; m < N; ++m) x[m] = T(0);
        for (int i = 0; i < nd; ++i) {
          T b[SD];
          AD_UNROLL for (int a = 0; a < SD; ++a) b[a] = __ldg(Bq + i * SD + a);
          AD_UNROLL for (int v = 0; v < VDIM; ++v) {
            const T uv = u[v * nd + i];
            AD_UNROLL for (int a = 0; a < SD; ++a) x[v * SD + a] += b[a] * uv;
          }
        }
        T h[NN];
        E::eval(x, prm + q * P, h);
        T* dst = sH + static_cast<size_t>(ql) * SD2 * BM + e * VD2;
        AD_UNROLL for (int v = 0; v < VDIM; ++v) {
          AD_UNROLL for (int a = 0; a < SD; ++a) {
            AD_UNROLL for (int w = 0; w < VDIM; ++w) {
              AD_UNROLL for (int b = 0; b < SD; ++b) {
                dst[(a * SD + b) * BM + v * VDIM + w] =
                    h[(v * SD + a) * N + w * SD + b];
              }
            }
          }
        }
      }
    }
    mbar_wait(bars + s % S, (s / S) & 1);  // slot s has landed
    __syncthreads();  // slot s - 1 is consumed by every thread
    // the next column tile's slots wait until its write-out has freed the
    // ring
    if (tid == 0 && ks + S - 1 < nks)
      stage_ww(Ww, sW, bars, s + S - 1, total, nks, BK, BN, K, S);

    // Contract slot s: per k, two 16-byte loads of H, two of Ww, 64 FMAs.
    const T* hs = sH + static_cast<size_t>(kc) * BK * BM + mg * 4;
    const T* ws = sW + static_cast<size_t>(s % S) * BK * BN + ng * 4;
    for (int qs = 0; qs < QS; ++qs) {
      AD_UNROLL for (int ab = 0; ab < SD2; ++ab) {
        T a[kTileM], b[kTileN];
        load_frag(hs, ws, qs * SD2 + ab, BM, BN, a, b);
        // b[j] is the operand consecutive FMAs share (the reuse cache);
        // this order leaves ptxas fewer FMAs whose other two operands sit
        // in one register bank than the transposed one (SASS of phase E3)
        AD_UNROLL for (int j = 0; j < kTileN; ++j) {
          AD_UNROLL for (int i = 0; i < kTileM; ++i) {
            acc[i][j] += a[i] * b[j];
          }
        }
      }
    }

    if (ks == nks - 1 && contiguous_out<T, VDIM>(pl, nd)) {
      // The block's only column tile is complete, and its output is one
      // contiguous run of A: assemble it in A's layout in the ring's memory
      // and write it with one TMA bulk copy.
      __syncthreads();  // the ring has been read
      int c_off[kTileN];
      AD_UNROLL for (int j = 0; j < kTileN; ++j) {
        const int c = (j < 4 ? 0 : BN / 2) + ng * 4 + (j & 3);
        const int ii = c / nd;
        c_off[j] = c < nd2 ? ii * nde + c - ii * nd : -1;
      }
      AD_UNROLL for (int i = 0; i < kTileM; ++i) {
        const int r = (i < 4 ? 0 : BM / 2) + mg * 4 + (i & 3);
        const int e = r / VD2;
        const int v = (r - e * VD2) / VDIM;
        const int w = r - e * VD2 - v * VDIM;
        if (e < te) {
          T* out = sC + (e * nde + v * nd) * nde + w * nd;
          if constexpr (VDIM == 1) {
            // a group of 4 columns is 4 consecutive values of A (nd^2 is
            // a multiple of 4 where the output is contiguous): one
            // 16-byte store (two in f64) in place of four
            AD_UNROLL for (int h = 0; h < 2; ++h) {
              if (c_off[4 * h] >= 0) store4(out + c_off[4 * h], acc[i] + 4 * h);
            }
          } else {
            AD_UNROLL for (int j = 0; j < kTileN; ++j) {
              if (c_off[j] >= 0) out[c_off[j]] = acc[i][j];
            }
          }
        }
      }
      __syncthreads();
      if (tid == 0) {
        const unsigned bytes = static_cast<unsigned>(te * nde * nde *
                                                     sizeof(T));
        asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
        asm volatile(
            "cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n"
            ::"l"(A + e0 * nde * nde),
            "r"(smem_addr(sC)), "r"(bytes)
            : "memory");
        asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
        // the block's shared memory must outlive the copy's reads
        asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
      }
    } else if (ks == nks - 1) {
      // Column tile ct is complete.  Stage the sums in the ring, half of
      // the rows at a time, and write them to A's (v,i,w,j) layout with
      // consecutive threads on consecutive columns (i, j); then start the
      // next column tile's copies.
      const int cl = tid % BN;
      const int c = ct * BN + cl;
      const int ii = c / nd;
      const int c_off = ii * nde + c - ii * nd;
      T* Ab = A + e0 * nde * nde;
      AD_UNROLL for (int h = 0; h < 2; ++h) {
        __syncthreads();  // the ring, or the previous half, has been read
        AD_UNROLL for (int i = 0; i < 4; ++i) {
          T* dst = sC + static_cast<size_t>(mg * 4 + i) * LDC + ng * 4;
          store4(dst, acc[h * 4 + i]);
          store4(dst + BN / 2, acc[h * 4 + i] + 4);
        }
        __syncthreads();
        for (int rr = tid / BN; rr < BM / 2; rr += blockDim.x / BN) {
          const int r = h * (BM / 2) + rr;
          const int e = r / VD2;
          const int v = (r - e * VD2) / VDIM;
          const int w = r - e * VD2 - v * VDIM;
          if (e < te && c < nd2) {
            Ab[(e * nde + v * nd) * nde + w * nd + c_off] =
                sC[static_cast<size_t>(rr) * LDC + cl];
          }
        }
      }
      AD_UNROLL for (int i = 0; i < kTileM; ++i) {
        AD_UNROLL for (int j = 0; j < kTileN; ++j) acc[i][j] = T(0);
      }
      __syncthreads();  // the staged output has been read
      if (tid == 0 && s + 1 < total) {
        // order the threads' writes of the staged output before the
        // copies that overwrite it
        asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
        for (int j = 1; j < S && j <= nks; ++j)  // the next column tile's
          stage_ww(Ww, sW, bars, s + j, total, nks, BK, BN, K, S);
      }
    }
  }
}

// Check the plan and launch on ``stream``: one block per elem_tile
// elements.  Returns cudaErrorInvalidValue for a plan this kernel cannot
// run, else the launch's cudaError_t.
template <typename T, int VDIM, int SD, class E>
cudaError_t launch(const void* ue, const void* B0, const void* Ww,
                   const void* prm, void* A, int64_t ne, int nq, int nd,
                   const Plan& p, cudaStream_t stream) {
  constexpr int VD2 = VDIM * VDIM;
  if (ne <= 0 || nq <= 0 || nd <= 0) return cudaErrorInvalidValue;
  if (p.col_tile <= 0 || p.col_tile % kTileN != 0)
    return cudaErrorInvalidValue;
  const int col_groups = p.col_tile / kTileN;
  if (p.threads <= 0 || p.threads > max_threads<T>() || p.threads % 32 != 0 ||
      p.threads % col_groups != 0 ||
      p.threads / col_groups % (32 / lanes_n(col_groups)) != 0)
    return cudaErrorInvalidValue;  // whole warps of LM x LN groups
  if (p.threads % p.col_tile != 0)
    return cudaErrorInvalidValue;  // the write-out: one column per thread
  if (p.elem_tile <= 0 || p.elem_tile * VD2 > row_tile(p))
    return cudaErrorInvalidValue;
  if (p.stages < 2 || p.stages > kMaxStages) return cudaErrorInvalidValue;
  if (p.quad_stage <= 0 || nq % p.quad_stage != 0 ||
      p.quad_chunk < p.quad_stage || p.quad_chunk > nq ||
      p.quad_chunk % p.quad_stage != 0)
    return cudaErrorInvalidValue;
  if (p.smem_bytes != smem_bytes<T, VDIM, SD>(p, nd) ||
      p.smem_bytes > kSmemLimit)
    return cudaErrorInvalidValue;
  const int64_t tiles = (ne + p.elem_tile - 1) / p.elem_tile;
  if (tiles > 0x7fffffff) return cudaErrorInvalidValue;
  auto kernel = blocked_kernel<T, VDIM, SD, E>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(p.smem_bytes));
  if (err != cudaSuccess) return err;
  // all of the SM's 228 KB as shared memory, so that two blocks of up to
  // 113 KB fit side by side
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributePreferredSharedMemoryCarveout,
                             cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return err;
  kernel<<<static_cast<unsigned>(tiles), p.threads,
           static_cast<size_t>(p.smem_bytes), stream>>>(
      static_cast<const T*>(ue), static_cast<const T*>(B0),
      static_cast<const T*>(Ww), static_cast<const T*>(prm),
      static_cast<T*>(A), ne, nq, nd, p);
  return cudaGetLastError();
}

#endif  // __CUDACC__

}  // namespace bj
