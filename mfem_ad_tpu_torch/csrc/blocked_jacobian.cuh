// Blocked-W0 element-Jacobian assembly for Hopper (sm_90a): closed-form
// Hessian entries contracted per vdim-block pair with W0 = b0 (x) b0.
//
// Replaces the TPU kernel mfem_ad_tpu/ops/fused_jacobian.py:119,
// _kernel_tile_blocked.  For every element e of a structured single-space
// integrator whose input is pure GRAD|VECTOR (N = VDIM*SD):
//
//   x_q[v*SD+a]        = sum_i B0[q,i,a] ue_e[v*nd+i]
//   H(q)               = the energy's closed entries at (x_q, p_q)
//   A_e[v*nd+i,w*nd+j] = sum_q sum_ab Ww[(q,a,b),(i,j)] H[v*SD+a][w*SD+b](q)
//
// with Ww = W0 with the quadrature weights folded into its rows.  The
// entries are straight-line code written by
// mfem_ad_tpu_torch/ops/energy_codegen.py (trace_entries), reached through
// a struct E with kInputs, kParams and
//   template <typename T> static void eval(const T* x, const T* p, T* h).
//
// What bounds it on the card: the contraction, VDIM^2 nd^2 nq SD^2 FMA per
// element (20,736 at 2D p2, 139,968 at 3D p1, 3,779,136 at 3D p2), against
// 4 (nde + nde^2) bytes in and out per element in f32: more than 10 FMA per
// byte everywhere, so FMA throughput bounds it, as it does the TPU kernel's
// GEMMs.  Design:
//   - a block owns TE elements (fixed at compile time, tile_elems: each
//     thread keeps TE x VDIM^2 sums in registers) and a tile of up to 128
//     output columns c = (i, j); each thread owns one column.  A Ww value
//     it loads serves TE*VDIM^2 FMAs (72 for 3D in f32), so the L2 traffic
//     stays well below what the FMA rate needs.  Ww is read from device
//     memory and stays in the 50 MB L2: at 3D p2 it is [576, 729], 1.68 MB
//     in f32, seven times what one block's shared memory holds, and it
//     never has to fit there;
//   - an element's outputs (6,561 at 3D p2) are tiled over the columns:
//     grid.y walks the column tiles, so no thread holds more than one
//     column of each of its TE elements.  Each column tile recomputes x and
//     the entries of its elements (6 tiles, so 6 times, at 3D p2);
//   - quadrature points go in chunks of qc, chosen at run time from the
//     shared-memory budget (kChunkBytes, checked against the 227 KB a block
//     may use): the threads first compute x and the N^2 entries of every
//     (element, point) pair of the chunk into shared memory, laid out
//     [q][a][b][v][w][e], then each thread contracts the chunk, reading
//     the TE*VDIM^2 entries of one (q, a, b) as 16-byte broadcast loads;
//   - each thread writes its column of A_e for every (v, w) straight into
//     the final (v,i,w,j) layout of A [ne, nde, nde]: no permute after it;
//   - plain FMAs in the working type: no tensor cores, no TF32 (the
//     reference contracts at Precision.HIGHEST).
// Tensor cores (wgmma), TMA, and the symmetry of A are left for later work.

#pragma once

#include "ad_jacobian.cuh"

namespace bj {

#ifdef __CUDACC__

constexpr int kMaxThreads = 128;        // columns per block
constexpr size_t kChunkBytes = 32768;   // entries of one point chunk
constexpr size_t kSmemLimit = 232448;   // dynamic shared memory per block

// Elements per block.  Each thread keeps tile_elems * VDIM^2 sums: 64 for
// 2D and 72 for 3D in f32, half as many in f64.
template <typename T, int VDIM>
__host__ __device__ constexpr int tile_elems() {
  return (VDIM == 2 ? 16 : 8) * 4 / static_cast<int>(sizeof(T));
}

// ue [ne, VDIM*nd] byNODES (v, i) flat, B0 [nq, nd, SD], Ww [nq*SD*SD, nd*nd]
// (w-folded rows (q,a,b)), prm [nq, kParams], A [ne, VDIM*nd, VDIM*nd].
template <typename T, int VDIM, int SD, class E>
__global__ void __launch_bounds__(kMaxThreads)
    blocked_kernel(const T* __restrict__ ue, const T* __restrict__ B0,
                   const T* __restrict__ Ww, const T* __restrict__ prm,
                   T* __restrict__ A, int64_t ne, int nq, int nd, int qc) {
  constexpr int N = VDIM * SD;
  constexpr int NN = N * N;
  constexpr int VD2 = VDIM * VDIM;
  constexpr int SD2 = SD * SD;
  constexpr int P = E::kParams;
  constexpr int TE = tile_elems<T, VDIM>();
  static_assert(E::kInputs == N, "entries take VDIM*SD inputs");
  static_assert(TE % 4 == 0, "entries are read four at a time");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sH = reinterpret_cast<T*>(smem_raw);           // [qc][SD2][VD2][TE]
  T* sU = sH + static_cast<size_t>(qc) * NN * TE;   // [TE][nde]
  const int nde = VDIM * nd;
  const int nd2 = nd * nd;
  const int64_t e0 = static_cast<int64_t>(blockIdx.x) * TE;
  const int te = static_cast<int>(ne - e0 < TE ? ne - e0 : TE);
  const int c = blockIdx.y * blockDim.x + threadIdx.x;  // column (i, j)
  const int cl = c < nd2 ? c : nd2 - 1;  // idle threads load a valid column

  for (int k = threadIdx.x; k < TE * nde; k += blockDim.x)
    sU[k] = k < te * nde ? ue[e0 * nde + k] : T(0);

  T acc[VD2][TE];
  AD_UNROLL for (int vw = 0; vw < VD2; ++vw) {
    AD_UNROLL for (int e = 0; e < TE; ++e) acc[vw][e] = T(0);
  }

  for (int q0 = 0; q0 < nq; q0 += qc) {
    const int nqc = nq - q0 < qc ? nq - q0 : qc;
    __syncthreads();  // sU is loaded; the previous chunk is consumed
    // Entries of every (element, point) pair of the chunk.  Elements past
    // the end see ue = 0; their sums are never stored.
    for (int pr = threadIdx.x; pr < nqc * TE; pr += blockDim.x) {
      const int e = pr % TE;
      const int ql = pr / TE;
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
      T* dst = sH + static_cast<size_t>(ql) * NN * TE + e;
      AD_UNROLL for (int v = 0; v < VDIM; ++v) {
        AD_UNROLL for (int a = 0; a < SD; ++a) {
          AD_UNROLL for (int w = 0; w < VDIM; ++w) {
            AD_UNROLL for (int b = 0; b < SD; ++b) {
              dst[((a * SD + b) * VD2 + v * VDIM + w) * TE] =
                  h[(v * SD + a) * N + w * SD + b];
            }
          }
        }
      }
    }
    __syncthreads();
    // Contract the chunk: one Ww load per (q, a, b) serves VD2 * TE FMAs.
    const T* Wq = Ww + static_cast<size_t>(q0) * SD2 * nd2 + cl;
    for (int ql = 0; ql < nqc; ++ql) {
      AD_UNROLL for (int ab = 0; ab < SD2; ++ab) {
        const T wv = __ldg(Wq + static_cast<size_t>(ql * SD2 + ab) * nd2);
        const T* hs = sH + static_cast<size_t>(ql * SD2 + ab) * VD2 * TE;
        AD_UNROLL for (int vw = 0; vw < VD2; ++vw) {
          AD_UNROLL for (int e = 0; e < TE; e += 4) {
            T h4[4];
            ad::load4<T>(hs + vw * TE + e, h4);
            AD_UNROLL for (int k = 0; k < 4; ++k) {
              acc[vw][e + k] += wv * h4[k];
            }
          }
        }
      }
    }
  }

  if (c >= nd2) return;
  const int i = c / nd;
  const int j = c - i * nd;
  AD_UNROLL for (int e = 0; e < TE; ++e) {
    if (e < te) {
      T* Ae = A + (e0 + e) * nde * nde;
      AD_UNROLL for (int v = 0; v < VDIM; ++v) {
        AD_UNROLL for (int w = 0; w < VDIM; ++w) {
          Ae[static_cast<size_t>(v * nd + i) * nde + w * nd + j] =
              acc[v * VDIM + w][e];
        }
      }
    }
  }
}

// Launch on ``stream``: grid (element tiles, column tiles), one thread per
// column of a tile.  Returns the launch's cudaError_t.
template <typename T, int VDIM, int SD, class E>
cudaError_t launch(const void* ue, const void* B0, const void* Ww,
                   const void* prm, void* A, int64_t ne, int nq, int nd,
                   cudaStream_t stream) {
  constexpr int N = VDIM * SD;
  constexpr int TE = tile_elems<T, VDIM>();
  if (ne <= 0 || nq <= 0 || nd <= 0) return cudaErrorInvalidValue;
  const int nd2 = nd * nd;
  const int threads = nd2 < kMaxThreads ? (nd2 + 31) / 32 * 32 : kMaxThreads;
  const size_t per_q = static_cast<size_t>(N) * N * TE * sizeof(T);
  const size_t ue_bytes = static_cast<size_t>(TE) * VDIM * nd * sizeof(T);
  size_t qc = kChunkBytes / per_q;
  if (qc < 1) qc = 1;
  if (qc > static_cast<size_t>(nq)) qc = nq;
  const size_t smem = qc * per_q + ue_bytes;
  if (smem > kSmemLimit) return cudaErrorInvalidValue;
  const int64_t tiles = (ne + TE - 1) / TE;
  const int col_tiles = (nd2 + threads - 1) / threads;
  if (tiles > 0x7fffffff || col_tiles > 65535) return cudaErrorInvalidValue;
  auto kernel = blocked_kernel<T, VDIM, SD, E>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid(static_cast<unsigned>(tiles), col_tiles);
  kernel<<<grid, threads, smem, stream>>>(
      static_cast<const T*>(ue), static_cast<const T*>(B0),
      static_cast<const T*>(Ww), static_cast<const T*>(prm),
      static_cast<T*>(A), ne, nq, nd, static_cast<int>(qc));
  return cudaGetLastError();
}

#endif  // __CUDACC__

}  // namespace bj
