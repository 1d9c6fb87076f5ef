// Fused element-Jacobian assembly for Hopper (sm_90a).
//
// Replaces the TPU kernel mfem_ad_tpu/ops/fused_jacobian.py:_kernel_tile.
// For every element e:
//
//   x_q      = R_q ue_e                              (n values per qp)
//   H_ab(q)  = closed-form Hessian entries of the point energy at x_q
//   A_e[ij]  = sum_q sum_ab H_ab(q) Ww[(q,a,b), ij]   Ww = w-folded Bf (x) Bf
//
// Sizes compiled here: 2D GRAD|VECTOR input (n = 4) on Q1 quads (nde = 8),
// so K = nq*n*n = 144 and 64 outputs per element at nq = 9.
//
// What bounds it on the card: about 9.2k FMA per element (nq*n*n*nde^2)
// against 32 B of input and 256 B of output in f32 (512 B in f64), i.e.
// ~36 FMA per output byte, so the FMA pipes and the shared-memory reads
// that feed them bound it, not device memory.  Design:
//   - one thread owns one element; its 64 sums stay in registers and H
//     never leaves registers (the plain version writes and re-reads H,
//     576 B per element in f32);
//   - the w-folded W and R sit in shared memory, loaded once per block; all
//     threads of a warp read the same W entry at once (a broadcast), four
//     values per 16-byte load;
//   - blocks loop over element tiles (grid = resident blocks), so W is
//     loaded into shared memory once per block, not once per tile;
//   - results go out as 16-byte stores of each element's contiguous row;
//     the ragged tail is masked by the element loop bound.
// Coalesced stores, wgmma and TMA are left for later work.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int N = 4;  // per-qp input width
constexpr int NN = N * N;
constexpr int NDE = 8;  // element dofs
constexpr int NDE2 = NDE * NDE;
constexpr int THREADS = 128;
static_assert(NDE2 % 4 == 0, "rows are moved four values at a time");

enum Energy : int { kNeoHookean2D = 0, kLinearElasticity2D = 1 };

__device__ __forceinline__ float log_t(float x) { return logf(x); }
__device__ __forceinline__ double log_t(double x) { return log(x); }

__device__ __forceinline__ void load4(const float* p, float v[4]) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
}
__device__ __forceinline__ void load4(const double* p, double v[4]) {
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

// Neo-Hookean, d = 2 (mfem_ad_tpu/ad.py NeoHookeanEnergy.
// hessian_closed_entries): F = I + grad u, with g[i*2+j] = du_i/dx_j,
// H_{(ij),(kl)} = lam Finv_ji Finv_lk + (mu - lam log J) Finv_jk Finv_li
//                 + mu [ij == kl].
template <typename T>
__device__ __forceinline__ void neo_hookean_2d(const T g[N], T lam, T mu,
                                               T h[NN]) {
  const T f0 = g[0] + T(1), f1 = g[1], f2 = g[2], f3 = g[3] + T(1);
  const T det = f0 * f3 - f1 * f2;
  const T r = T(1) / det;
  const T inv[4] = {f3 * r, -f1 * r, -f2 * r, f0 * r};
  const T c2 = mu - lam * log_t(det);
#pragma unroll
  for (int a = 0; a < N; ++a) {
    const int i = a / 2, j = a % 2;
#pragma unroll
    for (int b = 0; b < N; ++b) {
      const int k = b / 2, l = b % 2;
      T v = lam * inv[j * 2 + i] * inv[l * 2 + k] +
            c2 * inv[j * 2 + k] * inv[l * 2 + i];
      if (a == b) v = v + mu;
      h[a * N + b] = v;
    }
  }
}

// Linear elasticity, d = 2 (LinearElasticityEnergy.hessian_closed_entries):
// H_{(ij),(kl)} = lam [i==j][k==l] + mu ([i==k][j==l] + [i==l][j==k]).
template <typename T>
__device__ __forceinline__ void linear_elasticity_2d(const T*, T lam, T mu,
                                                     T h[NN]) {
#pragma unroll
  for (int a = 0; a < N; ++a) {
    const int i = a / 2, j = a % 2;
#pragma unroll
    for (int b = 0; b < N; ++b) {
      const int k = b / 2, l = b % 2;
      h[a * N + b] = lam * T((i == j) && (k == l)) +
                     mu * T((i == k) * (j == l) + (i == l) * (j == k));
    }
  }
}

template <typename T, int ENERGY>
__global__ void __launch_bounds__(THREADS)
    fused_jacobian_kernel(const T* __restrict__ ue, const T* __restrict__ R,
                          const T* __restrict__ Ww,
                          const T* __restrict__ lam,
                          const T* __restrict__ mu, T* __restrict__ A,
                          int64_t ne, int nq) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sW = reinterpret_cast<T*>(smem_raw);  // [nq*NN][NDE2]
  T* sR = sW + static_cast<size_t>(nq) * NN * NDE2;  // [nq*N][NDE]
  T* sLam = sR + nq * N * NDE;                       // [nq]
  T* sMu = sLam + nq;                                // [nq]
  for (int i = threadIdx.x; i < nq * NN * NDE2; i += blockDim.x) sW[i] = Ww[i];
  for (int i = threadIdx.x; i < nq * N * NDE; i += blockDim.x) sR[i] = R[i];
  for (int i = threadIdx.x; i < nq; i += blockDim.x) {
    sLam[i] = lam[i];
    sMu[i] = mu[i];
  }
  __syncthreads();

  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t e = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       e < ne; e += stride) {
    T u[NDE];
#pragma unroll
    for (int i = 0; i < NDE; ++i) u[i] = ue[e * NDE + i];
    T acc[NDE2];
#pragma unroll
    for (int ij = 0; ij < NDE2; ++ij) acc[ij] = T(0);

    for (int q = 0; q < nq; ++q) {
      T g[N];
#pragma unroll
      for (int a = 0; a < N; ++a) {
        const T* Rr = sR + (q * N + a) * NDE;
        T s = T(0);
#pragma unroll
        for (int i = 0; i < NDE; ++i) s += Rr[i] * u[i];
        g[a] = s;
      }
      T h[NN];
      if (ENERGY == kNeoHookean2D) {
        neo_hookean_2d<T>(g, sLam[q], sMu[q], h);
      } else {
        linear_elasticity_2d<T>(g, sLam[q], sMu[q], h);
      }
      const T* Wq = sW + static_cast<size_t>(q) * NN * NDE2;
#pragma unroll
      for (int ab = 0; ab < NN; ++ab) {
        const T hv = h[ab];
        const T* Wr = Wq + ab * NDE2;
#pragma unroll
        for (int ij = 0; ij < NDE2; ij += 4) {
          T w4[4];
          load4(Wr + ij, w4);
#pragma unroll
          for (int c = 0; c < 4; ++c) acc[ij + c] += hv * w4[c];
        }
      }
    }
    T* Ae = A + e * NDE2;
#pragma unroll
    for (int ij = 0; ij < NDE2; ij += 4) store4(Ae + ij, acc + ij);
  }
}

template <typename T, int ENERGY>
cudaError_t launch(const void* ue, const void* R, const void* Ww,
                   const void* lam, const void* mu, void* A, int64_t ne,
                   int nq, cudaStream_t stream) {
  auto kernel = fused_jacobian_kernel<T, ENERGY>;
  const size_t smem =
      (static_cast<size_t>(nq) * NN * NDE2 + nq * N * NDE + 2 * nq) *
      sizeof(T);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  int device = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&device)) != cudaSuccess) return err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                    device)) != cudaSuccess)
    return err;
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &per_sm, kernel, THREADS, smem)) != cudaSuccess)
    return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  const int64_t tiles = (ne + THREADS - 1) / THREADS;
  const int64_t resident = static_cast<int64_t>(per_sm) * sms;
  const int grid = static_cast<int>(tiles < resident ? tiles : resident);
  kernel<<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(ue), static_cast<const T*>(R),
      static_cast<const T*>(Ww), static_cast<const T*>(lam),
      static_cast<const T*>(mu), static_cast<T*>(A), ne, nq);
  return cudaGetLastError();
}

template <typename T>
int dispatch(const void* ue, const void* R, const void* Ww, const void* lam,
             const void* mu, void* A, int64_t ne, int nq, int energy,
             void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (energy) {
    case kNeoHookean2D:
      return launch<T, kNeoHookean2D>(ue, R, Ww, lam, mu, A, ne, nq, s);
    case kLinearElasticity2D:
      return launch<T, kLinearElasticity2D>(ue, R, Ww, lam, mu, A, ne, nq, s);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// Plain C interface for ctypes.  Pointers are device pointers of contiguous
// tensors: ue [ne, 8], R [nq*4, 8], Ww [nq*16, 64], lam [nq], mu [nq],
// A [ne, 8, 8].  Returns the launch's cudaError_t (0 on success).
extern "C" int fj_launch_f32(const void* ue, const void* R, const void* Ww,
                             const void* lam, const void* mu, void* A,
                             int64_t ne, int nq, int energy, void* stream) {
  return dispatch<float>(ue, R, Ww, lam, mu, A, ne, nq, energy, stream);
}

extern "C" int fj_launch_f64(const void* ue, const void* R, const void* Ww,
                             const void* lam, const void* mu, void* A,
                             int64_t ne, int nq, int energy, void* stream) {
  return dispatch<double>(ue, R, Ww, lam, mu, A, ne, nq, energy, stream);
}
