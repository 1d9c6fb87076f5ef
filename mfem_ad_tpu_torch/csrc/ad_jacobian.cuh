// Generic AD element-Jacobian assembly for Hopper (sm_90a): any point
// energy, code-generated and differentiated by nested dual numbers.
//
// Replaces the TPU kernel mfem_ad_tpu/ops/fused_jacobian.py:_kernel, both
// of its branches: the closed branch (vmapped hessian_closed, Mass and
// Diffusion) and the generic branch (jax.grad of the energy traced into the
// kernel, n Hessian-vector products per point).  Mass and Diffusion are
// quadratic, so the nested duals below give their Hessian exactly, the same
// function hessian_closed returns; one kernel serves both branches.
//
// For every element e:
//
//   x_q      = R_q ue_e                                  (N values per qp)
//   H_ab(q)  = d2 E / dx_a dx_b at (x_q, p_q)            (hyper-dual AD)
//   A_e[ij]  = sum_q sum_ab H_ab(q) Ww[(q,a,b), ij]      Ww = w-folded Bf(x)Bf
//
// The energy E is a struct with kInputs, kParams and
//   template <typename T> static T eval(const T* x, const T* p),
// straight-line code written by mfem_ad_tpu_torch/ops/energy_codegen.py.
// T is the plain scalar (value) or HyperDual<S> {v, a, b, ab}: seeding
// x_a.a = 1 and x_b.b = 1 gives dE/dx_a in .a and d2E/dx_a dx_b in .ab (the
// reference's nested-dual Hessian, n(n+1)/2 evaluations per point).
//
// What bounds it on the card: the contraction, nq*N^2*NDE^2 FMA per element
// (9,216 at the 2D Q1 vector headline, 576 for scalar Q1, 5,184 for scalar
// Q2), plus the hyper-dual energy evaluations, N(N+1)/2 per qp at about
// four times the arithmetic of a plain evaluation; against 4*NDE bytes in
// and 4*NDE^2 bytes out per element in f32.  At the vector headline that is
// ~36 FMA per output byte, so FMA throughput bounds it; at scalar Q1
// (~8 FMA per byte) device memory and launch overhead do.  Design (that
// of csrc/fused_jacobian.cu, generalised):
//   - one thread owns one element; its NDE^2 <= 81 sums and the Hessian
//     stay in registers (the plain version writes and re-reads H);
//   - the w-folded W, R and the per-qp parameters sit in dynamic shared
//     memory, loaded once per block; a warp reads one W entry at a time
//     (a broadcast), four at once where the row length allows;
//   - blocks loop over element tiles (grid = resident blocks);
//   - each element's row is stored contiguously (16-byte stores where
//     NDE^2 % 4 == 0); the ragged tail is masked by the loop bound.
// Tensor cores (wgmma), TMA and coalesced stores are left for later work.
//
// The header compiles as CUDA (nvcc) and as host C++ (g++): the nested
// duals and point_hessian are __host__ __device__, the kernel and its
// launcher exist only under __CUDACC__.

#pragma once

#include <math.h>
#include <stdint.h>

#ifdef __CUDACC__
#include <cuda_runtime.h>
#define AD_HD __host__ __device__ __forceinline__
#define AD_UNROLL _Pragma("unroll")
#else
#define AD_HD inline
#define AD_UNROLL
#endif

namespace ad {

// Hyper-dual number v + a e1 + b e2 + ab e1 e2 with e1^2 = e2^2 = 0.
template <typename S>
struct HyperDual {
  S v, a, b, ab;
  HyperDual() = default;
  AD_HD HyperDual(S v_) : v(v_), a(S(0)), b(S(0)), ab(S(0)) {}
  AD_HD HyperDual(S v_, S a_, S b_, S ab_) : v(v_), a(a_), b(b_), ab(ab_) {}
};

template <typename T>
struct scalar_of {
  using type = T;
};
template <typename S>
struct scalar_of<HyperDual<S>> {
  using type = S;
};

// ---- scalar functions -----------------------------------------------------

AD_HD float value(float x) { return x; }
AD_HD double value(double x) { return x; }
AD_HD float log(float x) { return ::logf(x); }
AD_HD double log(double x) { return ::log(x); }
AD_HD float exp(float x) { return ::expf(x); }
AD_HD double exp(double x) { return ::exp(x); }
AD_HD float sqrt(float x) { return ::sqrtf(x); }
AD_HD double sqrt(double x) { return ::sqrt(x); }
AD_HD float sin(float x) { return ::sinf(x); }
AD_HD double sin(double x) { return ::sin(x); }
AD_HD float cos(float x) { return ::cosf(x); }
AD_HD double cos(double x) { return ::cos(x); }
AD_HD float tanh(float x) { return ::tanhf(x); }
AD_HD double tanh(double x) { return ::tanh(x); }
AD_HD float abs(float x) { return ::fabsf(x); }
AD_HD double abs(double x) { return ::fabs(x); }
AD_HD float pow(float x, float c) { return ::powf(x, c); }
AD_HD double pow(double x, double c) { return ::pow(x, c); }

// ---- hyper-dual arithmetic ------------------------------------------------

template <typename S>
AD_HD S value(const HyperDual<S>& x) {
  return x.v;
}

template <typename S>
AD_HD HyperDual<S> operator-(const HyperDual<S>& x) {
  return {-x.v, -x.a, -x.b, -x.ab};
}

template <typename S>
AD_HD HyperDual<S> operator+(const HyperDual<S>& x, const HyperDual<S>& y) {
  return {x.v + y.v, x.a + y.a, x.b + y.b, x.ab + y.ab};
}
template <typename S>
AD_HD HyperDual<S> operator+(const HyperDual<S>& x, S c) {
  return {x.v + c, x.a, x.b, x.ab};
}
template <typename S>
AD_HD HyperDual<S> operator+(S c, const HyperDual<S>& x) {
  return {c + x.v, x.a, x.b, x.ab};
}

template <typename S>
AD_HD HyperDual<S> operator-(const HyperDual<S>& x, const HyperDual<S>& y) {
  return {x.v - y.v, x.a - y.a, x.b - y.b, x.ab - y.ab};
}
template <typename S>
AD_HD HyperDual<S> operator-(const HyperDual<S>& x, S c) {
  return {x.v - c, x.a, x.b, x.ab};
}
template <typename S>
AD_HD HyperDual<S> operator-(S c, const HyperDual<S>& x) {
  return {c - x.v, -x.a, -x.b, -x.ab};
}

template <typename S>
AD_HD HyperDual<S> operator*(const HyperDual<S>& x, const HyperDual<S>& y) {
  return {x.v * y.v, x.a * y.v + x.v * y.a, x.b * y.v + x.v * y.b,
          x.ab * y.v + x.a * y.b + x.b * y.a + x.v * y.ab};
}
template <typename S>
AD_HD HyperDual<S> operator*(const HyperDual<S>& x, S c) {
  return {x.v * c, x.a * c, x.b * c, x.ab * c};
}
template <typename S>
AD_HD HyperDual<S> operator*(S c, const HyperDual<S>& x) {
  return {c * x.v, c * x.a, c * x.b, c * x.ab};
}

// q = x / y from q y = x, differentiated twice: the value is the correctly
// rounded quotient, as in the plain evaluation.
template <typename S>
AD_HD HyperDual<S> operator/(const HyperDual<S>& x, const HyperDual<S>& y) {
  const S qv = x.v / y.v;
  const S qa = (x.a - qv * y.a) / y.v;
  const S qb = (x.b - qv * y.b) / y.v;
  return {qv, qa, qb, (x.ab - qa * y.b - qb * y.a - qv * y.ab) / y.v};
}
template <typename S>
AD_HD HyperDual<S> operator/(const HyperDual<S>& x, S c) {
  return {x.v / c, x.a / c, x.b / c, x.ab / c};
}
template <typename S>
AD_HD HyperDual<S> operator/(S c, const HyperDual<S>& y) {
  const S qv = c / y.v;
  const S qa = -(qv * y.a) / y.v;
  const S qb = -(qv * y.b) / y.v;
  return {qv, qa, qb, -(qa * y.b + qb * y.a + qv * y.ab) / y.v};
}

// f(x) for f with value f0, first derivative f1 and second f2 at x.v.
template <typename S>
AD_HD HyperDual<S> chain(const HyperDual<S>& x, S f0, S f1, S f2) {
  return {f0, f1 * x.a, f1 * x.b, f1 * x.ab + f2 * x.a * x.b};
}

template <typename S>
AD_HD HyperDual<S> log(const HyperDual<S>& x) {
  const S r = S(1) / x.v;
  return chain(x, log(x.v), r, -r * r);
}
template <typename S>
AD_HD HyperDual<S> exp(const HyperDual<S>& x) {
  const S e = exp(x.v);
  return chain(x, e, e, e);
}
template <typename S>
AD_HD HyperDual<S> sqrt(const HyperDual<S>& x) {
  const S s = sqrt(x.v);
  const S d1 = S(0.5) / s;
  return chain(x, s, d1, -d1 / (S(2) * x.v));
}
template <typename S>
AD_HD HyperDual<S> sin(const HyperDual<S>& x) {
  const S s = sin(x.v), c = cos(x.v);
  return chain(x, s, c, -s);
}
template <typename S>
AD_HD HyperDual<S> cos(const HyperDual<S>& x) {
  const S s = sin(x.v), c = cos(x.v);
  return chain(x, c, -s, -c);
}
template <typename S>
AD_HD HyperDual<S> tanh(const HyperDual<S>& x) {
  const S t = tanh(x.v);
  const S d1 = S(1) - t * t;
  return chain(x, t, d1, S(-2) * t * d1);
}
template <typename S>
AD_HD HyperDual<S> abs(const HyperDual<S>& x) {
  const S sgn = x.v > S(0) ? S(1) : (x.v < S(0) ? S(-1) : S(0));
  return chain(x, abs(x.v), sgn, S(0));
}
template <typename S>
AD_HD HyperDual<S> pow(const HyperDual<S>& x, S c) {
  return chain(x, pow(x.v, c), c * pow(x.v, c - S(1)),
               c * (c - S(1)) * pow(x.v, c - S(2)));
}

// ---- per-point derivatives ------------------------------------------------

// Value and gradient of E at one point: N evaluations, seed e1 = x_i.
template <typename S, class E>
AD_HD S point_gradient(const S* x, const S* p, S* g) {
  constexpr int N = E::kInputs;
  constexpr int P = E::kParams > 0 ? E::kParams : 1;
  HyperDual<S> xd[N], pd[P];
  AD_UNROLL for (int i = 0; i < N; ++i) xd[i] = HyperDual<S>(x[i]);
  AD_UNROLL for (int k = 0; k < E::kParams; ++k) pd[k] = HyperDual<S>(p[k]);
  S val = S(0);
  AD_UNROLL for (int i = 0; i < N; ++i) {
    xd[i].a = S(1);
    const HyperDual<S> r = E::eval(xd, pd);
    g[i] = r.a;
    val = r.v;
    xd[i].a = S(0);
  }
  return val;
}

// Hessian h[N*N] of E at one point: the upper triangle from N(N+1)/2
// hyper-dual evaluations (seeds e1 = x_i, e2 = x_j), mirrored.
template <typename S, class E>
AD_HD void point_hessian(const S* x, const S* p, S* h) {
  constexpr int N = E::kInputs;
  constexpr int P = E::kParams > 0 ? E::kParams : 1;
  HyperDual<S> xd[N], pd[P];
  AD_UNROLL for (int i = 0; i < N; ++i) xd[i] = HyperDual<S>(x[i]);
  AD_UNROLL for (int k = 0; k < E::kParams; ++k) pd[k] = HyperDual<S>(p[k]);
  AD_UNROLL for (int i = 0; i < N; ++i) {
    AD_UNROLL for (int j = i; j < N; ++j) {
      xd[i].a = S(1);
      xd[j].b = S(1);
      const S hij = E::eval(xd, pd).ab;
      h[i * N + j] = hij;
      h[j * N + i] = hij;
      xd[i].a = S(0);
      xd[j].b = S(0);
    }
  }
}

#ifdef __CUDACC__

constexpr int kThreads = 128;

template <typename S, int NDE, class E>
constexpr size_t smem_elems(int nq) {
  return static_cast<size_t>(nq) * E::kInputs * E::kInputs * NDE * NDE +
         static_cast<size_t>(nq) * E::kInputs * NDE +
         static_cast<size_t>(nq) * E::kParams;
}

template <typename S>
__device__ __forceinline__ void load4(const S* p, S v[4]);
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

// ue [ne, NDE], R [nq*N, NDE], Ww [nq*N*N, NDE*NDE] (w-folded rows (q,a,b)),
// prm [nq, kParams], A [ne, NDE, NDE].
template <typename S, int NDE, class E>
__global__ void __launch_bounds__(kThreads)
    jacobian_kernel(const S* __restrict__ ue, const S* __restrict__ R,
                    const S* __restrict__ Ww, const S* __restrict__ prm,
                    S* __restrict__ A, int64_t ne, int nq) {
  constexpr int N = E::kInputs;
  constexpr int NN = N * N;
  constexpr int P = E::kParams;
  constexpr int NDE2 = NDE * NDE;
  constexpr bool kVec4 = NDE2 % 4 == 0;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  S* sW = reinterpret_cast<S*>(smem_raw);                // [nq*NN][NDE2]
  S* sR = sW + static_cast<size_t>(nq) * NN * NDE2;      // [nq*N][NDE]
  S* sP = sR + static_cast<size_t>(nq) * N * NDE;        // [nq][P]
  for (int i = threadIdx.x; i < nq * NN * NDE2; i += blockDim.x) sW[i] = Ww[i];
  for (int i = threadIdx.x; i < nq * N * NDE; i += blockDim.x) sR[i] = R[i];
  for (int i = threadIdx.x; i < nq * P; i += blockDim.x) sP[i] = prm[i];
  __syncthreads();

  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t e = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       e < ne; e += stride) {
    S u[NDE];
    AD_UNROLL for (int i = 0; i < NDE; ++i) u[i] = ue[e * NDE + i];
    S acc[NDE2];
    AD_UNROLL for (int ij = 0; ij < NDE2; ++ij) acc[ij] = S(0);

    for (int q = 0; q < nq; ++q) {
      S x[N];
      AD_UNROLL for (int a = 0; a < N; ++a) {
        const S* Rr = sR + (q * N + a) * NDE;
        S s = S(0);
        AD_UNROLL for (int i = 0; i < NDE; ++i) s += Rr[i] * u[i];
        x[a] = s;
      }
      S h[NN];
      point_hessian<S, E>(x, sP + q * P, h);
      const S* Wq = sW + static_cast<size_t>(q) * NN * NDE2;
      AD_UNROLL for (int ab = 0; ab < NN; ++ab) {
        const S hv = h[ab];
        const S* Wr = Wq + ab * NDE2;
        if constexpr (kVec4) {
          AD_UNROLL for (int ij = 0; ij < NDE2; ij += 4) {
            S w4[4];
            load4<S>(Wr + ij, w4);
            AD_UNROLL for (int c = 0; c < 4; ++c) acc[ij + c] += hv * w4[c];
          }
        } else {
          AD_UNROLL for (int ij = 0; ij < NDE2; ++ij) acc[ij] += hv * Wr[ij];
        }
      }
    }
    S* Ae = A + e * NDE2;
    if constexpr (kVec4) {
      AD_UNROLL for (int ij = 0; ij < NDE2; ij += 4) store4(Ae + ij, acc + ij);
    } else {
      AD_UNROLL for (int ij = 0; ij < NDE2; ++ij) Ae[ij] = acc[ij];
    }
  }
}

// Launch on ``stream``: one block of kThreads per resident slot, each
// looping over element tiles.  Returns the launch's cudaError_t.
template <typename S, int NDE, class E>
cudaError_t launch(const void* ue, const void* R, const void* Ww,
                   const void* prm, void* A, int64_t ne, int nq,
                   cudaStream_t stream) {
  auto kernel = jacobian_kernel<S, NDE, E>;
  const size_t smem = smem_elems<S, NDE, E>(nq) * sizeof(S);
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
           &per_sm, kernel, kThreads, smem)) != cudaSuccess)
    return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  const int64_t tiles = (ne + kThreads - 1) / kThreads;
  const int64_t resident = static_cast<int64_t>(per_sm) * sms;
  const int grid = static_cast<int>(tiles < resident ? tiles : resident);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const S*>(ue), static_cast<const S*>(R),
      static_cast<const S*>(Ww), static_cast<const S*>(prm),
      static_cast<S*>(A), ne, nq);
  return cudaGetLastError();
}

#endif  // __CUDACC__

}  // namespace ad
