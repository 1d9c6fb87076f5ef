// The packed Newton state of a structured 2D H1 form for Hopper (sm_90a):
// the weighted per-point Hessian planes of a point energy, in one kernel
// and no atomics.
//
// For a single-space integrator on a structured 2D H1 dof grid with an
// element-shared shape tensor B0 [NQ, ND, SD] (a uniform Jacobian),
// element-shared quadrature weights wq [NQ] and parameters prm [NQ, P]:
//
//   u_e[c][d]     = u[c*nds + dof(e, d)]
//   x_q[c*SD+k]   = sum_d B0[q,d,k] u_e[c][d]
//   h_ab(e, q)    = d2 E / dx_a dx_b at (x_q, prm_q)
//   planes[kk, e, q] = h_ab(e, q) wq[q],  kk the packed index of (a, b),
//                      a <= b, in the order (0,0), (0,1), ..., (N-1,N-1)
//
// with N = VDIM*SD: the SymHess state that ADBlockIntegrator.hess_state
// returns with sym=True.  The entries stage is a type with kInputs,
// kParams and eval(x, p, h) writing h[a*N + b]: ad::HessianEntries<E> of
// ad_jacobian.cuh, the nested-dual Hessian of a traced energy, N(N+1)/2
// hyper-dual evaluations per point.
//
// It replaces no TPU kernel: the JAX package's hess_state is
// vmap(jacfwd(grad(f))) that XLA fuses on the TPU.  In eager PyTorch the
// same torch.func program issues about 1,900 aten and prims calls per
// state, whatever the grid's size, so a Newton direction of a six-level
// nonlinear multigrid spent its time on the host linearizing.
//
// What bounds it on the card: the bytes.  The function writes K = N(N+1)/2
// planes per point (2D neo-Hookean Q1 vdim 2 at 512^2 in f64: K = 10,
// 193 MB, about 0.058 ms at 3.35 TB/s) and reads the dofs once; its least
// arithmetic, the 75 lines of that energy's traced closed entries per
// point, is 0.28 GFLOP.  The nested duals do more than the function
// needs: N(N+1)/2 hyper-dual evaluations per point, each recomputing the
// value and the gradient parts beside its one second part (about
// 4.5 GFLOP of f64 there), so that arithmetic, not the bytes, sets the
// kernel's time; PERF.md gives the measured share of the bytes bound.
// Design:
//   - one thread per (element, point), neighbouring threads on
//     neighbouring points of one element, so every plane's writes are
//     fully coalesced and each plane is written once;
//   - B0 and the dofs of the block's elements are staged in shared
//     memory (each element's dofs read once from device memory by the
//     block), x and the Hessian live in registers;
//   - fixed-size blocks of kThreads threads, whatever NQ, so a block's
//     registers fit the f64 hyper-dual evaluation; a block's points span
//     at most kSpan elements;
//   - each thread writes its own entries, no atomics: the same input
//     gives bitwise the same output.
#pragma once

#include <cstdint>

#include "ad_jacobian.cuh"
#include "grid_hess_mult.cuh"

namespace ghs {

using ghm::Grid;

constexpr int kThreads = 128;  // threads per block, one (element, point)

#ifdef __CUDACC__

template <typename T, int VDIM, int ND, int NQ, int SD, class Entries>
__global__ void __launch_bounds__(kThreads)
    state_kernel(const T* __restrict__ u, const T* __restrict__ B0,
                 const T* __restrict__ wq, const T* __restrict__ prm,
                 T* __restrict__ planes, const Grid<ND> g) {
  constexpr int N = VDIM * SD;
  constexpr int NDE = VDIM * ND;
  constexpr int NP = Entries::kParams;
  constexpr int kSpan = (kThreads - 1) / NQ + 2;  // elements a block spans
  static_assert(Entries::kInputs == N, "the entries take VDIM*SD inputs");
  __shared__ T bs[NQ * ND * SD];   // B0, [q][d][k]
  __shared__ T us[kSpan * NDE];    // element dofs, [el][c][d]

  const int t = threadIdx.x;
  const int64_t total = g.ne * NQ;
  const int64_t i0 = static_cast<int64_t>(blockIdx.x) * kThreads;
  const int64_t e_first = i0 / NQ;
  for (int i = t; i < NQ * ND * SD; i += kThreads) bs[i] = B0[i];
  // i = (c*ND + d)*kSpan + el: consecutive threads, neighbouring elements
  for (int i = t; i < kSpan * NDE; i += kThreads) {
    const int el = i % kSpan, cd = i / kSpan;
    const int d = cd % ND, c = cd / ND;
    const int64_t e = e_first + el;
    T val = T(0);
    if (e < g.ne) {
      const int64_t ex = e % g.nx, ey = e / g.nx;
      val = u[c * g.nds + (ey * g.p + g.aj[d]) * g.NX + ex * g.p + g.ai[d]];
    }
    us[el * NDE + c * ND + d] = val;
  }
  __syncthreads();

  const int64_t idx = i0 + t;  // = e*NQ + q
  if (idx >= total) return;
  const int64_t e = idx / NQ;
  const int q = static_cast<int>(idx - e * NQ);
  const T* ue = us + (e - e_first) * NDE;
  T x[N];
#pragma unroll
  for (int c = 0; c < VDIM; ++c) {
#pragma unroll
    for (int k = 0; k < SD; ++k) {
      T acc = T(0);
#pragma unroll
      for (int d = 0; d < ND; ++d)
        acc += bs[(q * ND + d) * SD + k] * ue[c * ND + d];
      x[c * SD + k] = acc;
    }
  }
  T p[NP > 0 ? NP : 1];
#pragma unroll
  for (int k = 0; k < NP; ++k) p[k] = prm[q * NP + k];
  T h[N * N];
  Entries::eval(x, p, h);
  const T w = wq[q];
  int kk = 0;
#pragma unroll
  for (int a = 0; a < N; ++a) {
#pragma unroll
    for (int b = a; b < N; ++b, ++kk)
      planes[kk * total + idx] = h[a * N + b] * w;
  }
}

// Launch the kernel on ``stream``.  ``prm`` may be null (no parameters).
// Returns cudaErrorInvalidValue for a grid the kernel cannot index, else
// the launch's cudaError_t.
template <typename T, int VDIM, int ND, int NQ, int SD, class Entries>
cudaError_t launch(const void* u, const void* B0, const void* wq,
                   const void* prm, void* planes, int nx, int ny, int p,
                   const int* offs, cudaStream_t stream) {
  Grid<ND> g;
  if (!ghm::make_grid(nx, ny, p, offs, &g)) return cudaErrorInvalidValue;
  const int64_t blocks = (g.ne * NQ + kThreads - 1) / kThreads;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  state_kernel<T, VDIM, ND, NQ, SD, Entries>
      <<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(
          static_cast<const T*>(u), static_cast<const T*>(B0),
          static_cast<const T*>(wq), static_cast<const T*>(prm),
          static_cast<T*>(planes), g);
  return cudaGetLastError();
}

#endif  // __CUDACC__

}  // namespace ghs
