// The matrix-free Jacobian apply of a structured 2D H1 form for Hopper
// (sm_90a): y = J v with the packed symmetric per-point Hessian, in two
// passes and no atomics.
//
// For a single-space integrator on a structured 2D H1 dof grid with an
// element-shared shape tensor B0 [NQ, ND, SD] (a uniform Jacobian) and a
// packed Newton state (SymHess: K = N(N+1)/2 planes [K, ne, NQ], pair order
// (a, b), a <= b, quadrature weights folded in; N = VDIM*SD):
//
//   u_e[c][d]  = v[c*nds + dof(e, d)], 0 at essential dofs
//   x_q[c*SD+k] = sum_d B0[q,d,k] u_e[c][d]
//   y_q[a]      = sum_b H_q[a][b] x_q[b]
//   r_e[c][d]   = sum_q sum_k B0[q,d,k] y_q[c*SD+k]
//   out[c*nds+g] = v[c*nds+g] at essential dofs, else the sum of r_e[c][d]
//                  over the element nodes (e, d) that sit on dof g, in
//                  node order d (the order of the port's grid scatter)
//
// It replaces no TPU kernel: the JAX package's hess_mult is plain jnp that
// XLA fuses on the TPU.  Eager PyTorch runs it as about 43 kernels whose
// temporaries stream about 2 GB per apply at 512^2 Q1 vdim 2 (each plane
// product reads two full planes and writes one).
//
// What bounds it on the card: device memory.  The planes are read once
// (K NQ values per element: 90 at Q1 vdim 2, 75 at Q3 scalar, 27 at Q1
// scalar) against 2 (VDIM ND) + 2 N^2 NQ FMA per element; the input and
// output vectors and the element buffer (VDIM ND values per element,
// written once and read once) are the rest of the bytes.  Design:
//   - the element pass gives one thread to each (element, point) of a
//     block of kElems elements, so consecutive threads read consecutive
//     addresses of every plane (fully coalesced, each plane read once);
//   - the block's element dofs and B0 are staged in shared memory, x and
//     y live in registers, y goes through shared memory to the threads
//     that each sum one (node, component) of one element over the points;
//   - the element buffer is laid out [(c, d), ne], so its writes and the
//     dof pass's reads run along consecutive elements;
//   - the dof pass gives one thread to each dof: it sums the element
//     values of the nodes that sit on it in a fixed order and applies the
//     essential-dof mask, so the same input gives bitwise the same output.
#pragma once

#include <cstdint>

#include <cuda_runtime.h>

namespace ghm {

constexpr int kElems = 32;      // elements per block of the element pass
constexpr int kDofThreads = 256;  // threads per block of the dof pass

// The structured grid: nx x ny elements of order p, NX = nx*p + 1 dofs a
// row, nds = NX (ny*p + 1) scalar dofs; ai, aj the node offsets of every
// element node on the dof grid (x, y).
template <int ND>
struct Grid {
  int nx, ny, p, NX;
  int64_t nds, ne;
  int ai[ND], aj[ND];
};

// The grid of nx x ny elements of order p with node offsets offs[ND][2]
// (x, y); false where the kernels cannot index it.
template <int ND>
inline bool make_grid(int nx, int ny, int p, const int* offs, Grid<ND>* g) {
  if (nx <= 0 || ny <= 0 || p <= 0) return false;
  g->nx = nx;
  g->ny = ny;
  g->p = p;
  g->NX = nx * p + 1;
  g->nds = static_cast<int64_t>(g->NX) * (static_cast<int64_t>(ny) * p + 1);
  g->ne = static_cast<int64_t>(nx) * ny;
  for (int d = 0; d < ND; ++d) {
    g->ai[d] = offs[2 * d];
    g->aj[d] = offs[2 * d + 1];
    if (g->ai[d] < 0 || g->ai[d] > p || g->aj[d] < 0 || g->aj[d] > p)
      return false;
  }
  return true;
}

#ifdef __CUDACC__

template <typename T, int VDIM, int ND, int NQ, int SD>
__global__ void __launch_bounds__(kElems * NQ)
    element_pass(const T* __restrict__ v, const bool* __restrict__ ess,
                 const T* __restrict__ planes, const T* __restrict__ B0,
                 T* __restrict__ re, const Grid<ND> g) {
  constexpr int N = VDIM * SD;
  constexpr int NT = kElems * NQ;
  constexpr int NDE = VDIM * ND;
  __shared__ T bs[NQ * ND * SD];        // B0, [q][d][k]
  __shared__ T us[kElems * NDE];        // element dofs, [el][c][d]
  __shared__ T ys[kElems * NQ * N];     // H x, [el][q][a]

  const int t = threadIdx.x;
  const int64_t e0 = static_cast<int64_t>(blockIdx.x) * kElems;
  for (int i = t; i < NQ * ND * SD; i += NT) bs[i] = B0[i];
  // i = (c*ND + d)*kElems + el: consecutive threads, neighbouring elements
  for (int i = t; i < kElems * NDE; i += NT) {
    const int el = i % kElems, cd = i / kElems;
    const int d = cd % ND, c = cd / ND;
    const int64_t e = e0 + el;
    T val = T(0);
    if (e < g.ne) {
      const int64_t ex = e % g.nx, ey = e / g.nx;
      const int64_t k = c * g.nds + (ey * g.p + g.aj[d]) * g.NX +
                        ex * g.p + g.ai[d];
      if (ess == nullptr || !ess[k]) val = v[k];
    }
    us[(el * VDIM + c) * ND + d] = val;
  }
  __syncthreads();

  const int el = t / NQ, q = t % NQ;
  if (e0 + el < g.ne) {
    T x[N];
#pragma unroll
    for (int c = 0; c < VDIM; ++c) {
#pragma unroll
      for (int k = 0; k < SD; ++k) {
        T acc = T(0);
#pragma unroll
        for (int d = 0; d < ND; ++d)
          acc += bs[(q * ND + d) * SD + k] * us[(el * VDIM + c) * ND + d];
        x[c * SD + k] = acc;
      }
    }
    // plane kk at (e, q): kk*ne*NQ + e*NQ + q = kk*ne*NQ + e0*NQ + t
    const T* h = planes + e0 * NQ + t;
    const int64_t stride = g.ne * NQ;
    T y[N];
#pragma unroll
    for (int a = 0; a < N; ++a) y[a] = T(0);
    int kk = 0;
#pragma unroll
    for (int a = 0; a < N; ++a) {
#pragma unroll
      for (int b = a; b < N; ++b, ++kk) {
        const T hk = __ldg(h + kk * stride);
        y[a] += hk * x[b];
        if (a != b) y[b] += hk * x[a];
      }
    }
#pragma unroll
    for (int a = 0; a < N; ++a) ys[t * N + a] = y[a];
  }
  __syncthreads();

  for (int i = t; i < kElems * NDE; i += NT) {
    const int el2 = i % kElems, cd = i / kElems;
    const int d = cd % ND, c = cd / ND;
    const int64_t e = e0 + el2;
    if (e >= g.ne) continue;
    T acc = T(0);
#pragma unroll
    for (int qq = 0; qq < NQ; ++qq) {
#pragma unroll
      for (int k = 0; k < SD; ++k)
        acc += bs[(qq * ND + d) * SD + k] *
               ys[(el2 * NQ + qq) * N + c * SD + k];
    }
    re[static_cast<int64_t>(cd) * g.ne + e] = acc;
  }
}

template <typename T, int VDIM, int ND>
__global__ void __launch_bounds__(kDofThreads)
    dof_pass(const T* __restrict__ v, const bool* __restrict__ ess,
             const T* __restrict__ re, T* __restrict__ out,
             const Grid<ND> g) {
  const int64_t i =
      static_cast<int64_t>(blockIdx.x) * kDofThreads + threadIdx.x;
  if (i >= VDIM * g.nds) return;
  if (ess != nullptr && ess[i]) {
    out[i] = v[i];
    return;
  }
  const int c = static_cast<int>(i / g.nds);
  const int64_t dof = i - c * g.nds;
  const int gy = static_cast<int>(dof / g.NX);
  const int gx = static_cast<int>(dof - static_cast<int64_t>(gy) * g.NX);
  T acc = T(0);
#pragma unroll
  for (int d = 0; d < ND; ++d) {
    const int rx = gx - g.ai[d], ry = gy - g.aj[d];
    if (rx < 0 || ry < 0 || rx % g.p != 0 || ry % g.p != 0) continue;
    const int ex = rx / g.p, ey = ry / g.p;
    if (ex >= g.nx || ey >= g.ny) continue;
    acc += re[static_cast<int64_t>(c * ND + d) * g.ne +
              static_cast<int64_t>(ey) * g.nx + ex];
  }
  out[i] = acc;
}

// Launch both passes on ``stream``.  ``ess`` may be null (no mask: the
// integrator's hess_mult).  Returns cudaErrorInvalidValue for a grid the
// kernels cannot index, else the launches' cudaError_t.
template <typename T, int VDIM, int ND, int NQ, int SD>
cudaError_t launch(const void* v, const void* ess, const void* planes,
                   const void* B0, void* re, void* out, int nx, int ny,
                   int p, const int* offs, cudaStream_t stream) {
  static_assert(kElems * NQ <= 1024, "one thread per element point");
  Grid<ND> g;
  if (!make_grid(nx, ny, p, offs, &g) ||
      g.nds * VDIM > 0x7fffffffLL * kDofThreads)
    return cudaErrorInvalidValue;
  const int64_t blocks = (g.ne + kElems - 1) / kElems;
  element_pass<T, VDIM, ND, NQ, SD>
      <<<static_cast<unsigned>(blocks), kElems * NQ, 0, stream>>>(
          static_cast<const T*>(v), static_cast<const bool*>(ess),
          static_cast<const T*>(planes), static_cast<const T*>(B0),
          static_cast<T*>(re), g);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int64_t dof_blocks = (VDIM * g.nds + kDofThreads - 1) / kDofThreads;
  dof_pass<T, VDIM, ND><<<static_cast<unsigned>(dof_blocks), kDofThreads, 0,
                          stream>>>(
      static_cast<const T*>(v), static_cast<const bool*>(ess),
      static_cast<const T*>(re), static_cast<T*>(out), g);
  return cudaGetLastError();
}

#endif  // __CUDACC__

}  // namespace ghm
