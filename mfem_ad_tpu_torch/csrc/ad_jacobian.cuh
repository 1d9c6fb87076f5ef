// Nested dual numbers for the generic AD element-Jacobian kernel on Hopper
// (sm_90a): any point energy, code-generated and differentiated in the
// kernel.
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
// The kernel is the element-Jacobian GEMM of blocked_jacobian.cuh
// instantiated with VDIM = 1, SD = N, nd = NDE, B0 = Bf and the full W as
// its factor, with HessianEntries<E> below as its entries stage: x and the
// hyper-dual Hessian are computed once per (element, point) by all threads
// of a block, then contracted with Ww staged by TMA (ops/ad_jacobian.py
// writes the launchers).  What bounds it on the card and how the GEMM
// meets it is written there.
//
// The header compiles as CUDA (nvcc) and as host C++ (g++): the nested
// duals, point_hessian and HessianEntries are __host__ __device__.

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

// The AD entries stage of the element-Jacobian GEMM (blocked_jacobian.cuh,
// instantiated with VDIM = 1 and SD = N against the full W): the per-point
// Hessian of the energy E by nested duals, in the interface of the traced
// closed entries (kInputs, kParams, eval(x, p, h) writing h[a*N + b]).
template <class E>
struct HessianEntries {
  static constexpr int kInputs = E::kInputs;
  static constexpr int kParams = E::kParams;
  template <typename T>
  static AD_HD void eval(const T* x, const T* p, T* h) {
    point_hessian<T, E>(x, p, h);
  }
};

}  // namespace ad
