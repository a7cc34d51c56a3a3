// CUDA entry points for the evidence kernel (sm_90a), one per (kind, dtype).
//
// A thin __global__ wrapper around gt::evidence_chain (see
// evidence_chain.cuh for the math, the TPU kernel it replaces and what
// bounds it): one thread per chain, grid-stride over C, the ragged edge
// masked by `c < C` (no padding). theta is chains-minor, thetaT (P, C), as
// in the reference; the aux inputs mu, nd, w, wp and their cotangents are
// (N, C) row-major and may each be null. ll (C,), grad (P, C) and the
// cotangents are written by the kernel and allocated by the caller. Plain
// C interface, bound from Python by ctypes; each entry point returns
// cudaGetLastError() after the launch.

#include <cuda_runtime.h>

#include "evidence_chain.cuh"

namespace {

constexpr int kThreads = 64;

template <typename T, int K>
__global__ void __launch_bounds__(kThreads)
evidence_kernel(int n, const double* __restrict__ X, const int* __restrict__ nid,
                const double* __restrict__ y, const double* __restrict__ err2,
                double df, const T* __restrict__ thetaT, int C,
                const T* mu, const T* nd, const T* w, const T* wp,
                T* __restrict__ ll, T* __restrict__ grad,
                T* gmu, T* gnd, T* gw, T* gwp) {
  constexpr int P = gt::KindParams<K>::value;
  for (int c = blockIdx.x * blockDim.x + threadIdx.x; c < C;
       c += gridDim.x * blockDim.x) {
    T th[P], g[P], v;
    for (int p = 0; p < P; ++p) th[p] = thetaT[p * C + c];
    const gt::Aux<T> aux{
        mu ? mu + c : nullptr,   nd ? nd + c : nullptr,
        w ? w + c : nullptr,     wp ? wp + c : nullptr,
        gmu ? gmu + c : nullptr, gnd ? gnd + c : nullptr,
        gw ? gw + c : nullptr,   gwp ? gwp + c : nullptr,
        C};
    gt::evidence_chain<T, K>(n, X, nid, y, err2, df, th, aux, &v, g);
    ll[c] = v;
    for (int p = 0; p < P; ++p) grad[p * C + c] = g[p];
  }
}

template <typename T, int K>
int launch(int n, const void* X, const void* nid, const void* y,
           const void* err2, double df, const void* thetaT, int C,
           const void* mu, const void* nd, const void* w, const void* wp,
           void* ll, void* grad, void* gmu, void* gnd, void* gw, void* gwp,
           void* stream) {
  if (n < 1 || n > gt::N_MAX || C < 1) return int(cudaErrorInvalidValue);
  const int blocks = (C + kThreads - 1) / kThreads;
  evidence_kernel<T, K><<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      n, (const double*)X, (const int*)nid, (const double*)y,
      (const double*)err2, df, (const T*)thetaT, C, (const T*)mu,
      (const T*)nd, (const T*)w, (const T*)wp, (T*)ll, (T*)grad, (T*)gmu,
      (T*)gnd, (T*)gw, (T*)gwp);
  return int(cudaGetLastError());
}

}  // namespace

#define GT_EXPORT(NAME, T, K)                                                 \
  extern "C" int NAME(int n, const void* X, const void* nid, const void* y,   \
                      const void* err2, double df, const void* thetaT, int C, \
                      const void* mu, const void* nd, const void* w,          \
                      const void* wp, void* ll, void* grad, void* gmu,        \
                      void* gnd, void* gw, void* gwp, void* stream) {         \
    return launch<T, K>(n, X, nid, y, err2, df, thetaT, C, mu, nd, w, wp, ll, \
                        grad, gmu, gnd, gw, gwp, stream);                     \
  }

GT_EXPORT(gt_gibbs_tanh_evidence_f32, float, gt::GIBBS_TANH)
GT_EXPORT(gt_gibbs_tanh_evidence_f64, double, gt::GIBBS_TANH)
GT_EXPORT(gt_se_evidence_f32, float, gt::SE)
GT_EXPORT(gt_se_evidence_f64, double, gt::SE)
GT_EXPORT(gt_matern52_evidence_f32, float, gt::MATERN52)
GT_EXPORT(gt_matern52_evidence_f64, double, gt::MATERN52)
