// CUDA entry points for the Gibbs-tanh evidence kernel (sm_90a).
//
// A thin __global__ wrapper around gt::gibbs_tanh_chain (see
// gibbs_tanh_chain.cuh for the math, the TPU kernel it replaces and what
// bounds it): one thread per chain, grid-stride over C, the ragged edge
// masked by `c < C` (no padding). theta is chains-minor, thetaT (5, C), as
// in the reference; ll (C,) and grad (5, C) are written by the kernel and
// allocated by the caller. Plain C interface, bound from Python by ctypes;
// each entry point returns cudaGetLastError() after the launch.

#include <cuda_runtime.h>

#include "gibbs_tanh_chain.cuh"

namespace {

constexpr int kThreads = 64;

template <typename T>
__global__ void __launch_bounds__(kThreads)
gibbs_tanh_evidence_kernel(int n, const double* __restrict__ X,
                           const int* __restrict__ nid,
                           const double* __restrict__ y,
                           const double* __restrict__ err2, double df,
                           const T* __restrict__ thetaT, int C,
                           T* __restrict__ ll, T* __restrict__ grad) {
  for (int c = blockIdx.x * blockDim.x + threadIdx.x; c < C;
       c += gridDim.x * blockDim.x) {
    T th[gt::NUM_PARAMS], g[gt::NUM_PARAMS], v;
    for (int p = 0; p < gt::NUM_PARAMS; ++p) th[p] = thetaT[p * C + c];
    gt::gibbs_tanh_chain<T>(n, X, nid, y, err2, df, th, &v, g);
    ll[c] = v;
    for (int p = 0; p < gt::NUM_PARAMS; ++p) grad[p * C + c] = g[p];
  }
}

template <typename T>
int launch(int n, const void* X, const void* nid, const void* y,
           const void* err2, double df, const void* thetaT, int C, void* ll,
           void* grad, void* stream) {
  if (n < 1 || n > gt::N_MAX || C < 1) return int(cudaErrorInvalidValue);
  const int blocks = (C + kThreads - 1) / kThreads;
  gibbs_tanh_evidence_kernel<T><<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      n, (const double*)X, (const int*)nid, (const double*)y,
      (const double*)err2, df, (const T*)thetaT, C, (T*)ll, (T*)grad);
  return int(cudaGetLastError());
}

}  // namespace

extern "C" {

int gt_gibbs_tanh_evidence_f32(int n, const void* X, const void* nid,
                               const void* y, const void* err2, double df,
                               const void* thetaT, int C, void* ll, void* grad,
                               void* stream) {
  return launch<float>(n, X, nid, y, err2, df, thetaT, C, ll, grad, stream);
}

int gt_gibbs_tanh_evidence_f64(int n, const void* X, const void* nid,
                               const void* y, const void* err2, double df,
                               const void* thetaT, int C, void* ll, void* grad,
                               void* stream) {
  return launch<double>(n, X, nid, y, err2, df, thetaT, C, ll, grad, stream);
}

}  // extern "C"
