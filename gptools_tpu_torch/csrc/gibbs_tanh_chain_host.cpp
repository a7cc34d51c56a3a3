// Host build of the evidence kernel's per-chain body, for the CPU tests.
//
// Compiles gibbs_tanh_chain.cuh with an ordinary C++ compiler (outside nvcc
// the header's __host__ __device__ qualifiers expand to nothing) and loops
// over the chains on the CPU, so the hand-derived gradients are checked
// against torch autograd without a card:
//
//   c++ -O2 -std=c++17 -shared -fPIC -o libchain.so gibbs_tanh_chain_host.cpp

#include "gibbs_tanh_chain.cuh"

namespace {

template <typename T>
int run(int n, const double* X, const int* nid, const double* y,
        const double* err2, double df, const T* thetaT, int C, T* ll, T* grad) {
  if (n < 1 || n > gt::N_MAX) return 1;
  for (int c = 0; c < C; ++c) {
    T th[gt::NUM_PARAMS], g[gt::NUM_PARAMS];
    for (int p = 0; p < gt::NUM_PARAMS; ++p) th[p] = thetaT[p * C + c];
    gt::gibbs_tanh_chain<T>(n, X, nid, y, err2, df, th, &ll[c], g);
    for (int p = 0; p < gt::NUM_PARAMS; ++p) grad[p * C + c] = g[p];
  }
  return 0;
}

}  // namespace

extern "C" {

int gt_gibbs_tanh_chain_host_f32(int n, const double* X, const int* nid,
                                 const double* y, const double* err2,
                                 double df, const float* thetaT, int C,
                                 float* ll, float* grad) {
  return run<float>(n, X, nid, y, err2, df, thetaT, C, ll, grad);
}

int gt_gibbs_tanh_chain_host_f64(int n, const double* X, const int* nid,
                                 const double* y, const double* err2,
                                 double df, const double* thetaT, int C,
                                 double* ll, double* grad) {
  return run<double>(n, X, nid, y, err2, df, thetaT, C, ll, grad);
}

}  // extern "C"
