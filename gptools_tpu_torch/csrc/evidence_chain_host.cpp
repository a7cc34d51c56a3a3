// Host build of the evidence kernel's per-chain body, for the CPU tests.
//
// Compiles evidence_chain.cuh with an ordinary C++ compiler (outside nvcc
// the header's __host__ __device__ qualifiers expand to nothing) and loops
// over the chains on the CPU, with the CUDA entry points' signature minus
// the stream (float64 only), so the hand-derived gradients are checked against torch
// autograd without a card:
//
//   c++ -O2 -std=c++17 -shared -fPIC -o libchain.so evidence_chain_host.cpp

#include "evidence_chain.cuh"

namespace {

template <typename T, int K>
int run(int n, const double* X, const int* nid, const double* y,
        const double* err2, double df, const T* thetaT, int C, const T* mu,
        const T* nd, const T* w, const T* wp, T* ll, T* grad, T* gmu, T* gnd,
        T* gw, T* gwp) {
  constexpr int P = gt::KindParams<K>::value;
  if (n < 1 || n > gt::N_MAX) return 1;
  for (int c = 0; c < C; ++c) {
    T th[P], g[P];
    for (int p = 0; p < P; ++p) th[p] = thetaT[p * C + c];
    const gt::Aux<T> aux{
        mu ? mu + c : nullptr,   nd ? nd + c : nullptr,
        w ? w + c : nullptr,     wp ? wp + c : nullptr,
        gmu ? gmu + c : nullptr, gnd ? gnd + c : nullptr,
        gw ? gw + c : nullptr,   gwp ? gwp + c : nullptr,
        C};
    gt::evidence_chain<T, K>(n, X, nid, y, err2, df, th, aux, &ll[c], g);
    for (int p = 0; p < P; ++p) grad[p * C + c] = g[p];
  }
  return 0;
}

}  // namespace

#define GT_HOST_EXPORT(NAME, T, K)                                            \
  extern "C" int NAME(int n, const double* X, const int* nid, const double* y, \
                      const double* err2, double df, const T* thetaT, int C,  \
                      const T* mu, const T* nd, const T* w, const T* wp,      \
                      T* ll, T* grad, T* gmu, T* gnd, T* gw, T* gwp) {        \
    return run<T, K>(n, X, nid, y, err2, df, thetaT, C, mu, nd, w, wp, ll,    \
                     grad, gmu, gnd, gw, gwp);                                \
  }

GT_HOST_EXPORT(gt_gibbs_tanh_chain_host_f64, double, gt::GIBBS_TANH)
GT_HOST_EXPORT(gt_se_chain_host_f64, double, gt::SE)
GT_HOST_EXPORT(gt_matern52_chain_host_f64, double, gt::MATERN52)
