// Host build of the CUDA kernels' bodies, for the CPU tests.
//
// Compiles evidence_chain.cuh (the evidence kernel's per-chain body) and
// cov_entry.cuh (the covariance kernel's per-point and per-entry functions)
// with an ordinary C++ compiler (outside nvcc the headers' __host__
// __device__ qualifiers expand to nothing) and loops over the chains or the
// entries on the CPU, with the CUDA entry points' signatures minus the
// stream (float64 only), so the hand-derived math is checked against torch
// without a card:
//
//   c++ -O2 -std=c++17 -shared -fPIC -o libchain.so evidence_chain_host.cpp

#include "cov_entry.cuh"

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

// The covariance kernel's work, entry by entry: per theta, the per-point
// operands of every point, then every (i, j).
template <typename T, int K>
int run_cov(int n, const double* X, const int* nid, const T* theta, int B, T* out) {
  constexpr int P = gt::KindParams<K>::value;
  if (n < 1 || n > 4096) return 1;
  T a0[4096], a1[4096];
  for (int b = 0; b < B; ++b) {
    const T* th = theta + b * P;
    for (int p = 0; p < n; ++p) gt::cov_point<T, K>(th, X[p], a0[p], a1[p]);
    for (int i = 0; i < n; ++i)
      for (int j = 0; j < n; ++j)
        out[((long)b * n + i) * n + j] = gt::cov_entry<T, K>(
            th, X[i], X[j], nid[i], nid[j], a0[i], a1[i], a0[j], a1[j]);
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

#define GT_HOST_COV_EXPORT(NAME, T, K)                                         \
  extern "C" int NAME(int n, const double* X, const int* nid, const T* theta,  \
                      int B, T* out) {                                         \
    return run_cov<T, K>(n, X, nid, theta, B, out);                            \
  }

GT_HOST_COV_EXPORT(gt_se_cov_host_f64, double, gt::SE)
GT_HOST_COV_EXPORT(gt_gibbs_tanh_cov_host_f64, double, gt::GIBBS_TANH)
