// Host build of the CUDA kernels' bodies, for the CPU tests.
//
// Compiles evidence_chain.cuh (the evidence kernel's warp-per-chain body)
// and cov_entry.cuh (the covariance kernel's per-point and per-entry
// functions) with an ordinary C++ compiler (outside nvcc the headers'
// __host__ __device__ qualifiers expand to nothing) and runs them on the
// CPU with the CUDA entry points' signatures minus the stream (float64
// only), so the hand-derived math is checked against torch without a card.
//
// The evidence body runs chain by chain as the kernel runs it: one chain's
// shared-memory slice (filled with NaN first, so a read of a slot that the
// chain never wrote shows), its 32 lanes by `gt::HostTeam`, phase after
// phase. gt_{kind}_chain_host_f64 runs the lanes of each phase in order
// 0..31, gt_{kind}_chain_host_rev_f64 in order 31..0: a lane that read what
// another lane writes in the same phase makes the two differ.
//
//   c++ -O2 -std=c++17 -shared -fPIC -o libchain.so evidence_chain_host.cpp

#include <limits>
#include <vector>

#include "cov_entry.cuh"
#include "evidence_chain.cuh"

namespace {

template <typename T, int K>
int run(int n, const double* X, const int* nid, const double* y,
        const double* err2, double df, const T* thetaT, int C, const T* mu,
        const T* nd, const T* w, const T* wp, T* ll, T* grad, T* gmu, T* gnd,
        T* gw, T* gwp, bool reversed) {
  constexpr int P = gt::KindParams<K>::value;
  if (n < 1 || n > gt::N_MAX) return 1;
  std::vector<unsigned char> tab(n * (n + 1));
  for (int q = 0; q < n * (n + 1) / 2; ++q) gt::pair_entry(q, tab.data());
  std::vector<T> buf(gt::chain_elems(n));
  const gt::ChainSmem<T> s = gt::chain_smem<T>(buf.data(), n);
  const gt::HostTeam team{reversed};
  const gt::AuxSet has{mu != nullptr, nd != nullptr, w != nullptr, wp != nullptr};
  for (int c = 0; c < C; ++c) {
    for (T& v : buf) v = std::numeric_limits<T>::quiet_NaN();
    for (int p = 0; p < P; ++p) s.th[p] = thetaT[p * C + c];
    for (int i = 0; i < n; ++i) {
      if (mu) s.mu[i] = mu[i * C + c];
      if (nd) s.nd[i] = nd[i * C + c];
      if (w) s.w[i] = w[i * C + c];
      if (wp) s.wp[i] = wp[i * C + c];
    }
    gt::evidence_chain<T, K>(team, n, X, nid, y, err2, df, tab.data(), has, s);
    ll[c] = s.out[0];
    for (int p = 0; p < P; ++p) grad[p * C + c] = s.out[1 + p];
    for (int i = 0; i < n; ++i) {
      if (gmu) gmu[i * C + c] = s.alpha[i];
      if (gnd) gnd[i * C + c] = s.kbd[i];
      if (gw) gw[i * C + c] = s.b0[i];
      if (gwp) gwp[i * C + c] = s.b1[i];
    }
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

#define GT_HOST_EXPORT(NAME, T, K, REVERSED)                                  \
  extern "C" int NAME(int n, const double* X, const int* nid, const double* y, \
                      const double* err2, double df, const T* thetaT, int C,  \
                      const T* mu, const T* nd, const T* w, const T* wp,      \
                      T* ll, T* grad, T* gmu, T* gnd, T* gw, T* gwp) {        \
    return run<T, K>(n, X, nid, y, err2, df, thetaT, C, mu, nd, w, wp, ll,    \
                     grad, gmu, gnd, gw, gwp, REVERSED);                      \
  }

GT_HOST_EXPORT(gt_gibbs_tanh_chain_host_f64, double, gt::GIBBS_TANH, false)
GT_HOST_EXPORT(gt_se_chain_host_f64, double, gt::SE, false)
GT_HOST_EXPORT(gt_matern52_chain_host_f64, double, gt::MATERN52, false)
GT_HOST_EXPORT(gt_gibbs_tanh_chain_host_rev_f64, double, gt::GIBBS_TANH, true)
GT_HOST_EXPORT(gt_se_chain_host_rev_f64, double, gt::SE, true)
GT_HOST_EXPORT(gt_matern52_chain_host_rev_f64, double, gt::MATERN52, true)

#define GT_HOST_COV_EXPORT(NAME, T, K)                                         \
  extern "C" int NAME(int n, const double* X, const int* nid, const T* theta,  \
                      int B, T* out) {                                         \
    return run_cov<T, K>(n, X, nid, theta, B, out);                            \
  }

GT_HOST_COV_EXPORT(gt_se_cov_host_f64, double, gt::SE)
GT_HOST_COV_EXPORT(gt_gibbs_tanh_cov_host_f64, double, gt::GIBBS_TANH)
