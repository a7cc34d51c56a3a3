// Host build of the CUDA kernels' bodies, for the CPU tests.
//
// Compiles evidence_chain.cuh (the evidence kernel's warp-per-chain body)
// and cov_entry.cuh (the covariance kernel's per-thread work in both of its
// layouts) with an ordinary C++ compiler (outside nvcc the headers'
// __host__ __device__ qualifiers expand to nothing) and runs them on the
// CPU with the CUDA entry points' signatures minus the stream (the evidence
// body in float64, the covariance kernel in float64 and float32), so the
// hand-derived math is checked against torch without a card.
//
// The evidence body runs chain by chain as the kernel runs it: one chain's
// shared-memory slice (filled with NaN first, so a read of a slot that the
// chain never wrote shows), its 32 lanes by `gt::HostTeam`, phase after
// phase. gt_{kind}_chain_host_f64 runs the lanes of each phase in order
// 0..31, gt_{kind}_chain_host_rev_f64 in order 31..0: a lane that read what
// another lane writes in the same phase makes the two differ.
//
// The covariance kernel runs block by block in the same way, with the
// layout a card of `sms` multiprocessors would launch (the CUDA entry
// point's arguments, the stream replaced by sms): its threads phase by
// phase on NaN-filled shared memory, in order 0..nt-1
// (gt_{kind}_cov_host_{dtype}) or nt-1..0 (gt_{kind}_cov_host_rev_{dtype}).
//
//   c++ -O2 -std=c++17 -shared -fPIC -o libchain.so evidence_chain_host.cpp

#include <algorithm>
#include <limits>
#include <memory>
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

// NaN in every floating slot of a block's shared memory (a read of a slot
// that the block never wrote shows in the output), id 0 in the id slots (a
// valid id, so such a read is not hidden behind an exact zero)
template <typename T>
void fill_nan(T* p, size_t count) {
  for (size_t k = 0; k < count; ++k) p[k] = std::numeric_limits<T>::quiet_NaN();
}

template <typename T, int IMG>
void fill_small(gt::CovSmallShared<T, IMG>& s) {
  fill_nan(s.img, sizeof s.img / sizeof(T));
  fill_nan(s.a0, gt::COV_SMALL_N);
  fill_nan(s.a1, gt::COV_SMALL_N);
  fill_nan(s.th, sizeof s.th / sizeof(T));
  fill_nan(s.x, gt::COV_SMALL_N);
  std::fill(s.nid, s.nid + gt::COV_SMALL_N, 0);
}

// The covariance kernel's blocks one after another, as cov_kernel.cu
// launches them on a card of `sms` multiprocessors, the threads of each
// phase in order 0..nt-1 (or nt-1..0).
template <typename T, int K>
int run_cov(int n, const double* X, const int* nid, const T* theta, int B, T* out,
            int sms, bool reversed) {
  constexpr int P = gt::KindParams<K>::value;
  if (n < 1 || B < 1) return 1;
  int nt = gt::COV_THREADS;
  auto each = [reversed, &nt](auto&& f) {
    for (int k = 0; k < nt; ++k) f(reversed ? nt - 1 - k : k);
  };
  if (n <= gt::COV_SMALL_N && gt::cov_small_direct(n, B, sms)) {
    nt = 32 * gt::COV_BAND;
    std::unique_ptr<gt::CovSmallShared<T, 0>> sm(new gt::CovSmallShared<T, 0>);
    for (int b = 0; b < B; ++b) {
      for (int band = 0; band * gt::COV_BAND < n; ++band) {
        fill_small(*sm);
        const gt::CovSmall<T> c =
            gt::cov_small_band<T, K>(n, X, nid, theta, out, b, band, gt::small_smem(*sm));
        each([&](int t) { gt::small_points<T, K>(c, t); });
        each([&](int t) { gt::small_pairs<T, K>(c, t); });
      }
    }
    return 0;
  }
  if (n <= gt::COV_SMALL_N) {
    nt = gt::cov_small_threads(n);
    std::unique_ptr<gt::CovSmallShared<T, gt::COV_IMG>> sm(
        new gt::CovSmallShared<T, gt::COV_IMG>);
    for (int b = 0; b < B; ++b) {
      fill_small(*sm);
      const gt::CovSmall<T> c =
          gt::cov_small<T, K>(n, X, nid, theta, out, b, nt, gt::small_smem(*sm));
      each([&](int t) { gt::small_points<T, K>(c, t); });
      each([&](int t) { gt::small_pairs<T, K>(c, t); });
      each([&](int t) { gt::small_store<T>(c, t); });
    }
    return 0;
  }
  const size_t bytes = gt::cov_tile_bytes<T>();
  std::vector<double> buf(bytes / sizeof(double) + 2);  // 16-byte aligned by malloc
  const gt::CovTileSmem<T> sm = gt::cov_tile_smem<T>(buf.data());
  const long long tiles = (n + gt::COV_TILE - 1) / gt::COV_TILE;
  for (int b = 0; b < B; ++b) {
    for (long long q = 0; q < tiles * (tiles + 1) / 2; ++q) {
      int I, J;
      gt::tri_pair(q, I, J);
      fill_nan(sm.S1, 2 * gt::COV_TILE * gt::tile_ld<T>());
      fill_nan(sm.a0, 2 * gt::COV_TILE);
      fill_nan(sm.a1, 2 * gt::COV_TILE);
      fill_nan(sm.x, 2 * gt::COV_TILE);
      std::fill(sm.nid, sm.nid + 2 * gt::COV_TILE, 0);
      const gt::CovTile<T> c{n, I, J, X, nid, theta + (size_t)b * P,
                             out + (size_t)b * n * n, sm};
      each([&](int t) { gt::tile_points<T, K>(c, t); });
      each([&](int t) { gt::tile_entries<T, K>(c, t); });
      each([&](int t) { gt::tile_store<T>(c, t); });
    }
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

#define GT_HOST_COV_EXPORT(NAME, T, K, REVERSED)                               \
  extern "C" int NAME(int n, const double* X, const int* nid, const T* theta,  \
                      int B, T* out, int sms) {                                \
    return run_cov<T, K>(n, X, nid, theta, B, out, sms, REVERSED);             \
  }

GT_HOST_COV_EXPORT(gt_se_cov_host_f64, double, gt::SE, false)
GT_HOST_COV_EXPORT(gt_gibbs_tanh_cov_host_f64, double, gt::GIBBS_TANH, false)
GT_HOST_COV_EXPORT(gt_se_cov_host_rev_f64, double, gt::SE, true)
GT_HOST_COV_EXPORT(gt_gibbs_tanh_cov_host_rev_f64, double, gt::GIBBS_TANH, true)
GT_HOST_COV_EXPORT(gt_se_cov_host_f32, float, gt::SE, false)
GT_HOST_COV_EXPORT(gt_gibbs_tanh_cov_host_f32, float, gt::GIBBS_TANH, false)
GT_HOST_COV_EXPORT(gt_se_cov_host_rev_f32, float, gt::SE, true)
GT_HOST_COV_EXPORT(gt_gibbs_tanh_cov_host_rev_f32, float, gt::GIBBS_TANH, true)
