// Per-chain Gibbs-tanh GP evidence value and analytic theta-gradient.
//
// Replaces the TPU kernel gptools_tpu/ops/evidence_pallas.py ::
// build_loglik_vag (kind "gibbs_tanh", no aux inputs; body `kernel`,
// launched by `pl.pallas_call` in `call`). For one chain with
// theta = (sigma_f, l1, l2, lw, x0) it computes, in one pass:
//
//   tanh warp l(x_i), l'(x_i) -> lower-triangle pairs K_ij (i >= j) with the
//   derivative-block selector sel = 2 nid_i + nid_j -> err^2 and relative
//   jitter df * eps * max(mean diag, 1) -> Cholesky -> forward / back solves
//   -> ll -> Z = L^{-1} -> K^{-1} at the pairs -> dll/dK (+ jitter trace
//   term) -> per-pair VJPs -> warp VJP -> dll/dtheta.
//   A non-finite ll gives ll = -inf and an all-zero gradient.
//
// The Pallas body takes its pair and warp gradients with jax.vjp; here they
// are derived by hand (`pair_vjp`, `warp_vjp`), and the CPU tests compile
// this header with the host C++ compiler (GT_HD expands to nothing there)
// and hold it against torch autograd of the plain version.
//
// Layout: one thread per chain. The triangle lives in a packed local array
// (index i(i+1)/2 + j); the Cholesky factor overwrites K in place and
// L^{-1} then overwrites L in place, so one array of N_MAX(N_MAX+1)/2
// values carries the whole factorization.
//
// What bounds it on Hopper: per chain ~N^3/2 dependent multiply-adds over
// local memory (N = 27: ~10^4), i.e. latency of L1-cached local loads and
// of the FP64 pipe at low occupancy; device-memory traffic is only theta
// in and (ll, grad) out, 6 values per chain in and out. A warp per chain
// with the triangle in shared memory or registers, and tensor-core tiles
// for the O(N^3) stages, are the next steps.

#pragma once

#include <cmath>

#ifdef __CUDACC__
#define GT_HD __host__ __device__ __forceinline__
#else
#define GT_HD inline
#endif

namespace gt {

constexpr int N_MAX = 48;
constexpr int PACKED_MAX = N_MAX * (N_MAX + 1) / 2;
constexpr int NUM_PARAMS = 5;
constexpr double LOG_2PI = 1.8378770664093453;

template <typename T> struct Eps;
template <> struct Eps<float> { static constexpr double value = 1.1920928955078125e-07; };
template <> struct Eps<double> { static constexpr double value = 2.220446049250313e-16; };

#ifdef __CUDACC__
GT_HD float m_exp(float x) { return expf(x); }
GT_HD double m_exp(double x) { return exp(x); }
GT_HD float m_log(float x) { return logf(x); }
GT_HD double m_log(double x) { return log(x); }
GT_HD float m_sqrt(float x) { return sqrtf(x); }
GT_HD double m_sqrt(double x) { return sqrt(x); }
GT_HD float m_tanh(float x) { return tanhf(x); }
GT_HD double m_tanh(double x) { return tanh(x); }
#else
template <typename T> inline T m_exp(T x) { return std::exp(x); }
template <typename T> inline T m_log(T x) { return std::log(x); }
template <typename T> inline T m_sqrt(T x) { return std::sqrt(x); }
template <typename T> inline T m_tanh(T x) { return std::tanh(x); }
#endif

// x - x is 0 for finite x and NaN for +-inf and NaN (IEEE; the kernel is
// built without fast-math).
template <typename T> GT_HD bool m_isfinite(T x) { return x - x == T(0); }

GT_HD int tri(int i, int j) { return i * (i + 1) / 2 + j; }  // i >= j

// One lower-triangle covariance entry: sel 0 = value-value, 1 = value-slope
// (column derivative), 2 = slope-value (row derivative), 3 = slope-slope.
// Same expressions as _gibbs_pair in the reference kernel.
template <typename T>
GT_HD T pair_value(T sf, T la, T dla, T lb, T dlb, T d, int sel) {
  const T u = la * la, v = lb * lb;
  const T inv_S = T(1) / (u + v);
  const T k = (sf * sf) * m_sqrt(T(2) * la * lb * inv_S) * m_exp(-(d * d) * inv_S);
  if (sel == 0) return k;
  const T up = T(2) * la * dla, vp = T(2) * lb * dlb;
  const T inv_S2 = inv_S * inv_S;
  const T common = T(-0.5) * inv_S + (d * d) * inv_S2;
  const T g1 = up * (T(0.25) / u + common) - T(2) * d * inv_S;
  const T g2 = vp * (T(0.25) / v + common) + T(2) * d * inv_S;
  if (sel == 2) return g1 * k;
  if (sel == 1) return g2 * k;
  const T dg2dx = vp * (T(0.5) * up * inv_S2 + T(2) * d * inv_S2
                        - T(2) * (d * d) * up * inv_S2 * inv_S)
                  + T(2) * inv_S - T(2) * d * up * inv_S2;
  return (g1 * g2 + dg2dx) * k;
}

// Reverse mode of pair_value by hand: given the cotangent `gbar` of the
// entry, ADD d(entry)/d(sf, la, dla, lb, dlb) * gbar into the accumulators.
// Writing the entry as F * k with k = sf^2 sqrt(2 la lb iS) exp(-d^2 iS),
// iS = 1/(la^2 + lb^2), and F in {1, g1, g2, g1 g2 + dg2dx}, the adjoints
// flow back through the intermediates (g1, g2, dg2dx, common, iS2, iS, up,
// vp, u, v) to the five operands.
template <typename T>
GT_HD void pair_vjp(T sf, T la, T dla, T lb, T dlb, T d, int sel, T gbar,
                    T& sf_bar, T& la_bar, T& dla_bar, T& lb_bar, T& dlb_bar) {
  const T u = la * la, v = lb * lb;
  const T S = u + v;
  const T iS = T(1) / S;
  const T d2 = d * d;
  const T sqE = m_sqrt(T(2) * la * lb * iS) * m_exp(-d2 * iS);
  const T k = (sf * sf) * sqE;
  const T up = T(2) * la * dla, vp = T(2) * lb * dlb;
  const T iS2 = iS * iS;
  const T common = T(-0.5) * iS + d2 * iS2;
  T g1 = T(0), g2 = T(0), F = T(1);
  if (sel != 0) {
    g1 = up * (T(0.25) / u + common) - T(2) * d * iS;
    g2 = vp * (T(0.25) / v + common) + T(2) * d * iS;
  }
  const T B = T(0.5) * up * iS2 + T(2) * d * iS2 - T(2) * d2 * up * iS2 * iS;
  if (sel == 2) F = g1;
  if (sel == 1) F = g2;
  if (sel == 3) F = g1 * g2 + vp * B + T(2) * iS - T(2) * d * up * iS2;

  // entry = F * k
  const T k_bar = gbar * F;
  const T F_bar = gbar * k;
  T g1_bar = T(0), g2_bar = T(0), dg_bar = T(0);
  if (sel == 2) g1_bar = F_bar;
  if (sel == 1) g2_bar = F_bar;
  if (sel == 3) { g1_bar = F_bar * g2; g2_bar = F_bar * g1; dg_bar = F_bar; }

  T up_bar = T(0), vp_bar = T(0), u_bar = T(0), v_bar = T(0);
  T common_bar = T(0), iS2_bar = T(0), iS_bar = T(0);
  // g1 = up (1/(4u) + common) - 2 d iS
  up_bar += g1_bar * (T(0.25) / u + common);
  u_bar += g1_bar * up * (T(-0.25) / (u * u));
  common_bar += g1_bar * up;
  iS_bar += g1_bar * (T(-2) * d);
  // g2 = vp (1/(4v) + common) + 2 d iS
  vp_bar += g2_bar * (T(0.25) / v + common);
  v_bar += g2_bar * vp * (T(-0.25) / (v * v));
  common_bar += g2_bar * vp;
  iS_bar += g2_bar * (T(2) * d);
  // dg2dx = vp B + 2 iS - 2 d up iS2,
  // B = up iS2 / 2 + 2 d iS2 - 2 d^2 up iS2 iS
  vp_bar += dg_bar * B;
  const T B_bar = dg_bar * vp;
  up_bar += B_bar * (T(0.5) * iS2 - T(2) * d2 * iS2 * iS) + dg_bar * (T(-2) * d * iS2);
  iS2_bar += B_bar * (T(0.5) * up + T(2) * d - T(2) * d2 * up * iS)
             + dg_bar * (T(-2) * d * up);
  iS_bar += B_bar * (T(-2) * d2 * up * iS2) + dg_bar * T(2);
  // common = -iS / 2 + d^2 iS2
  iS_bar += common_bar * T(-0.5);
  iS2_bar += common_bar * d2;
  // iS2 = iS^2
  iS_bar += iS2_bar * T(2) * iS;
  // k: d log k / d iS = 1/(2 iS) - d^2 ; d log k / d la (direct) = 1/(2 la)
  iS_bar += k_bar * k * (T(0.5) * S - d2);
  sf_bar += k_bar * T(2) * sf * sqE;
  T la_b = k_bar * k * (T(0.5) / la);
  T lb_b = k_bar * k * (T(0.5) / lb);
  // iS = 1/S, S = u + v
  const T S_bar = -iS_bar * iS * iS;
  u_bar += S_bar;
  v_bar += S_bar;
  // u = la^2, v = lb^2, up = 2 la dla, vp = 2 lb dlb
  la_b += u_bar * T(2) * la + up_bar * T(2) * dla;
  lb_b += v_bar * T(2) * lb + vp_bar * T(2) * dlb;
  la_bar += la_b;
  lb_bar += lb_b;
  dla_bar += up_bar * T(2) * la;
  dlb_bar += vp_bar * T(2) * lb;
}

// Reverse mode of the tanh warp at one point: with z = (x - x0)/lw,
// t = tanh(z), l = l1 + (l2 - l1)(1 + t)/2, l' = (l2 - l1)(1 - t^2)/(2 lw),
// ADD (dl/dq * l_bar + dl'/dq * dl_bar) for q in (l1, l2, lw, x0) into g.
template <typename T>
GT_HD void warp_vjp(T l1, T l2, T lw, T z, T t, T dl, T l_bar, T dl_bar, T* g) {
  const T h = T(1) - t * t;
  const T t_bar = l_bar * T(0.5) * (l2 - l1) - dl_bar * (l2 - l1) * t / lw;
  const T z_bar = t_bar * h;
  g[1] += l_bar * T(0.5) * (T(1) - t) - dl_bar * T(0.5) * h / lw;
  g[2] += l_bar * T(0.5) * (T(1) + t) + dl_bar * T(0.5) * h / lw;
  g[3] += -dl_bar * dl / lw - z_bar * z / lw;
  g[4] += -z_bar / lw;
}

// Evidence value and theta-gradient of one chain. X, y, err2 (n,) are the
// observation constants (double), nid (n,) the order ids in {0, 1}, n <= N_MAX.
template <typename T>
GT_HD void gibbs_tanh_chain(int n, const double* X, const int* nid,
                            const double* y, const double* err2, double df,
                            const T th[NUM_PARAMS], T* ll_out,
                            T grad_out[NUM_PARAMS]) {
  const T sf = th[0], l1 = th[1], l2 = th[2], lw = th[3], x0 = th[4];
  T z[N_MAX], t[N_MAX], l[N_MAX], dl[N_MAX];
  for (int i = 0; i < n; ++i) {
    z[i] = (T(X[i]) - x0) / lw;
    t[i] = m_tanh(z[i]);
    l[i] = l1 + T(0.5) * (l2 - l1) * (T(1) + t[i]);
    dl[i] = T(0.5) * (l2 - l1) * (T(1) - t[i] * t[i]) / lw;
  }

  // ---- build the lower triangle, err^2 and relative jitter --------------
  T A[PACKED_MAX];
  T scale = T(0);
  for (int i = 0; i < n; ++i) {
    for (int j = 0; j <= i; ++j)
      A[tri(i, j)] = pair_value<T>(sf, l[i], dl[i], l[j], dl[j],
                                   T(X[i] - X[j]), 2 * nid[i] + nid[j]);
    A[tri(i, i)] += T(err2[i]);
    scale += A[tri(i, i)];
  }
  scale = scale * T(1.0 / n);
  const T jitter = T(df * Eps<T>::value) * (scale > T(1) ? scale : T(1));
  for (int i = 0; i < n; ++i) A[tri(i, i)] += jitter;

  // ---- Cholesky in place (row by row; a bad pivot propagates NaN) -------
  for (int i = 0; i < n; ++i) {
    for (int j = 0; j <= i; ++j) {
      T s = A[tri(i, j)];
      for (int k = 0; k < j; ++k) s -= A[tri(i, k)] * A[tri(j, k)];
      A[tri(i, j)] = (i == j) ? m_sqrt(s) : s / A[tri(j, j)];
    }
  }

  // ---- solves and ll ----------------------------------------------------
  T w[N_MAX], alpha[N_MAX];
  T quad = T(0), logdet = T(0);
  for (int i = 0; i < n; ++i) {
    T s = T(y[i]);
    for (int k = 0; k < i; ++k) s -= A[tri(i, k)] * w[k];
    w[i] = s / A[tri(i, i)];
    quad += w[i] * w[i];
    logdet += m_log(A[tri(i, i)]);
  }
  for (int i = n - 1; i >= 0; --i) {
    T s = w[i];
    for (int k = i + 1; k < n; ++k) s -= A[tri(k, i)] * alpha[k];
    alpha[i] = s / A[tri(i, i)];
  }
  const T ll = T(-0.5) * quad - logdet - T(0.5 * n * LOG_2PI);
  if (!m_isfinite(ll)) {
    *ll_out = -T(INFINITY);
    for (int p = 0; p < NUM_PARAMS; ++p) grad_out[p] = T(0);
    return;
  }
  *ll_out = ll;

  // ---- Z = L^{-1} in place, column by column ----------------------------
  // Column j reads L[i][k] for k > j and L[i][i] (not yet overwritten) and
  // Z[k][j] for k < i (already written), so L can be overwritten as we go.
  for (int j = 0; j < n; ++j) {
    A[tri(j, j)] = T(1) / A[tri(j, j)];
    for (int i = j + 1; i < n; ++i) {
      T s = -A[tri(i, j)] * A[tri(j, j)];
      for (int k = j + 1; k < i; ++k) s -= A[tri(i, k)] * A[tri(k, j)];
      A[tri(i, j)] = s / A[tri(i, i)];
    }
  }

  // ---- dll/dK at the pairs: K^{-1}_ij = sum_{k >= i} Z_ki Z_kj ----------
  T trace = T(0);
  T kbar_diag[N_MAX];
  for (int i = 0; i < n; ++i) {
    T kinv = T(0);
    for (int k = i; k < n; ++k) kinv += A[tri(k, i)] * A[tri(k, i)];
    kbar_diag[i] = T(0.5) * (alpha[i] * alpha[i] - kinv);
    trace += kbar_diag[i];
  }
  // the jitter depends on mean(diag K) only where scale > 1
  const T corr = scale > T(1) ? T(df * Eps<T>::value / n) * trace : T(0);

  // ---- backward through the build ---------------------------------------
  T l_bar[N_MAX], dl_bar[N_MAX];
  for (int i = 0; i < n; ++i) { l_bar[i] = T(0); dl_bar[i] = T(0); }
  T g[NUM_PARAMS] = {T(0), T(0), T(0), T(0), T(0)};
  for (int i = 0; i < n; ++i) {
    for (int j = 0; j <= i; ++j) {
      T gbar;
      if (i == j) {
        gbar = kbar_diag[i] + corr;
      } else {
        // only the lower triangle was built, so the off-diagonal cotangent
        // carries both symmetric halves: alpha_i alpha_j - K^{-1}_ij
        T kinv = T(0);
        for (int k = i; k < n; ++k) kinv += A[tri(k, i)] * A[tri(k, j)];
        gbar = alpha[i] * alpha[j] - kinv;
      }
      pair_vjp<T>(sf, l[i], dl[i], l[j], dl[j], T(X[i] - X[j]),
                  2 * nid[i] + nid[j], gbar, g[0], l_bar[i], dl_bar[i],
                  l_bar[j], dl_bar[j]);
    }
  }
  for (int i = 0; i < n; ++i)
    warp_vjp<T>(l1, l2, lw, z[i], t[i], dl[i], l_bar[i], dl_bar[i], g);
  for (int p = 0; p < NUM_PARAMS; ++p) grad_out[p] = g[p];
}

}  // namespace gt
