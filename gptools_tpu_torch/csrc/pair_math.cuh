// The pair math shared by the evidence kernel (evidence_chain.cuh) and the
// covariance kernel (cov_entry.cuh), and by their host build
// (evidence_chain_host.cpp): the per-point operands and one covariance entry
// of each pair kind, with their hand-derived reverse modes.
//
// - Gibbs-tanh: `tanh_warp` gives l(x), l'(x); `gibbs_pair_value` one entry
//   of a {value, slope} block, `gibbs_pair_vjp` and `warp_vjp` their
//   reverse modes (the Pallas body takes these with jax.vjp).
// - SE and Matern-5/2: `stat_pair` gives G(l, d) with its partials in d and
//   l; `slope_scale` the warp-slope factor of a slope block.
//
// The derivative-block selector is sel = 2 nid_i + nid_j (0 value-value,
// 1 value-slope, 2 slope-value, 3 slope-slope). Matern-5/2 takes
// |d| = sgn * d with sgn the sign of the UNWARPED separation X_i - X_j (0 on
// the diagonal and at repeated x), as the reference does, so |d| is exact
// for a warped d = w_i - w_j too (monotone warps keep the order of the
// points) and d|d|/dd is sgn, never NaN.
//
// Outside nvcc GT_HD expands to nothing, so the host C++ compiler builds
// the same functions for the CPU tests.

#pragma once

#include <cmath>

#ifdef __CUDACC__
#define GT_HD __host__ __device__ __forceinline__
#else
#define GT_HD inline
#endif

namespace gt {

constexpr int P_MAX = 5;
constexpr double LOG_2PI = 1.8378770664093453;
constexpr double SQRT5 = 2.23606797749979;

enum Kind { GIBBS_TANH = 0, SE = 1, MATERN52 = 2 };

// theta rows the kernel sees for each kind
template <int K> struct KindParams;
template <> struct KindParams<GIBBS_TANH> { static constexpr int value = 5; };
template <> struct KindParams<SE> { static constexpr int value = 2; };
template <> struct KindParams<MATERN52> { static constexpr int value = 2; };

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
// a product the compiler may not fuse into a later add (fma(a, a, b*b) and
// fma(b, b, a*a) differ in the last bit, so a*a + b*b would not commute)
#ifdef __CUDA_ARCH__
GT_HD float m_mul(float a, float b) { return __fmul_rn(a, b); }
GT_HD double m_mul(double a, double b) { return __dmul_rn(a, b); }
#else
GT_HD float m_mul(float a, float b) { return a * b; }
GT_HD double m_mul(double a, double b) { return a * b; }
#endif
#else
template <typename T> inline T m_exp(T x) { return std::exp(x); }
template <typename T> inline T m_log(T x) { return std::log(x); }
template <typename T> inline T m_sqrt(T x) { return std::sqrt(x); }
template <typename T> inline T m_tanh(T x) { return std::tanh(x); }
template <typename T> inline T m_mul(T a, T b) { return a * b; }
#endif

// x - x is 0 for finite x and NaN for +-inf and NaN (IEEE; the kernel is
// built without fast-math).
template <typename T> GT_HD bool m_isfinite(T x) { return x - x == T(0); }

// ---- Gibbs-tanh pairs ----------------------------------------------------

// One covariance entry: sel 0 = value-value, 1 = value-slope (column
// derivative), 2 = slope-value (row derivative), 3 = slope-slope. Same
// expressions as _gibbs_pair in the reference kernel. The value-value entry
// is symmetric to the bit under swapping (la, dla) with (lb, dlb) and d
// with -d: u + v commutes (see m_mul) and 2 la lb is exact in either order.
template <typename T>
GT_HD T gibbs_pair_value(T sf, T la, T dla, T lb, T dlb, T d, int sel) {
  const T u = m_mul(la, la), v = m_mul(lb, lb);
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

// Reverse mode of gibbs_pair_value by hand: given the cotangent `gbar` of
// the entry, ADD d(entry)/d(sf, la, dla, lb, dlb) * gbar into the
// accumulators. Writing the entry as F * k with k = sf^2 sqrt(2 la lb iS)
// exp(-d^2 iS), iS = 1/(la^2 + lb^2), and F in {1, g1, g2, g1 g2 + dg2dx},
// the adjoints flow back through the intermediates (g1, g2, dg2dx, common,
// iS2, iS, up, vp, u, v) to the five operands.
template <typename T>
GT_HD void gibbs_pair_vjp(T sf, T la, T dla, T lb, T dlb, T d, int sel, T gbar,
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

// The tanh warp at one point: z = (x - x0)/lw, t = tanh(z),
// l = l1 + (l2 - l1)(1 + t)/2, l' = (l2 - l1)(1 - t^2)/(2 lw).
template <typename T>
GT_HD void tanh_warp(T l1, T l2, T lw, T x0, double x, T& z, T& t, T& l, T& dl) {
  z = (T(x) - x0) / lw;
  t = m_tanh(z);
  l = l1 + T(0.5) * (l2 - l1) * (T(1) + t);
  dl = T(0.5) * (l2 - l1) * (T(1) - t * t) / lw;
}

// Reverse mode of the tanh warp at one point: ADD (dl/dq * l_bar +
// dl'/dq * dl_bar) for q in (l1, l2, lw, x0) into g[1..4].
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

// ---- stationary pairs (SE, Matern-5/2) -----------------------------------

// One entry of the base kernel at separation d is sf^2 * G(l, d); this
// returns G, with the expressions of _se_pair / _matern52_pair in the
// reference kernel. With `want_grad`, also its partials Gd = dG/dd and
// Gl = dG/dl.
template <typename T, int K>
GT_HD T stat_pair(T ell, T d, T sgn, int sel, bool want_grad, T& Gd, T& Gl) {
  if constexpr (K == SE) {
    const T inv_l2 = T(1) / (ell * ell);
    const T r2 = (d * d) * inv_l2;
    const T E = m_exp(T(-0.5) * r2);
    T G;
    if (sel == 0) {
      G = E;
      if (want_grad) { Gd = -d * inv_l2 * E; Gl = E * r2 / ell; }
    } else if (sel == 3) {
      G = (T(1) - r2) * inv_l2 * E;
      if (want_grad) {
        Gd = -d * inv_l2 * inv_l2 * E * (T(3) - r2);
        Gl = inv_l2 * E * (T(-2) + T(5) * r2 - r2 * r2) / ell;
      }
    } else {
      // sel 1: d/l^2 E; sel 2: its negative
      const T s = sel == 1 ? T(1) : T(-1);
      G = s * d * inv_l2 * E;
      if (want_grad) {
        Gd = s * inv_l2 * E * (T(1) - r2);
        Gl = s * d * inv_l2 * E * (r2 - T(2)) / ell;
      }
    }
    return G;
  } else {
    // s = sqrt(5)|d|/l with |d| = sgn d; ds/dd = sqrt(5) sgn / l, ds/dl = -s/l
    const T s = (T(SQRT5) / ell) * (sgn * d);
    const T E = m_exp(-s);
    const T c53 = T(5.0 / 3.0) / (ell * ell);
    T G, Gs = T(0), Gd_x = T(0), Gl_x = T(0);  // dG/ds and explicit partials
    if (sel == 0) {
      G = (T(1) + s + s * s * T(1.0 / 3.0)) * E;
      if (want_grad) Gs = -(s * (T(1) + s) * T(1.0 / 3.0)) * E;
    } else if (sel == 3) {
      G = c53 * (T(1) + s - s * s) * E;
      if (want_grad) { Gs = c53 * s * (s - T(3)) * E; Gl_x = T(-2) * G / ell; }
    } else {
      const T sg = sel == 1 ? T(1) : T(-1);
      G = sg * c53 * d * (T(1) + s) * E;
      if (want_grad) {
        Gs = -sg * c53 * d * s * E;
        Gd_x = sg * c53 * (T(1) + s) * E;
        Gl_x = T(-2) * G / ell;
      }
    }
    if (want_grad) {
      Gd = Gs * (T(SQRT5) * sgn / ell) + Gd_x;
      Gl = Gs * (-s / ell) + Gl_x;
    }
    return G;
  }
}

// The warp-slope factor of a stationary entry: the row (sel 2), column
// (sel 1) or both (sel 3) derivatives of k(w(x), w(x')) carry w'.
template <typename T>
GT_HD T slope_scale(int sel, T wpi, T wpj) {
  return sel == 0 ? T(1) : sel == 2 ? wpi : sel == 1 ? wpj : wpi * wpj;
}

}  // namespace gt
