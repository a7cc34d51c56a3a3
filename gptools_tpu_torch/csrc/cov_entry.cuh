// One entry of a GP covariance matrix with {value, slope} blocks, for the
// covariance kernel (cov_kernel.cu) and its host build
// (evidence_chain_host.cpp).
//
// The per-point operands and the pair math are the evidence kernel's
// (pair_math.cuh): `tanh_warp` gives l(x) and l'(x) of the Gibbs-tanh
// kernel, `gibbs_pair_value` and `stat_pair<T, SE>` one entry of a
// derivative block. An entry of rows i, j takes the block
// sel = 2 nid_i + nid_j (0 value-value, 1 value-slope, 2 slope-value,
// 3 slope-slope); order ids outside {0, 1} give an exact zero, as the
// padded points of the reference's Pallas tiles do.

#pragma once

#include "pair_math.cuh"

namespace gt {

// The per-point operands (a0, a1) of the point x: (l, l') for Gibbs-tanh,
// unused zeros for SE. theta holds the kind's rows.
template <typename T, int K>
GT_HD void cov_point(const T* th, double x, T& a0, T& a1) {
  static_assert(K == GIBBS_TANH || K == SE, "covariance kinds: gibbs_tanh, se");
  if constexpr (K == GIBBS_TANH) {
    T z, t;
    tanh_warp<T>(th[1], th[2], th[3], th[4], x, z, t, a0, a1);
  } else {
    a0 = T(0);
    a1 = T(0);
  }
}

// K_ij of rows (xi, ni, ai0, ai1) and (xj, nj, aj0, aj1). The separation is
// taken in double and then rounded to T.
template <typename T, int K>
GT_HD T cov_entry(const T* th, double xi, double xj, int ni, int nj, T ai0,
                  T ai1, T aj0, T aj1) {
  static_assert(K == GIBBS_TANH || K == SE, "covariance kinds: gibbs_tanh, se");
  if ((ni != 0 && ni != 1) || (nj != 0 && nj != 1)) return T(0);
  const int sel = 2 * ni + nj;
  const T d = T(xi - xj);
  if constexpr (K == GIBBS_TANH) {
    return gibbs_pair_value<T>(th[0], ai0, ai1, aj0, aj1, d, sel);
  } else {
    T Gd, Gl;
    return th[0] * th[0] * stat_pair<T, SE>(th[1], d, T(0), sel, false, Gd, Gl);
  }
}

}  // namespace gt
