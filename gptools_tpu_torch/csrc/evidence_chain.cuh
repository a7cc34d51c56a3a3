// Per-chain GP evidence value and analytic gradient, one warp per chain.
//
// Replaces the TPU kernel gptools_tpu/ops/evidence_pallas.py ::
// build_loglik_vag (body `kernel`, launched by `pl.pallas_call` in `call`
// at :475) for its kinds "gibbs_tanh" (theta = sigma_f, l1, l2, lw, x0),
// "se" and "matern52" (theta = sigma_f, l), with its auxiliary per-point
// inputs: mu (mean at each observation), nd (theta-dependent noise
// variance on the diagonal), w (warped coordinate) and wp (warp slope).
// For one chain it computes:
//
//   per-point pair operands (pair_math.cuh) -> lower-triangle pairs K_ij
//   (i >= j) with sel = 2 nid_i + nid_j -> err^2, nd and relative jitter
//   df * eps * max(mean diag, 1) -> Cholesky, with the forward solve on
//   y - mu and Z = L^{-1} as its extra rows -> ll -> alpha = Z^T L^{-1} r
//   -> K^{-1} at the pairs -> dll/dK (+ jitter trace term) -> per-pair VJPs
//   -> dll/dtheta and dll/d(mu, nd, w, wp).
//   A non-finite ll gives ll = -inf and all-zero gradients and cotangents.
//
// Layout. The Pallas kernel puts 1024 chains on the lanes of a VPU tile;
// on Hopper the parallel unit is a warp and the fast private storage is
// shared memory, so a warp of 32 lanes works on one chain, whose matrices
// live in the block's shared memory (`ChainSmem`, sized from n at launch;
// every row starts on a whole vector, and the dots read rows as float2 /
// double2):
//
//   S   n x ld: K in the lower triangle, overwritten by L (strict lower;
//       diag(L) in `dg`); then the pair cotangents dll/dK_ij over L, and
//       finally the i-end and j-end cotangents of each pair's first operand
//       (row p of S holds every contribution into point p).
//   S2  n x ld: zeros in the strict lower triangle, and row m of Z^T
//       (Z_km, k >= m) from the diagonal on; then the same cotangents as S
//       for the second operand.
//   n-vectors a0, a1 (pair operands), dg, wv (residual, then L^{-1} r),
//   alpha, kbd (diag dll/dK), b0, b1; the staged theta and aux inputs; the
//   lanes' partial sums `part`, P_MAX x 32.
//
// The work is a sequence of phases; a phase is a function of the lane,
// run by a `Team`, with a barrier after it:
//
//   operands (a lane per point) | build (pairs round-robin over lanes,
//   per-lane diagonal sums) | Cholesky, left-looking, one phase per two
//   columns: every lane forms the two pivots, and each row of the phase
//   (rows of L below them, the residual, rows of Z^T: one per lane for
//   n < 32, two up to N_MAX) its two entries | quad, logdet (a lane per
//   point) | alpha and diag K^{-1} (a lane per point) | dll/dK_ij (pairs) |
//   pair VJPs (pairs) | per-point sums of the pair cotangents and the warp
//   VJP (a lane per point) | outputs.
//
// No lane reads, within a phase, what another lane writes in it, and every
// sum is taken in a fixed order: a lane's own loop, then across lanes by
// `Team::sum`, a butterfly whose every lane ends with the same bits. There
// are no atomics, so two calls on the same inputs give the same bits.
// Every loop is bounded by n alone, so a NaN theta runs the same path and
// comes out as -inf with zero gradients; the -inf test is taken on ll,
// which all lanes hold equal.
//
// `WarpTeam` runs a phase on the lanes of a warp and __syncwarp()s; the host
// build (evidence_chain_host.cpp) uses `HostTeam`, which runs the lanes one
// after another, in order 0..31 or 31..0. A lane that read another lane's
// write of the same phase would make the two orders differ, which the CPU
// tests check bit for bit; they also hold the result to autograd of the
// plain version.
//
// What bounds it on Hopper: per chain ~N^3 flops of dependent multiply-adds
// (the Cholesky with Z = L^{-1} as extra rows, ~N^3/3, and K^{-1} at the
// pairs, ~N^3/6) plus ~50-150 flops per pair for the build and its VJP: at
// N = 27-35 and C = 4096-12288 about 1e8-5e8 flops a call, a bound of
// ~4-15 us at the card's 67 TFLOP/s FP32 (twice that at 34 TFLOP/s FP64);
// the bytes are ~0.5-5 MB. The algebra is a chain of small dependent steps
// (a Cholesky column waits on the last), so a chain is bound by the latency
// of its steps and each step by its shared-memory loads; the design spreads
// each step over 32 lanes, halves the steps (two columns each), loads 16
// bytes at a time, and keeps up to 24 chains resident per SM (~8 KB of
// shared memory a chain at N = 27 in float32) to hide the rest. No tensor
// cores: TF32 or bf16 would break the float64 parity and the float32
// bounds.

#pragma once

#include <type_traits>

#include "pair_math.cuh"

#ifdef __CUDACC__
#define GT_DEV __device__ __forceinline__
#define GT_UNROLL _Pragma("unroll")
#define GT_ROLLED _Pragma("unroll 1")
#else
#define GT_DEV inline
#define GT_UNROLL
#define GT_ROLLED
#endif

namespace gt {

constexpr int N_MAX = 48;
constexpr int LANES = 32;

// ---- teams ------------------------------------------------------------------

#ifdef __CUDACC__
#ifdef GT_PHASE_CLOCK
// Profiling build only: the SM clock of block 0's first thread at the start
// of the chain body (slot 0) and after each phase (slots 1, 2, ...).
constexpr int PHASE_MARKS = 256;
static __device__ long long phase_clk[PHASE_MARKS];
#endif

// The lanes of one warp; every lane of the warp calls every phase.
struct WarpTeam {
  int lane;
#ifdef GT_PHASE_CLOCK
  mutable int mark = 0;
#endif
  template <class F>
  __device__ __forceinline__ void run(F&& f) const {
    f(lane);
    __syncwarp();
#ifdef GT_PHASE_CLOCK
    if (blockIdx.x == 0 && threadIdx.x == 0 && mark + 1 < PHASE_MARKS)
      phase_clk[1 + mark] = clock64();
    ++mark;
#endif
  }
  // sum of part[0..31]: a butterfly, lane l adding lane l ^ off's value at
  // each level; addition commutes, so every lane ends with the same bits
  template <typename T>
  __device__ __forceinline__ T sum(const T* part) const {
    T v = part[lane];
#pragma unroll
    for (int off = LANES / 2; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
    return v;
  }
};
#else
// The host's stand-in: the lanes one after another, forward or reversed;
// the same butterfly for sums.
struct HostTeam {
  bool reversed;
  template <class F>
  void run(F&& f) const {
    for (int l = 0; l < LANES; ++l) f(reversed ? LANES - 1 - l : l);
  }
  template <typename T>
  T sum(const T* part) const {
    T a[LANES], b[LANES];
    for (int l = 0; l < LANES; ++l) a[l] = part[l];
    for (int off = LANES / 2; off > 0; off >>= 1) {
      for (int l = 0; l < LANES; ++l) b[l] = a[l] + a[l ^ off];
      for (int l = 0; l < LANES; ++l) a[l] = b[l];
    }
    return a[0];
  }
};
#endif

// ---- one chain's shared memory ----------------------------------------------

// Elements in one vector load: the dots read rows two elements at a time
// (float2, double2), so every row and vector of a slice starts on a whole
// vector. (float4 loads were no faster and took more registers.)
constexpr int VW = 2;

// n rounded up to whole vectors
GT_HD int chain_nv(int n) { return (n + VW - 1) / VW * VW; }

// Row stride of the squares: whole vectors, and an odd count of them, so
// lanes loading a vector each from consecutive rows hit different banks
// (float2: the 16 lanes of a half warp, 16 bank pairs; double2: the 8
// lanes of a quarter warp, 8 groups of four banks).
GT_HD int chain_ld(int n) { return (chain_nv(n) / VW | 1) * VW; }

// elements of one chain's slice, a whole number of vectors
GT_HD int chain_elems(int n) {
  return 2 * n * chain_ld(n) + 12 * chain_nv(n) + chain_nv(P_MAX * LANES + 2 * P_MAX + 1);
}

template <typename T>
struct ChainSmem {
  T *S, *S2;                                        // n x ld each
  T *a0, *a1, *dg, *wv, *alpha, *kbd, *b0, *b1;     // n each
  T *mu, *nd, *w, *wp;                              // staged aux inputs, n each
  T* part;                                          // P_MAX x LANES
  T* th;                                            // theta, P_MAX
  T* out;                                           // ll, grad: 1 + P_MAX
  int ld;
};

template <typename T>
GT_HD ChainSmem<T> chain_smem(T* base, int n) {
  ChainSmem<T> s;
  s.ld = chain_ld(n);
  const int nv = chain_nv(n);
  s.S = base;
  s.S2 = s.S + n * s.ld;
  T* v = s.S2 + n * s.ld;  // the 12 n-vectors, each on a whole vector
  s.a0 = v;
  s.a1 = v + nv;
  s.dg = v + 2 * nv;
  s.wv = v + 3 * nv;
  s.alpha = v + 4 * nv;
  s.kbd = v + 5 * nv;
  s.b0 = v + 6 * nv;
  s.b1 = v + 7 * nv;
  s.mu = v + 8 * nv;
  s.nd = v + 9 * nv;
  s.w = v + 10 * nv;
  s.wp = v + 11 * nv;
  s.part = v + 12 * nv;
  s.th = s.part + P_MAX * LANES;
  s.out = s.th + P_MAX;
  return s;
}

// Which aux channels the chain has (their values staged in ChainSmem).
struct AuxSet {
  bool mu, nd, w, wp;
};

// Entry q of the pair table: the pairs (i, j), i >= j, of a triangle in
// row-major order q = i(i+1)/2 + j, as bytes tab[2q] = i, tab[2q + 1] = j.
GT_HD void pair_entry(int q, unsigned char* tab) {
  int i = 0;
  while ((i + 1) * (i + 2) / 2 <= q) ++i;
  tab[2 * q] = (unsigned char)i;
  tab[2 * q + 1] = (unsigned char)(q - i * (i + 1) / 2);
}

// 1 / sqrt(x): the card's reciprocal square root (within 2 ulp in float32,
// 1 ulp in float64), one dependent step where sqrt and a division take two
#ifdef __CUDA_ARCH__
GT_DEV float m_rsqrt(float x) { return rsqrtf(x); }
GT_DEV double m_rsqrt(double x) { return rsqrt(x); }
#else
template <typename T>
inline T m_rsqrt(T x) { return T(1) / std::sqrt(x); }
#endif

// The vector at p (aligned to it) into v[0], v[1].
#ifdef __CUDA_ARCH__
GT_DEV void loadv(const float* p, float (&v)[2]) {
  const float2 q = *reinterpret_cast<const float2*>(p);
  v[0] = q.x;
  v[1] = q.y;
}
GT_DEV void loadv(const double* p, double (&v)[2]) {
  const double2 q = *reinterpret_cast<const double2*>(p);
  v[0] = q.x;
  v[1] = q.y;
}
#else
template <typename T>
inline void loadv(const T* p, T (&v)[VW]) {
  v[0] = p[0];
  v[1] = p[1];
}
#endif

// sum_{lo <= k < hi} a[k] b[k] in a fixed order: two partial sums, over
// even and odd k - lo, from vector loads, then the tail; lo a multiple of
// VW and a, b aligned to whole vectors.
template <typename T>
GT_HD T vdot(const T* a, const T* b, int lo, int hi) {
  T acc[2] = {};
  const int hv = lo + (hi - lo) / VW * VW;
  for (int k = lo; k < hv; k += VW) {
    T x[VW], y[VW];
    loadv(a + k, x);
    loadv(b + k, y);
    GT_UNROLL for (int e = 0; e < VW; ++e) acc[e & 1] += x[e] * y[e];
  }
  // the tail by a constant index, so acc stays in registers
  GT_UNROLL for (int e = 0; e < VW - 1; ++e) {
    if (hv + e < hi) acc[e & 1] += a[hv + e] * b[hv + e];
  }
  return acc[0] + acc[1];
}

// sum of a[0..n) in the order of vdot (a aligned to whole vectors)
template <typename T>
GT_HD T vsum(const T* a, int n) {
  T acc[2] = {};
  const int nv = n / VW * VW;
  for (int k = 0; k < nv; k += VW) {
    T x[VW];
    loadv(a + k, x);
    GT_UNROLL for (int e = 0; e < VW; ++e) acc[e & 1] += x[e];
  }
  GT_UNROLL for (int e = 0; e < VW - 1; ++e) {
    if (nv + e < n) acc[e & 1] += a[nv + e];
  }
  return acc[0] + acc[1];
}

// ---- the chain ------------------------------------------------------------

// Evidence value and gradient of one chain, by the lanes of `team`. X, y,
// err2 (n,) are the observation constants (double), nid (n,) the order ids
// in {0, 1}, n <= N_MAX; tab the pair table (`pair_entry`) of n points;
// s.th holds the kind's theta rows and s.mu .. s.wp the aux inputs that
// `has` names. Results: s.out[0] = ll, s.out[1 + p] the gradient, and the
// cotangents dll/dmu = s.alpha, dll/dnd = s.kbd, dll/dw = s.b0,
// dll/dwp = s.b1.
//
// The pair phases take two pairs at a time (q and q + 32 of the lane's
// round-robin share), loading both before they store either, so the two
// chains of pair math overlap; where the lane has one pair left, the
// second is a copy of the first and is not stored.
template <typename T, int K, class Team>
GT_DEV void evidence_chain(const Team& team, int n, const double* X, const int* nid,
                           const double* y, const double* err2, double df,
                           const unsigned char* tab, AuxSet has, const ChainSmem<T>& s) {
  constexpr int P = KindParams<K>::value;
  const int ld = s.ld;
  const int npairs = n * (n + 1) / 2;
  T* const S = s.S;
  T* const S2 = s.S2;
  T th[P];
  for (int p = 0; p < P; ++p) th[p] = s.th[p];

  // ---- per-point operands: (l, l') for Gibbs; (w, w') or (unused, 1); the
  // residual y - mu
  team.run([&](int lane) {
    for (int i = lane; i < n; i += LANES) {
      if constexpr (K == GIBBS_TANH) {
        T z, t;
        tanh_warp<T>(th[1], th[2], th[3], th[4], X[i], z, t, s.a0[i], s.a1[i]);
      } else {
        s.a0[i] = has.w ? s.w[i] : T(0);
        s.a1[i] = has.wp ? s.wp[i] : T(1);
      }
      T r = T(y[i]);
      if (has.mu) r -= s.mu[i];
      s.wv[i] = r;
    }
  });

  // ---- build the lower triangle with err^2 and nd, and zeros in the strict
  // lower triangle of S2 (Z^T's, below); relative jitter -------------------
  auto entry = [&](int i, int j) -> T {
    const int sel = 2 * nid[i] + nid[j];
    T v;
    if constexpr (K == GIBBS_TANH) {
      v = gibbs_pair_value<T>(th[0], s.a0[i], s.a1[i], s.a0[j], s.a1[j], T(X[i] - X[j]), sel);
    } else {
      const T d = has.w ? s.a0[i] - s.a0[j] : T(X[i] - X[j]);
      const T sgn = T((X[i] > X[j]) - (X[i] < X[j]));
      T Gd, Gl;
      v = th[0] * th[0] * stat_pair<T, K>(th[1], d, sgn, sel, false, Gd, Gl)
          * slope_scale<T>(sel, s.a1[i], s.a1[j]);
    }
    if (i == j) {
      v += T(err2[i]);
      if (has.nd) v += s.nd[i];
    }
    return v;
  };
  team.run([&](int lane) {
    T dsum = T(0);
    for (int q = lane; q < npairs; q += 2 * LANES) {
      const int q1 = q + LANES < npairs ? q + LANES : q;
      const int i0 = tab[2 * q], j0 = tab[2 * q + 1];
      const int i1 = tab[2 * q1], j1 = tab[2 * q1 + 1];
      const T v0 = entry(i0, j0), v1 = entry(i1, j1);
      if (i0 == j0) dsum += v0;
      S[i0 * ld + j0] = v0;
      S2[i0 * ld + j0] = T(0);
      if (q1 != q) {
        if (i1 == j1) dsum += v1;
        S[i1 * ld + j1] = v1;
        S2[i1 * ld + j1] = T(0);
      }
    }
    s.part[lane] = dsum;
  });
  const T scale = team.sum(s.part) * T(1.0 / n);
  const T jitter = T(df * Eps<T>::value) * (scale > T(1) ? scale : T(1));

  // ---- Cholesky of K + jitter, left-looking, with the forward solve and
  // Z = L^{-1} as extra rows: for column j every lane forms the pivot from
  // row j, and each row R of the column forms
  // R[j] = (R[j] - sum_{k<j} R[k] L_jk) / L_jj. The rows are slots t:
  // t < n-1 is row t+1 of S (L), t = n-1 the residual r in wv (giving
  // L^{-1} r), t >= n row m = t-n of S2, which becomes row m of Z^T
  // (Z_km at S2[m][k], zero for k < m, starting from e_m: its entry j
  // starts as 1 at j = m and 0 above, without being read). Column j needs
  // the n+1 consecutive slots j..j+n (rows of L below j, r, Z^T rows
  // m <= j), and slot t goes to lane t % 32: one row a lane for n < 32, at
  // most two up to N_MAX. A bad pivot propagates NaN. ----------------------
  auto slot_row = [&](int t) -> T* {
    return t < n - 1 ? S + (t + 1) * ld : t == n - 1 ? s.wv : S2 + (t - n) * ld;
  };
  // A step (a phase) takes columns j and j+1 (C2), or the last column
  // alone. Every lane forms L_{j+1,j} and both pivots from rows j and j+1,
  // which no lane writes in the step (L_{j+1,j} is needed only here, so it
  // stays in a register and row j+1 keeps K_{j+1,j}); the rows of the step
  // are slots j+C2 .. j+C2+n, and each forms both of its entries, the
  // second from the first.
  auto chol_step = [&](int lane, int j, auto two_rows, auto two_cols) {
    constexpr bool TWO = decltype(two_rows)::value, C2 = decltype(two_cols)::value;
    const T* Lj = S + j * ld;
    const T* Lk = Lj + ld;  // row j+1 (read only with C2)
    const int lo = j + C2;
    const int t0 = lo + ((lane - lo) & (LANES - 1)), t1 = t0 + LANES;
    const bool a0 = t0 <= lo + n, a1 = TWO && t1 <= lo + n;
    // an idle row reads row j and is not written
    T* R0 = a0 ? slot_row(t0) : const_cast<T*>(Lj);
    T* R1 = a1 ? slot_row(t1) : const_cast<T*>(Lj);
    // the dot products over k < j, two partial sums each (even and odd
    // k), from vector loads: pivot rows j, j+1 with themselves and each
    // other, and the lane's rows with both
    T p[2] = {}, q[2] = {}, h[2] = {}, u[2] = {}, u2[2] = {}, w[2] = {}, w2[2] = {};
    auto acc = [&](int e, T l, T m, T r0, T r1) {
      p[e] += l * l;
      u[e] += r0 * l;
      if constexpr (C2) {
        q[e] += m * l;
        h[e] += m * m;
        u2[e] += r0 * m;
      }
      if constexpr (TWO) {
        w[e] += r1 * l;
        if constexpr (C2) w2[e] += r1 * m;
      }
    };
    const int jv = j / VW * VW;
    // kept rolled: unrolled, its loads in flight take the registers of a
    // sixth block per SM (evidence_kernel.cu, kMinBlocks)
    GT_ROLLED for (int k = 0; k < jv; k += VW) {
      T l[VW], m[VW], r0[VW], r1[VW];
      loadv(Lj + k, l);
      loadv(R0 + k, r0);
      if constexpr (C2) loadv(Lk + k, m);
      if constexpr (TWO) loadv(R1 + k, r1);
      GT_UNROLL for (int e = 0; e < VW; ++e)
        acc(e & 1, l[e], C2 ? m[e] : T(0), r0[e], TWO ? r1[e] : T(0));
    }
    // the tail k = jv + e < j by a constant e, so the sums stay in registers
    GT_UNROLL for (int e = 0; e < VW - 1; ++e) {
      const int k = jv + e;
      if (k < j) acc(e & 1, Lj[k], C2 ? Lk[k] : T(0), R0[k], TWO ? R1[k] : T(0));
    }
    // 1 / L_jj from one reciprocal square root, L_jj = x / sqrt(x); then
    // L_{j+1,j} and 1 / L_{j+1,j+1}
    const T x = (Lj[j] + jitter) - (p[0] + p[1]);
    const T rd = m_rsqrt(x);
    T lk = T(0), rd1 = T(0);
    if constexpr (C2) {
      lk = (Lk[j] - (q[0] + q[1])) * rd;
      const T x1 = (Lk[j + 1] + jitter) - ((h[0] + h[1]) + lk * lk);
      rd1 = m_rsqrt(x1);
      if ((a0 && t0 == n + j + 1) || (a1 && t1 == n + j + 1)) s.dg[j + 1] = x1 * rd1;
    }
    // a row's entry c before the step: K_ic, r_c, or e_m's
    auto row = [&](int t, T* R, const T (&uj)[2], const T (&uk)[2]) {
      const T a = ((t < n ? R[j] : T(t - n == j)) - (uj[0] + uj[1])) * rd;
      R[j] = a;
      if constexpr (C2) {
        R[j + 1] = ((t < n ? R[j + 1] : T(t - n == j + 1)) - ((uk[0] + uk[1]) + a * lk)) * rd1;
      }
    };
    if (a0) row(t0, R0, u, u2);
    if (a1) row(t1, R1, w, w2);
    // the lane of slot n + j (Z^T row j, whose step-j entry is 1 / L_jj)
    if ((a0 && t0 == n + j) || (a1 && t1 == n + j)) s.dg[j] = x * rd;
  };
  for (int j = 0; j < n; j += 2) {
    auto step = [&](auto two_rows) {
      if (j + 1 < n) {
        team.run([&](int lane) { chol_step(lane, j, two_rows, std::true_type{}); });
      } else {
        team.run([&](int lane) { chol_step(lane, j, two_rows, std::false_type{}); });
      }
    };
    if (n < LANES) {
      step(std::false_type{});
    } else {
      step(std::true_type{});
    }
  }

  // ---- ll ------------------------------------------------------------------
  team.run([&](int lane) {
    T quad = T(0), logdet = T(0);
    for (int i = lane; i < n; i += LANES) {
      quad += s.wv[i] * s.wv[i];
      logdet += m_log(s.dg[i]);
    }
    s.part[lane] = quad;
    s.part[LANES + lane] = logdet;
  });
  const T ll = T(-0.5) * team.sum(s.part) - team.sum(s.part + LANES)
               - T(0.5 * n * LOG_2PI);

  // ---- alpha = Z^T (L^{-1} r) and diag dll/dK = (alpha_i^2 - K^{-1}_ii)/2
  team.run([&](int lane) {
    T trace = T(0);
    for (int i = lane; i < n; i += LANES) {
      const T* Zi = S2 + i * ld;  // Z_ki at Zi[k], k >= i
      // Z_ki is 0 for k < i, so the dots start on i's vector
      const int lo = i / VW * VW;
      const T a = vdot(Zi, s.wv, lo, n);
      const T kinv = vdot(Zi, Zi, lo, n);
      s.alpha[i] = a;
      s.kbd[i] = T(0.5) * (a * a - kinv);
      trace += s.kbd[i];
    }
    s.part[lane] = trace;
  });
  // the jitter depends on mean(diag K) only where scale > 1; nd sits on
  // the diagonal before the jitter, so its cotangent carries corr too
  const T corr = scale > T(1) ? T(df * Eps<T>::value / n) * team.sum(s.part) : T(0);

  // ---- dll/dK_ij off the diagonal, over L: only the lower triangle was
  // built, so it carries both symmetric halves, alpha_i alpha_j - K^{-1}_ij
  team.run([&](int lane) {
    for (int q = lane; q < npairs; q += LANES) {
      const int i = tab[2 * q], j = tab[2 * q + 1];
      if (i == j) continue;
      const T kinv = vdot(S2 + i * ld, S2 + j * ld, i / VW * VW, n);
      S[i * ld + j] = s.alpha[i] * s.alpha[j] - kinv;
    }
  });

  // ---- backward through the build: each pair's cotangents into its two
  // points' operands, i-end at [i][j] and j-end at [j][i] (first operand
  // in S, second in S2; both ends of a diagonal pair summed at [i][i]) ---
  auto vjp = [&](int i, int j, T gbar, T* g, T& i0, T& i1, T& j0, T& j1) {
    const int sel = 2 * nid[i] + nid[j];
    i0 = i1 = j0 = j1 = T(0);
    if constexpr (K == GIBBS_TANH) {
      gibbs_pair_vjp<T>(th[0], s.a0[i], s.a1[i], s.a0[j], s.a1[j], T(X[i] - X[j]), sel,
                        gbar, g[0], i0, i1, j0, j1);
    } else {
      const T d = has.w ? s.a0[i] - s.a0[j] : T(X[i] - X[j]);
      const T sgn = T((X[i] > X[j]) - (X[i] < X[j]));
      T Gd, Gl;
      const T G = stat_pair<T, K>(th[1], d, sgn, sel, true, Gd, Gl);
      const T sf2 = th[0] * th[0];
      const T v = sf2 * G;
      // entry = v * scale(wp_i, wp_j)
      const T vbar = gbar * slope_scale<T>(sel, s.a1[i], s.a1[j]);
      if (sel == 2) i1 = gbar * v;
      if (sel == 1) j1 = gbar * v;
      if (sel == 3) {
        i1 = gbar * v * s.a1[j];
        j1 = gbar * v * s.a1[i];
      }
      g[0] += vbar * T(2) * th[0] * G;
      g[1] += vbar * sf2 * Gl;
      // d = w_i - w_j
      const T dbar = vbar * sf2 * Gd;
      i0 = dbar;
      j0 = -dbar;
    }
  };
  auto put = [&](int i, int j, T i0, T i1, T j0, T j1) {
    if (i == j) {
      S[i * ld + i] = i0 + j0;
      S2[i * ld + i] = i1 + j1;
    } else {
      S[i * ld + j] = i0;
      S[j * ld + i] = j0;
      S2[i * ld + j] = i1;
      S2[j * ld + i] = j1;
    }
  };
  team.run([&](int lane) {
    // g: the pairs q, q + 64, ...; g1: q + 32, q + 96, ... (gq, the second
    // pair's own, is added to g1 only where that pair exists)
    T g[P], g1[P];
    for (int p = 0; p < P; ++p) g[p] = g1[p] = T(0);
    for (int q = lane; q < npairs; q += 2 * LANES) {
      const bool two = q + LANES < npairs;
      const int q1 = two ? q + LANES : q;
      const int ia = tab[2 * q], ja = tab[2 * q + 1];
      const int ib = tab[2 * q1], jb = tab[2 * q1 + 1];
      const T ga = ia == ja ? s.kbd[ia] + corr : S[ia * ld + ja];
      const T gb = ib == jb ? s.kbd[ib] + corr : S[ib * ld + jb];
      T a0, a1, a2, a3, b0, b1, b2, b3, gq[P];
      for (int p = 0; p < P; ++p) gq[p] = T(0);
      vjp(ia, ja, ga, g, a0, a1, a2, a3);
      vjp(ib, jb, gb, gq, b0, b1, b2, b3);
      put(ia, ja, a0, a1, a2, a3);
      if (two) {
        put(ib, jb, b0, b1, b2, b3);
        for (int p = 0; p < P; ++p) g1[p] += gq[p];
      }
    }
    for (int p = 0; p < P; ++p) s.part[p * LANES + lane] = g[p] + g1[p];
  });

  // ---- per point: b0, b1 = the rows of S, S2; the warp's VJP; nd's corr
  team.run([&](int lane) {
    T g[P];
    for (int p = 0; p < P; ++p) g[p] = s.part[p * LANES + lane];
    for (int i = lane; i < n; i += LANES) {
      const T v0 = vsum(S + i * ld, n), v1 = vsum(S2 + i * ld, n);
      s.b0[i] = v0;
      s.b1[i] = v1;
      if constexpr (K == GIBBS_TANH) {
        T z, t, l, dl;
        tanh_warp<T>(th[1], th[2], th[3], th[4], X[i], z, t, l, dl);
        warp_vjp<T>(th[1], th[2], th[3], z, t, dl, v0, v1, g);
      }
      s.kbd[i] += corr;
    }
    for (int p = 0; p < P; ++p) s.part[p * LANES + lane] = g[p];
  });
  T grad[P];
  for (int p = 0; p < P; ++p) grad[p] = team.sum(s.part + p * LANES);

  // ---- outputs; a non-finite ll zeroes every gradient and cotangent ------
  const bool ok = m_isfinite(ll);
  team.run([&](int lane) {
    if (!ok) {
      for (int i = lane; i < n; i += LANES) {
        s.alpha[i] = T(0);
        s.kbd[i] = T(0);
        s.b0[i] = T(0);
        s.b1[i] = T(0);
      }
    }
    if (lane == 0) {
      s.out[0] = ok ? ll : -T(INFINITY);
      for (int p = 0; p < P; ++p) s.out[1 + p] = ok ? grad[p] : T(0);
    }
  });
}

}  // namespace gt
