// The covariance kernel's work (cov_kernel.cu), written as functions of the
// thread index that its host build (evidence_chain_host.cpp) also compiles.
//
// One entry: the per-point operands and the pair math are the evidence
// kernel's (pair_math.cuh): `tanh_warp` gives l(x) and l'(x) of the
// Gibbs-tanh kernel, `gibbs_pair_value` and `stat_pair<T, SE>` one entry of
// a derivative block. An entry of rows i, j takes the block
// sel = 2 nid_i + nid_j (0 value-value, 1 value-slope, 2 slope-value,
// 3 slope-slope); order ids outside {0, 1} give an exact zero, as the
// padded points of the reference's Pallas tiles do.
//
// Three layouts, each of which evaluates each unordered pair {i, j} once
// (i >= j) and writes it at (i, j) and at (j, i), so the whole matrix is
// exactly symmetric and half the divisions, square roots and exponentials
// of a full evaluation are saved. The small and tile layouts stage what
// they write in shared memory and store whole runs of the output with
// 16-byte vector stores (`put_vec`): a staged run sits shifted by the
// misalignment of its first output element (`vec_shift`), so every vector
// of the run is aligned in shared memory and in device memory alike, and
// only the first and last vectors of a run, where they are partial, are
// stored entry by entry.
//
// - small (n <= COV_SMALL_N): a block takes one theta, whose output is
//   one contiguous span, its threads sized for balanced rounds of pairs
//   (`cov_small_threads`). Phase 1: the points and their per-point
//   operands; phase 2: the pairs t, t + nt, ... (`cov_pair`), written
//   twice into the span's image; phase 3: the span in vectors.
// - bands (n <= 32 and fewer thetas than SMs, `cov_small_direct`): a block
//   takes COV_BAND rows of one theta, a thread per entry of them; phase 1
//   as the small layout's, phase 2 stores each pair straight from
//   registers.
// - tiles (n > COV_SMALL_N): a block takes one 64 x 64 tile (I, J), I >= J,
//   of one theta. Phase 1: the operands of its 64 row and 64 column
//   points; phase 2: thread (ty, tx) evaluates the 4 x 4 entries
//   (ty + 16 a, tx + 16 b), a row's operands in registers, and
//   writes each into the row-major tile S1 and the transposed tile S2
//   (a diagonal tile: its lower half, mirrored inside S1); phase 3: S1's
//   rows to tile (I, J) and S2's rows to tile (J, I), a row per half warp
//   (float32) or warp (float64). The ragged edge is masked.
//
// Within a phase no thread reads what another thread writes in it, and
// every output entry is written by one thread of one block; the kernel
// puts a barrier between phases. The host build runs a phase's threads
// one after another, in order 0..nt-1 or nt-1..0, on NaN-filled shared
// memory, and the CPU tests demand the same bits in both orders.

#pragma once

#include <cstddef>

#include "pair_math.cuh"

#ifdef __CUDACC__
#define GT_COV_UNROLL _Pragma("unroll")
#define GT_COV_ROLLED _Pragma("unroll 1")
#else
#define GT_COV_UNROLL
#define GT_COV_ROLLED
#endif

namespace gt {

// ---- one entry ---------------------------------------------------------------

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

// ---- shared pieces of the layouts -------------------------------------------

constexpr int COV_THREADS = 256;           // threads of a tile block
constexpr int COV_ROUND = 320;             // most threads of a small block that fills
constexpr int COV_BAND = 4;                // rows of a direct small block
constexpr int COV_SMALL_N = 64;            // n up to this: the small layout
constexpr int COV_IMG = COV_SMALL_N * COV_SMALL_N;  // entries of the small layout's image
constexpr int COV_TILE = 64;               // tile side
constexpr int COV_SUB = 16;                // threads along a tile side
constexpr int COV_MICRO = COV_TILE / COV_SUB;  // entries along a thread's side

// entries of T in a 16-byte vector
template <typename T> struct Vec { static constexpr int value = int(16 / sizeof(T)); };

// (i, j), i >= j, of the q-th pair of a lower triangle taken row by row
// (the tile layout's tile pairs)
GT_HD void tri_pair(long long q, int& i, int& j) {
  long long r = (long long)((m_sqrt(8.0f * float(q) + 1.0f) - 1.0f) * 0.5f);
  while (r * (r + 1) / 2 > q) --r;
  while ((r + 1) * (r + 2) / 2 <= q) ++r;
  i = int(r);
  j = int(q - r * (r + 1) / 2);
}

// entries of T from the last 16-byte boundary to p
template <typename T>
GT_HD int vec_shift(const T* p) {
  return int((reinterpret_cast<size_t>(p) / sizeof(T)) % Vec<T>::value);
}

// one 16-byte vector from src to dst, both 16-byte aligned
template <typename T>
GT_HD void store16(T* dst, const T* src) {
#ifdef __CUDA_ARCH__
  *reinterpret_cast<int4*>(dst) = *reinterpret_cast<const int4*>(src);
#else
  for (int m = 0; m < Vec<T>::value; ++m) dst[m] = src[m];
#endif
}

// Vector k of a staged run: a run of w entries that starts at dst and sits
// at positions [s, s + w) of the staged row src (s = vec_shift(dst), src
// 16-byte aligned), so positions [V k, V k + V) land on an aligned vector
// of dst - s. One vector store where all V positions lie in the run, else
// one store per entry that does.
template <typename T>
GT_HD void put_vec(T* dst, const T* src, int s, int w, int k) {
  constexpr int V = Vec<T>::value;
  const int e0 = k * V;
  if (e0 >= s && e0 + V <= s + w) {
    store16(dst + (e0 - s), src + e0);
    return;
  }
  for (int m = 0; m < V; ++m) {
    const int e = e0 + m;
    if (e >= s && e < s + w) dst[e - s] = src[e];
  }
}

// ---- small and band layouts (n <= COV_SMALL_N) ---------------------------------

// The pairs of a lower triangle of up to COV_SMALL_N rows, row by row, as
// i << 6 | j (i >= j): the order does not depend on n, so one table
// serves every n. The kernel reads it through the read-only cache.
struct CovPairTab {
  unsigned short v[COV_SMALL_N * (COV_SMALL_N + 1) / 2];
};

constexpr CovPairTab cov_pair_tab() {
  CovPairTab t{};
  int q = 0;
  for (int i = 0; i < COV_SMALL_N; ++i)
    for (int j = 0; j <= i; ++j) t.v[q++] = (unsigned short)(i << 6 | j);
  return t;
}

#ifdef __CUDACC__
__device__ const CovPairTab kCovPairsDev = cov_pair_tab();
#endif
constexpr CovPairTab kCovPairs = cov_pair_tab();

GT_HD unsigned cov_pair(int q) {
#ifdef __CUDA_ARCH__
  return __ldg(&kCovPairsDev.v[q]);
#else
  return kCovPairs.v[q];
#endif
}

// Whether small blocks store straight from registers: where B thetas do
// not fill the card's `sms` multiprocessors (B = 1, the point predictor's
// state), the time is the latency of the launch and of one block, and
// the staged image would add a barrier and a pass to it. Then a block
// takes one band of COV_BAND rows of one theta, n <= 32, with a thread
// for each entry of the band's rows (t = 32 (i - r0) + j), as the
// earlier design did, and only those with i >= j work: a theta's pairs
// are spread over several SMs. Where the thetas fill the card (the MCMC
// predictor's 512 states), the image and its vector stores.
GT_HD bool cov_small_direct(int n, int B, int sms) { return n <= 32 && B < sms; }

// Threads of an image-layout block: the theta's pairs in balanced rounds
// of up to COV_ROUND threads, in whole warps (several blocks an SM, all
// in one wave at the serving shapes: 192 threads at n = 27, 288 at 32).
GT_HD int cov_small_threads(int n) {
  const int pairs = n * (n + 1) / 2;
  const int rounds = (pairs + COV_ROUND - 1) / COV_ROUND;
  const int t = ((pairs + rounds - 1) / rounds + 31) / 32 * 32;
  return t < 64 ? 64 : t;
}

// A small block's shared memory: the image (IMG entries, the theta's
// span shifted by its misalignment; none when direct), the per-point
// operands, the theta, and the points' x and id.
template <typename T, int IMG>
struct alignas(16) CovSmallShared {
  T img[IMG + 4];
  T a0[COV_SMALL_N], a1[COV_SMALL_N];
  T th[P_MAX];
  double x[COV_SMALL_N];
  int nid[COV_SMALL_N];
};

template <typename T>
struct CovSmallSmem {
  T* img;
  T* a0;
  T* a1;
  T* th;
  double* x;
  int* nid;
};

template <typename T, int IMG>
GT_HD CovSmallSmem<T> small_smem(CovSmallShared<T, IMG>& s) {
  return CovSmallSmem<T>{s.img, s.a0, s.a1, s.th, s.x, s.nid};
}

// One block's work: theta b, its output span from out; when direct, rows
// [r0, r0 + COV_BAND) of it, whose operands need the points [0, npts).
template <typename T>
struct CovSmall {
  int n, npairs, s, nt;  // s: vec_shift(out); nt: threads of the block
  bool direct;           // stores from registers (no image, no phase 3)
  int r0, npts;
  const double* X;
  const int* nid;
  const T* theta;  // the theta's row
  T* out;          // the theta's first entry
  CovSmallSmem<T> sm;
};

// the block of theta b of the image layout
template <typename T, int K>
GT_HD CovSmall<T> cov_small(int n, const double* X, const int* nid, const T* theta, T* out,
                            int b, int nt, CovSmallSmem<T> sm) {
  constexpr int P = KindParams<K>::value;
  T* o = out + (size_t)b * n * n;
  return CovSmall<T>{n, n * (n + 1) / 2, vec_shift(o), nt, false, 0, n, X, nid,
                     theta + (size_t)b * P, o, sm};
}

// the block of band `band` of theta b (direct)
template <typename T, int K>
GT_HD CovSmall<T> cov_small_band(int n, const double* X, const int* nid, const T* theta,
                                 T* out, int b, int band, CovSmallSmem<T> sm) {
  constexpr int P = KindParams<K>::value;
  const int r0 = band * COV_BAND;
  T* o = out + (size_t)b * n * n;
  return CovSmall<T>{n, n * (n + 1) / 2, 0, 32 * COV_BAND, true, r0,
                     r0 + COV_BAND < n ? r0 + COV_BAND : n, X, nid,
                     theta + (size_t)b * P, o, sm};
}

// phase 1, thread t: points e = t, t + nt, ...: x, id and the operands of
// point e, and theta entry e. A slot's global reads come before its
// shared stores, so they are issued together.
template <typename T, int K>
GT_HD void small_points(const CovSmall<T>& c, int t) {
  constexpr int P = KindParams<K>::value;
  const CovSmallSmem<T>& s = c.sm;
  for (int e = t; e < c.npts || e < P; e += c.nt) {
    const bool pt = e < c.npts;
    T th[P] = {}, tv = T(0);
    double x = 0.0;
    int id = 0;
    if (pt) {
      x = c.X[e];
      id = c.nid[e];
      for (int k = 0; k < P; ++k) th[k] = c.theta[k];
    }
    if (e < P) tv = c.theta[e];
    if (pt) {
      T a0, a1;
      cov_point<T, K>(th, x, a0, a1);
      s.x[e] = x;
      s.nid[e] = id;
      s.a0[e] = a0;
      s.a1[e] = a1;
    }
    if (e < P) s.th[e] = tv;
  }
}

// K of pair (i, j) of the block's theta th
template <typename T, int K>
GT_HD T small_entry(const CovSmall<T>& c, const T* th, int i, int j) {
  const CovSmallSmem<T>& s = c.sm;
  return cov_entry<T, K>(th, s.x[i], s.x[j], s.nid[i], s.nid[j], s.a0[i], s.a1[i], s.a0[j],
                         s.a1[j]);
}

// phase 2, thread t. Direct: the entry (i, j) = (r0 + t / 32, t % 32) if
// i >= j, to (i, j) and (j, i) of the output. Else pairs t, t + nt, ...
// of the lower triangle (row by row), each to (i, j) and (j, i) of the
// image, the theta in registers.
template <typename T, int K>
GT_HD void small_pairs(const CovSmall<T>& c, int t) {
  constexpr int P = KindParams<K>::value;
  const int n = c.n;
  T th[P];
  for (int k = 0; k < P; ++k) th[k] = c.sm.th[k];
  if (c.direct) {
    const int i = c.r0 + (t >> 5), j = t & 31;
    if (i < n && j <= i) {
      const T v = small_entry<T, K>(c, th, i, j);
      c.out[i * n + j] = v;
      c.out[j * n + i] = v;
    }
    return;
  }
  T* im = c.sm.img + c.s;
  for (int q = t; q < c.npairs; q += c.nt) {
    const unsigned e = cov_pair(q);
    const int i = int(e >> 6), j = int(e & 63);
    const T v = small_entry<T, K>(c, th, i, j);
    im[i * n + j] = v;
    im[j * n + i] = v;
  }
}

// phase 3 (image only), thread t: vectors t, t + nt, ... of the span
template <typename T>
GT_HD void small_store(const CovSmall<T>& c, int t) {
  constexpr int V = Vec<T>::value;
  const int len = c.n * c.n;
  const int nvec = (c.s + len + V - 1) / V;
  for (int k = t; k < nvec; k += c.nt) put_vec(c.out, c.sm.img, c.s, len, k);
}

// ---- tile layout: a block per 64 x 64 tile of one theta ----------------------

// Row stride of a staged tile: 64 entries and room for a shift, a whole
// number of 16-byte vectors, 16 bytes past a multiple of 128 (consecutive
// rows start 4 banks apart).
template <typename T>
constexpr int tile_ld() { return COV_TILE + Vec<T>::value; }

// A tile block's shared memory, carved from one dynamic allocation:
// S1 and S2 (64 x tile_ld each), then the operands of the 2 x 64 points
// ([0, 64) the tile's rows, [64, 128) its columns).
template <typename T>
struct CovTileSmem {
  T* S1;
  T* S2;
  T* a0;
  T* a1;
  double* x;
  int* nid;
};

template <typename T>
GT_HD size_t cov_tile_bytes() {
  return 2 * size_t(COV_TILE) * tile_ld<T>() * sizeof(T)
         + 2 * COV_TILE * (2 * sizeof(T) + sizeof(double) + sizeof(int));
}

template <typename T>
GT_HD CovTileSmem<T> cov_tile_smem(void* base) {
  T* S1 = static_cast<T*>(base);
  T* S2 = S1 + COV_TILE * tile_ld<T>();
  T* a0 = S2 + COV_TILE * tile_ld<T>();
  T* a1 = a0 + 2 * COV_TILE;
  double* x = reinterpret_cast<double*>(a1 + 2 * COV_TILE);
  int* nid = reinterpret_cast<int*>(x + 2 * COV_TILE);
  return CovTileSmem<T>{S1, S2, a0, a1, x, nid};
}

// One tile's work: tile (I, J), I >= J, of the (n, n) output out of the
// theta row th.
template <typename T>
struct CovTile {
  int n, I, J;
  const double* X;
  const int* nid;
  const T* th;
  T* out;
  CovTileSmem<T> sm;
};

// phase 1, thread t < 128: point t of the tile's rows (t < 64) or columns
template <typename T, int K>
GT_HD void tile_points(const CovTile<T>& c, int t) {
  constexpr int P = KindParams<K>::value;
  if (t >= 2 * COV_TILE) return;
  const int p = (t < COV_TILE ? c.I : c.J) * COV_TILE + t % COV_TILE;
  if (p >= c.n) return;
  T th[P];
  for (int k = 0; k < P; ++k) th[k] = c.th[k];
  const double x = c.X[p];
  const int id = c.nid[p];
  T a0, a1;
  cov_point<T, K>(th, x, a0, a1);
  c.sm.x[t] = x;
  c.sm.nid[t] = id;
  c.sm.a0[t] = a0;
  c.sm.a1[t] = a1;
}

// phase 2, thread t = 16 ty + tx: entries (ty + 16 a, tx + 16 b) of the
// tile, a, b < 4, each into S1 at (row, column) and into S2 (S1 on a
// diagonal tile) at (column, row), each staged row shifted as its output
// run will be.
template <typename T, int K>
GT_HD void tile_entries(const CovTile<T>& c, int t) {
  constexpr int P = KindParams<K>::value, M = COV_MICRO, LD = tile_ld<T>();
  const int n = c.n, tx = t % COV_SUB, ty = t / COV_SUB;
  const int r0 = c.I * COV_TILE, c0 = c.J * COV_TILE;
  const bool diag = c.I == c.J;
  T th[P];
  for (int p = 0; p < P; ++p) th[p] = c.th[p];
  T* S2 = diag ? c.sm.S1 : c.sm.S2;
  // rows one at a time, their operands in registers, the columns' read
  // from shared memory at each entry: few enough registers that 3 blocks
  // fit an SM without spilling
  GT_COV_ROLLED
  for (int a = 0; a < M; ++a) {
    const int r = ty + COV_SUB * a;
    if (r0 + r >= n) break;
    const double xr = c.sm.x[r];
    const int nr = c.sm.nid[r];
    const T ar0 = c.sm.a0[r], ar1 = c.sm.a1[r];
    const int sr = vec_shift(c.out + (size_t)(r0 + r) * n + c0);
    GT_COV_UNROLL
    for (int b = 0; b < M; ++b) {
      const int cc = tx + COV_SUB * b;
      if (c0 + cc >= n || (diag && r < cc)) continue;
      const int p = COV_TILE + cc;
      const T v = cov_entry<T, K>(th, xr, c.sm.x[p], nr, c.sm.nid[p], ar0, ar1, c.sm.a0[p],
                                  c.sm.a1[p]);
      c.sm.S1[r * LD + cc + sr] = v;
      S2[cc * LD + r + vec_shift(c.out + (size_t)(c0 + cc) * n + r0)] = v;
    }
  }
}

// The rows of a staged tile S to output tile (R, C): half-warps (float32)
// or warps (float64) take rows, their threads the vectors of a row.
template <typename T>
GT_HD void tile_rows(T* out, int n, const T* S, int R, int C, int t) {
  constexpr int V = Vec<T>::value, LD = tile_ld<T>();
  constexpr int per_row = COV_TILE / V, rows_per_pass = COV_THREADS / per_row;
  const int rows = n - R * COV_TILE < COV_TILE ? n - R * COV_TILE : COV_TILE;
  const int w = n - C * COV_TILE < COV_TILE ? n - C * COV_TILE : COV_TILE;
  for (int r = t / per_row; r < rows; r += rows_per_pass) {
    T* dst = out + (size_t)(R * COV_TILE + r) * n + C * COV_TILE;
    const int s = vec_shift(dst);
    const int nvec = (s + w + V - 1) / V;
    for (int k = t % per_row; k < nvec; k += per_row) put_vec(dst, S + r * LD, s, w, k);
  }
}

// phase 3, thread t: S1 to tile (I, J), and S2 to tile (J, I)
template <typename T>
GT_HD void tile_store(const CovTile<T>& c, int t) {
  tile_rows(c.out, c.n, c.sm.S1, c.I, c.J, t);
  if (c.I != c.J) tile_rows(c.out, c.n, c.sm.S2, c.J, c.I, t);
}

}  // namespace gt
