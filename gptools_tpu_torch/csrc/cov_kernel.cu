// Covariance kernel (sm_90a): for a batch of theta, the (N, N) covariance
// of one 1-D point set with its {value, slope} blocks.
//
// Replaces the TPU kernel gptools_tpu/ops/pallas_cov.py :: _tiled_cov
// (`pl.pallas_call` at :98, tile body `_make_tile_body` :80), reached by
// `se_cov` / `gibbs_tanh_cov` and their VJPs. The reference writes the
// kernel for one theta, pads rows to 8 and columns to 128 in tiles of up to
// 128 x 128, slices the padding off, and gets a theta batch from jax.vmap;
// here the batch is the grid's z axis (one launch for all B) and the ragged
// edge is masked, with no padding.
//
// Layout: one thread per output entry, blocks of 32 columns x 8 rows. A
// block first evaluates the per-point operands of its 32 column points and
// 8 row points once into shared memory (the tanh warp l(x), l'(x) for
// Gibbs-tanh: what the Pallas tile computes once per row block and column
// block), from one call site, so a point gets the same bits as a row and
// as a column and the value-value block comes out exactly symmetric. Then
// each thread evaluates its entry (cov_entry.cuh) and stores it row-major:
// a warp writes 32 consecutive columns.
//
// What bounds it on Hopper: it reads N points and writes B N^2 entries, so
// at the serving shapes (B up to 512, N ~ 30) it is one launch of a few
// microseconds against a sub-microsecond bound, and at large N it is bound
// by the stores: (B, N) = (256, 1024) writes 1.07 GB in float32 (0.32 ms at
// 3.35 TB/s) against ~10-60 flops per entry. The coalesced row-major
// stores are what the design does about that.
//
// Exports gt_{se,gibbs_tanh}_cov_{f32,f64}(n, X, nid, theta, B, out,
// stream): X (n,) double, nid (n,) int32, theta (B, P) row-major in T,
// out (B, n, n) in T allocated by the caller; returns cudaGetLastError()
// after the launch.

#include <cuda_runtime.h>

#include "cov_entry.cuh"

namespace {

constexpr int kCols = 32;
constexpr int kRows = 8;
constexpr int kPoints = kCols + kRows;  // slots [0, 32) columns, [32, 40) rows
constexpr int kMaxGridZ = 65535;

template <typename T, int K>
__global__ void __launch_bounds__(kCols * kRows)
cov_kernel(int n, const double* __restrict__ X, const int* __restrict__ nid,
           const T* __restrict__ theta, int B, T* __restrict__ out) {
  constexpr int P = gt::KindParams<K>::value;
  __shared__ double xs[kPoints];
  __shared__ int ns[kPoints];
  __shared__ T a0s[kPoints], a1s[kPoints];
  const int col0 = blockIdx.x * kCols, row0 = blockIdx.y * kRows;
  const int slot = threadIdx.y * kCols + threadIdx.x;
  const int pt = slot < kCols ? col0 + slot : row0 + (slot - kCols);
  const bool loads = slot < kPoints && pt < n;
  if (loads) {
    xs[slot] = X[pt];
    ns[slot] = nid[pt];
  }
  const int i = row0 + threadIdx.y, j = col0 + threadIdx.x;
  const int r = kCols + threadIdx.y, c = threadIdx.x;
  for (int b = blockIdx.z; b < B; b += gridDim.z) {
    T th[P];
    for (int p = 0; p < P; ++p) th[p] = theta[(size_t)b * P + p];
    if (loads) gt::cov_point<T, K>(th, xs[slot], a0s[slot], a1s[slot]);
    __syncthreads();
    if (i < n && j < n) {
      out[((size_t)b * n + i) * n + j] = gt::cov_entry<T, K>(
          th, xs[r], xs[c], ns[r], ns[c], a0s[r], a1s[r], a0s[c], a1s[c]);
    }
    __syncthreads();
  }
}

template <typename T, int K>
int launch(int n, const void* X, const void* nid, const void* theta, int B,
           void* out, void* stream) {
  if (n < 1 || B < 1) return int(cudaErrorInvalidValue);
  const dim3 block(kCols, kRows);
  const dim3 grid((n + kCols - 1) / kCols, (n + kRows - 1) / kRows,
                  B < kMaxGridZ ? B : kMaxGridZ);
  cov_kernel<T, K><<<grid, block, 0, (cudaStream_t)stream>>>(
      n, (const double*)X, (const int*)nid, (const T*)theta, B, (T*)out);
  return int(cudaGetLastError());
}

}  // namespace

#define GT_COV_EXPORT(NAME, T, K)                                            \
  extern "C" int NAME(int n, const void* X, const void* nid,                 \
                      const void* theta, int B, void* out, void* stream) {   \
    return launch<T, K>(n, X, nid, theta, B, out, stream);                   \
  }

GT_COV_EXPORT(gt_se_cov_f32, float, gt::SE)
GT_COV_EXPORT(gt_se_cov_f64, double, gt::SE)
GT_COV_EXPORT(gt_gibbs_tanh_cov_f32, float, gt::GIBBS_TANH)
GT_COV_EXPORT(gt_gibbs_tanh_cov_f64, double, gt::GIBBS_TANH)
