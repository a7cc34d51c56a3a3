// Covariance kernel (sm_90a): for a batch of theta, the (N, N) covariance
// of one 1-D point set with its {value, slope} blocks.
//
// Replaces the TPU kernel gptools_tpu/ops/pallas_cov.py :: _tiled_cov
// (`pl.pallas_call` at :98, tile body `_make_tile_body` :80), reached by
// `se_cov` / `gibbs_tanh_cov` and their VJPs. The reference writes the
// kernel for one theta, pads rows to 8 and columns to 128 in tiles of up to
// 128 x 128, evaluates every entry, slices the padding off, and gets a
// theta batch from jax.vmap. Here one launch serves the whole batch, each
// unordered pair is evaluated once and written twice, and the ragged edge
// is masked, with no padding. The work of each thread between barriers is
// in cov_entry.cuh (the host build runs the same functions).
//
// Layouts (cov_entry.cuh):
// - n <= 64 (the serving shapes, N = 27 and 32): `cov_small_kernel`, a
//   block per theta, grid-stride over B; the theta's contiguous span is
//   built in shared memory and stored in 16-byte vectors, by blocks of up
//   to 320 threads. At
//   (B, N) = (512, 27) that is 512 blocks, in one wave,
//   where the earlier design ran four blocks per theta with one scalar
//   store per entry. Fewer thetas than SMs (B = 1) at n <= 32 take
//   `cov_band_kernel`: a block per band of 4 rows of a theta (7 and 8
//   blocks of 128 threads at N = 27 and 32), a thread per entry of the
//   band, each pair's two entries stored straight from registers: the
//   time then is the latency of the launch and of one block, to which
//   the image would add a barrier and a pass.
// - n > 64: `cov_tile_kernel`, 256 threads, a block per 64 x 64 tile
//   (I, J), I >= J, of the lower triangle on the grid's x axis, theta on z
//   (a stride loop past 65535); a thread evaluates 4 x 4 entries, and the
//   tile and its transpose are staged in shared memory (71 KB a block in
//   float64, 37 KB in float32) and stored as rows of 16-byte vectors at
//   (I, J) and (J, I).
//
// What bounds it on Hopper: it reads N points and writes B N^2 entries, so
// it is bound by the stores: (B, N) = (256, 1024) writes 2.15 GB in
// float64 (0.64 ms at 3.35 TB/s). The Gibbs-tanh entry costs ~60 FP64
// instructions (an IEEE division, a square root, an exponential), so in
// float64 its arithmetic, once per pair, takes about as long as the
// stores; evaluating each pair once is what brings it to the byte
// bound's order, and 3 tile blocks an SM overlap one block's entries with
// another's stores. At the serving shapes the time is the launch and one
// block's latency: the per-point loads and tanh, one or two rounds of
// FP64 pairs, and one wave's stores (`scripts/profile_torch_leapfrog.py
// --cov` reads each phase's cycles).
//
// Built with -DGT_PHASE_CLOCK (`scripts/profile_torch_leapfrog.py --cov`),
// thread 0 of the first and the last block read the SM clock after every
// phase and barrier (`gt_cov_phase_clocks`); the real library has no such
// code.
//
// Exports gt_{se,gibbs_tanh}_cov_{f32,f64}(n, X, nid, theta, B, out,
// stream): X (n,) double, nid (n,) int32, theta (B, P) row-major in T,
// out (B, n, n) in T allocated by the caller (any sizeof(T)-aligned
// address); returns cudaGetLastError() after the launch. And
// gt_cov_layout(n, B, item, info) fills info[0..4] with the layout a
// launch at (n, B) and element size `item` takes on the current device
// (`layout` below).

#include <atomic>

#include <cuda_runtime.h>

#include "cov_entry.cuh"

namespace {

#ifdef GT_PHASE_CLOCK
// Profiling build only: the SM clock of thread 0 of the grid's first block
// (row 0) and of its last block (row 1) at the block's start (slot 0) and
// after each phase and each barrier (slots 1, 2, ...), and the global
// timer (ns) at the block's start and end.
__device__ long long cov_clk[2][8];
__device__ unsigned long long cov_gtime[2][2];

__device__ __forceinline__ int clock_row() {
  if (threadIdx.x != 0) return -1;
  if (blockIdx.x == 0 && blockIdx.y == 0 && blockIdx.z == 0) return 0;
  if (blockIdx.x == gridDim.x - 1 && blockIdx.y == gridDim.y - 1 && blockIdx.z == gridDim.z - 1)
    return 1;
  return -1;
}

__device__ __forceinline__ unsigned long long global_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

#define GT_COV_MARK(k)                                   \
  do {                                                   \
    const int row_ = clock_row();                        \
    if (row_ >= 0) {                                     \
      cov_clk[row_][k] = clock64();                      \
      if ((k) == 0) cov_gtime[row_][0] = global_ns();    \
      cov_gtime[row_][1] = global_ns();                  \
    }                                                    \
  } while (0)
#else
#define GT_COV_MARK(k) \
  do {                 \
  } while (0)
#endif

constexpr int kMaxGrid = 65535;
constexpr int kMaxDevices = 64;
constexpr size_t kStaticSmem = 48 * 1024;
// Tile blocks per SM that the compiler sizes the registers for (at most
// 85 a thread): with a row's operands in registers and the columns' read
// from shared memory the entries fit without spilling, and 3 blocks hide
// more of the entries' latency than 2.
constexpr int kTileMinBlocks = 3;
// Small blocks per SM that the compiler sizes the registers for (at most
// 64 a thread), so that the serving shapes' 512 blocks take one wave.
constexpr int kSmallMinBlocks = 3;

template <typename T, int K>
__global__ void __launch_bounds__(gt::COV_ROUND, kSmallMinBlocks)
cov_small_kernel(int n, const double* __restrict__ X, const int* __restrict__ nid,
                 const T* __restrict__ theta, int B, T* __restrict__ out) {
  __shared__ gt::CovSmallShared<T, gt::COV_IMG> sm;
  for (int b = blockIdx.x; b < B; b += gridDim.x) {
    GT_COV_MARK(0);
    const gt::CovSmall<T> c =
        gt::cov_small<T, K>(n, X, nid, theta, out, b, blockDim.x, gt::small_smem(sm));
    gt::small_points<T, K>(c, threadIdx.x);
    GT_COV_MARK(1);
    __syncthreads();
    GT_COV_MARK(2);
    gt::small_pairs<T, K>(c, threadIdx.x);
    GT_COV_MARK(3);
    __syncthreads();
    GT_COV_MARK(4);
    gt::small_store<T>(c, threadIdx.x);
    GT_COV_MARK(5);
    __syncthreads();
    GT_COV_MARK(6);
  }
}

template <typename T, int K>
__global__ void __launch_bounds__(32 * gt::COV_BAND)
cov_band_kernel(int n, const double* __restrict__ X, const int* __restrict__ nid,
                const T* __restrict__ theta, T* __restrict__ out) {
  __shared__ gt::CovSmallShared<T, 0> sm;
  GT_COV_MARK(0);
  const gt::CovSmall<T> c = gt::cov_small_band<T, K>(n, X, nid, theta, out, blockIdx.y,
                                                     blockIdx.x, gt::small_smem(sm));
  gt::small_points<T, K>(c, threadIdx.x);
  GT_COV_MARK(1);
  __syncthreads();
  GT_COV_MARK(2);
  gt::small_pairs<T, K>(c, threadIdx.x);
  GT_COV_MARK(3);
}

template <typename T, int K>
__global__ void __launch_bounds__(gt::COV_THREADS, kTileMinBlocks)
cov_tile_kernel(int n, const double* __restrict__ X, const int* __restrict__ nid,
                const T* __restrict__ theta, int B, T* __restrict__ out) {
  constexpr int P = gt::KindParams<K>::value;
  extern __shared__ __align__(16) unsigned char smem[];
  int I, J;
  gt::tri_pair(blockIdx.x, I, J);
  for (int b = blockIdx.z; b < B; b += gridDim.z) {
    const gt::CovTile<T> c{n, I, J, X, nid, theta + (size_t)b * P,
                           out + (size_t)b * n * n, gt::cov_tile_smem<T>(smem)};
    GT_COV_MARK(0);
    gt::tile_points<T, K>(c, threadIdx.x);
    GT_COV_MARK(1);
    __syncthreads();
    GT_COV_MARK(2);
    gt::tile_entries<T, K>(c, threadIdx.x);
    GT_COV_MARK(3);
    __syncthreads();
    GT_COV_MARK(4);
    gt::tile_store<T>(c, threadIdx.x);
    GT_COV_MARK(5);
    __syncthreads();
    GT_COV_MARK(6);
  }
}

// Allow the tile kernel its dynamic shared memory above 48 KB on the
// current device (float64): the limit is an attribute of each device, so
// it is raised once per device; a refusal is returned and tried again at
// the next launch.
template <typename T, int K>
int allow_tile_smem() {
  if (gt::cov_tile_bytes<T>() <= kStaticSmem) return 0;
  static std::atomic<bool> raised[kMaxDevices];
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return int(e);
  const bool cached = dev < kMaxDevices;
  if (cached && raised[dev].load(std::memory_order_relaxed)) return 0;
  e = cudaFuncSetAttribute(cov_tile_kernel<T, K>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           int(gt::cov_tile_bytes<T>()));
  if (e == cudaSuccess && cached) raised[dev].store(true, std::memory_order_relaxed);
  return int(e);
}

// Multiprocessors of the current device, read once per device (0 where
// the device cannot be read).
int sm_count() {
  static std::atomic<int> sms[kMaxDevices];
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return 0;
  int v = dev < kMaxDevices ? sms[dev].load(std::memory_order_relaxed) : 0;
  if (v == 0 && cudaDeviceGetAttribute(&v, cudaDevAttrMultiProcessorCount, dev) == cudaSuccess
      && dev < kMaxDevices)
    sms[dev].store(v, std::memory_order_relaxed);
  return v;
}

// The layout of a launch at (n, B) with elements of `item` bytes on a card
// of `sms` multiprocessors, into info[0..4]: 0 small / 1 tiles / 2 bands,
// grid x, grid y (bands) or z (tiles), threads a block, shared bytes a
// block; false where the tile grid would not fit the grid's x axis.
bool layout(int n, int B, int item, int sms, int* info) {
  const bool f32 = item == 4;
  if (n <= gt::COV_SMALL_N && gt::cov_small_direct(n, B, sms)) {
    const int sh = int(f32 ? sizeof(gt::CovSmallShared<float, 0>)
                           : sizeof(gt::CovSmallShared<double, 0>));
    const int v[5] = {2, (n + gt::COV_BAND - 1) / gt::COV_BAND, B, 32 * gt::COV_BAND, sh};
    for (int k = 0; k < 5; ++k) info[k] = v[k];
    return true;
  }
  if (n <= gt::COV_SMALL_N) {
    const int sh = int(f32 ? sizeof(gt::CovSmallShared<float, gt::COV_IMG>)
                           : sizeof(gt::CovSmallShared<double, gt::COV_IMG>));
    const int v[5] = {0, B < kMaxGrid ? B : kMaxGrid, 1, gt::cov_small_threads(n), sh};
    for (int k = 0; k < 5; ++k) info[k] = v[k];
    return true;
  }
  const long long nt = (n + gt::COV_TILE - 1) / gt::COV_TILE;
  const long long tiles = nt * (nt + 1) / 2;
  if (tiles > 0x7fffffffLL) return false;
  const int sh = int(f32 ? gt::cov_tile_bytes<float>() : gt::cov_tile_bytes<double>());
  const int v[5] = {1, int(tiles), B < kMaxGrid ? B : kMaxGrid, gt::COV_THREADS, sh};
  for (int k = 0; k < 5; ++k) info[k] = v[k];
  return true;
}

template <typename T, int K>
int launch(int n, const void* X, const void* nid, const void* theta, int B,
           void* out, void* stream) {
  int info[5];
  if (n < 1 || B < 1 || !layout(n, B, int(sizeof(T)), sm_count(), info))
    return int(cudaErrorInvalidValue);
  const cudaStream_t st = (cudaStream_t)stream;
  const double* Xd = (const double*)X;
  const int* ids = (const int*)nid;
  if (info[0] == 2) {
    cov_band_kernel<T, K><<<dim3(info[1], info[2]), info[3], 0, st>>>(
        n, Xd, ids, (const T*)theta, (T*)out);
  } else if (info[0] == 0) {
    cov_small_kernel<T, K><<<info[1], info[3], 0, st>>>(n, Xd, ids, (const T*)theta, B,
                                                        (T*)out);
  } else {
    const int attr = allow_tile_smem<T, K>();
    if (attr != 0) return attr;
    cov_tile_kernel<T, K><<<dim3(info[1], 1, info[2]), info[3], info[4], st>>>(
        n, Xd, ids, (const T*)theta, B, (T*)out);
  }
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

extern "C" int gt_cov_layout(int n, int B, int item, int* info) {
  if (n < 1 || B < 1 || (item != 4 && item != 8) || !layout(n, B, item, sm_count(), info))
    return int(cudaErrorInvalidValue);
  return 0;
}

#ifdef GT_PHASE_CLOCK
// Copy the phase marks out (cycles: 2 x 8, then global ns: 2 x 2), or zero
// them (reset = 1).
extern "C" int gt_cov_phase_clocks(long long* clk, unsigned long long* gtime, int reset) {
  static long long zc[2][8];
  static unsigned long long zg[2][2];
  if (reset) {
    const cudaError_t e = cudaMemcpyToSymbol(cov_clk, zc, sizeof zc);
    return int(e != cudaSuccess ? e : cudaMemcpyToSymbol(cov_gtime, zg, sizeof zg));
  }
  const cudaError_t e = cudaMemcpyFromSymbol(clk, cov_clk, sizeof zc);
  return int(e != cudaSuccess ? e : cudaMemcpyFromSymbol(gtime, cov_gtime, sizeof zg));
}
#endif
