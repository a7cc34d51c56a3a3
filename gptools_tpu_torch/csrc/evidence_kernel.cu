// CUDA entry points for the evidence kernel (sm_90a), one per (kind, dtype).
//
// A block of W warps serves W consecutive chains, one warp per chain (see
// evidence_chain.cuh for the math, the TPU kernel it replaces and what
// bounds it); the grid is ceil(C / W) blocks, and a warp whose chain is
// >= C skips it as a whole warp. The block's dynamic shared memory holds
// the observation constants once (X, y, err2, nid, and the pair table of
// gt::pair_entry) and one slice per chain
// (`gt::ChainSmem`, sized from n); the block stages its chains' theta
// columns and aux rows into it, and writes the outputs back from it, with
// the block's threads on consecutive chains. W is 4 (kWarps).
//
// theta is chains-minor, thetaT (P, C), as in the reference; the aux inputs
// mu, nd, w, wp and their cotangents are (N, C) row-major and may each be
// null. ll (C,), grad (P, C) and the cotangents are written by the kernel
// and allocated by the caller. Plain C interface, bound from Python by
// ctypes; each entry point returns the cudaError of raising the kernel's
// shared-memory limit (first launch on a device only) or of the launch.
//
// Built with -DGT_PHASE_CLOCK (scripts/profile_torch_leapfrog.py --phases),
// block 0's first thread also writes the SM clock at the start of the chain
// body and after every phase (gt::phase_clk), read back by
// gt_phase_clocks.

#include <cuda_runtime.h>

#include <atomic>
#include <type_traits>

#include "evidence_chain.cuh"

namespace {

constexpr int kWarps = 4;
constexpr int kMaxSmem = 232448;  // 227 KB, the most a block may use
constexpr int kMaxDevices = 64;

// bytes of the block's constants (X, y, err2, nid and the pair table),
// rounded up to 16
__host__ __device__ int const_bytes(int n) {
  return (n * (3 * 8 + 4) + n * (n + 1) + 15) / 16 * 16;
}

template <typename T>
__device__ __forceinline__ gt::ChainSmem<T> slice(unsigned char* smem, int n, int w) {
  T* base = reinterpret_cast<T*>(smem + const_bytes(n));
  return gt::chain_smem<T>(base + w * gt::chain_elems(n), n);
}

// Copy the (n, C) rows of the block's chains between global memory and the
// chains' slices (`field`), consecutive threads on consecutive chains: a
// const array is an input (global -> slice), any other an output (slice ->
// global); a null array is absent.
template <typename T, typename G>
__device__ __forceinline__ void stage_rows(unsigned char* smem, int n, int W, int c0, int C,
                                           G* g, T* gt::ChainSmem<T>::*field) {
  if (!g) return;
  for (int e = threadIdx.x; e < n * W; e += blockDim.x) {
    const int i = e / W, c = c0 + e % W;
    if (c >= C) continue;
    T* v = slice<T>(smem, n, e % W).*field;
    if constexpr (std::is_const<G>::value) {
      v[i] = g[(size_t)i * C + c];
    } else {
      g[(size_t)i * C + c] = v[i];
    }
  }
}

// Blocks per SM that the compiler sizes the registers for. float32: 6, the
// most that config 4's slices (n = 27, ~36 KB a block) fit in shared
// memory, so 80 registers a thread, which the body takes without spilling;
// float64: 1, since with the thread count alone ptxas stops at 128
// registers and spills, and the slices (~70 KB a block at n = 27) allow 3
// blocks anyway.
template <typename T>
constexpr int kMinBlocks = sizeof(T) == 4 ? 6 : 1;

template <typename T, int K>
__global__ void __launch_bounds__(kWarps * gt::LANES, kMinBlocks<T>)
evidence_kernel(int n, const double* __restrict__ X, const int* __restrict__ nid,
                const double* __restrict__ y, const double* __restrict__ err2,
                double df, const T* __restrict__ thetaT, int C,
                const T* mu, const T* nd, const T* w, const T* wp,
                T* __restrict__ ll, T* __restrict__ grad,
                T* gmu, T* gnd, T* gw, T* gwp) {
  constexpr int P = gt::KindParams<K>::value;
  extern __shared__ __align__(16) unsigned char smem[];
  double* sX = reinterpret_cast<double*>(smem);
  double* sy = sX + n;
  double* se = sy + n;
  int* snid = reinterpret_cast<int*>(se + n);
  unsigned char* tab = reinterpret_cast<unsigned char*>(snid + n);
  constexpr int W = kWarps;
  const int c0 = blockIdx.x * W;
  const int tid = threadIdx.x, nt = blockDim.x;

  // ---- stage: constants, theta (P, W) and aux rows (n, W) -------------
  for (int i = tid; i < n; i += nt) {
    sX[i] = X[i];
    sy[i] = y[i];
    se[i] = err2[i];
    snid[i] = nid[i];
  }
  for (int q = tid; q < n * (n + 1) / 2; q += nt) gt::pair_entry(q, tab);
  for (int e = tid; e < P * W; e += nt) {
    const int p = e / W, c = c0 + e % W;
    if (c < C) slice<T>(smem, n, e % W).th[p] = thetaT[(size_t)p * C + c];
  }
  stage_rows<T>(smem, n, W, c0, C, mu, &gt::ChainSmem<T>::mu);
  stage_rows<T>(smem, n, W, c0, C, nd, &gt::ChainSmem<T>::nd);
  stage_rows<T>(smem, n, W, c0, C, w, &gt::ChainSmem<T>::w);
  stage_rows<T>(smem, n, W, c0, C, wp, &gt::ChainSmem<T>::wp);
  __syncthreads();

  // ---- one warp per chain -------------------------------------------------
#ifdef GT_PHASE_CLOCK
  if (blockIdx.x == 0 && tid == 0) gt::phase_clk[0] = clock64();
#endif
  const int warp = tid / gt::LANES;
  if (c0 + warp < C) {
    gt::evidence_chain<T, K>(gt::WarpTeam{tid % gt::LANES}, n, sX, snid, sy, se, df, tab,
                             gt::AuxSet{mu != nullptr, nd != nullptr, w != nullptr,
                                        wp != nullptr},
                             slice<T>(smem, n, warp));
  }
  __syncthreads();

  // ---- write back: ll, grad (P, W) and the cotangent rows (n, W) --------
  for (int e = tid; e < (1 + P) * W; e += nt) {
    const int r = e / W, c = c0 + e % W;
    if (c >= C) continue;
    const T v = slice<T>(smem, n, e % W).out[r];
    if (r == 0) {
      ll[c] = v;
    } else {
      grad[(size_t)(r - 1) * C + c] = v;
    }
  }
  stage_rows<T>(smem, n, W, c0, C, gmu, &gt::ChainSmem<T>::alpha);
  stage_rows<T>(smem, n, W, c0, C, gnd, &gt::ChainSmem<T>::kbd);
  stage_rows<T>(smem, n, W, c0, C, gw, &gt::ChainSmem<T>::b0);
  stage_rows<T>(smem, n, W, c0, C, gwp, &gt::ChainSmem<T>::b1);
}

// dynamic shared memory of a block at n points (at most ~181 KB, float64
// at N_MAX)
template <typename T>
size_t smem_bytes(int n) {
  return const_bytes(n) + size_t(kWarps) * gt::chain_elems(n) * sizeof(T);
}

// Allow the kernel dynamic shared memory above 48 KB on the current device:
// the limit is an attribute of each device, so it is raised once per device;
// a refusal is returned and tried again at the next launch.
template <typename T, int K>
int allow_smem() {
  static std::atomic<bool> raised[kMaxDevices];
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return int(e);
  const bool cached = dev < kMaxDevices;
  if (cached && raised[dev].load(std::memory_order_relaxed)) return 0;
  e = cudaFuncSetAttribute(evidence_kernel<T, K>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           kMaxSmem);
  if (e == cudaSuccess && cached) raised[dev].store(true, std::memory_order_relaxed);
  return int(e);
}

template <typename T, int K>
int launch(int n, const void* X, const void* nid, const void* y,
           const void* err2, double df, const void* thetaT, int C,
           const void* mu, const void* nd, const void* w, const void* wp,
           void* ll, void* grad, void* gmu, void* gnd, void* gw, void* gwp,
           void* stream) {
  if (n < 1 || n > gt::N_MAX || C < 1) return int(cudaErrorInvalidValue);
  const int attr = allow_smem<T, K>();
  if (attr != 0) return attr;
  const int blocks = (C + kWarps - 1) / kWarps;
  evidence_kernel<T, K><<<blocks, kWarps * gt::LANES, smem_bytes<T>(n), (cudaStream_t)stream>>>(
      n, (const double*)X, (const int*)nid, (const double*)y,
      (const double*)err2, df, (const T*)thetaT, C, (const T*)mu,
      (const T*)nd, (const T*)w, (const T*)wp, (T*)ll, (T*)grad, (T*)gmu,
      (T*)gnd, (T*)gw, (T*)gwp);
  return int(cudaGetLastError());
}

}  // namespace

#define GT_EXPORT(NAME, T, K)                                                 \
  extern "C" int NAME(int n, const void* X, const void* nid, const void* y,   \
                      const void* err2, double df, const void* thetaT, int C, \
                      const void* mu, const void* nd, const void* w,          \
                      const void* wp, void* ll, void* grad, void* gmu,        \
                      void* gnd, void* gw, void* gwp, void* stream) {         \
    return launch<T, K>(n, X, nid, y, err2, df, thetaT, C, mu, nd, w, wp, ll, \
                        grad, gmu, gnd, gw, gwp, stream);                     \
  }

GT_EXPORT(gt_gibbs_tanh_evidence_f32, float, gt::GIBBS_TANH)
GT_EXPORT(gt_gibbs_tanh_evidence_f64, double, gt::GIBBS_TANH)
GT_EXPORT(gt_se_evidence_f32, float, gt::SE)
GT_EXPORT(gt_se_evidence_f64, double, gt::SE)
GT_EXPORT(gt_matern52_evidence_f32, float, gt::MATERN52)
GT_EXPORT(gt_matern52_evidence_f64, double, gt::MATERN52)

#ifdef GT_PHASE_CLOCK
// Copy the phase clocks out (reset = 0) or zero them (reset = 1).
extern "C" int gt_phase_clocks(long long* out, int reset) {
  static long long zero[gt::PHASE_MARKS];
  if (reset) return int(cudaMemcpyToSymbol(gt::phase_clk, zero, sizeof zero));
  return int(cudaMemcpyFromSymbol(out, gt::phase_clk, sizeof zero));
}
#endif
