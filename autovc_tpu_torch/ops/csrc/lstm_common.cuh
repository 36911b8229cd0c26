// What the LSTM kernels (lstm_fwd.cu, lstm_bwd.cu) share: the block shape,
// the staged loads, the register-tiled product over a K slice, and the
// launcher that checks a plan of ops/lstm.py:launch_plan and launches it.
#pragma once

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <mutex>
#include <vector>

namespace {

constexpr int NT = 256;           // threads per block
constexpr int RB = 4;             // batch rows per thread
constexpr int PAD = 4;            // floats added to each staged row (float4-aligned, spreads banks)
constexpr int ERR_PLAN = -1;      // the plan does not match the shapes
constexpr int ERR_RESIDENT = -2;  // the grid cannot be resident (info holds both numbers)

__device__ __forceinline__ float lane(const float4& v, int k) {
  return k == 0 ? v.x : k == 1 ? v.y : k == 2 ? v.z : v.w;
}

// 16 bytes global -> shared, cached in L2 only: a row another block wrote
// before the grid barrier is read as written, never from a stale L1 line.
__device__ __forceinline__ void cp_async16(float* smem, const float* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() { asm volatile("cp.async.wait_group %0;\n" ::"n"(N)); }

// acc[r][c] += sum over the float4 columns k4 = ks, ks + KS, ... < n4 of
// A[row0 + r][4 k4 ..] * W[4 k4 .. ][col0 + c], A row stride lda, W row
// stride ldw (floats).
__device__ __forceinline__ void gemm_slice(float (&acc)[RB][4], const float* A, int lda, const float* W, int ldw,
                                           int row0, int col0, int n4, int ks, int KS) {
  for (int k4 = ks; k4 < n4; k4 += KS) {
    float4 a[RB];
#pragma unroll
    for (int r = 0; r < RB; ++r) a[r] = *reinterpret_cast<const float4*>(A + (row0 + r) * lda + 4 * k4);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const float4 w = *reinterpret_cast<const float4*>(W + (4 * k4 + kk) * ldw + col0);
#pragma unroll
      for (int r = 0; r < RB; ++r) {
        const float x = lane(a[r], kk);
        acc[r][0] = fmaf(x, w.x, acc[r][0]);
        acc[r][1] = fmaf(x, w.y, acc[r][1]);
        acc[r][2] = fmaf(x, w.z, acc[r][2]);
        acc[r][3] = fmaf(x, w.w, acc[r][3]);
      }
    }
  }
}

// ERR_PLAN unless the plan fits the shapes: regime 0 (a) has H units a
// block and ceil(B / rows) blocks, regime 1 (b) H / units blocks and K
// chunks of kc floats; the product's tasks and the (row, unit) pairs, RB a
// thread, fit the threads. Else 0, with ks = NT / tasks.
inline int check_plan(int B, int T, int H, int regime, int blocks, int units, int rows, int kc, int tasks, int& ks) {
  const int tj = regime == 0 ? H : units;
  if (B <= 0 || T <= 0 || H <= 0 || H % 8 != 0 || rows <= 0 || rows % RB != 0 || units <= 0 || tasks <= 0 ||
      tasks > NT || rows * tj > RB * NT || regime < 0 || regime > 1)
    return ERR_PLAN;
  if (regime == 0 ? (units != H || blocks != (B + rows - 1) / rows)
                  : (H % units != 0 || blocks != H / units || kc <= 0 || kc % 4 != 0))
    return ERR_PLAN;
  ks = NT / tasks;
  return 0;
}

// The resident blocks per SM of `kernel` at `smem` dynamic shared bytes and
// the current device's SM count, asked of the runtime once per (kernel,
// device, smem) and kept; the kernel's dynamic shared limit is raised to
// `smem` when it is the largest asked for so far (above 48 KB a launch is
// refused without it). Returns 0 or the CUDA error.
int occupancy(const void* kernel, int smem, int& per_sm, int& sms) {
  struct Seen {
    const void* kernel;
    int dev, smem, per_sm, sms;
  };
  static std::mutex mu;
  static std::vector<Seen> seen;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  std::lock_guard<std::mutex> lock(mu);
  int raised = 0;
  for (const Seen& s : seen) {
    if (s.kernel != kernel || s.dev != dev) continue;
    if (s.smem == smem) {
      per_sm = s.per_sm;
      sms = s.sms;
      return 0;
    }
    raised = s.smem > raised ? s.smem : raised;
  }
  if (smem > raised &&
      (err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem)) != cudaSuccess)
    return (int)err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess) return (int)err;
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, NT, smem)) != cudaSuccess)
    return (int)err;
  seen.push_back({kernel, dev, smem, per_sm, sms});
  return 0;
}

// Launches regime (a)'s kernel, or regime (b)'s cooperatively once the
// occupancy query shows every block resident; info (2 ints, may be null)
// receives the resident blocks per SM and the SM count. Returns 0,
// ERR_RESIDENT or the CUDA error.
template <class Args>
int launch(void (*block_kernel)(Args), void (*grid_kernel)(Args), Args a, int regime, int blocks, int smem, int* info,
           cudaStream_t stream) {
  const void* kernel = regime == 0 ? (const void*)block_kernel : (const void*)grid_kernel;
  int sms = 0, per_sm = 0;
  const int err = occupancy(kernel, smem, per_sm, sms);
  if (err != 0) return err;
  if (info != nullptr) {
    info[0] = per_sm;
    info[1] = sms;
  }
  if (regime == 0) {
    if (per_sm < 1) return ERR_RESIDENT;
    block_kernel<<<blocks, NT, smem, stream>>>(a);
  } else {
    if ((long)per_sm * sms < blocks) return ERR_RESIDENT;
    void* params[] = {&a};
    const cudaError_t launched =
        cudaLaunchCooperativeKernel(kernel, dim3(blocks), dim3(NT), params, (size_t)smem, stream);
    if (launched != cudaSuccess) return (int)launched;
  }
  return (int)cudaGetLastError();
}

}  // namespace
