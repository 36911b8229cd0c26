// What the kernels share: the launchers' error codes, the asynchronous
// copies and the occupancy query (all of them), and the cooperative launch
// that a grid barrier needs (the persistent kernels: lstm_fwd.cu,
// lstm_bwd.cu, wavenet_gen.cu).
//
// A grid barrier (cooperative_groups::this_grid().sync()) is safe only when
// every block of the grid is resident at once. The launcher raises the
// kernel's dynamic shared limit, asks the runtime how many blocks fit an SM
// at that size, refuses a grid larger than that times the SM count (the
// caller raises with both numbers) and launches with
// cudaLaunchCooperativeKernel, which itself refuses a grid that cannot be
// resident.
#pragma once

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <mutex>
#include <vector>

namespace {

constexpr int ERR_PLAN = -1;      // the plan does not match the shapes
constexpr int ERR_RESIDENT = -2;  // the grid cannot be resident (info holds both numbers)

// 16 bytes global -> shared, cached in L2 only: a row another block wrote
// before the grid barrier is read as written, never from a stale L1 line.
__device__ __forceinline__ void cp_async16(float* smem, const float* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem));
}
// The same with `bytes` (0..16) of the source read and the rest of the 16
// zero-filled; 0 reads nothing (gmem must still be a valid address).
__device__ __forceinline__ void cp_async16_part(void* smem, const void* gmem, int bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(gmem), "r"(bytes));
}
// All 16 bytes, or zeros.
__device__ __forceinline__ void cp_async16_fill(float* smem, const float* gmem, bool valid) {
  cp_async16_part(smem, gmem, valid ? 16 : 0);
}
// 4 bytes global -> shared through L1, 0 source bytes filling a zero (gmem
// must still be a valid address): for rows that are not 16-byte aligned.
__device__ __forceinline__ void cp_async4_fill(float* smem, const float* gmem, bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s), "l"(gmem), "r"(valid ? 4 : 0));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() { asm volatile("cp.async.wait_group %0;\n" ::"n"(N)); }

// Hopper's bulk copy (the TMA engine, no tensor map): `bytes` (a multiple of
// 16, both addresses 16-byte aligned) global -> shared, issued by one thread
// and counted on an mbarrier in shared memory, so that the copy takes no
// load slots of the threads and its completion is awaited where it is used.
__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void mbar_init(unsigned long long* bar) {  // one arrival a phase: the issuing thread's
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(smem_addr(bar)));
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}
__device__ __forceinline__ void bulk_load(void* dst, const void* src, unsigned bytes, unsigned long long* bar) {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");  // the slot's earlier reads before the copy
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(bytes)
               : "memory");
  asm volatile("cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(bytes), "r"(smem_addr(bar))
               : "memory");
}
// Waits for the mbarrier's phase of the given parity to complete.
__device__ __forceinline__ void mbar_wait(unsigned long long* bar, unsigned parity) {
  asm volatile(
      "{\n .reg .pred p;\n WAIT:\n mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n @!p bra WAIT;\n}\n" ::"r"(
          smem_addr(bar)),
      "r"(parity)
      : "memory");
}

// The resident blocks per SM of `kernel` at `threads` a block and `smem`
// dynamic shared bytes, and the current device's SM count, asked of the
// runtime once per (kernel, device, threads, smem) and kept; the kernel's
// dynamic shared limit is raised to `smem` when it is the largest asked for
// so far (above 48 KB a launch is refused without it). Returns 0 or the
// CUDA error.
int occupancy(const void* kernel, int threads, int smem, int& per_sm, int& sms) {
  struct Seen {
    const void* kernel;
    int dev, threads, smem, per_sm, sms;
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
    if (s.smem == smem && s.threads == threads) {
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
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, smem)) != cudaSuccess)
    return (int)err;
  seen.push_back({kernel, dev, threads, smem, per_sm, sms});
  return 0;
}

// Launches `kernel(args)` cooperatively on `blocks` blocks of `threads`
// once the occupancy query shows every block resident; info (2 ints, may be
// null) receives the resident blocks per SM and the SM count. Returns 0,
// ERR_RESIDENT or the CUDA error.
template <class Args>
int launch_cooperative(void (*kernel)(Args), Args a, int blocks, int threads, int smem, int* info,
                       cudaStream_t stream) {
  int sms = 0, per_sm = 0;
  const int err = occupancy((const void*)kernel, threads, smem, per_sm, sms);
  if (err != 0) return err;
  if (info != nullptr) {
    info[0] = per_sm;
    info[1] = sms;
  }
  if ((long)per_sm * sms < blocks) return ERR_RESIDENT;
  void* params[] = {&a};
  const cudaError_t launched =
      cudaLaunchCooperativeKernel((const void*)kernel, dim3(blocks), dim3(threads), params, (size_t)smem, stream);
  if (launched != cudaSuccess) return (int)launched;
  return (int)cudaGetLastError();
}

}  // namespace
