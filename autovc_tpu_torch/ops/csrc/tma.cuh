// Hopper's tensor memory accelerator as the kernels use it (lstm_gates.cu,
// lstm_scan_fwd.cu): tensor maps encoded on the host, the loads of a box into
// shared memory, counted on an mbarrier, and the wgmma descriptor of the
// 128-byte swizzled tiles those loads write.
#pragma once

#include <cuda.h>
#include <dlfcn.h>

#include <cstdint>

#include "coop.cuh"

namespace {

constexpr int ERR_TMA = -3;  // the tensor map could not be encoded

// A box of a 3-D (4-D, 2-D) tensor map at the given coordinates, innermost
// first, into shared memory at dst (the map's swizzle applied), its bytes
// counted on the mbarrier bar; boxes past the tensor's edges are zero-filled.
__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map, void* bar, int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1, {%3, %4, %5}], "
      "[%2];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(bar)), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}
__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map, void* bar, int c0, int c1, int c2,
                                            int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1, {%3, %4, %5, %6}], "
      "[%2];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(bar)), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}
__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map, void* bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1, {%3, %4}], [%2];\n" ::
          "r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(bar)), "r"(c0), "r"(c1)
      : "memory");
}

// A wgmma shared-memory descriptor with the 128-byte swizzle: the start
// address, the leading and the stride byte offsets (16-byte units).
__device__ __forceinline__ uint64_t sw128_desc(const void* p, unsigned lbo, unsigned sbo) {
  return (uint64_t)((smem_addr(p) & 0x3FFFF) >> 4) | (uint64_t)((lbo >> 4) & 0x3FFF) << 16 |
         (uint64_t)((sbo >> 4) & 0x3FFF) << 32 | (uint64_t)1 << 62;
}

// The host side: cuTensorMapEncodeTiled from the libcuda.so.1 the process
// has loaded (no -lcuda).
using EncodeFn = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
                              const cuuint64_t*, const cuuint32_t*, const cuuint32_t*, CUtensorMapInterleave,
                              CUtensorMapSwizzle, CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeFn encode_fn() {
  static EncodeFn fn = [] {
    void* lib = dlopen("libcuda.so.1", RTLD_NOW | RTLD_NOLOAD);
    if (lib == nullptr) lib = dlopen("libcuda.so.1", RTLD_NOW);
    return lib == nullptr ? nullptr : reinterpret_cast<EncodeFn>(dlsym(lib, "cuTensorMapEncodeTiled"));
  }();
  return fn;
}

// A bfloat16 tensor map with zero fill: `rank` dims (innermost first), byte
// strides of dims 1.., the box, the swizzle.
bool encode(CUtensorMap* map, const void* ptr, int rank, const cuuint64_t* dims, const cuuint64_t* strides,
            const cuuint32_t* box, CUtensorMapSwizzle swizzle) {
  const EncodeFn fn = encode_fn();
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  return fn != nullptr && fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, rank, const_cast<void*>(ptr), dims, strides,
                             box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

}  // namespace
