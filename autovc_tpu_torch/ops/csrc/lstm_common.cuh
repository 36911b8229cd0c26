// What the LSTM kernels (lstm_fwd.cu, lstm_bwd.cu) share: the block shape,
// the staged loads, the register-tiled product over a K slice, and the
// launcher that checks a plan of ops/lstm.py:launch_plan and launches it
// (cooperatively in regime (b), through coop.cuh).
#pragma once

#include <cuda_bf16.h>

#include "coop.cuh"
#include "scan_round.cuh"

namespace {

constexpr int NT = 256;           // threads per block
constexpr int RB = 4;             // batch rows per thread
constexpr int PAD = 4;            // floats added to each staged row (float4-aligned, spreads banks)

__device__ __forceinline__ float lane(const float4& v, int k) {
  return k == 0 ? v.x : k == 1 ? v.y : k == 2 ? v.z : v.w;
}

// Four consecutive weights as floats: a float4, or four bfloat16 (8 bytes,
// exactly widened).
__device__ __forceinline__ float4 load4(const float* p) { return *reinterpret_cast<const float4*>(p); }
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const float2 lo = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
  const float2 hi = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
  return make_float4(lo.x, lo.y, hi.x, hi.y);
}

// One value of device memory that no block writes during the launch, as a
// float, and a float stored as TW (bfloat16: rounded to nearest even).
__device__ __forceinline__ float load_ro1(const float* p) { return __ldg(p); }
__device__ __forceinline__ float load_ro1(const __nv_bfloat16* p) {
  return __bfloat162float(__ushort_as_bfloat16(__ldg(reinterpret_cast<const unsigned short*>(p))));
}
__device__ __forceinline__ void store1(float* p, float v) { *p = v; }
__device__ __forceinline__ void store1(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }

// acc[r][c] += sum over the float4 columns k4 = ks, ks + KS, ... < n4 of
// A[row0 + r][4 k4 ..] * W[4 k4 .. ][col0 + c], A row stride lda, W row
// stride ldw (elements). W is float32 or bfloat16, widened exactly: the
// products and sums are float32 FMAs either way.
template <class TW>
__device__ __forceinline__ void gemm_slice(float (&acc)[RB][4], const float* A, int lda, const TW* W, int ldw,
                                           int row0, int col0, int n4, int ks, int KS) {
  for (int k4 = ks; k4 < n4; k4 += KS) {
    float4 a[RB];
#pragma unroll
    for (int r = 0; r < RB; ++r) a[r] = *reinterpret_cast<const float4*>(A + (row0 + r) * lda + 4 * k4);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const float4 w = load4(W + (4 * k4 + kk) * ldw + col0);
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
// block and ceil(B / rows) blocks, regimes 1 (b) and 2 (c) H / units blocks
// and chunks of kc floats of K (H in the forward, 4H in the backward), (c)
// its first kres rows of K resident, a multiple of kc short of K; the
// product's tasks and the (row, unit) pairs, RB a thread, fit the threads.
// Else 0, with ks = NT / tasks.
inline int check_plan(int B, int T, int H, int K, int regime, int blocks, int units, int rows, int kc, int kres,
                      int tasks, int& ks) {
  const int tj = regime == 0 ? H : units;
  if (B <= 0 || T <= 0 || H <= 0 || H % 8 != 0 || rows <= 0 || rows % RB != 0 || units <= 0 || tasks <= 0 ||
      tasks > NT || rows * tj > RB * NT || regime < 0 || regime > 2)
    return ERR_PLAN;
  if (regime == 0 ? (units != H || blocks != (B + rows - 1) / rows)
                  : (H % units != 0 || blocks != H / units || kc <= 0 || kc % 4 != 0))
    return ERR_PLAN;
  if (regime == 2 && (kres < 0 || kres % kc != 0 || kres >= K)) return ERR_PLAN;
  ks = NT / tasks;
  return 0;
}

// Launches regime (a)'s kernel, or regime (b)'s cooperatively once the
// occupancy query shows every block resident (coop.cuh); info (2 ints, may
// be null) receives the resident blocks per SM and the SM count. Returns 0,
// ERR_RESIDENT or the CUDA error.
template <class Args>
int launch(void (*block_kernel)(Args), void (*grid_kernel)(Args), Args a, int regime, int blocks, int smem, int* info,
           cudaStream_t stream) {
  if (regime == 1) return launch_cooperative(grid_kernel, a, blocks, NT, smem, info, stream);
  int sms = 0, per_sm = 0;
  const int err = occupancy((const void*)block_kernel, NT, smem, per_sm, sms);
  if (err != 0) return err;
  if (info != nullptr) {
    info[0] = per_sm;
    info[1] = sms;
  }
  if (per_sm < 1) return ERR_RESIDENT;
  block_kernel<<<blocks, NT, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace
