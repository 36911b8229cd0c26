// What the LSTM kernels (lstm_fwd.cu, lstm_bwd.cu) share: the block shape,
// the staged loads, the register-tiled product over a K slice, and the
// launcher that checks a plan of ops/lstm.py:launch_plan and launches it
// (cooperatively in regime (b), through coop.cuh).
#pragma once

#include "coop.cuh"

namespace {

constexpr int NT = 256;           // threads per block
constexpr int RB = 4;             // batch rows per thread
constexpr int PAD = 4;            // floats added to each staged row (float4-aligned, spreads banks)

__device__ __forceinline__ float lane(const float4& v, int k) {
  return k == 0 ? v.x : k == 1 ? v.y : k == 2 ? v.z : v.w;
}

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
