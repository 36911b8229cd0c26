// The recurrent weight gradient of the LSTM's scan rounding (ops/lstm.py:
// lstm_scan_bf16_weight_grad_ref): dW_hh of _lstm_scan in bfloat16 as XLA
// computes it when it transposes the scan. The transpose carries w_hh's
// cotangent through the reversed loop in bfloat16, so each step's product
// is rounded, added to the carried dW and rounded again:
//   dW = rb(dW + rb(hprev_t^T @ dxproj_t))        t in the backward's order
// with the products of two bfloat16 values exact and their sum over the B
// batch rows in float32. No library product computes this: a GEMM over K =
// B*T sums every step in float32 and rounds once (lstm_dw_kernel in
// lstm_bwd.cu, the Pallas rounding).
//
// Inputs: h_seq (B, T, H) bfloat16, the scan forward's hidden sequence; h0
// (B, H) float32 of bfloat16 values, or null (zero); dxproj (B, T, 4H)
// bfloat16, the scan backward's gate gradients. hprev_t is h0 at the
// forward's first step (t = 0, or t = T-1 for reverse) and h_seq's
// neighbour (t-1, or t+1) after it. Output dw (H, 4H) bfloat16.
//
// Design. One block an output tile of TI x TJ, its accumulator in
// registers as float32 values that are bfloat16 (TI*TJ / NT of them a
// thread). The block walks the T steps in the backward's order, forming
// each element's float32 sum over b in order, rounding it and adding it to
// the accumulator. The steps are serial for every tile, so the grid is the
// tiles: (4H / TJ) x (H / TI) blocks, 1024 at H=1024. Where B <= BC (the
// training batches) a block stages CT steps at once, hprev_t's TI columns
// and dxproj_t's TJ columns of every batch row (coalesced rows), and walks
// them from shared memory: two barriers every CT steps. A larger B stages
// one step's rows BC at a time instead. The work is 2*B*T*4H^2 flops and
// the bytes (h_seq, dxproj, dW once) are small: the kernel is bound by its
// T serial steps, not by the card's rates (0.2 ms a sequence at H=32, B=7,
// T=128 against a 0.1-us bound: chip_smoke.py 10b).

#include <cuda_bf16.h>

namespace {

constexpr int NT = 256;  // threads a block
constexpr int TI = 64;   // rows of dW (hidden units of hprev) a tile
constexpr int TJ = 64;   // columns of dW (gates) a tile
constexpr int RI = 4;    // rows a thread
constexpr int RJ = 4;    // columns a thread
constexpr int BC = 8;    // batch rows staged at once
constexpr int CT = 8;    // steps staged at once where B <= BC
static_assert((TI / RI) * (TJ / RJ) == NT, "one thread an RI x RJ patch of the tile");

using bf16 = __nv_bfloat16;

__device__ __forceinline__ float rb(float v) { return __bfloat162float(__float2bfloat16_rn(v)); }
__device__ __forceinline__ float widen(const bf16* p) {
  return __bfloat162float(__ushort_as_bfloat16(__ldg(reinterpret_cast<const unsigned short*>(p))));
}

// hprev at step t of batch row b, unit i (zero outside H, and h0 or zero at
// the forward's first step)
__device__ __forceinline__ float hprev_at(const bf16* h_seq, const float* h0, int b, int t, int i, int T, int H,
                                          int reverse) {
  if (i >= H) return 0.f;
  const bool first = reverse ? t == T - 1 : t == 0;
  if (!first) return widen(h_seq + ((long)b * T + (reverse ? t + 1 : t - 1)) * H + i);
  return h0 != nullptr ? __ldg(h0 + (long)b * H + i) : 0.f;
}

// p += the float32 sum over the nb <= BC batch rows staged at slot
// ``slot``, in row order (the loop bound a constant, so that p and the
// operands stay in registers)
__device__ __forceinline__ void accumulate(float (&p)[RI][RJ], const float (*hs)[BC][TI], const float (*gs)[BC][TJ],
                                           int slot, int nb, int ti, int tj) {
#pragma unroll
  for (int bb = 0; bb < BC; ++bb) {
    if (bb < nb) {
      float a[RI], g[RJ];
#pragma unroll
      for (int r = 0; r < RI; ++r) a[r] = hs[slot][bb][ti * RI + r];
#pragma unroll
      for (int c = 0; c < RJ; ++c) g[c] = gs[slot][bb][tj * RJ + c];
#pragma unroll
      for (int r = 0; r < RI; ++r)
#pragma unroll
        for (int c = 0; c < RJ; ++c) p[r][c] = fmaf(a[r], g[c], p[r][c]);
    }
  }
}

// acc = rb(acc + rb(p)), element by element, and p zeroed for the next step
__device__ __forceinline__ void round_in(float (&acc)[RI][RJ], float (&p)[RI][RJ]) {
#pragma unroll
  for (int r = 0; r < RI; ++r)
#pragma unroll
    for (int c = 0; c < RJ; ++c) {
      acc[r][c] = rb(acc[r][c] + rb(p[r][c]));
      p[r][c] = 0.f;
    }
}

__global__ void __launch_bounds__(NT) lstm_scan_dw_kernel(const bf16* __restrict__ h_seq,
                                                          const float* __restrict__ h0,
                                                          const bf16* __restrict__ dx, bf16* __restrict__ dw,
                                                          int B, int T, int H, int reverse) {
  __shared__ float hs[CT][BC][TI];
  __shared__ float gs[CT][BC][TJ];
  const int H4 = 4 * H;
  const int i0 = blockIdx.y * TI, j0 = blockIdx.x * TJ;
  const int ti = threadIdx.x / (TJ / RJ), tj = threadIdx.x % (TJ / RJ);
  float acc[RI][RJ], p[RI][RJ];
#pragma unroll
  for (int r = 0; r < RI; ++r)
#pragma unroll
    for (int c = 0; c < RJ; ++c) acc[r][c] = p[r][c] = 0.f;

  if (B <= BC) {
    for (int s0 = 0; s0 < T; s0 += CT) {
      const int ns = min(CT, T - s0);
      __syncthreads();  // the last chunk's reads are done
      for (int e = threadIdx.x; e < ns * B * TI; e += NT) {
        const int k = e / (B * TI), bb = e / TI % B, ii = e % TI, s = s0 + k;
        hs[k][bb][ii] = hprev_at(h_seq, h0, bb, reverse ? s : T - 1 - s, i0 + ii, T, H, reverse);
      }
      for (int e = threadIdx.x; e < ns * B * TJ; e += NT) {
        const int k = e / (B * TJ), bb = e / TJ % B, jj = e % TJ, s = s0 + k, j = j0 + jj;
        gs[k][bb][jj] = j < H4 ? widen(dx + ((long)bb * T + (reverse ? s : T - 1 - s)) * H4 + j) : 0.f;
      }
      __syncthreads();
      for (int k = 0; k < ns; ++k) {
        accumulate(p, hs, gs, k, B, ti, tj);
        round_in(acc, p);
      }
    }
  } else {
    for (int s = 0; s < T; ++s) {
      const int t = reverse ? s : T - 1 - s;
      for (int b0 = 0; b0 < B; b0 += BC) {
        const int nb = min(BC, B - b0);
        __syncthreads();  // the last chunk's reads are done
        for (int e = threadIdx.x; e < nb * TI; e += NT)
          hs[0][e / TI][e % TI] = hprev_at(h_seq, h0, b0 + e / TI, t, i0 + e % TI, T, H, reverse);
        for (int e = threadIdx.x; e < nb * TJ; e += NT) {
          const int j = j0 + e % TJ;
          gs[0][e / TJ][e % TJ] = j < H4 ? widen(dx + ((long)(b0 + e / TJ) * T + t) * H4 + j) : 0.f;
        }
        __syncthreads();
        accumulate(p, hs, gs, 0, nb, ti, tj);
      }
      round_in(acc, p);
    }
  }
#pragma unroll
  for (int r = 0; r < RI; ++r) {
    const int i = i0 + ti * RI + r;
    if (i >= H) continue;
#pragma unroll
    for (int c = 0; c < RJ; ++c) {
      const int j = j0 + tj * RJ + c;
      if (j < H4) dw[(long)i * H4 + j] = __float2bfloat16_rn(acc[r][c]);
    }
  }
}

}  // namespace

extern "C" {

// dW (H, 4H) bfloat16 of the scan rounding, one launch on `stream`, without
// synchronising. h_seq and dxproj bfloat16, h0 float32 of bfloat16 values or
// null. Returns 0, -1 for shapes it does not take, or the CUDA error of the
// launch.
int autovc_lstm_scan_dw(const void* h_seq, const float* h0, const void* dxproj, void* dw, int B, int T, int H,
                        int reverse, cudaStream_t stream) {
  if (B <= 0 || T <= 0 || H <= 0 || H % 8 != 0 || (long)B * T * 4 * H > (1L << 31)) return -1;
  const dim3 grid((4 * H + TJ - 1) / TJ, (H + TI - 1) / TI);
  lstm_scan_dw_kernel<<<grid, NT, 0, stream>>>(static_cast<const bf16*>(h_seq), h0, static_cast<const bf16*>(dxproj),
                                               static_cast<bf16*>(dw), B, T, H, reverse);
  return (int)cudaGetLastError();
}

const char* autovc_cuda_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

}  // extern "C"
