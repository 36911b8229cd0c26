// The LSTM gate activations of every step of a bfloat16 sequence, recomputed
// for the backward from the rounded hidden sequence: one parallel product
// over all (b, t), not a recurrence.
//
// Replaces the gate recompute inside the backward Pallas kernels of
// autovc_tpu/ops/pallas_lstm.py: _lstm_bwd_kernel (:410, gates = xproj +
// hprev @ w_hh at :431) and _lstm_bwd_kernel_split (:169, g_s at :214), with
// hprev = concat(h0, h_seq[:-1]) built by _chunk_bwd_call (:465) and
// _split_bwd_rule (:268). In bfloat16 hprev is the STORED h, rounded to
// bfloat16 and widened, not the float32 carry the forward multiplied, so the
// activations the forward kernel could save would differ from the
// reference's by about a bfloat16 ulp of h through w_hh: they are recomputed
// here instead, and the backward recurrence (lstm_bwd.cu) reads them.
//
// Computes, for every row m = (b, t) of B*T and column n of 4H:
//   pre[m, n] = f32(xproj[m, n]) + sum_k hprev[m, k] * f32(w_hh[k, n])
//   act[m, n] = sigmoid(pre) for the gates i, f, o; tanh(pre) for g
// hprev[m] = h_seq[b, t - 1] (t + 1 for reverse), and at the sequence's first
// step h0[b] (float32), or zero when h0 is null. xproj (B, T, 4H), w_hh (H, 4H)
// and h_seq (B, T, H) bfloat16; act (B, T, 4H) float32 in the order
// [sigmoid(i), sigmoid(f), tanh(g), sigmoid(o)] of lstm_fwd.cu's training form.
//
// Bound. 2*B*T*H*4H operations (0.12 ms at B=7, T=128, H=1024 in float32
// FMAs on the CUDA cores, 8 us at the bfloat16 tensor cores' 989 TFLOP/s)
// against xproj + w_hh + h_seq read and act written once (8.2 MB there,
// 2.4 us at 3.35 TB/s). Both operands of the product are exactly bfloat16
// (h_seq rounded, w_hh the layer's bfloat16 cast), so the tensor cores
// multiply them exactly and sum in float32: the product equals the float32
// reference up to the order of the sum. The rows whose hprev is h0, a float32
// state that need not be bfloat16 exactly, take a zero row in the tensor-core
// product and add h0 @ w_hh in float32 FMAs in the epilogue (none in the
// model, whose state starts at zero).
//
// Design. A block computes a 64 x 64 tile of pre with four warps, each a
// 32 x 32 part of it as 2 x 2 wmma fragments (16 x 16 x 16, bfloat16 in,
// float32 accumulators), walking K in chunks of 32 staged in shared memory
// (hprev's rows gathered from h_seq by their (b, t); 16-byte loads). The
// accumulators go through shared memory to the epilogue, where a thread a
// column adds xproj, applies the gate's activation and writes act, the
// threads of a warp on consecutive columns.

#include <cuda_bf16.h>
#include <mma.h>

#include "coop.cuh"

namespace {

using bf16 = __nv_bfloat16;
namespace wmma = nvcuda::wmma;

constexpr int GT = 64;              // rows and columns of pre a block
constexpr int GK = 32;              // K a stage
constexpr int G_THREADS = 128;      // four warps, 2 x 2 over the tile
constexpr int LDA = GK + 8;         // staged hprev row, bfloat16 (a multiple of 8, rows 32-byte aligned by 16)
constexpr int LDB = GT + 8;         // staged w_hh row, bfloat16
constexpr int LDC = GT + 4;         // the accumulators' rows, float32
constexpr int A_LOADS = GT * GK / 8 / G_THREADS;  // 16-byte loads of hprev a thread a stage
constexpr int B_LOADS = GK * GT / 8 / G_THREADS;  // ... and of w_hh
static_assert(A_LOADS * 8 * G_THREADS == GT * GK && B_LOADS * 8 * G_THREADS == GK * GT, "whole 16-byte loads");

struct GateArgs {
  const bf16* xproj;
  const bf16* w_hh;
  const float* h0;
  const bf16* h_seq;
  float* act;
  int B, T, H, reverse;
};

__device__ __forceinline__ float sigmoid(float x) { return 1.0f / (1.0f + expf(-x)); }

__global__ void __launch_bounds__(G_THREADS) lstm_gates_kernel(GateArgs a) {
  __shared__ __align__(32) bf16 As[GT][LDA];
  __shared__ __align__(32) bf16 Bs[GK][LDB];
  __shared__ __align__(32) float Cs[GT][LDC];
  const int tid = threadIdx.x, warp = tid / 32, wm = warp / 2, wn = warp % 2;
  const int H = a.H, N = 4 * H, T = a.T, M = a.B * T;
  const int m0 = blockIdx.y * GT, n0 = blockIdx.x * GT;

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.0f);

  // this thread's staged hprev rows: the h_seq row each is read from, or
  // null (past M, or a first step: h0 is added in the epilogue)
  const bf16* arow[A_LOADS];
  int acol[A_LOADS];
#pragma unroll
  for (int u = 0; u < A_LOADS; ++u) {
    const int e = tid + u * G_THREADS, r = e / (GK / 8), m = m0 + r;
    acol[u] = 8 * (e % (GK / 8));
    arow[u] = nullptr;
    if (m < M) {
      const int b = m / T, t = m % T, tp = a.reverse ? t + 1 : t - 1;
      if (tp >= 0 && tp < T) arow[u] = a.h_seq + ((size_t)b * T + tp) * H;
    }
  }
  const uint4 zero = make_uint4(0, 0, 0, 0);
  for (int k0 = 0; k0 < H; k0 += GK) {
#pragma unroll
    for (int u = 0; u < A_LOADS; ++u) {
      const int e = tid + u * G_THREADS, k = k0 + acol[u];
      *reinterpret_cast<uint4*>(&As[e / (GK / 8)][acol[u]]) =
          arow[u] != nullptr && k < H ? __ldg(reinterpret_cast<const uint4*>(arow[u] + k)) : zero;
    }
#pragma unroll
    for (int u = 0; u < B_LOADS; ++u) {
      const int e = tid + u * G_THREADS, r = e / (GT / 8), c = 8 * (e % (GT / 8));
      const int k = k0 + r, n = n0 + c;
      *reinterpret_cast<uint4*>(&Bs[r][c]) =
          k < H && n < N ? __ldg(reinterpret_cast<const uint4*>(a.w_hh + (size_t)k * N + n)) : zero;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < GK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa[2];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> fb[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) wmma::load_matrix_sync(fa[i], &As[32 * wm + 16 * i][kk], LDA);
#pragma unroll
      for (int j = 0; j < 2; ++j) wmma::load_matrix_sync(fb[j], &Bs[kk][32 * wn + 16 * j], LDB);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) wmma::mma_sync(acc[i][j], fa[i], fb[j], acc[i][j]);
    }
    __syncthreads();  // the stage is free for the next chunk
  }
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j)
      wmma::store_matrix_sync(&Cs[32 * wm + 16 * i][32 * wn + 16 * j], acc[i][j], LDC, wmma::mem_row_major);
  __syncthreads();

  for (int e = tid; e < GT * GT; e += G_THREADS) {
    const int r = e / GT, c = e % GT, m = m0 + r, n = n0 + c;
    if (m >= M || n >= N) continue;
    float pre = Cs[r][c] + __bfloat162float(a.xproj[(size_t)m * N + n]);
    const int b = m / T, t = m % T;
    if (a.h0 != nullptr && t == (a.reverse ? T - 1 : 0)) {
      const float* h = a.h0 + (size_t)b * H;
      for (int k = 0; k < H; ++k) pre = fmaf(h[k], __bfloat162float(a.w_hh[(size_t)k * N + n]), pre);
    }
    a.act[(size_t)m * N + n] = n / H == 2 ? tanhf(pre) : sigmoid(pre);
  }
}

}  // namespace

extern "C" {

// act (B, T, 4H) float32 from xproj, w_hh, h_seq (bfloat16) and h0 (float32,
// may be null), one launch on `stream`, without synchronising. Returns 0,
// ERR_PLAN for shapes it does not take (H % 8 != 0), or the CUDA error of
// the launch.
int autovc_lstm_gates(const void* xproj, const void* w_hh, const float* h0, const void* h_seq, float* act, int B,
                      int T, int H, int reverse, cudaStream_t stream) {
  const long M = (long)B * T;
  if (B <= 0 || T <= 0 || H <= 0 || H % 8 != 0 || M > (1L << 30) || (M + GT - 1) / GT > 65535) return ERR_PLAN;
  const GateArgs a{static_cast<const bf16*>(xproj), static_cast<const bf16*>(w_hh), h0,
                   static_cast<const bf16*>(h_seq), act, B, T, H, reverse};
  const dim3 grid((4 * H + GT - 1) / GT, (unsigned)((M + GT - 1) / GT));
  lstm_gates_kernel<<<grid, G_THREADS, 0, stream>>>(a);
  return (int)cudaGetLastError();
}

const char* autovc_cuda_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

}  // extern "C"
