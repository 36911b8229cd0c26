// Forward LSTM recurrence over hoisted input projections, one launch per step.
//
// Replaces the forward Pallas kernels of autovc_tpu/ops/pallas_lstm.py:
//   _chunk_fwd (-> _lstm_kernel, _lstm_kernel_train) and
//   _lstm_chunk_split_impl (-> _lstm_kernel_split, _lstm_kernel_split_train).
// The TPU needed the gate-split variant only because a (H, 4H) f32 w_hh of
// 16 MB at H=1024 does not fit its VMEM; here one kernel serves every H.
//
// Computes, for t in time order (or reversed):
//   gates = xproj[:, t] + h_{t-1} @ w_hh        (B, 4H), gate order i, f, g, o
//   c_t = sigmoid(f) * c_{t-1} + sigmoid(i) * tanh(g)
//   h_t = sigmoid(o) * tanh(c_t)                 h_seq[:, t] = h_t
// from (h0, c0) and float32 throughout.
//   xproj (B, T, 4H), w_hh (H, 4H) row-major, h_seq (B, T, H), c (B, H).
// h0 (B, H) may be null (zero initial h, the product of step 0 is skipped);
// c holds c0 on entry (the caller zeroes it for a zero state) and cN on exit.
// The training form also writes the cell sequence c_seq (B, T, H), the
// backward's residual (csrc/lstm_bwd.cu); inference passes null and pays no
// c_seq traffic. hN is h_seq at the last step taken.
//
// Design. The host launcher runs one kernel per time step on the caller's
// stream; the kernel boundary is the only synchronisation between steps (no
// grid barrier, no cooperative launch, no spin-wait). Step t reads h_{t-1}
// from h_seq[:, t-1] (written by the previous launch), or h0 at the first
// step, and writes h_t into h_seq[:, t], so h is double-buffered by the
// sequence itself. c is updated in place: element (b, j) is read and written
// by one thread only.
//
// Each block owns TJ hidden units for up to BT batch rows and computes their
// four gate dot products of length H, so the cell update needs no exchange
// between blocks. Threads split the H reduction KS ways and hold RB batch
// rows x 4 gates of accumulators; w_hh and h tiles are staged through shared
// memory KC rows at a time and the KS partial sums are added in shared memory.
//
// Bound. Per step the blocks together read all of w_hh once (4H^2 floats:
// 16 MB at H=1024, which stays resident in the 50 MB L2 across steps) and
// h_{t-1} once per block (another 16 MB at B=32, H=1024: 128 blocks x 128 KB),
// and do 8*B*H^2 flops on the f32 CUDA cores (67 TFLOP/s peak): at B=32,
// H=1024 that is 4 us of arithmetic per step, beside the L2 traffic and a few
// microseconds of launch latency per step; the training form adds B*T*H
// floats of c_seq writes. The design accepts all three: no
// tensor cores, h re-read by every block, and T launches per sequence. A
// persistent kernel that keeps w_hh in shared memory across SMs, bf16 weights
// and CUDA graphs are later work, to be measured against these numbers.

#include <cuda_runtime.h>

namespace {

constexpr int TJ = 8;    // hidden units per block
constexpr int BT = 32;   // batch rows per block
constexpr int RB = 4;    // batch rows per thread
constexpr int KS = 4;    // ways the H reduction is split among threads
constexpr int KC = 64;   // rows of w_hh / columns of h staged per tile
constexpr int NT = TJ * (BT / RB) * KS;  // 256 threads
constexpr int HS = KC + 4;               // h tile row stride (keeps float4 alignment)

static_assert(NT == 256, "thread layout");
static_assert((KC / KS) % 4 == 0, "inner loop is unrolled by 4");

__device__ __forceinline__ float sigmoid(float x) { return 1.0f / (1.0f + expf(-x)); }

__global__ void __launch_bounds__(NT)
lstm_step_kernel(const float* __restrict__ xproj, const float* __restrict__ w_hh,
                 const float* h_prev, size_t h_stride, float* h_seq,
                 float* __restrict__ c_state, float* __restrict__ c_seq,
                 int B, int T, int H, int t) {
  // h_prev: row b of h_{t-1} at h_prev + b * h_stride, or null for a zero h.
  // It aliases h_seq (another time slice), so neither is __restrict__.
  __shared__ __align__(16) float ws[KC][4][TJ];    // w_hh tile: [k][gate][unit]
  __shared__ __align__(16) float hs[BT][HS];       // h tile: [batch][k]
  __shared__ __align__(16) float red[KS][BT][TJ][4];

  const int tid = threadIdx.x;
  const int j = tid % TJ;                  // unit within the block
  const int bg = (tid / TJ) % (BT / RB);   // group of RB batch rows
  const int ks = tid / (TJ * (BT / RB));   // slice of each k tile
  const int j0 = blockIdx.x * TJ;
  const int b0 = blockIdx.y * BT;

  float acc[RB][4];
#pragma unroll
  for (int r = 0; r < RB; ++r)
#pragma unroll
    for (int g = 0; g < 4; ++g) acc[r][g] = 0.0f;

  if (h_prev != nullptr) {
    for (int kc = 0; kc < H; kc += KC) {
      // w_hh rows kc..kc+KC, columns g*H + j0 .. +TJ: 32-byte runs per gate.
      for (int e = tid; e < KC * 4 * TJ; e += NT) {
        const int u = e % TJ, g = (e / TJ) % 4, k = e / (4 * TJ);
        ws[k][g][u] = (kc + k < H) ? w_hh[(size_t)(kc + k) * 4 * H + (size_t)g * H + j0 + u] : 0.0f;
      }
      // h_{t-1} rows b0..b0+BT, columns kc..kc+KC, as float4 (H % 4 == 0).
      for (int e = tid; e < BT * (KC / 4); e += NT) {
        const int k4 = e % (KC / 4), b = e / (KC / 4);
        float4 v = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
        if (b0 + b < B && kc + 4 * k4 < H)
          v = *reinterpret_cast<const float4*>(h_prev + (size_t)(b0 + b) * h_stride + kc + 4 * k4);
        *reinterpret_cast<float4*>(&hs[b][4 * k4]) = v;
      }
      __syncthreads();
#pragma unroll 2
      for (int k = ks * (KC / KS); k < (ks + 1) * (KC / KS); k += 4) {
        float4 hv[RB];
#pragma unroll
        for (int r = 0; r < RB; ++r) hv[r] = *reinterpret_cast<const float4*>(&hs[bg * RB + r][k]);
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          float w[4];
#pragma unroll
          for (int g = 0; g < 4; ++g) w[g] = ws[k + kk][g][j];
#pragma unroll
          for (int r = 0; r < RB; ++r) {
            const float h = kk == 0 ? hv[r].x : kk == 1 ? hv[r].y : kk == 2 ? hv[r].z : hv[r].w;
#pragma unroll
            for (int g = 0; g < 4; ++g) acc[r][g] = fmaf(h, w[g], acc[r][g]);
          }
        }
      }
      __syncthreads();
    }
  }

#pragma unroll
  for (int r = 0; r < RB; ++r)
    *reinterpret_cast<float4*>(&red[ks][bg * RB + r][j][0]) =
        make_float4(acc[r][0], acc[r][1], acc[r][2], acc[r][3]);
  __syncthreads();

  // One thread per (batch row, unit): add the KS partial sums, update the cell.
  const int b = tid / TJ, u = tid % TJ;
  const int bb = b0 + b, jj = j0 + u;
  if (bb >= B) return;
  float s[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
  for (int q = 0; q < KS; ++q)
#pragma unroll
    for (int g = 0; g < 4; ++g) s[g] += red[q][b][u][g];
  const float* xp = xproj + ((size_t)bb * T + t) * 4 * H;
  const float gi = xp[jj] + s[0];
  const float gf = xp[H + jj] + s[1];
  const float gg = xp[2 * H + jj] + s[2];
  const float go = xp[3 * H + jj] + s[3];
  const float c = sigmoid(gf) * c_state[(size_t)bb * H + jj] + sigmoid(gi) * tanhf(gg);
  c_state[(size_t)bb * H + jj] = c;
  if (c_seq != nullptr) c_seq[((size_t)bb * T + t) * H + jj] = c;
  h_seq[((size_t)bb * T + t) * H + jj] = sigmoid(go) * tanhf(c);
}

}  // namespace

extern "C" {

// Runs the whole sequence: T launches on `stream`, none synchronising.
// h0 and c_seq may be null; c_state holds c0 on entry and cN on exit.
// Returns 0, or the first CUDA error (cudaGetLastError after each launch).
int autovc_lstm_fwd(const float* xproj, const float* w_hh, const float* h0, float* h_seq,
                    float* c_state, float* c_seq, int B, int T, int H, int reverse,
                    cudaStream_t stream) {
  if (B <= 0 || T <= 0 || H <= 0 || H % TJ != 0) return (int)cudaErrorInvalidValue;
  const dim3 grid(H / TJ, (B + BT - 1) / BT);
  for (int s = 0; s < T; ++s) {
    const int t = reverse ? T - 1 - s : s;
    const int t_prev = reverse ? t + 1 : t - 1;
    const float* h_prev = s == 0 ? h0 : h_seq + (size_t)t_prev * H;
    const size_t h_stride = s == 0 ? (size_t)H : (size_t)T * H;
    lstm_step_kernel<<<grid, NT, 0, stream>>>(xproj, w_hh, h_prev, h_stride, h_seq, c_state, c_seq,
                                              B, T, H, t);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return 0;
}

const char* autovc_cuda_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

}  // extern "C"
