// Backward of the LSTM recurrence over hoisted input projections, one launch
// per reversed time step, and the recurrent weight gradient as a tiled SGEMM.
//
// Replaces the backward Pallas kernels of autovc_tpu/ops/pallas_lstm.py:
//   _chunk_bwd_call (-> _lstm_bwd_kernel, dW_hh accumulated on-chip) and
//   _split_bwd_rule (-> _lstm_bwd_kernel_split, dW as one matmul outside).
// The TPU split the gates only because a (H, 4H) f32 w_hh of 16 MB at H=1024
// does not fit its VMEM; here one kernel set serves every H.
//
// Inputs are the forward's (csrc/lstm_fwd.cu, training form): xproj (B, T, 4H),
// w_hh (H, 4H) row-major, h0/c0 (B, H) or null (zero), h_seq and c_seq
// (B, T, H), and the cotangents dy (B, T, H), dhN (B, H) or null. Walking
// the steps in the reverse of the forward's order (t = T-1 .. 0, or 0 .. T-1
// for reverse=1, whose forward ran right to left), step t computes, in float32:
//   hprev, cprev = h_seq/c_seq at the step the forward took before t (or h0/c0)
//   gates = xproj[:, t] + hprev @ w_hh            (recomputed, gate order i,f,g,o)
//   dh = dy[:, t] + (dgates_{t_next} @ w_hh^T, or dhN at the first step taken)
//   do = dh * tanh(c_t) * so * (1 - so)
//   dc = dc + dh * so * (1 - tanh(c_t)^2)
//   di = dc * tg * si * (1 - si);  dg = dc * si * (1 - tg^2);  df = dc * cprev * sf * (1 - sf)
//   dxproj[:, t] = [di, df, dg, do];  dc = dc * sf
// the formulas of pallas_lstm.py:438-453. A last launch forms
// dh0 = dgates_{last} @ w_hh^T; dc0 is the carried dc. Then
//   dW[k, g] = sum over (b, t) of hprev[b, t, k] * dxproj[b, t, g]
// is a separate kernel over the whole sequence (K = B*T).
//
// Design. As in the forward kernel: one launch per step on the caller's
// stream, the kernel boundary the only synchronisation between steps (no grid
// barrier, no cooperative launch, no spin-wait), cudaGetLastError after every
// launch. The dgates of step t_next live in dxproj itself, so dgates is
// double-buffered by the sequence as h is in the forward. Each block owns TJ
// hidden units j for BT batch rows and computes (1) the gate recompute, the
// forward's dot products of length H against columns g*H + j of w_hh, and (2)
// the dh contraction, a dot product of length 4H of dgates_{t_next} against
// row j of w_hh (read contiguously), both staged through shared memory; then
// (3) one thread per (b, j) applies the cell gradient and updates dc in place,
// which only it reads and writes. The weight gradient is a 64x64-tile SGEMM
// whose loader builds hprev's rows from h_seq and h0, so no shifted copy of
// h_seq is made; the reverse direction is walked left to right in place,
// never flipped by a copy.
//
// Bound. Per step the blocks together read w_hh twice (once as columns for
// the recompute, once as rows for dh: 32 MB at H=1024, resident in the 50 MB
// L2 across steps) and do 16*B*H^2 flops on the f32 CUDA cores; dW is
// 8*B*T*H^2 flops. At B=7 the step work is microseconds, so a step is bound
// by its launch and the L2 reads, as the forward's; the per-sequence minimum
// the card allows is the larger of the flops at 67 TFLOP/s and the bytes
// (xproj, h_seq, c_seq, c_prev, dy and w_hh read once, dxproj and dW written
// once) at 3.35 TB/s. Tensor cores, a persistent kernel and CUDA graphs are
// later work, to be measured against these numbers.

#include <cuda_runtime.h>

namespace {

constexpr int TJ = 8;    // hidden units per block
constexpr int BT = 32;   // batch rows per block
constexpr int RB = 4;    // batch rows per thread
constexpr int KS = 4;    // ways each reduction is split among threads
constexpr int KC = 64;   // reduction columns staged per tile
constexpr int NT = TJ * (BT / RB) * KS;  // 256 threads
constexpr int HS = KC + 4;               // tile row stride (keeps float4 alignment)

static_assert(NT == 256, "thread layout");
static_assert((KC / KS) % 4 == 0, "inner loops step by 4");

__device__ __forceinline__ float sigmoid(float x) { return 1.0f / (1.0f + expf(-x)); }

struct Tiles {
  float ws[KC][4][TJ];  // w_hh rows kc.., columns g*H + j0 + u: [k][gate][unit]
  float rows[BT][HS];   // h_{t-1} or dgates_{t_next} tile: [batch][k]
  float wr[TJ][HS];     // w_hh rows j0 + u, columns kc..: [unit][k]
};

// Thread's partial gate preactivations: acc[r][g] += sum over its k slice of
// h_prev[b0 + bg*RB + r, k] * w_hh[k, g*H + j0 + j]. h_prev row b is at
// h_prev + b * h_stride.
__device__ __forceinline__ void gate_products(float (&acc)[RB][4], Tiles& sm, const float* __restrict__ w_hh,
                                              const float* h_prev, size_t h_stride, int B, int H, int b0,
                                              int j0, int j, int bg, int ks) {
  const int tid = threadIdx.x;
  for (int kc = 0; kc < H; kc += KC) {
    for (int e = tid; e < KC * 4 * TJ; e += NT) {
      const int u = e % TJ, g = (e / TJ) % 4, k = e / (4 * TJ);
      sm.ws[k][g][u] = (kc + k < H) ? w_hh[(size_t)(kc + k) * 4 * H + (size_t)g * H + j0 + u] : 0.0f;
    }
    for (int e = tid; e < BT * (KC / 4); e += NT) {
      const int k4 = e % (KC / 4), b = e / (KC / 4);
      float4 v = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      if (b0 + b < B && kc + 4 * k4 < H)
        v = *reinterpret_cast<const float4*>(h_prev + (size_t)(b0 + b) * h_stride + kc + 4 * k4);
      *reinterpret_cast<float4*>(&sm.rows[b][4 * k4]) = v;
    }
    __syncthreads();
    for (int k = ks * (KC / KS); k < (ks + 1) * (KC / KS); k += 4) {
      float4 hv[RB];
#pragma unroll
      for (int r = 0; r < RB; ++r) hv[r] = *reinterpret_cast<const float4*>(&sm.rows[bg * RB + r][k]);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        float w[4];
#pragma unroll
        for (int g = 0; g < 4; ++g) w[g] = sm.ws[k + kk][g][j];
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

// Thread's partial dh: acc[r] += sum over its k slice of
// dg[b0 + bg*RB + r, k] * w_hh[j0 + j, k], k over 4H. dg row b is at
// dg + b * dg_stride.
__device__ __forceinline__ void dh_products(float (&acc)[RB], Tiles& sm, const float* __restrict__ w_hh,
                                            const float* dg, size_t dg_stride, int B, int H, int b0, int j0,
                                            int j, int bg, int ks) {
  const int tid = threadIdx.x;
  const int H4 = 4 * H;
  for (int kc = 0; kc < H4; kc += KC) {
    for (int e = tid; e < TJ * (KC / 4); e += NT) {
      const int k4 = e % (KC / 4), u = e / (KC / 4);
      float4 v = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      if (kc + 4 * k4 < H4) v = *reinterpret_cast<const float4*>(w_hh + (size_t)(j0 + u) * H4 + kc + 4 * k4);
      *reinterpret_cast<float4*>(&sm.wr[u][4 * k4]) = v;
    }
    for (int e = tid; e < BT * (KC / 4); e += NT) {
      const int k4 = e % (KC / 4), b = e / (KC / 4);
      float4 v = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      if (b0 + b < B && kc + 4 * k4 < H4)
        v = *reinterpret_cast<const float4*>(dg + (size_t)(b0 + b) * dg_stride + kc + 4 * k4);
      *reinterpret_cast<float4*>(&sm.rows[b][4 * k4]) = v;
    }
    __syncthreads();
    for (int k = ks * (KC / KS); k < (ks + 1) * (KC / KS); k += 4) {
      const float4 w = *reinterpret_cast<const float4*>(&sm.wr[j][k]);
#pragma unroll
      for (int r = 0; r < RB; ++r) {
        const float4 d = *reinterpret_cast<const float4*>(&sm.rows[bg * RB + r][k]);
        acc[r] = fmaf(d.x, w.x, acc[r]);
        acc[r] = fmaf(d.y, w.y, acc[r]);
        acc[r] = fmaf(d.z, w.z, acc[r]);
        acc[r] = fmaf(d.w, w.w, acc[r]);
      }
    }
    __syncthreads();
  }
}

__global__ void __launch_bounds__(NT)
lstm_bwd_step_kernel(const float* __restrict__ xproj, const float* __restrict__ w_hh,
                     const float* h_prev, size_t h_stride, const float* c_prev, size_t c_stride,
                     const float* __restrict__ c_seq, const float* __restrict__ dy,
                     const float* __restrict__ dh_first, float* dxproj, float* __restrict__ dc_state,
                     int B, int T, int H, int t, int t_next) {
  // h_prev/c_prev: rows of the state before step t (null: zero). t_next < 0
  // marks the first step taken, whose dh carry is dh_first (null: zero);
  // otherwise the carry is dxproj[:, t_next] @ w_hh^T. dxproj is read at
  // t_next and written at t, so it is not __restrict__.
  __shared__ __align__(16) Tiles sm;
  __shared__ __align__(16) float red[KS][BT][TJ][4];
  __shared__ float red_dh[KS][BT][TJ];

  const int tid = threadIdx.x;
  const int j = tid % TJ;
  const int bg = (tid / TJ) % (BT / RB);
  const int ks = tid / (TJ * (BT / RB));
  const int j0 = blockIdx.x * TJ;
  const int b0 = blockIdx.y * BT;
  const size_t H4 = 4 * (size_t)H;

  float acc[RB][4];
  float acc_dh[RB];
#pragma unroll
  for (int r = 0; r < RB; ++r) {
    acc_dh[r] = 0.0f;
#pragma unroll
    for (int g = 0; g < 4; ++g) acc[r][g] = 0.0f;
  }
  if (h_prev != nullptr) gate_products(acc, sm, w_hh, h_prev, h_stride, B, H, b0, j0, j, bg, ks);
  if (t_next >= 0) dh_products(acc_dh, sm, w_hh, dxproj + (size_t)t_next * H4, T * H4, B, H, b0, j0, j, bg, ks);

#pragma unroll
  for (int r = 0; r < RB; ++r) {
    *reinterpret_cast<float4*>(&red[ks][bg * RB + r][j][0]) =
        make_float4(acc[r][0], acc[r][1], acc[r][2], acc[r][3]);
    red_dh[ks][bg * RB + r][j] = acc_dh[r];
  }
  __syncthreads();

  // One thread per (batch row, unit): add the KS partial sums, apply the cell
  // gradient.
  const int b = tid / TJ, u = tid % TJ;
  const int bb = b0 + b, jj = j0 + u;
  if (bb >= B) return;
  float s[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  float carry = 0.0f;
#pragma unroll
  for (int q = 0; q < KS; ++q) {
#pragma unroll
    for (int g = 0; g < 4; ++g) s[g] += red[q][b][u][g];
    carry += red_dh[q][b][u];
  }
  if (t_next < 0) carry = dh_first != nullptr ? dh_first[(size_t)bb * H + jj] : 0.0f;
  const size_t row = (size_t)bb * T + t;
  const float* xp = xproj + row * H4;
  const float si = sigmoid(xp[jj] + s[0]);
  const float sf = sigmoid(xp[H + jj] + s[1]);
  const float tg = tanhf(xp[2 * H + jj] + s[2]);
  const float so = sigmoid(xp[3 * H + jj] + s[3]);
  const float tc = tanhf(c_seq[row * H + jj]);
  const float cp = c_prev != nullptr ? c_prev[(size_t)bb * c_stride + jj] : 0.0f;

  const float dh = dy[row * H + jj] + carry;
  const float d_o = dh * tc * so * (1.0f - so);
  const float dc = dc_state[(size_t)bb * H + jj] + dh * so * (1.0f - tc * tc);
  const float di = dc * tg * si * (1.0f - si);
  const float dg = dc * si * (1.0f - tg * tg);
  const float df = dc * cp * sf * (1.0f - sf);
  float* dx = dxproj + row * H4;
  dx[jj] = di;
  dx[H + jj] = df;
  dx[2 * H + jj] = dg;
  dx[3 * H + jj] = d_o;
  dc_state[(size_t)bb * H + jj] = dc * sf;
}

// dh_out[b, j] = sum_k dg[b, k] * w_hh[j, k], k over 4H (dh0 after the last step).
__global__ void __launch_bounds__(NT)
lstm_dh_kernel(const float* __restrict__ w_hh, const float* __restrict__ dg, size_t dg_stride,
               float* __restrict__ dh_out, int B, int H) {
  __shared__ __align__(16) Tiles sm;
  __shared__ float red_dh[KS][BT][TJ];
  const int tid = threadIdx.x;
  const int j = tid % TJ;
  const int bg = (tid / TJ) % (BT / RB);
  const int ks = tid / (TJ * (BT / RB));
  const int j0 = blockIdx.x * TJ;
  const int b0 = blockIdx.y * BT;
  float acc[RB] = {0.0f, 0.0f, 0.0f, 0.0f};
  dh_products(acc, sm, w_hh, dg, dg_stride, B, H, b0, j0, j, bg, ks);
#pragma unroll
  for (int r = 0; r < RB; ++r) red_dh[ks][bg * RB + r][j] = acc[r];
  __syncthreads();
  const int b = tid / TJ, u = tid % TJ;
  if (b0 + b >= B) return;
  float s = 0.0f;
#pragma unroll
  for (int q = 0; q < KS; ++q) s += red_dh[q][b][u];
  dh_out[(size_t)(b0 + b) * H + j0 + u] = s;
}

constexpr int GM = 64;  // dW rows (k of w_hh) per block
constexpr int GN = 64;  // dW columns (gate units) per block
constexpr int GK = 16;  // (b, t) rows staged per tile
static_assert(GK * GM / 4 == NT && GK * GN / 4 == NT, "one float4 per thread per tile");

// dW (H, 4H) = hprev^T @ dxproj over the K = B*T rows (b, t); hprev row
// (b, t) is h_seq[b, t-1] (t+1 for reverse), or h0[b] (zero if null) at the
// sequence's start. Each thread accumulates a 4x4 block of dW.
__global__ void __launch_bounds__(NT)
lstm_dw_kernel(const float* __restrict__ h_seq, const float* __restrict__ h0,
               const float* __restrict__ dxproj, float* __restrict__ dw, int B, int T, int H,
               int reverse) {
  __shared__ __align__(16) float as[GK][GM + 4];
  __shared__ __align__(16) float gs[GK][GN + 4];
  const int tid = threadIdx.x;
  const int tx = tid % (GN / 4), ty = tid / (GN / 4);
  const int m0 = blockIdx.y * GM, n0 = blockIdx.x * GN;
  const int H4 = 4 * H;
  const long K = (long)B * T;
  float acc[4][4] = {};
  const int lk = tid / (GM / 4), l4 = tid % (GM / 4);  // this thread's tile load
  for (long k0 = 0; k0 < K; k0 += GK) {
    const long r = k0 + lk;
    float4 a = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    float4 g = a;
    if (r < K) {
      const int b = (int)(r / T), t = (int)(r % T);
      const int tp = reverse ? t + 1 : t - 1;
      const float* hrow = (tp < 0 || tp >= T) ? (h0 != nullptr ? h0 + (size_t)b * H : nullptr)
                                              : h_seq + ((size_t)b * T + tp) * H;
      if (hrow != nullptr && m0 + 4 * l4 < H) a = *reinterpret_cast<const float4*>(hrow + m0 + 4 * l4);
      if (n0 + 4 * l4 < H4) g = *reinterpret_cast<const float4*>(dxproj + (size_t)r * H4 + n0 + 4 * l4);
    }
    *reinterpret_cast<float4*>(&as[lk][4 * l4]) = a;
    *reinterpret_cast<float4*>(&gs[lk][4 * l4]) = g;
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < GK; ++kk) {
      const float4 av = *reinterpret_cast<const float4*>(&as[kk][4 * ty]);
      const float4 gv = *reinterpret_cast<const float4*>(&gs[kk][4 * tx]);
      const float ar[4] = {av.x, av.y, av.z, av.w};
      const float gr[4] = {gv.x, gv.y, gv.z, gv.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[i][q] = fmaf(ar[i], gr[q], acc[i][q]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = m0 + 4 * ty + i;
    if (m >= H) continue;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int n = n0 + 4 * tx + q;
      if (n < H4) dw[(size_t)m * H4 + n] = acc[i][q];
    }
  }
}

}  // namespace

extern "C" {

// The backward over the whole sequence: T step launches and one dh0 launch on
// `stream`, none synchronising. h0, c0 and dhn may be null (zero); dc_state
// holds dcN on entry (the caller zeroes it for a zero cotangent) and dc0 on
// exit; dh0 may be null (not wanted). Returns 0, or the first CUDA error
// (cudaGetLastError after each launch).
int autovc_lstm_bwd(const float* xproj, const float* w_hh, const float* h0, const float* c0,
                    const float* h_seq, const float* c_seq, const float* dy, const float* dhn,
                    float* dxproj, float* dc_state, float* dh0, int B, int T, int H, int reverse,
                    cudaStream_t stream) {
  if (B <= 0 || T <= 0 || H <= 0 || H % TJ != 0) return (int)cudaErrorInvalidValue;
  const dim3 grid(H / TJ, (B + BT - 1) / BT);
  const size_t H4 = 4 * (size_t)H;
  for (int s = 0; s < T; ++s) {
    const int t = reverse ? s : T - 1 - s;
    const int t_next = s == 0 ? -1 : (reverse ? t - 1 : t + 1);
    const int t_prev = reverse ? t + 1 : t - 1;
    const bool start = t_prev < 0 || t_prev >= T;
    const float* h_prev = start ? h0 : h_seq + (size_t)t_prev * H;
    const float* c_prev = start ? c0 : c_seq + (size_t)t_prev * H;
    const size_t stride = start ? (size_t)H : (size_t)T * H;
    lstm_bwd_step_kernel<<<grid, NT, 0, stream>>>(xproj, w_hh, h_prev, stride, c_prev, stride, c_seq, dy,
                                                  dhn, dxproj, dc_state, B, T, H, t, t_next);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  if (dh0 != nullptr) {
    const int t_last = reverse ? T - 1 : 0;
    lstm_dh_kernel<<<grid, NT, 0, stream>>>(w_hh, dxproj + (size_t)t_last * H4, (size_t)T * H4, dh0, B, H);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return 0;
}

// dW (H, 4H) = hprev^T @ dxproj over all (b, t), one launch. h0 may be null.
int autovc_lstm_dw(const float* h_seq, const float* h0, const float* dxproj, float* dw, int B, int T,
                   int H, int reverse, cudaStream_t stream) {
  if (B <= 0 || T <= 0 || H <= 0 || H % TJ != 0) return (int)cudaErrorInvalidValue;
  const dim3 grid((4 * H + GN - 1) / GN, (H + GM - 1) / GM);
  lstm_dw_kernel<<<grid, NT, 0, stream>>>(h_seq, h0, dxproj, dw, B, T, H, reverse);
  return (int)cudaGetLastError();
}

const char* autovc_cuda_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

}  // extern "C"
