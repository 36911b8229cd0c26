// Autoregressive WaveNet generation, two launches per layer and one per
// sample for the output head.
//
// Replaces the Pallas kernels of autovc_tpu/ops/pallas_wavenet.py reached
// through generate_pallas: _wavenet_kernel (all dilation rings in VMEM) and
// _wavenet_kernel_hybrid (large-dilation rings in HBM through double-buffered
// DMA), with their helpers _begin_sample, _residual_layer, _emit_sample and
// _sample_mol. The TPU split the rings only because 504 slots of (B, R) do
// not fit VMEM at large B; here every ring lives in device memory and one
// kernel set serves every B.
//
// For each sample t (in order) and layer l with dilation d, ring slots
// off_l + (t mod 2d) and off_l + ((t+d) mod 2d) hold x(t-2d) and x(t-d):
//   (a) gate_kernel:  z = tanh(a) * sigmoid(b), [a | b] = [x(t-2d), x(t-d), h,
//       cond_t] @ [w3_l; wcond_l] + bg_l                                (B, G/2)
//   (b) resid_kernel: ring[slot] = h_in;  h = (h_in + z @ wout_l + bo_l) * sqrt(.5)
//                     skip = (skip + z @ wskip_l + bs_l) * sqrt(.5)
// At l = 0 both take h_in = x_prev * fk + fb and (b) takes skip = 0. Then
//   (c) head_kernel:  logits = relu(relu(skip) @ l1k + l1b) @ l2k + l2b, the
//       Gumbel-argmax mixture choice and logistic sample from the caller's
//       uniforms (clipped to [1e-5, 1-1e-5]); writes y[:, t], logits[:, t] and
//       x_prev.
// Float32 throughout; precise logf/expf/log1pf/tanhf (no fast math).
//
// Design. The host loop runs T * (2L + 1) launches on the caller's stream;
// the kernel boundary is the only synchronisation (no grid barrier,
// cooperative launch or spin-wait). (a) reads all of h and both ring slots;
// (b) owns each element of h, skip and the ring slot it writes (one thread
// reads h_in, stores it into the ring and writes h_out), so h and skip are
// updated in place and the ring write cannot race a read of the same layer.
//
// (a) and (b) are the same tiled vector-matrix product. A block owns 8
// output columns (32-byte rows of the weight matrix: whole sectors) for up to
// BT = 8 batch rows; its 256 threads are 2 float4 column groups x 128 slices
// of the K rows. The input rows (B x K) sit in shared memory; each thread
// streams its weight rows straight from device memory and keeps BT x 4 (b) or
// BT x 8 (a: the tanh and the sigmoid column of each pair) sums; warp
// shuffles and a small shared buffer add the 128 slices. (a) has G/2/8
// blocks, (b) (R+S)/8, per batch tile of 8 rows. Each thread stages its
// share of the input rows as float4 loads issued together. (c) is one block
// of 1024 threads per batch row: last1 as S/4 float4 column groups x 16
// slices of its rows, last2 one warp per output, the sampling on one thread.
//
// Bound. Every sample reads all the layer weights once: 24 x 1,025,280 +
// 74,526 floats, 98.7 MB at full width, more than the 50 MB L2, so the run is
// bound by device-memory bytes (29.8 us a sample at 3.35 TB/s); the work is
// 2*B*24.65 M flops a sample (5.9 us at B=8 on the f32 cores). This design
// spends 49 launches a sample, puts 32 (a) and 96 (b) blocks on the card at
// B <= 8 and keeps few loads in flight per SM, so launch gaps and latency,
// not bandwidth, limit it. A persistent kernel that keeps the weights
// streaming across samples, bf16 weights and CUDA graphs are later work.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int BT = 8;          // batch rows per block
constexpr int NT = 256;        // threads per block
constexpr int KG = NT / 2;     // slices of the K rows (2 column groups of 4)
constexpr int NW = NT / 32;    // warps
constexpr int NCOL = 8;        // output columns per block
constexpr int HEAD_NT = 1024;  // threads of the head kernel's block
constexpr float SQRT_HALF = 0.70710678118654752440f;
constexpr float U_MIN = 1e-5f;
constexpr float U_MAX = (float)(1.0 - 1e-5);

__device__ __forceinline__ float sigmoidf_(float x) { return 1.0f / (1.0f + expf(-x)); }

__device__ __forceinline__ float4 load4(const float* p) { return __ldg(reinterpret_cast<const float4*>(p)); }

// Copies rows b0 .. b0+BT of a (B, n) array with row stride ld into
// dst[b * ldd + 0 .. n), zeros for rows past B; n, ld, ldd multiples of 4.
// Each thread issues its SU float4 loads before it stores any, so the loads
// are in flight together.
__device__ __forceinline__ void stage_rows(float* dst, int ldd, const float* __restrict__ src, size_t ld, int n,
                                           int B, int b0) {
  constexpr int SU = 4;
  const int n4 = n / 4, total = BT * n4;
  for (int e0 = threadIdx.x; e0 < total; e0 += NT * SU) {
    float4 v[SU];
#pragma unroll
    for (int u = 0; u < SU; ++u) {
      const int e = e0 + u * NT, b = e / n4;
      v[u] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      if (e < total && b0 + b < B) v[u] = load4(src + (b0 + b) * ld + 4 * (e - b * n4));
    }
#pragma unroll
    for (int u = 0; u < SU; ++u) {
      const int e = e0 + u * NT, b = e / n4;
      if (e < total) *reinterpret_cast<float4*>(dst + b * ldd + 4 * (e - b * n4)) = v[u];
    }
  }
}

// Adds acc over the 16 K slices in each warp (lanes of one column group share
// lane & 1) and writes the warp's sums to red[warp][lane][0..N).
template <int N>
__device__ __forceinline__ void warp_sums(float (&acc)[N], float* red) {
#pragma unroll
  for (int i = 0; i < N; ++i) {
    float v = acc[i];
#pragma unroll
    for (int off = 16; off >= 2; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
    acc[i] = v;
  }
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane < 2) {
#pragma unroll
    for (int i = 0; i < N; ++i) red[(warp * 2 + lane) * N + i] = acc[i];
  }
}

__global__ void __launch_bounds__(NT)
gate_kernel(const float* __restrict__ w3, const float* __restrict__ wcond, const float* __restrict__ bg,
            const float* __restrict__ ring_2d, const float* __restrict__ ring_d,
            const float* __restrict__ h, const float* __restrict__ x_prev,
            const float* __restrict__ fk, const float* __restrict__ fb, int first,
            const float* __restrict__ cond_t, float* __restrict__ z,
            int B, int T, int R, int G, int C) {
  extern __shared__ __align__(16) float xs[];  // [BT][3R + C]
  __shared__ float red[NW * 2 * BT * 8];
  const int K = 3 * R + C, G2 = G / 2;
  const int b0 = blockIdx.y * BT;
  const int tid = threadIdx.x;

  stage_rows(xs, K, ring_2d, R, R, B, b0);
  stage_rows(xs + R, K, ring_d, R, R, B, b0);
  if (first) {
    for (int e = tid; e < BT * R; e += NT) {
      const int b = e / R, k = e - b * R;
      xs[b * K + 2 * R + k] = b0 + b < B ? x_prev[b0 + b] * fk[k] + fb[k] : 0.0f;
    }
  } else {
    stage_rows(xs + 2 * R, K, h, R, R, B, b0);
  }
  stage_rows(xs + 3 * R, K, cond_t, (size_t)T * C, C, B, b0);
  __syncthreads();

  const int tx = tid & 1, ty = tid >> 1;
  const int j = blockIdx.x * NCOL + 4 * tx;  // first of this thread's 4 tanh columns
  float acc[BT * 8];
#pragma unroll
  for (int i = 0; i < BT * 8; ++i) acc[i] = 0.0f;
#pragma unroll 8
  for (int k = ty; k < K; k += KG) {
    const float* row = k < 3 * R ? w3 + (size_t)k * G : wcond + (size_t)(k - 3 * R) * G;
    const float4 wa = load4(row + j), wb = load4(row + G2 + j);
#pragma unroll
    for (int b = 0; b < BT; ++b) {
      const float x = xs[b * K + k];
      acc[b * 8 + 0] = fmaf(x, wa.x, acc[b * 8 + 0]);
      acc[b * 8 + 1] = fmaf(x, wa.y, acc[b * 8 + 1]);
      acc[b * 8 + 2] = fmaf(x, wa.z, acc[b * 8 + 2]);
      acc[b * 8 + 3] = fmaf(x, wa.w, acc[b * 8 + 3]);
      acc[b * 8 + 4] = fmaf(x, wb.x, acc[b * 8 + 4]);
      acc[b * 8 + 5] = fmaf(x, wb.y, acc[b * 8 + 5]);
      acc[b * 8 + 6] = fmaf(x, wb.z, acc[b * 8 + 6]);
      acc[b * 8 + 7] = fmaf(x, wb.w, acc[b * 8 + 7]);
    }
  }
  warp_sums(acc, red);
  __syncthreads();

  if (tid < BT * NCOL) {
    const int b = tid / NCOL, c = tid % NCOL, bb = b0 + b;
    const int col = blockIdx.x * NCOL + c, g = c / 4, i = b * 8 + c % 4;
    float a = 0.0f, s = 0.0f;
    for (int w = 0; w < NW; ++w) {
      a += red[(w * 2 + g) * BT * 8 + i];
      s += red[(w * 2 + g) * BT * 8 + i + 4];
    }
    if (bb < B) z[(size_t)bb * G2 + col] = tanhf(a + bg[col]) * sigmoidf_(s + bg[G2 + col]);
  }
}

__global__ void __launch_bounds__(NT)
resid_kernel(const float* __restrict__ z, const float* __restrict__ wout, const float* __restrict__ wskip,
             const float* __restrict__ bo, const float* __restrict__ bs,
             float* __restrict__ h, float* __restrict__ skip, float* __restrict__ ring_slot,
             const float* __restrict__ x_prev, const float* __restrict__ fk, const float* __restrict__ fb,
             int first, int B, int R, int G2, int S) {
  extern __shared__ __align__(16) float zs[];  // [BT][G/2]
  __shared__ float red[NW * 2 * BT * 4];
  const int b0 = blockIdx.y * BT;
  const int tid = threadIdx.x;
  stage_rows(zs, G2, z, G2, G2, B, b0);
  __syncthreads();

  const int n0 = blockIdx.x * NCOL;
  const bool is_out = n0 < R;  // R % 8 == 0: a block is all wout or all wskip
  const float* w = is_out ? wout + n0 : wskip + (n0 - R);
  const int ld = is_out ? R : S;
  const int tx = tid & 1, ty = tid >> 1;
  float acc[BT * 4];
#pragma unroll
  for (int i = 0; i < BT * 4; ++i) acc[i] = 0.0f;
#pragma unroll 4
  for (int k = ty; k < G2; k += KG) {
    const float4 wv = load4(w + (size_t)k * ld + 4 * tx);
#pragma unroll
    for (int b = 0; b < BT; ++b) {
      const float x = zs[b * G2 + k];
      acc[b * 4 + 0] = fmaf(x, wv.x, acc[b * 4 + 0]);
      acc[b * 4 + 1] = fmaf(x, wv.y, acc[b * 4 + 1]);
      acc[b * 4 + 2] = fmaf(x, wv.z, acc[b * 4 + 2]);
      acc[b * 4 + 3] = fmaf(x, wv.w, acc[b * 4 + 3]);
    }
  }
  warp_sums(acc, red);
  __syncthreads();

  if (tid < BT * NCOL) {
    const int b = tid / NCOL, c = tid % NCOL, bb = b0 + b;
    const int g = c / 4, i = b * 4 + c % 4;
    float sum = 0.0f;
    for (int wp = 0; wp < NW; ++wp) sum += red[(wp * 2 + g) * BT * 4 + i];
    if (bb >= B) return;
    const int n = n0 + c;
    if (is_out) {
      const size_t e = (size_t)bb * R + n;
      const float h_in = first ? x_prev[bb] * fk[n] + fb[n] : h[e];
      ring_slot[e] = h_in;  // the layer input, into the slot x(t-2d) was read from
      h[e] = (h_in + (sum + bo[n])) * SQRT_HALF;
    } else {
      const int sc = n - R;
      const size_t e = (size_t)bb * S + sc;
      const float s_in = first ? 0.0f : skip[e];
      skip[e] = (s_in + (sum + bs[sc])) * SQRT_HALF;
    }
  }
}

__global__ void __launch_bounds__(HEAD_NT)
head_kernel(const float* __restrict__ skip, const float* __restrict__ l1k, const float* __restrict__ l1b,
            const float* __restrict__ l2k, const float* __restrict__ l2b, const float* __restrict__ unif_t,
            float* __restrict__ y_t, float* __restrict__ logits_t, float* __restrict__ x_prev,
            int T, int S, int NOUT, float log_scale_min) {
  extern __shared__ float sm[];  // sk[S], o1[S], lg[NOUT]
  __shared__ __align__(16) float red[4 * HEAD_NT];  // [KS][S] partial sums of last1
  float* sk = sm;
  float* o1 = sm + S;
  float* lg = sm + 2 * S;
  const int b = blockIdx.x, tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;

  for (int j = tid; j < S; j += HEAD_NT) sk[j] = fmaxf(skip[(size_t)b * S + j], 0.0f);
  __syncthreads();
  // last1: S/4 float4 column groups x KS slices of the S rows (S <= 4 * HEAD_NT).
  const int s4 = S / 4, ks_n = HEAD_NT / s4;
  const int cg = tid % s4, ks = tid / s4;
  if (ks < ks_n) {
    float4 a = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
#pragma unroll 8
    for (int k = ks; k < S; k += ks_n) {
      const float x = sk[k];
      const float4 w = load4(l1k + (size_t)k * S + 4 * cg);
      a.x = fmaf(x, w.x, a.x); a.y = fmaf(x, w.y, a.y); a.z = fmaf(x, w.z, a.z); a.w = fmaf(x, w.w, a.w);
    }
    *reinterpret_cast<float4*>(&red[ks * S + 4 * cg]) = a;
  }
  __syncthreads();
  for (int j = tid; j < S; j += HEAD_NT) {
    float a = 0.0f;
    for (int q = 0; q < ks_n; ++q) a += red[q * S + j];
    o1[j] = fmaxf(a + l1b[j], 0.0f);
  }
  __syncthreads();
  for (int j = warp; j < NOUT; j += HEAD_NT / 32) {
    float a = 0.0f;
    for (int k = lane; k < S; k += 32) a = fmaf(o1[k], l2k[(size_t)k * NOUT + j], a);
#pragma unroll
    for (int off = 16; off >= 1; off >>= 1) a += __shfl_xor_sync(0xffffffffu, a, off);
    if (lane == 0) {
      lg[j] = a + l2b[j];
      logits_t[(size_t)b * T * NOUT + j] = lg[j];
    }
  }
  __syncthreads();

  if (tid == 0) {
    const int K = NOUT / 3;
    const float* u = unif_t + (size_t)b * T * (K + 1);
    int best = 0;
    float best_v = 0.0f;
    for (int i = 0; i < K; ++i) {
      const float ui = fminf(fmaxf(u[i], U_MIN), U_MAX);
      const float v = lg[i] - logf(-logf(ui));
      if (i == 0 || v > best_v) {  // ties keep the first index, as argmax does
        best = i;
        best_v = v;
      }
    }
    const float ux = fminf(fmaxf(u[K], U_MIN), U_MAX);
    const float log_s = fmaxf(lg[2 * K + best], log_scale_min);
    float x = lg[K + best] + expf(log_s) * (logf(ux) - log1pf(-ux));
    x = x < -1.0f ? -1.0f : (x > 1.0f ? 1.0f : x);  // keeps a NaN, as clip does
    y_t[(size_t)b * T] = x;
    x_prev[b] = x;
  }
}

}  // namespace

extern "C" {

// Generates T samples for B rows: T * (2L + 1) launches on `stream`, none
// synchronising; *n_launched gets the count. ring (sum 2d, B, R), h (B, R),
// skip (B, S), z (B, G/2) and x_prev (B,) are the caller's scratch; ring and
// x_prev must be zero. cond (B, T, C), unif (B, T, K+1), y (B, T) and logits
// (B, T, 3K) are contiguous; dils is a host array of L dilations.
// Returns 0, or the first CUDA error (cudaGetLastError after each launch).
int autovc_wavenet_gen(const float* w3, const float* wcond, const float* wout, const float* wskip,
                       const float* bg, const float* bo, const float* bs, const float* fk, const float* fb,
                       const float* l1k, const float* l1b, const float* l2k, const float* l2b,
                       const float* cond, const float* unif, float* y, float* logits,
                       float* ring, float* h, float* skip, float* z, float* x_prev,
                       const int* dils, int L, int B, int T, int R, int G, int S, int C, int NOUT,
                       float log_scale_min, long long* n_launched, cudaStream_t stream) {
  *n_launched = 0;
  if (L <= 0 || B <= 0 || T <= 0 || G % 16 || R % 8 || S % 8 || C % 4 || S > 4 * HEAD_NT || NOUT % 3 || NOUT <= 0)
    return (int)cudaErrorInvalidValue;
  const int G2 = G / 2, K = NOUT / 3;
  const size_t gate_smem = sizeof(float) * BT * (3 * R + C);
  const size_t resid_smem = sizeof(float) * BT * G2;
  const size_t head_smem = sizeof(float) * (2 * S + NOUT);
  cudaError_t err;
  if (gate_smem > 48 * 1024) {
    err = cudaFuncSetAttribute(gate_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)gate_smem);
    if (err != cudaSuccess) return (int)err;
  }
  if (resid_smem > 48 * 1024) {
    err = cudaFuncSetAttribute(resid_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)resid_smem);
    if (err != cudaSuccess) return (int)err;
  }
  if (L > 256) return (int)cudaErrorInvalidValue;
  int offsets[256];
  for (int l = 0, off = 0; l < L; ++l) {
    if (dils[l] < 1) return (int)cudaErrorInvalidValue;
    offsets[l] = off;
    off += 2 * dils[l];
  }
  const int b_tiles = (B + BT - 1) / BT;
  const dim3 gate_grid(G2 / NCOL, b_tiles), resid_grid((R + S) / NCOL, b_tiles);
  const size_t slot_elems = (size_t)B * R;
  long long count = 0;
  for (int t = 0; t < T; ++t) {
    for (int l = 0; l < L; ++l) {
      const int d = dils[l];
      const float* ring_2d = ring + (offsets[l] + t % (2 * d)) * slot_elems;
      const float* ring_d = ring + (offsets[l] + (t + d) % (2 * d)) * slot_elems;
      gate_kernel<<<gate_grid, NT, gate_smem, stream>>>(
          w3 + (size_t)l * 3 * R * G, wcond + (size_t)l * C * G, bg + (size_t)l * G, ring_2d, ring_d,
          h, x_prev, fk, fb, l == 0, cond + (size_t)t * C, z, B, T, R, G, C);
      if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
      resid_kernel<<<resid_grid, NT, resid_smem, stream>>>(
          z, wout + (size_t)l * G2 * R, wskip + (size_t)l * G2 * S, bo + (size_t)l * R, bs + (size_t)l * S,
          h, skip, ring + (offsets[l] + t % (2 * d)) * slot_elems, x_prev, fk, fb, l == 0, B, R, G2, S);
      if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
      count += 2;
    }
    head_kernel<<<B, HEAD_NT, head_smem, stream>>>(skip, l1k, l1b, l2k, l2b, unif + (size_t)t * (K + 1), y + t,
                                              logits + (size_t)t * NOUT, x_prev, T, S, NOUT, log_scale_min);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
    count += 1;
    *n_launched = count;
  }
  return 0;
}

const char* autovc_cuda_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

}  // extern "C"
