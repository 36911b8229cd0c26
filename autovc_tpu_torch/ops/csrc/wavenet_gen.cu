// Autoregressive WaveNet generation: one persistent cooperative launch per
// call, every sample and layer inside it, one grid barrier a layer.
//
// Replaces the Pallas kernels of autovc_tpu/ops/pallas_wavenet.py reached
// through generate_pallas: _wavenet_kernel (all dilation rings in VMEM) and
// _wavenet_kernel_hybrid (large-dilation rings in HBM through double-buffered
// DMA), with their helpers _begin_sample, _residual_layer, _emit_sample and
// _sample_mol. The TPU split the rings only because 504 slots of (B, R) do
// not fit VMEM at large B; here every ring lives in device memory and one
// kernel serves every B.
//
// For each sample t (in order) and layer l with dilation d, ring slots
// off_l + (t mod 2d) and off_l + ((t+d) mod 2d) hold x(t-2d) and x(t-d):
//   gate:     z = tanh(a) * sigmoid(b), [a | b] = [x(t-2d), x(t-d), h, cond_t]
//             @ [w3_l; wcond_l] + bg_l                                  (B, G/2)
//   residual: ring[slot t mod 2d] = h_in;  h = (h_in + z @ wout_l + bo_l) * sqrt(.5)
//             skip = (skip + z @ wskip_l + bs_l) * sqrt(.5)
// At l = 0, h_in = x_prev * fk + fb and skip = 0. Then the head:
//   logits = relu(relu(skip) @ l1k + l1b) @ l2k + l2b, the Gumbel-argmax
//   mixture choice and logistic sample from the caller's uniforms (clipped
//   to [1e-5, 1-1e-5]); y[:, t], logits[:, t] and x_prev.
// Float32 throughout; precise logf/expf/log1pf/tanhf (no fast math).
//
// Bound. Every sample reads all the layer weights once: 24 x 1,025,280 +
// 74,526 floats, 98.7 MB at full width, more than the 50 MB L2, so the run is
// bound by device-memory bytes (29.8 us a sample at 3.35 TB/s); the work is
// 2*B*24.65 M flops a sample (5.9 us at B=8 on the f32 cores). This kernel
// streams 122 MB a sample (25 phase slots of 38 KB for 128 blocks: the
// folded rows below and the padding to 4 columns).
//
// Design. The TPU kernel is persistent: its grid (T, L) walks the samples
// and layers in order and double-buffers layer l+1's weights against layer
// l's compute. So does this kernel, with a grid barrier in place of the
// TPU's sequential grid. The plan (ops/wavenet.py:generate_plan) puts one
// block on each of up to `blocks` SMs, launched with
// cudaLaunchCooperativeKernel after an occupancy check (coop.cuh). Each
// block owns, for the whole launch, `pairs` tanh/sigmoid column pairs of
// the gate, `cols` columns of [wout | wskip] and `head_cols` columns of
// last1; at full width on 128 blocks 2, 6 and 2 (a block past the end owns
// none, and still meets every barrier).
//
// One barrier a layer. Every block needs all of h_l for its gate columns of
// layer l, and h_l = (h_{l-1} + z_{l-1} @ wout_{l-1} + bo_{l-1}) * sqrt(.5)
// is spread over the blocks' residual columns, which would cost a barrier
// between the residual update and the gate. The wrapper folds that update
// into the gate's weights instead (ops/wavenet.py:kernel_weights, products
// of weights in float64, rounded once): the gate of layer l takes
// [x(t-2d), x(t-d), h_{l-1}, z_{l-1}, cond_t], so phase p of a sample runs
// the residual update of layer p - 1 (its h and skip columns, the layer's
// input into ring slot t mod 2d) and the gate of layer p from one staged
// row, and ends at one grid barrier; h and z alternate between two buffers,
// a phase reading one and writing the other. Phase L runs the last
// residual update, then last1 is split over the blocks' head columns (one
// more barrier); last2 and the sampling run in every block on the same
// inputs in the same order, so each block holds the same x_prev without
// another barrier, and block 0 writes y and the logits. L + 2 barriers a
// sample (a gate and a residual barrier a layer would take 2L + 1).
//
// Weights. A block's slices of a phase's weights and biases (38 KB at full
// width), laid out by the wrapper as one contiguous run a (phase, block),
// stream into a ring of `depth` phase slots in shared memory, one bulk copy
// (the TMA engine) a slot, awaited on the slot's mbarrier: the copy of
// phase g - 1 + depth is issued as phase g begins, into phase g - 1's slot,
// across samples, since the weights do not depend on the data. (Issued just
// before a grid barrier instead, the copies made that barrier 1.2-1.5 us
// slower on an H100.) The weight bytes flow behind the barriers, not in the
// chain of them, and no bias is fetched from device memory after a barrier.
//
// Batch. Tiles of 8 batch rows loop inside a phase with the weights already
// in shared memory, so the weights are read once a sample whatever B is;
// the next tile's rows are loaded into registers while the current tile is
// multiplied. Within a phase the block's threads split the K rows of the
// weight slice, each multiplying a weight row by all the tile's batch rows
// (tile_dot); the lane sums are added by xor shuffles and the warps' through
// shared memory, in a fixed order, and no float is added atomically, so a
// call's waveform is the same on every run.
//
// Ordering. Rows that another block wrote during the launch (the rings, h,
// skip, z and last1's output) are read with ld.global.cg, through L2, never
// through L1 or the non-coherent path; only the weights (bulk copies,
// __ldg), cond and the uniforms, which no block writes, take those. A weight
// slot is awaited with mbarrier.try_wait on its own copy, the hardware's
// wait for the TMA engine, not on another block. Phase p writes ring slot
// t mod 2d of layer p - 1, which phase p - 1 read as x(t-2d); at d = 1 the
// slot x(t-d) of the next sample is the one just written; h and z of phase
// p are read in phase p + 1: every such order holds across a grid barrier.

#include <cuda_bf16.h>
#include <math.h>

#include "coop.cuh"
#include "scan_round.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int NT = 256;       // threads per block
constexpr int BT = NT / 32;   // batch rows a tile: one per warp
constexpr int MAXC = 8;       // columns a block owns in one phase, at most
constexpr int MAX_DEPTH = 4;  // phase slots of the weight ring, at most
constexpr int MAX_L = 64;     // layers
constexpr float SQRT_HALF = 0.70710678118654752440f;
constexpr float U_MIN = 1e-5f;
constexpr float U_MAX = (float)(1.0 - 1e-5);

struct Args {
  const float *slices, *fk, *fb, *l1k, *l1b, *l2k, *l2b;
  const float *cond, *unif;
  float *y, *logits, *ring, *h, *skip, *z, *o1;
  int L, B, T, R, G2, S, C, NOUT;
  int pairs, cols, head_cols, depth;
  float log_scale_min;
  int dil[MAX_L], off[MAX_L];
};

__host__ __device__ inline int r4(int n) { return (n + 3) / 4 * 4; }

__host__ __device__ inline int r16(int n) { return (n + 15) / 16 * 16; }

// The block's shared layout, in floats, as ops/wavenet.py:_smem lays it out:
// the weight ring (depth slots of the gate slice (K + 1) x CG, K = 3R + G/2
// + C, and the residual slice (G/2 + 3) x CR, ops/wavenet.py:kernel_weights), the staged
// rows (BT x XW), last1's slice (S x CH) and all of last2 with its bias
// ((S + 1) x NOUT), held for the launch, the tile's logits (BT x NOUT4),
// x_prev (B, rounded to 4), tile_dot's warp sums (two buffers of NT/32 x
// BT x MAXC).
// bfloat16 form (wavenet_kernel_bf16): K = 3R + C, the gate's staged row; a
// slot holds one phase's slice, the gate's (K x CG bfloat16, then CG
// float32 biases at the next 16 bytes: gate_bytes) or the residual's (G/2 x
// CR bfloat16, then CR float32 biases: resid_bytes), so it is the larger of
// the two; the staged rows hold K or G/2 bfloat16 values, or S floats.
struct Layout {
  int K, CG, CR, CH, XW, NOUT4, slot, xs, l1, l2, lg, xp, rd, total;
  int gate_bytes, resid_bytes;  // bfloat16 form only
  __host__ __device__ Layout(int B, int R, int G2, int S, int C, int NOUT, int pairs, int cols, int head_cols,
                             int depth, bool bf16 = false) {
    CG = r4(2 * pairs);
    CR = r4(cols);
    CH = r4(head_cols);
    NOUT4 = r4(NOUT);
    if (bf16) {
      K = 3 * R + C;
      gate_bytes = r16(2 * K * CG) + 4 * CG;
      resid_bytes = r16(2 * G2 * CR) + 4 * CR;
      slot = (gate_bytes > resid_bytes ? gate_bytes : resid_bytes) / 4;
      const int row = (K > G2 ? K : G2) / 2;
      XW = r4(row > S ? row : S);
    } else {
      K = 3 * R + G2 + C;
      gate_bytes = resid_bytes = 0;
      slot = (K + 1) * CG + (G2 + 3) * CR;
      XW = r4(K > S ? K : S);
    }
    xs = depth * slot;
    l1 = xs + BT * XW;
    l2 = l1 + S * CH;
    lg = l2 + r4((S + 1) * NOUT);
    xp = lg + BT * NOUT4;
    rd = xp + r4(B);
    total = rd + 2 * (NT / 32) * BT * MAXC;
  }
};

__device__ __forceinline__ float sigmoidf_(float x) { return 1.0f / (1.0f + expf(-x)); }

// A row that another block may have written during the launch: through L2.
__device__ __forceinline__ float4 load_cg(const float* p) { return __ldcg(reinterpret_cast<const float4*>(p)); }
__device__ __forceinline__ float4 load_ro(const float* p) { return __ldg(reinterpret_cast<const float4*>(p)); }

__device__ __forceinline__ float4 relu4(float4 v) {
  return make_float4(fmaxf(v.x, 0.0f), fmaxf(v.y, 0.0f), fmaxf(v.z, 0.0f), fmaxf(v.w, 0.0f));
}

// This thread's share of a tile's rows: v[b][u] = src(b0 + b, c4) for the
// float4 columns c4 = column(u, n4) of rows b0 + b < B.
// Every load is issued before any is used.
// Each block starts at another column (blockIdx.x * 32 float4 on), so that
// the blocks, which all read the same rows at once, ask different L2 lines
// for them at a time.
__device__ __forceinline__ int column(int u, int n4) {
  const int c4 = (threadIdx.x + u * NT + blockIdx.x * 32) % (2 * NT);
  return c4 < n4 ? c4 : -1;
}

template <class Src>
__device__ __forceinline__ void fetch(float4 (&v)[BT][2], int n4, int b0, int B, Src src) {
#pragma unroll
  for (int b = 0; b < BT; ++b)
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int c4 = column(u, n4);
      v[b][u] = b0 + b < B && c4 >= 0 ? src(b0 + b, c4) : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    }
}

__device__ __forceinline__ void put(float* xs, int n, const float4 (&v)[BT][2]) {
#pragma unroll
  for (int b = 0; b < BT; ++b)
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int c4 = column(u, n / 4);
      if (c4 >= 0) *reinterpret_cast<float4*>(xs + b * n + 4 * c4) = v[b][u];
    }
}

// One phase over the batch: rows of n floats (n / 4 <= 2 NT) from src staged
// tile by tile (BT rows a tile) into xs, body(b0) run by every thread on
// each tile, the next tile's rows in registers meanwhile. Ends with the
// block synchronised and xs free.
template <class Src, class Body>
__device__ __forceinline__ void phase(float* xs, int n, int B, Src src, Body body) {
  float4 v[BT][2];
  fetch(v, n / 4, 0, B, src);
  put(xs, n, v);
  __syncthreads();
  for (int b0 = 0; b0 < B; b0 += BT) {
    const bool next = b0 + BT < B;
    if (next) fetch(v, n / 4, b0 + BT, B, src);
    body(b0);
    __syncthreads();
    if (next) {
      put(xs, n, v);
      __syncthreads();
    }
  }
}

// One step of a warp's reduce-scatter: lanes with bit o set keep the upper
// H of the 2H values, the others the lower H, each adding its partner's.
template <int V, int H>
__device__ __forceinline__ void halve(float (&v)[V], int lane, int o) {
  const bool up = lane & o;
#pragma unroll
  for (int i = 0; i < H; ++i) {
    const float send = up ? v[i] : v[i + H];
    const float keep = up ? v[i + H] : v[i];
    v[i] = keep + __shfl_xor_sync(0xffffffffu, send, o);
  }
}

// Four consecutive weights as floats (bfloat16 widened exactly), and one
// staged value as a float.
__device__ __forceinline__ float4 load4(const float* p) { return *reinterpret_cast<const float4*>(p); }
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const float2 lo = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
  const float2 hi = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
  return make_float4(lo.x, lo.y, hi.x, hi.y);
}
__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

// The product of a tile's staged rows (ROWS of them, row stride ldx, n
// values each, float32 or bfloat16; rows past the batch hold stale values
// whose sums are not read) with a weight slice (n rows of 4 NC4 columns,
// float32 or bfloat16; every product and sum a float32 FMA), called by every
// thread of the block: thread i takes the slice rows k = i, i + NT, ...,
// and multiplies each weight row it reads by all the tile's rows, so that
// the slice is read from shared memory once a tile whatever B is (one warp
// a batch row, each reading the whole slice, was slower at every B on an
// H100). A warp adds its lanes' V = ROWS x 4 NC4 sums by xor shuffles (a
// reduce-scatter from V = 32 on: lane l ends with the sums l V/32 ..),
// writes them to red (NT/32 x V floats) and meets the block; tile_sum then
// adds a sum over the warps. Every order is fixed.
template <int NC4, int ROWS, class TX, class TW>
__device__ __forceinline__ void tile_dot(const TX* xs, int ldx, const TW* w, int n, float* red) {
  constexpr int NC = 4 * NC4, V = ROWS * NC;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  float v[V];
#pragma unroll
  for (int i = 0; i < V; ++i) v[i] = 0.0f;
#pragma unroll 2
  for (int k = threadIdx.x; k < n; k += NT) {
    float4 wv[NC4];
#pragma unroll
    for (int q = 0; q < NC4; ++q) wv[q] = load4(w + (size_t)k * NC + 4 * q);
#pragma unroll
    for (int r = 0; r < ROWS; ++r) {
      const float x = to_f(xs[r * ldx + k]);
#pragma unroll
      for (int q = 0; q < NC4; ++q) {
        float* o = v + r * NC + 4 * q;
        o[0] = fmaf(x, wv[q].x, o[0]);
        o[1] = fmaf(x, wv[q].y, o[1]);
        o[2] = fmaf(x, wv[q].z, o[2]);
        o[3] = fmaf(x, wv[q].w, o[3]);
      }
    }
  }
  if constexpr (V >= 32) {
    halve<V, V / 2>(v, lane, 16);
    halve<V, V / 4>(v, lane, 8);
    halve<V, V / 8>(v, lane, 4);
    halve<V, V / 16>(v, lane, 2);
    halve<V, V / 32>(v, lane, 1);
#pragma unroll
    for (int j = 0; j < V / 32; ++j) red[warp * V + lane * (V / 32) + j] = v[j];
  } else {
#pragma unroll
    for (int i = 0; i < V; ++i) {
#pragma unroll
      for (int o = 16; o >= 1; o >>= 1) v[i] += __shfl_xor_sync(0xffffffffu, v[i], o);
      if (lane == i) red[warp * V + i] = v[i];
    }
  }
  __syncthreads();
}

template <int NC4, class TX, class TW>
__device__ __forceinline__ int tile_dot(const TX* xs, int ldx, const TW* w, int n, int rows, float* red) {
  if (rows <= 1) {
    tile_dot<NC4, 1>(xs, ldx, w, n, red);
    return 4 * NC4;
  }
  if (rows <= 2) {
    tile_dot<NC4, 2>(xs, ldx, w, n, red);
    return 8 * NC4;
  }
  if (rows <= 4) {
    tile_dot<NC4, 4>(xs, ldx, w, n, red);
    return 16 * NC4;
  }
  tile_dot<NC4, BT>(xs, ldx, w, n, red);
  return 4 * NC4 * BT;
}

// tile_dot for rows <= BT staged rows and a slice of 4 nc4 columns, nc4 1
// or 2; returns V, the sums a warp wrote (the tile's rows rounded up to a
// power of 2, times 4 nc4).
template <class TX, class TW>
__device__ __forceinline__ int tile_dot(const TX* xs, int ldx, const TW* w, int n, int nc4, int rows, float* red) {
  return nc4 == 1 ? tile_dot<1>(xs, ldx, w, n, rows, red) : tile_dot<2>(xs, ldx, w, n, rows, red);
}

// The tile's sum i (row i / (4 nc4), column i % (4 nc4)) over the warps.
__device__ __forceinline__ float tile_sum(const float* red, int V, int i) {
  float s = 0.0f;
#pragma unroll
  for (int w = 0; w < NT / 32; ++w) s += red[w * V + i];
  return s;
}

// Issues the bulk copy of phase p's slices of this block (one contiguous run
// of Y.slot floats, ops/wavenet.py:kernel_weights) into ring slot w,
// counted on bar. One thread issues it.
__device__ __forceinline__ void load_slot(const Args& a, const Layout& Y, float* w, int p, unsigned long long* bar) {
  bulk_load(w, a.slices + ((size_t)p * gridDim.x + blockIdx.x) * Y.slot, 4u * Y.slot, bar);
}

// The head after a sample's last layer (either form): last1 over the
// blocks' head columns from relu(skip), a grid barrier, then last2 and the
// MoL sample in every block alike from the same inputs in the same order,
// so every block holds the same x_prev; block 0 writes y and the logits.
template <class A>
__device__ __forceinline__ void emit_sample(const A& a, const Layout& Y, int t, float* xs, const float* l1s,
                                            const float* l2s, float* lgs, float* xprev, float* red_r,
                                            const float (&l1b)[MAXC], int h0, int nh, cg::grid_group& grid) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, S = a.S;
  // head: last1 over the blocks' columns, then last2 and the sample in
  // every block alike
  phase(
      xs, S, a.B, [&](int b, int c4) { return relu4(load_cg(a.skip + (size_t)b * S + 4 * c4)); },
      [&](int b0) {
        if (nh == 0) return;
        const int rows = min(BT, a.B - b0);
        const int V = tile_dot(xs, S, l1s, S, Y.CH / 4, rows, red_r);
        const int r = tid / Y.CH, c = tid % Y.CH;
        if (r < rows && c < nh)
          a.o1[(size_t)(b0 + r) * S + h0 + c] = fmaxf(tile_sum(red_r, V, tid) + l1b[c], 0.0f);
      });
  grid.sync();
  phase(
      xs, S, a.B, [&](int b, int c4) { return load_cg(a.o1 + (size_t)b * S + 4 * c4); },
      [&](int b0) {
        const int b = b0 + warp;
        if (b >= a.B) return;
        const float* o = xs + warp * S;
        float* lg = lgs + warp * Y.NOUT4;
        for (int j = lane; j < a.NOUT; j += 32) {
          float s0 = 0.0f, s1 = 0.0f, s2 = 0.0f, s3 = 0.0f;
          for (int k = 0; k < S; k += 4) {  // S % 4 == 0
            s0 = fmaf(o[k], l2s[k * a.NOUT + j], s0);
            s1 = fmaf(o[k + 1], l2s[(k + 1) * a.NOUT + j], s1);
            s2 = fmaf(o[k + 2], l2s[(k + 2) * a.NOUT + j], s2);
            s3 = fmaf(o[k + 3], l2s[(k + 3) * a.NOUT + j], s3);
          }
          lg[j] = ((s0 + s1) + (s2 + s3)) + l2s[S * a.NOUT + j];
          if (blockIdx.x == 0) a.logits[((size_t)b * a.T + t) * a.NOUT + j] = lg[j];
        }
        __syncwarp();
        if (lane != 0) return;
        const int K3 = a.NOUT / 3;
        const float* u = a.unif + ((size_t)b * a.T + t) * (K3 + 1);
        int best = 0;
        float best_v = 0.0f;
        for (int i = 0; i < K3; ++i) {
          const float ui = fminf(fmaxf(__ldg(u + i), U_MIN), U_MAX);
          const float v = lg[i] - logf(-logf(ui));
          if (i == 0 || v > best_v) {  // ties keep the first index, as argmax does
            best = i;
            best_v = v;
          }
        }
        const float ux = fminf(fmaxf(__ldg(u + K3), U_MIN), U_MAX);
        const float log_s = fmaxf(lg[2 * K3 + best], a.log_scale_min);
        float x = lg[K3 + best] + expf(log_s) * (logf(ux) - log1pf(-ux));
        x = x < -1.0f ? -1.0f : (x > 1.0f ? 1.0f : x);  // keeps a NaN, as clip does
        xprev[b] = x;
        if (blockIdx.x == 0) a.y[(size_t)b * a.T + t] = x;
      });
}

__global__ void __launch_bounds__(NT, 1) wavenet_kernel(Args a) {
  extern __shared__ __align__(16) float smem[];
  __shared__ unsigned long long wbar[MAX_DEPTH];  // ring slot q's copy lands on wbar[q]
  const Layout Y(a.B, a.R, a.G2, a.S, a.C, a.NOUT, a.pairs, a.cols, a.head_cols, a.depth);
  float* xs = smem + Y.xs;
  float* l1s = smem + Y.l1;
  float* l2s = smem + Y.l2;
  float* lgs = smem + Y.lg;
  float* xprev = smem + Y.xp;
  float* red_r = smem + Y.rd;            // tile_dot's sums of the residual product and of last1
  float* red_g = red_r + NT / 32 * BT * MAXC;  // ... of the gate product
  const int tid = threadIdx.x;
  const int R = a.R, G2 = a.G2, S = a.S, K = Y.K, RS = a.R + a.S;
  // what this block owns (possibly nothing)
  const int j0 = blockIdx.x * a.pairs, np = max(0, min(a.pairs, G2 - j0));
  const int n0 = blockIdx.x * a.cols, nc = max(0, min(a.cols, RS - n0));
  const int h0 = blockIdx.x * a.head_cols, nh = max(0, min(a.head_cols, S - h0));
  const size_t slot_elems = (size_t)a.B * R;
  const int phases = a.L + 1;  // a sample's phases, each with its weight slot
  const long total = (long)a.T * phases;
  cg::grid_group grid = cg::this_grid();

  for (int e = tid; e < S * Y.CH; e += NT) {
    const int k = e / Y.CH, c = e % Y.CH;
    l1s[e] = c < nh ? __ldg(a.l1k + (size_t)k * S + h0 + c) : 0.0f;
  }
  for (int e = tid; e < S * a.NOUT; e += NT) l2s[e] = __ldg(a.l2k + e);
  for (int e = tid; e < a.NOUT; e += NT) l2s[S * a.NOUT + e] = __ldg(a.l2b + e);
  float l1b[MAXC];  // last1's bias of this block's head columns
#pragma unroll
  for (int c = 0; c < MAXC; ++c) l1b[c] = c < nh ? __ldg(a.l1b + h0 + c) : 0.0f;
  for (int e = tid; e < a.B; e += NT) xprev[e] = 0.0f;
  if (tid == 0)
    for (int q = 0; q < a.depth; ++q) mbar_init(&wbar[q]);
  __syncthreads();
  if (tid == 32)
    for (int g = 0; g < a.depth && g < total; ++g) load_slot(a, Y, smem + g * Y.slot, g % phases, &wbar[g]);

  for (int t = 0; t < a.T; ++t) {
    // phase p: the residual update of layer p - 1 (p >= 1) and the gate of
    // layer p (p < L), both from one staged row [x(t-2d), x(t-d), h, z, cond]
    // (layer p's ring slots, h_{p-1} or h_0 = x_prev * fk + fb, z_{p-1})
    for (int p = 0; p < phases; ++p) {
      const long g = (long)t * phases + p;
      // phase g - 1's slot is free since the last barrier: phase g - 1 + depth into it
      if (tid == 32 && g >= 1 && g - 1 + a.depth < total)
        load_slot(a, Y, smem + ((g - 1) % a.depth) * Y.slot, (int)((g - 1 + a.depth) % phases),
                  &wbar[(g - 1) % a.depth]);
      const int q = (int)(g % a.depth);
      mbar_wait(&wbar[q], (unsigned)(g / a.depth) & 1u);  // phase g's slices have landed
      const float* wg = smem + q * Y.slot;   // K rows, then the bias row
      const float* wr = wg + (K + 1) * Y.CG;  // G/2 rows, then the bias, fk and fb rows
      const float* bias_g = wg + K * Y.CG;
      const float* bias_r = wr + G2 * Y.CR;
      const bool gate = p < a.L, resid = p >= 1;
      const int dg = gate ? a.dil[p] : 1, dr = resid ? a.dil[p - 1] : 1;
      const float* ring_2d = a.ring + ((size_t)a.off[gate ? p : 0] + t % (2 * dg)) * slot_elems;
      const float* ring_d = a.ring + ((size_t)a.off[gate ? p : 0] + (t + dg) % (2 * dg)) * slot_elems;
      const float* h_in = a.h + (size_t)((p + 1) & 1) * slot_elems;    // h_{p-1} (p >= 2)
      float* h_out = a.h + (size_t)(p & 1) * slot_elems;               // h_p
      const float* z_in = a.z + (size_t)((p + 1) & 1) * a.B * G2;      // z_{p-1}
      float* z_out = a.z + (size_t)(p & 1) * a.B * G2;                 // z_p
      float* ring_w = resid ? a.ring + ((size_t)a.off[p - 1] + t % (2 * dr)) * slot_elems : nullptr;

      phase(
          xs, K, a.B,
          [&](int b, int c4) -> float4 {
            const int k = 4 * c4;
            const float4 zero = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
            if (k < R) return gate ? load_cg(ring_2d + (size_t)b * R + k) : zero;
            if (k < 2 * R) return gate ? load_cg(ring_d + (size_t)b * R + k - R) : zero;
            if (k < 3 * R) {
              if (p >= 2) return load_cg(h_in + (size_t)b * R + k - 2 * R);
              const float x = xprev[b];
              const float4 f = load_ro(a.fk + k - 2 * R), c = load_ro(a.fb + k - 2 * R);
              return make_float4(x * f.x + c.x, x * f.y + c.y, x * f.z + c.z, x * f.w + c.w);
            }
            if (k < 3 * R + G2) return resid ? load_cg(z_in + (size_t)b * G2 + k - 3 * R) : zero;
            return gate ? load_ro(a.cond + ((size_t)b * a.T + t) * a.C + k - 3 * R - G2) : zero;
          },
          [&](int b0) {
            const int rows = min(BT, a.B - b0);
            if (resid && nc > 0) {
              // thread i < rows * CR updates column n0 + c, c = i % CR, of
              // h or skip for row r = i / CR, from the layer's input
              // h_{p-1} (staged) or skip (loaded before the product)
              const int r = tid / Y.CR, c = tid % Y.CR, n = n0 + c, b = b0 + r;
              const bool writes = r < rows && c < nc;
              float prev = 0.0f;
              if (writes)
                prev = n < R    ? xs[r * K + 2 * R + n]
                       : p == 1 ? 0.0f
                                : __ldcg(a.skip + (size_t)b * S + n - R);
              const int V = tile_dot(xs + 3 * R, K, wr, G2, Y.CR / 4, rows, red_r);
              if (writes) {
                const float out = (prev + (tile_sum(red_r, V, tid) + bias_r[c])) * SQRT_HALF;
                if (n < R) {
                  ring_w[(size_t)b * R + n] = prev;  // the layer input, into the slot x(t-2d) was read from
                  h_out[(size_t)b * R + n] = out;
                } else {
                  a.skip[(size_t)b * S + n - R] = out;
                }
              }
            }
            if (gate && np > 0) {
              // thread i < rows * CG / 2 forms z of row i / (CG / 2), pair i % (CG / 2)
              const int V = tile_dot(xs, K, wg, K, Y.CG / 4, rows, red_g);
              const int r = tid / (Y.CG / 2), j = tid % (Y.CG / 2);
              if (r < rows && j < np) {
                const int i = r * Y.CG + 2 * j;
                z_out[(size_t)(b0 + r) * G2 + j0 + j] = tanhf(tile_sum(red_g, V, i) + bias_g[2 * j]) *
                                                        sigmoidf_(tile_sum(red_g, V, i + 1) + bias_g[2 * j + 1]);
              }
            }
          });
      grid.sync();
    }

    emit_sample(a, Y, t, xs, l1s, l2s, lgs, xprev, red_r, l1b, h0, nh, grid);
  }
}

// ---------------------------------------------------------------------------
// bfloat16 weights (wavenet_kernel_bf16). What generate_pallas computes from
// pack_weights(..., dtype=bfloat16) (pallas_wavenet.py:74-127): for layer l
// of sample t,
//   x_all = [ring(t-2d), ring(t-d), bf16(h_l)]              bfloat16 (B, 3R)
//   gates = x_all @ w3_l + bf16(cond_t) @ wcond_l + bg_l    float32 sums
//   z     = bf16(tanh(a) * sigmoid(b))
//   skip  = (skip + z @ wskip_l + bs_l) * sqrt(.5)          float32
//   h_l+1 = (h_l + z @ wout_l + bo_l) * sqrt(.5)            float32, unrounded
// and the ring slot t mod 2d takes bf16(h_l). w3, wcond, wout and wskip are
// bfloat16; the biases, the first conv, the head and the (h, skip)
// accumulators float32; every product is a bfloat16 value widened exactly
// into a float32 FMA.
//
// The float32 kernel's fold (the residual update of layer l - 1 taken into
// the gate of layer l through products of weights) cannot give bf16(h_l):
// the gate needs h_l rounded, which needs h_l whole, which is spread over
// the blocks' residual columns. So each layer takes two phases, each ending
// at a grid barrier: the gate phase stages [ring(t-2d), ring(t-d), bf16(h_l),
// bf16(cond_t)] (K = 3R + C bfloat16 values a row, 3.2 KB at full width,
// against the float32 kernel's 7.5 KB) and writes z_l; the residual phase
// stages z_l (G/2 values) and updates the block's h and skip columns from
// h_l (float32, hf) and skip, writing h_l+1 to hf and bf16(h_l+1) to hb for
// the next gate, and bf16(h_l) into the ring slot the gate read x(t-2d)
// from. 2L + 1 barriers a sample (with the head's), against L + 2. The
// weights (about 49 MB a sample at full width, half the float32 kernel's)
// stream through the same ring of phase slots, one bulk copy a phase of
// the phase's own bytes.
//
// Ordering. The gate of layer l reads hb[l % 2] and ring slots of layer l;
// the residual phase of layer l writes hf and hb [(l + 1) % 2], ring slot
// t mod 2d of layer l and skip, and reads hf[l % 2], z and skip: every
// write is separated from every read of another block by a grid barrier,
// and z, written by the gate of layer l + 1, was last read by the residual
// phase of layer l, before the barrier that ends it.
//
// Scan rounding (wavenet_kernel_bf16<true>, autovc_wavenet_gen_scan). What
// the JAX scan engine computes in bfloat16 (_generate_scan(dtype=bfloat16),
// autovc_tpu/vocoder/wavenet.py:244-310), every weight, bias and the first
// conv cast to bfloat16 and every op rounded as XLA:CPU rounds it under jit
// (ops/wavenet.py:generate_ref, scan=True): each of the four products of a
// gate summed in float32 and rounded alone, then added in order,
//   gates = rb(rb(rb(rb(d(t-2d) + d(t-d)) + d(h)) + bg) + d(cond))
//   z     = rb(rb(tanh(a)) * sigmoid(b)),  sigmoid(x) = rb(1 / rb(1 + rb(exp(-x))))
//   skip  = rb(rb(skip + rb(rb(z @ wskip) + bs)) * c)
//   h     = rb(rb(h + rb(rb(z @ wout) + bo)) * c),   c = bf16(sqrt(.5)) = 0.70703125
// and h_0 = rb(rb(rb(x_prev) * fk) + fb), so h and skip are bfloat16 values
// and the ring takes h as it is. The head stays float32 on relu(skip). The
// wrapper rounds the biases, fk and fb to bfloat16 values (float32 in the
// same slices); the kernel runs the gate's product as four tile_dots over
// the staged row's segments [ring(t-2d) | ring(t-d) | h | cond], each with
// its own reduction, and keeps no float32 h (hf unused).
struct ArgsBF {
  const float* slices;  // (2L, blocks, slot) phase slices: bfloat16 weights, float32 biases
  const float *fk, *fb, *l1k, *l1b, *l2k, *l2b;
  const __nv_bfloat16* cond;  // (B, T, C), rounded by the wrapper as the reference rounds it
  const float* unif;
  float *y, *logits;
  __nv_bfloat16* ring;  // (sum 2d, B, R)
  float* hf;            // (2, B, R) float32 h (null in the scan rounding)
  __nv_bfloat16* hb;    // (2, B, R) bf16(h)
  float* skip;          // (B, S)
  __nv_bfloat16* z;     // (B, G/2)
  float* o1;            // (B, S)
  int L, B, T, R, G2, S, C, NOUT;
  int pairs, cols, head_cols, depth;
  float log_scale_min;
  int dil[MAX_L], off[MAX_L];
};

// 16 bytes (eight bfloat16 values) of a row another block may have written,
// through L2; of a row no block writes, through the read-only path.
__device__ __forceinline__ float4 load_cg8(const __nv_bfloat16* p) {
  return __ldcg(reinterpret_cast<const float4*>(p));
}
__device__ __forceinline__ float4 load_ro8(const __nv_bfloat16* p) {
  return __ldg(reinterpret_cast<const float4*>(p));
}

// h_0 = x_prev * fk + fb (float32, rounded as the plain version rounds it:
// no fused multiply-add) for the eight columns at k.
__device__ __forceinline__ float first_conv(const ArgsBF& a, float x, int k) {
  return __fadd_rn(__fmul_rn(x, __ldg(a.fk + k)), __ldg(a.fb + k));
}
__device__ __forceinline__ float first_conv2(const ArgsBF& a, float x, int k) {  // two, rounded, as one float's bits
  const __nv_bfloat162 v = __floats2bfloat162_rn(first_conv(a, x, k), first_conv(a, x, k + 1));
  return __uint_as_float(*reinterpret_cast<const unsigned*>(&v));
}
__device__ __forceinline__ float4 first_conv8(const ArgsBF& a, float x, int k) {
  return make_float4(first_conv2(a, x, k), first_conv2(a, x, k + 2), first_conv2(a, x, k + 4),
                     first_conv2(a, x, k + 6));
}

// The scan rounding (rb, sigmoid_scan: scan_round.cuh) multiplies by
// bf16(sqrt(.5)), the constant XLA's bfloat16 program holds.
constexpr float SQRT_HALF_BF16 = 0.70703125f;

// h_0 in the scan rounding: rb(rb(rb(x) * fk) + fb), fk and fb bfloat16 values.
__device__ __forceinline__ float first_conv_scan(const ArgsBF& a, float x, int k) {
  return rb(__fadd_rn(rb(__fmul_rn(rb(x), __ldg(a.fk + k))), __ldg(a.fb + k)));
}
template <bool SCAN>
__device__ __forceinline__ float4 first_conv8_of(const ArgsBF& a, float x, int k) {
  if constexpr (SCAN) {
    float4 out;
    __nv_bfloat162* o = reinterpret_cast<__nv_bfloat162*>(&out);
#pragma unroll
    for (int i = 0; i < 4; ++i)
      o[i] = __floats2bfloat162_rn(first_conv_scan(a, x, k + 2 * i), first_conv_scan(a, x, k + 2 * i + 1));
    return out;
  } else {
    return first_conv8(a, x, k);
  }
}

template <bool SCAN>
__global__ void __launch_bounds__(NT, 1) wavenet_kernel_bf16(ArgsBF a) {
  extern __shared__ __align__(16) float smem[];
  __shared__ unsigned long long wbar[MAX_DEPTH];
  const Layout Y(a.B, a.R, a.G2, a.S, a.C, a.NOUT, a.pairs, a.cols, a.head_cols, a.depth, true);
  float* xs = smem + Y.xs;
  const __nv_bfloat16* xb = reinterpret_cast<const __nv_bfloat16*>(xs);  // the staged rows as bfloat16
  float* l1s = smem + Y.l1;
  float* l2s = smem + Y.l2;
  float* lgs = smem + Y.lg;
  float* xprev = smem + Y.xp;
  float* red_r = smem + Y.rd;
  float* red_g = red_r + NT / 32 * BT * MAXC;
  const int tid = threadIdx.x;
  const int R = a.R, G2 = a.G2, S = a.S, K = Y.K, RS = a.R + a.S;
  const int j0 = blockIdx.x * a.pairs, np = max(0, min(a.pairs, G2 - j0));
  const int n0 = blockIdx.x * a.cols, nc = max(0, min(a.cols, RS - n0));
  const int h0 = blockIdx.x * a.head_cols, nh = max(0, min(a.head_cols, S - h0));
  const size_t slot_elems = (size_t)a.B * R;
  const int phases = 2 * a.L;  // a sample's weight phases: gate and residual of each layer
  const long total = (long)a.T * phases;
  const int slot_floats = Y.slot;
  cg::grid_group grid = cg::this_grid();

  for (int e = tid; e < S * Y.CH; e += NT) {
    const int k = e / Y.CH, c = e % Y.CH;
    l1s[e] = c < nh ? __ldg(a.l1k + (size_t)k * S + h0 + c) : 0.0f;
  }
  for (int e = tid; e < S * a.NOUT; e += NT) l2s[e] = __ldg(a.l2k + e);
  for (int e = tid; e < a.NOUT; e += NT) l2s[S * a.NOUT + e] = __ldg(a.l2b + e);
  float l1b[MAXC];
#pragma unroll
  for (int c = 0; c < MAXC; ++c) l1b[c] = c < nh ? __ldg(a.l1b + h0 + c) : 0.0f;
  for (int e = tid; e < a.B; e += NT) xprev[e] = 0.0f;
  if (tid == 0)
    for (int q = 0; q < a.depth; ++q) mbar_init(&wbar[q]);
  __syncthreads();
  // phase p's slices of this block into ring slot q: the gate's (p even) or
  // the residual's (p odd) own bytes
  auto load = [&](int q, int p) {
    bulk_load(smem + (size_t)q * slot_floats, a.slices + ((size_t)p * gridDim.x + blockIdx.x) * slot_floats,
              (unsigned)((p & 1) ? Y.resid_bytes : Y.gate_bytes), &wbar[q]);
  };
  if (tid == 32)
    for (int g = 0; g < a.depth && g < total; ++g) load(g, g % phases);

  for (int t = 0; t < a.T; ++t) {
    for (int p = 0; p < phases; ++p) {
      const long g = (long)t * phases + p;
      if (tid == 32 && g >= 1 && g - 1 + a.depth < total)
        load((int)((g - 1) % a.depth), (int)((g - 1 + a.depth) % phases));
      const int q = (int)(g % a.depth);
      mbar_wait(&wbar[q], (unsigned)(g / a.depth) & 1u);
      const float* slot = smem + (size_t)q * slot_floats;
      const __nv_bfloat16* w = reinterpret_cast<const __nv_bfloat16*>(slot);
      const int l = p >> 1, d = a.dil[l];
      const size_t par_in = (size_t)(l & 1) * slot_elems, par_out = (size_t)((l + 1) & 1) * slot_elems;
      if ((p & 1) == 0) {
        // the gate of layer l from [ring(t-2d), ring(t-d), bf16(h_l), bf16(cond_t)]
        const float* bias = reinterpret_cast<const float*>(reinterpret_cast<const char*>(slot) +
                                                           r16(2 * K * Y.CG));
        const __nv_bfloat16* ring_2d = a.ring + ((size_t)a.off[l] + t % (2 * d)) * slot_elems;
        const __nv_bfloat16* ring_d = a.ring + ((size_t)a.off[l] + (t + d) % (2 * d)) * slot_elems;
        const __nv_bfloat16* h_in = a.hb + par_in;
        phase(
            xs, K / 2, a.B,
            [&](int b, int c4) -> float4 {
              const int k = 8 * c4;  // eight bfloat16 values a 16-byte unit
              if (k < R) return load_cg8(ring_2d + (size_t)b * R + k);
              if (k < 2 * R) return load_cg8(ring_d + (size_t)b * R + k - R);
              if (k < 3 * R) return l == 0 ? first_conv8_of<SCAN>(a, xprev[b], k - 2 * R)
                                           : load_cg8(h_in + (size_t)b * R + k - 2 * R);
              return load_ro8(a.cond + ((size_t)b * a.T + t) * a.C + k - 3 * R);
            },
            [&](int b0) {
              if (np == 0) return;
              const int rows = min(BT, a.B - b0);
              const int r = tid / (Y.CG / 2), j = tid % (Y.CG / 2);
              const bool forms = r < rows && j < np;
              const int i = r * Y.CG + 2 * j;
              float zv;
              if constexpr (SCAN) {
                // the four products of the segments, each rounded, added in
                // order (the two reduction buffers in turn: a buffer is
                // written again only after every thread has read it)
                const int off[5] = {0, R, 2 * R, 3 * R, K};
                float ga = 0.0f, gb = 0.0f;
#pragma unroll
                for (int seg = 0; seg < 4; ++seg) {
                  float* red = seg % 2 ? red_r : red_g;
                  const int V = tile_dot(xb + off[seg], K, w + (size_t)off[seg] * Y.CG, off[seg + 1] - off[seg],
                                         Y.CG / 4, rows, red);
                  if (!forms) continue;
                  const float da = rb(tile_sum(red, V, i)), db = rb(tile_sum(red, V, i + 1));
                  if (seg == 3) {
                    ga = rb(ga + bias[2 * j]);
                    gb = rb(gb + bias[2 * j + 1]);
                  }
                  ga = seg == 0 ? da : rb(ga + da);
                  gb = seg == 0 ? db : rb(gb + db);
                }
                zv = rb(tanhf(ga)) * sigmoid_scan(gb);
              } else {
                const int V = tile_dot(xb, K, w, K, Y.CG / 4, rows, red_g);
                if (forms)
                  zv = tanhf(tile_sum(red_g, V, i) + bias[2 * j]) * sigmoidf_(tile_sum(red_g, V, i + 1) + bias[2 * j + 1]);
              }
              if (forms) a.z[(size_t)(b0 + r) * G2 + j0 + j] = __float2bfloat16_rn(zv);
            });
      } else {
        // the residual update of layer l from z_l: the block's columns of h and skip
        const float* bias = reinterpret_cast<const float*>(reinterpret_cast<const char*>(slot) +
                                                           r16(2 * G2 * Y.CR));
        __nv_bfloat16* ring_w = a.ring + ((size_t)a.off[l] + t % (2 * d)) * slot_elems;
        phase(
            xs, G2 / 2, a.B, [&](int b, int c4) { return load_cg8(a.z + (size_t)b * G2 + 8 * c4); },
            [&](int b0) {
              if (nc == 0) return;
              const int rows = min(BT, a.B - b0);
              const int r = tid / Y.CR, c = tid % Y.CR, n = n0 + c, b = b0 + r;
              const bool writes = r < rows && c < nc;
              // the layer's input h_l (float32; in the scan rounding bfloat16) or skip,
              // loaded before the product
              float prev = 0.0f;
              if (writes && n < R) {
                if constexpr (SCAN)
                  prev = l == 0 ? first_conv_scan(a, xprev[b], n)
                                : __bfloat162float(__ushort_as_bfloat16(
                                      __ldcg(reinterpret_cast<const unsigned short*>(a.hb + par_in + (size_t)b * R + n))));
                else
                  prev = l == 0 ? first_conv(a, xprev[b], n) : __ldcg(a.hf + par_in + (size_t)b * R + n);
              } else if (writes && l > 0) {
                prev = __ldcg(a.skip + (size_t)b * S + n - R);
              }
              const int V = tile_dot(xb, G2, w, G2, Y.CR / 4, rows, red_r);
              if (writes) {
                float out;
                if constexpr (SCAN)
                  out = rb(rb(prev + rb(rb(tile_sum(red_r, V, tid)) + bias[c])) * SQRT_HALF_BF16);
                else
                  out = (prev + (tile_sum(red_r, V, tid) + bias[c])) * SQRT_HALF;
                if (n < R) {
                  ring_w[(size_t)b * R + n] = __float2bfloat16_rn(prev);
                  if constexpr (!SCAN) a.hf[par_out + (size_t)b * R + n] = out;
                  a.hb[par_out + (size_t)b * R + n] = __float2bfloat16_rn(out);
                } else {
                  a.skip[(size_t)b * S + n - R] = out;
                }
              }
            });
      }
      grid.sync();
    }
    emit_sample(a, Y, t, xs, l1s, l2s, lgs, xprev, red_r, l1b, h0, nh, grid);
  }
}

// Checks a bfloat16 plan and launches wavenet_kernel_bf16<SCAN> (the
// entry points below).
template <bool SCAN>
int launch_bf16(const float* slices, const float* fk, const float* fb, const float* l1k, const float* l1b,
                const float* l2k, const float* l2b, const void* cond, const float* unif, float* y, float* logits,
                void* ring, float* hf, void* hb, float* skip, void* z, float* o1, const int* dils, int L, int B, int T,
                int R, int G, int S, int C, int NOUT, float log_scale_min, int blocks, int pairs, int cols,
                int head_cols, int depth, int smem, int* info, cudaStream_t stream) {
  const int G2 = G / 2;
  if (L <= 0 || L > MAX_L || B <= 0 || T <= 0 || G % 16 || R % 8 || S % 4 || C % 8 || NOUT <= 0 || NOUT % 3 ||
      (3 * R + C) / 8 > 2 * NT || S / 4 > 2 * NT || (!SCAN && hf == nullptr))
    return ERR_PLAN;
  if (blocks <= 0 || pairs <= 0 || 2 * pairs > MAXC || cols <= 0 || cols > MAXC || head_cols <= 0 ||
      head_cols > MAXC || depth < 1 || depth > MAX_DEPTH || (long)blocks * pairs < G2 ||
      (long)blocks * cols < R + S || (long)blocks * head_cols < S)
    return ERR_PLAN;
  const Layout Y(B, R, G2, S, C, NOUT, pairs, cols, head_cols, depth, true);
  if ((long)Y.total * 4 != smem) return ERR_PLAN;
  ArgsBF a{slices, fk, fb, l1k, l1b, l2k, l2b, static_cast<const __nv_bfloat16*>(cond), unif, y, logits,
           static_cast<__nv_bfloat16*>(ring), hf, static_cast<__nv_bfloat16*>(hb), skip,
           static_cast<__nv_bfloat16*>(z), o1, L, B, T, R, G2, S, C, NOUT, pairs, cols, head_cols, depth,
           log_scale_min, {}, {}};
  for (int l = 0, off = 0; l < L; ++l) {
    if (dils[l] < 1) return ERR_PLAN;
    a.dil[l] = dils[l];
    a.off[l] = off;
    off += 2 * dils[l];
  }
  return launch_cooperative(wavenet_kernel_bf16<SCAN>, a, blocks, NT, smem, info, stream);
}

}  // namespace

extern "C" {

// Generates T samples for B rows in one cooperative launch on `stream`,
// without synchronising, with the plan of ops/wavenet.py:generate_plan
// (blocks, pairs, cols, head_cols, depth, smem); slices are the weights
// and biases in the plan's layout (ops/wavenet.py:kernel_weights: (L + 1)
// x blocks slots, each what the block holds in shared memory for a phase).
// ring (sum 2d, B, R), h (2, B, R), skip (B, S), z (2, B, G/2), o1 (B, S)
// are the caller's scratch; ring must be zero. cond (B, T, C), unif (B, T, K+1), y (B, T) and logits (B,
// T, 3K) are contiguous; dils is a host array of L dilations. info (2 ints,
// may be null) receives the resident blocks per SM and the SM count.
// Returns 0, ERR_PLAN, ERR_RESIDENT or the CUDA error of the launch.
int autovc_wavenet_gen(const float* slices, const float* fk, const float* fb, const float* l1k, const float* l1b,
                       const float* l2k, const float* l2b, const float* cond, const float* unif, float* y,
                       float* logits, float* ring, float* h, float* skip, float* z, float* o1,
                       const int* dils, int L, int B, int T, int R, int G, int S, int C, int NOUT,
                       float log_scale_min, int blocks, int pairs, int cols, int head_cols, int depth, int smem,
                       int* info, cudaStream_t stream) {
  const int G2 = G / 2;
  if (L <= 0 || L > MAX_L || B <= 0 || T <= 0 || G % 8 || R % 4 || S % 4 || C % 4 || NOUT <= 0 || NOUT % 3 ||
      (3 * R + G2 + C) / 4 > 2 * NT || S / 4 > 2 * NT)
    return ERR_PLAN;
  if (blocks <= 0 || pairs <= 0 || 2 * pairs > MAXC || cols <= 0 || cols > MAXC || head_cols <= 0 ||
      head_cols > MAXC || depth < 1 || depth > MAX_DEPTH || (long)blocks * pairs < G2 ||
      (long)blocks * cols < R + S || (long)blocks * head_cols < S)
    return ERR_PLAN;
  const Layout Y(B, R, G2, S, C, NOUT, pairs, cols, head_cols, depth);
  if ((long)Y.total * 4 != smem) return ERR_PLAN;
  Args a{slices, fk, fb, l1k, l1b, l2k, l2b, cond, unif, y, logits, ring, h, skip, z, o1,
         L, B, T, R, G2, S, C, NOUT, pairs, cols, head_cols, depth, log_scale_min, {}, {}};
  for (int l = 0, off = 0; l < L; ++l) {
    if (dils[l] < 1) return ERR_PLAN;
    a.dil[l] = dils[l];
    a.off[l] = off;
    off += 2 * dils[l];
  }
  return launch_cooperative(wavenet_kernel, a, blocks, NT, smem, info, stream);
}

// The bfloat16 form: as autovc_wavenet_gen, with slices in the bfloat16
// layout of ops/wavenet.py:kernel_weights_bf16 ((2L) x blocks phase slots),
// cond (B, T, C) in bfloat16, and the scratch ring (sum 2d, B, R) bfloat16
// (zero), hf (2, B, R) float32, hb (2, B, R) bfloat16, skip (B, S), z (B,
// G/2) bfloat16 and o1 (B, S). Needs R, G/2 and C multiples of 8 (16-byte
// units of bfloat16 rows).
int autovc_wavenet_gen_bf16(const float* slices, const float* fk, const float* fb, const float* l1k,
                            const float* l1b, const float* l2k, const float* l2b, const void* cond, const float* unif,
                            float* y, float* logits, void* ring, float* hf, void* hb, float* skip, void* z, float* o1,
                            const int* dils, int L, int B, int T, int R, int G, int S, int C, int NOUT,
                            float log_scale_min, int blocks, int pairs, int cols, int head_cols, int depth, int smem,
                            int* info, cudaStream_t stream) {
  return launch_bf16<false>(slices, fk, fb, l1k, l1b, l2k, l2b, cond, unif, y, logits, ring, hf, hb, skip, z, o1,
                            dils, L, B, T, R, G, S, C, NOUT, log_scale_min, blocks, pairs, cols, head_cols, depth,
                            smem, info, stream);
}

// The scan rounding: as autovc_wavenet_gen_bf16, with the slices' biases
// and fk, fb bfloat16 values (ops/wavenet.py:scan_weights); hf is unused
// (may be null).
int autovc_wavenet_gen_scan(const float* slices, const float* fk, const float* fb, const float* l1k,
                            const float* l1b, const float* l2k, const float* l2b, const void* cond, const float* unif,
                            float* y, float* logits, void* ring, float* hf, void* hb, float* skip, void* z, float* o1,
                            const int* dils, int L, int B, int T, int R, int G, int S, int C, int NOUT,
                            float log_scale_min, int blocks, int pairs, int cols, int head_cols, int depth, int smem,
                            int* info, cudaStream_t stream) {
  return launch_bf16<true>(slices, fk, fb, l1k, l1b, l2k, l2b, cond, unif, y, logits, ring, hf, hb, skip, z, o1,
                           dils, L, B, T, R, G, S, C, NOUT, log_scale_min, blocks, pairs, cols, head_cols, depth,
                           smem, info, stream);
}

const char* autovc_cuda_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

}  // extern "C"
