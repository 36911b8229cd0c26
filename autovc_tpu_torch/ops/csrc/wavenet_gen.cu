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
#include "tma.cuh"

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
struct Layout {
  int K, CG, CR, CH, XW, NOUT4, slot, xs, l1, l2, lg, xp, rd, total;
  __host__ __device__ Layout(int B, int R, int G2, int S, int C, int NOUT, int pairs, int cols, int head_cols,
                             int depth) {
    CG = r4(2 * pairs);
    CR = r4(cols);
    CH = r4(head_cols);
    NOUT4 = r4(NOUT);
    K = 3 * R + G2 + C;
    slot = (K + 1) * CG + (G2 + 3) * CR;
    XW = r4(K > S ? K : S);
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

// Four consecutive weights, and one staged value.
__device__ __forceinline__ float4 load4(const float* p) { return *reinterpret_cast<const float4*>(p); }
__device__ __forceinline__ float to_f(float x) { return x; }

// The product of a tile's staged rows (ROWS of them, row stride ldx, n
// values each; rows past the batch hold stale values whose sums are not
// read) with a weight slice (n rows of 4 NC4 columns; every product and sum
// a float32 FMA), called by every
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

// The head after a sample's last layer (every form): last1 over the
// blocks' head columns from relu(skip), a grid barrier, then last2 and the
// MoL sample in every block alike from the same inputs in the same order,
// so every block holds the same x_prev; block 0 writes y and the logits.
// Y gives the head's column stride CH and the logits' NOUT4.
template <class A, class Lay>
__device__ __forceinline__ void emit_sample(const A& a, const Lay& Y, int t, float* xs, const float* l1s,
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
// bfloat16 weights (wavenet_kernel_bf16<SCAN, NTL>). What generate_pallas
// computes from pack_weights(..., dtype=bfloat16) (pallas_wavenet.py:74-127):
// for layer l of sample t,
//   x_all = [ring(t-2d), ring(t-d), bf16(h_l)]              bfloat16 (B, 3R)
//   gates = x_all @ w3_l + bf16(cond_t) @ wcond_l + bg_l    float32 sums
//   z     = bf16(tanh(a) * sigmoid(b))
//   skip  = (skip + z @ wskip_l + bs_l) * sqrt(.5)          float32
//   h_l+1 = (h_l + z @ wout_l + bo_l) * sqrt(.5)            float32, unrounded
// and the ring slot t mod 2d takes bf16(h_l). w3, wcond, wout and wskip are
// bfloat16; the biases, the first conv, the head and the (h, skip)
// accumulators float32; the products are exact products of bfloat16 values
// summed in float32.
//
// Scan rounding (SCAN, autovc_wavenet_gen_scan). What the JAX scan engine
// computes in bfloat16 (_generate_scan(dtype=bfloat16),
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
// slices; ops/wavenet.py:scan_weights).
//
// Bound. Every sample reads the layer weights once, 24 x 1,024,000 bfloat16
// values at full width: 49.2 MB, 14.97 us a sample at 3.35 TB/s. The chain
// of 2L + 1 grid barriers a sample (below) bounds a sample's latency from
// beneath as well. The products are 2*B*24.6 M flops a sample (0.4 us at
// B=8 on the bfloat16 tensor cores).
//
// Design (a Hopper redesign of the first bfloat16 forms, which ran the
// float32 kernel's structure on bfloat16 values: CUDA-core FMAs, a shuffle
// tree and a block barrier a reduction, 128 blocks each staging the whole
// row by per-thread loads, four products and reductions a gate in the scan
// rounding).
//  - Two grid barriers a layer. The float32 kernel folds the residual update
//    into the next gate through products of weights; that cannot give
//    bf16(h_l), which needs h_l whole, spread over the blocks' residual
//    columns. So each layer takes a gate phase and a residual phase, each
//    ending at a grid barrier, and the head one more: 2L + 1 a sample.
//  - Tiles of 16 columns. Block i owns gate tile i (the pairs 8i .. 8i + 7:
//    their tanh columns, then their sigmoid columns) and residual tile i
//    (columns 16i .. 16i + 15 of [wout | wskip]: h, then skip) for the whole
//    launch: at full width 32 gate and 48 residual tiles, 48 blocks (a block
//    past a width owns nothing there and still meets every barrier). Each
//    block stages the whole activation row, so the L2 reads of a phase and
//    the barrier's arrivals grow with the blocks: the fewest that hold the
//    columns.
//  - Products on the tensor cores: mma.sync m16n8k16, bfloat16 in, float32
//    sums, M the tile's 16 columns, N the batch rows (n8 tiles; rows past B
//    staged as zeros, their sums not read), K split over the 8 warps in
//    contiguous runs of k16 steps. The wrapper lays each (phase, block)
//    slice out in fragment order (ops/wavenet.py:kernel_weights_bf16), so a
//    warp's A fragment of a step is one 16-byte shared load a lane; the
//    staged rows are read by ldmatrix from 128-byte atoms whose 16-byte
//    chunks are permuted by the row (TMA's 128-byte swizzle: no bank
//    conflicts). A warp writes its sums once (four floats a lane an n8
//    tile, in fragment order), the block meets, and one thread an output
//    pair adds the warps' sums in warp order: one reduction and two block
//    barriers a phase, every order fixed, so a call gives the same waveform
//    on every run. The scan rounding's gate keeps one accumulator a segment
//    [ring(t-2d) | ring(t-d) | h | cond] (a warp's run crosses at most one
//    boundary at full width); a warp a (segment, n8 tile) adds that
//    segment's warp sums in warp order (one thread adding all four
//    segments' serialised its shared loads on one register set), a third
//    block barrier, then each is rounded alone and chained in order. Each segment is padded to a multiple of
//    64 (whole atoms) with zero weight rows and zero staged values, the
//    global rows too (the wrapper allocates them so).
//  - Staged rows by TMA. After the barrier one thread copies ring(t-2d),
//    ring(t-d) and bf16(h_l) of the pass's batch rows into shared memory,
//    one TMA box a segment (the rows padded to whole 128-byte atoms, seen as
//    (64 k, B, atoms): a box of 64 x rows x atoms, 128-byte swizzle, rows
//    past B zero-filled), counted on an mbarrier; the residual phase copies
//    z the same way. Where the batch is one pass, the next gate's ring
//    segments are copied during the residual phase (written samples before;
//    their buffer is free), so the gate after the barrier waits for h alone.
//    cond_t of the pass's rows (the wrapper lays cond out as (T, B, Cq)) is
//    copied into a buffer of its own: where the batch is one pass, at layer
//    0 and kept for the sample's L layers, else by each gate pass beside its
//    ring rows (one pass's buffer, whatever B is); layer 0's h (the first
//    conv of x_prev, which every block holds) is written into the staged row
//    by the threads. The batch is one pass up to 32 rows (four n8 tiles); a
//    larger batch runs in passes of the plan's `rows`. (Measured on an H100
//    by scripts/wavenet_phases.py: one bulk copy a row and segment cost
//    30-110 ns a copy, issued one after another by the TMA engine, and
//    cp.async by the threads, 16 bytes a turn, stalled their issue on L2's
//    latency: both slower than a box a segment.)
//  - Weights. A block's slice of a phase (53.3 KB of gate and 8.3 KB of
//    residual weights at full width) streams by one bulk copy into a ring of
//    `depth` slots of its kind, issued by a lane of the last warp (which does
//    not reduce). The copy of phase g + depth goes as soon as the warps have
//    read slot g (after the product's sums are written; the biases are in
//    registers by then), so it has the reduction, the other kind's phase and
//    two barriers to land. The block's own residual columns of h (float32;
//    bfloat16 values in the scan rounding) and of skip stay in its shared
//    memory through a sample where the batch is one pass (else in the
//    caller's scratch hs, each value read and written by one thread, so
//    shared memory does not grow with B): only z, bf16(h) for the next gate,
//    the ring slot and, after the last layer, skip for the head go through
//    device memory.
//  - Ordering. z, hb and the ring are written by the threads (the generic
//    proxy) and read by other blocks' TMA copies (the async proxy): the
//    writers fence (fence.proxy.async.global) before the grid barrier, and
//    the thread that issues the copies fences after it; it also fences
//    shared memory (fence.proxy.async.shared::cta) before a copy overwrites
//    what the threads last read or wrote there. The gate of layer l reads
//    hb (written by the residual phase of layer l - 1) and ring slots of
//    layer l; the residual phase of layer l writes ring slot t mod 2d of
//    layer l (read as x(t-2d) by this sample's gate of layer l, before the
//    barrier between them) and hb; z, written by the gate of layer l, is
//    read by the residual phase of layer l: every write is separated from
//    every read of another block by a grid barrier.
//  - The head (emit_sample) is the float32 kernel's.

using bf16 = __nv_bfloat16;

constexpr int TILE = 16;         // columns a block owns in a phase: mma.sync's M
constexpr int NW = NT / 32;      // warps
constexpr int ATOM = 64;         // k of a staged atom: one 128-byte row, swizzled
constexpr int MAX_DEPTH_BF = 2;  // slots of each weight ring, at most
constexpr int PSLOTS = NW + 7;   // sums a phase an n8 tile: a warp's, one a segment boundary, a segment's

__host__ __device__ inline int r8(int n) { return (n + 7) / 8 * 8; }
__host__ __device__ inline int r64(int n) { return (n + 63) / 64 * 64; }
__host__ __device__ inline int r128(int n) { return (n + 127) / 128 * 128; }
__host__ __device__ inline int r1024(int n) { return (n + 1023) / 1024 * 1024; }
__host__ __device__ inline int imax(int a, int b) { return a > b ? a : b; }

struct ArgsBF {
  // The staged rows' tensor maps (128-byte swizzle, boxes of 64 k x rows x a
  // row's atoms): the ring (sum 2d, B, Rq) as (64, B, Rq / 64, sum 2d), hb
  // (B, Rq) as (64, B, Rq / 64), z (B, Gq) as (64, B, Gq / 64), cond (T, B,
  // Cq) as (64, B, Cq / 64, T); Rq, Gq and Cq are R, G/2 and C padded to 64
  // with zeros by the wrapper.
  CUtensorMap map_ring, map_hb, map_z, map_cond;
  const unsigned char* gate_w;  // (L, blocks, gate_bytes): a block's gate slice in fragment order, 16 float32 biases
  const unsigned char* res_w;   // (L, blocks, res_bytes): its residual slice, the same way
  const float *fk, *fb, *l1k, *l1b, *l2k, *l2b;
  const float* unif;
  float *y, *logits;
  bf16* ring;   // (sum 2d, B, Rq)
  bf16* hb;     // (B, Rq): bf16(h) for the next gate
  float* skip;  // (B, S): after the last layer, for the head
  bf16* z;      // (B, Gq)
  float* o1;    // (B, S)
  float* hs;    // (B, R + S): the residual columns of h and skip, where the batch is more than one pass
  int L, B, T, R, G2, S, C, NOUT;
  int rows, head_cols, depth;
  float log_scale_min;
  int dil[MAX_L], off[MAX_L];
};

// The block's shared layout in bytes, as ops/wavenet.py:bf16_smem lays it
// out (after the dynamic base is raised to 1024 bytes): the gate and the
// residual weight rings (depth slots each; a slot is KG or KR k16 steps of
// 512 bytes, then 16 float32 biases), the staged rows of a pass [ring(t-2d)
// | ring(t-d) | h] (each segment Rq / 64 atoms of rows x 128 bytes; the
// gate's warp sums and the head's staged rows reuse them), cond_t of a
// pass's rows (Cq / 64 atoms), z of a pass (Gq / 64 atoms; the residual's
// warp sums and the head's reuse it), the block's residual columns of h and
// skip for every row where the batch is one pass (none else: hs), last1's
// slice, last2 with its bias, the tile's logits, x_prev.
struct LayoutBF {
  int Rq, Cq, Gq, KG, KR, passes, gate_bytes, res_bytes, CH, NOUT4;
  int gw, rw, xs, cs, zs, st, l1, l2, lg, xp, total;
  __host__ __device__ LayoutBF(int B, int R, int G2, int S, int C, int NOUT, int rows, int head_cols, int depth) {
    Rq = r64(R);
    Cq = r64(C);
    Gq = r64(G2);
    KG = (3 * Rq + Cq) / 16;
    KR = Gq / 16;
    passes = (B + rows - 1) / rows;
    gate_bytes = KG * 512 + 4 * TILE;
    res_bytes = KR * 512 + 4 * TILE;
    CH = r4(head_cols);
    NOUT4 = r4(NOUT);
    gw = 0;
    rw = gw + depth * r128(gate_bytes);
    xs = r1024(rw + depth * r128(res_bytes));
    cs = xs + r1024(imax(imax(6 * Rq * rows, PSLOTS * (rows / 8) * 512), 4 * BT * S));
    zs = cs + 2 * Cq * rows;
    st = zs + r1024(imax(imax(2 * Gq * rows, NW * (rows / 8) * 512), 4 * NW * BT * MAXC));
    l1 = st + (passes == 1 ? r128(4 * r8(B) * TILE) : 0);
    l2 = l1 + r128(4 * S * CH);
    lg = l2 + r128(4 * (S + 1) * NOUT);
    xp = lg + r128(4 * BT * NOUT4);
    total = xp + r128(4 * r4(B)) + 1024;  // and the base raised to 1024 bytes
  }
};

// h_0 = x_prev * fk + fb for column k (float32, rounded as the plain version
// rounds it: no fused multiply-add); in the scan rounding rb(rb(rb(x) * fk)
// + fb), fk and fb bfloat16 values.
template <bool SCAN>
__device__ __forceinline__ float first_conv(const ArgsBF& a, float x, int k) {
  if constexpr (SCAN)
    return rb(__fadd_rn(rb(__fmul_rn(rb(x), __ldg(a.fk + k))), __ldg(a.fb + k)));
  else
    return __fadd_rn(__fmul_rn(x, __ldg(a.fk + k)), __ldg(a.fb + k));
}

// The scan rounding (rb, sigmoid_scan: scan_round.cuh) multiplies by
// bf16(sqrt(.5)), the constant XLA's bfloat16 program holds.
constexpr float SQRT_HALF_BF16 = 0.70703125f;

__device__ __forceinline__ void mbar_expect(unsigned long long* bar, unsigned bytes) {  // the one arrival of a phase
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(bytes)
               : "memory");
}
// Before a copy: the rows other blocks wrote before the barrier, and what
// this block's threads last did to the destination, ordered before the
// async proxy's accesses.
__device__ __forceinline__ void fence_for_copies() {
  asm volatile("fence.proxy.async.global;\n" ::: "memory");
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// Byte offset of staged value (row, k) in atoms of `rows` 128-byte rows:
// atom k / 64, the row's 16-byte chunks permuted by row % 8 (the layout of
// TMA's 128-byte swizzle).
__device__ __forceinline__ int sw_off(int row, int k, int rows) {
  return (k / ATOM) * rows * 128 + row * 128 + ((((k % ATOM) >> 3) ^ (row & 7)) << 4) + ((k & 7) << 1);
}

__device__ __forceinline__ void ldsm_x4(unsigned (&r)[4], unsigned addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}
__device__ __forceinline__ void ldsm_x2(unsigned& r0, unsigned& r1, unsigned addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n" : "=r"(r0), "=r"(r1) : "r"(addr));
}
// d += A (16 x 16) x B (16 x 8), bfloat16 in, float32 sums.
__device__ __forceinline__ void mma_acc(float (&d)[4], const uint4& a, unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a.x), "r"(a.y), "r"(a.z), "r"(a.w), "r"(b0), "r"(b1));
}

// A lane's ldmatrix addresses for the staged atoms (x4: lanes 8m .. 8m + 7
// give the rows of matrix m, n8 tile 2p + m / 2 at k half m % 2; x2 for a
// last, odd tile): x[p] the lane's row in tile pair p at atom 0, then step
// s adds (s / 4) atoms of `atom` bytes and its 16-byte chunk, swizzled.
template <int NTL>
struct Rows {
  unsigned x[(NTL + 1) / 2];
  unsigned atom;
  int kh, r7;
  __device__ __forceinline__ Rows(unsigned base, int rows, int lane) : atom(128u * rows) {
    const int m = lane >> 3;
    kh = m & 1;
    r7 = lane & 7;
#pragma unroll
    for (int p = 0; p < (NTL + 1) / 2; ++p) {
      const int tile = 2 * p + 1 < NTL ? 2 * p + (m >> 1) : 2 * p;
      x[p] = base + 128u * (tile * 8 + r7);
    }
  }
  __device__ __forceinline__ unsigned at(int p, int s) const {
    return x[p] + (unsigned)(s >> 2) * atom + (unsigned)(((((s & 3) << 1) | kh) ^ r7) << 4);
  }
};

// One k16 step s: its A fragment the lane's 16 bytes at w + (32 s + lane) *
// 16, its B fragments by ldmatrix from the staged atoms (step s - s0 of
// them), into d[t] for each n8 tile t.
template <int NTL>
__device__ __forceinline__ void step(float (&d)[NTL][4], const unsigned char* w, const Rows<NTL>& x, int s, int s0,
                                     int lane) {
  const uint4 af = *reinterpret_cast<const uint4*>(w + ((size_t)s * 32 + lane) * 16);
#pragma unroll
  for (int p = 0; p < NTL / 2; ++p) {
    unsigned b[4];
    ldsm_x4(b, x.at(p, s - s0));
    mma_acc(d[2 * p], af, b[0], b[1]);
    mma_acc(d[2 * p + 1], af, b[2], b[3]);
  }
  if constexpr (NTL % 2 == 1) {
    unsigned b0, b1;
    ldsm_x2(b0, b1, x.at(NTL / 2, s - s0));
    mma_acc(d[NTL - 1], af, b0, b1);
  }
}

// A warp's sums over its k16 steps [lo, hi) of a tile into acc (the staged
// atoms start at step s0); with one n8 tile, even and odd steps into two
// chains added at the end.
template <int NTL>
__device__ __forceinline__ void product(float (&acc)[NTL][4], const unsigned char* w, const Rows<NTL>& x, int s0,
                                        int lo, int hi, int lane) {
  if constexpr (NTL == 1) {
    float odd[1][4] = {};
    int s = lo;
    for (; s + 1 < hi; s += 2) {
      step<1>(acc, w, x, s, s0, lane);
      step<1>(odd, w, x, s + 1, s0, lane);
    }
    if (s < hi) step<1>(acc, w, x, s, s0, lane);
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[0][i] += odd[0][i];
  } else {
    for (int s = lo; s < hi; ++s) step<NTL>(acc, w, x, s, s0, lane);
  }
}

// A warp's sums of n8 tile t into slot `slot` of the sums buffer, in
// fragment order.
template <int NTL>
__device__ __forceinline__ void put_sums(float4* part, const float (&acc)[NTL][4], int slot, int lane) {
#pragma unroll
  for (int t = 0; t < NTL; ++t)
    part[(slot * NTL + t) * 32 + lane] = make_float4(acc[t][0], acc[t][1], acc[t][2], acc[t][3]);
}

__device__ __forceinline__ float4 add4(float4 a, float4 b) {
  return make_float4(a.x + b.x, a.y + b.y, a.z + b.z, a.w + b.w);
}

// One thread: the TMA copies of a pass's ring(t-2d) and ring(t-d) of layer
// l (a box each) into the first two segments, counted on bar, which it arms
// for `extra` bytes more.
__device__ __forceinline__ void stage_ring(const ArgsBF& a, const LayoutBF& Y, unsigned char* xs, int l, int t,
                                           int b0, unsigned extra, unsigned long long* bar) {
  const int d = a.dil[l];
  const unsigned seg = 2u * Y.Rq * a.rows;
  mbar_expect(bar, 2 * seg + extra);
  tma_load_4d(xs, &a.map_ring, bar, 0, b0, 0, a.off[l] + t % (2 * d));
  tma_load_4d(xs + seg, &a.map_ring, bar, 0, b0, 0, a.off[l] + (t + d) % (2 * d));
}

template <bool SCAN, int NTL>
__global__ void __launch_bounds__(NT, 1) wavenet_kernel_bf16(const __grid_constant__ ArgsBF a) {
  constexpr int ROWS = 8 * NTL;
  extern __shared__ __align__(128) unsigned char sm_raw[];
  __shared__ unsigned long long gbar[MAX_DEPTH_BF], rbar[MAX_DEPTH_BF], pbar, xbar, zbar;
  unsigned char* sm = sm_raw + ((1024 - (smem_addr(sm_raw) & 1023)) & 1023);
  const LayoutBF Y(a.B, a.R, a.G2, a.S, a.C, a.NOUT, a.rows, a.head_cols, a.depth);
  unsigned char* xs = sm + Y.xs;
  unsigned char* zs = sm + Y.zs;
  float4* gpart = reinterpret_cast<float4*>(xs);  // the gate's warp sums, once its staged rows are read
  float4* rpart = reinterpret_cast<float4*>(zs);  // the residual's, once z is read
  float* l1s = reinterpret_cast<float*>(sm + Y.l1);
  float* l2s = reinterpret_cast<float*>(sm + Y.l2);
  float* lgs = reinterpret_cast<float*>(sm + Y.lg);
  float* xprev = reinterpret_cast<float*>(sm + Y.xp);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int R = a.R, G2 = a.G2, S = a.S, B = a.B, L = a.L;
  const int j0 = blockIdx.x * (TILE / 2), n0 = blockIdx.x * TILE;  // the block's gate pairs, residual columns
  const bool owns_gate = j0 < G2, owns_res = n0 < R + S;
  const int h0 = blockIdx.x * a.head_cols, nh = max(0, min(a.head_cols, S - h0));
  const size_t slot_elems = (size_t)B * Y.Rq;
  const long total = (long)a.T * L;  // the launch's phases of each kind
  const int gslot = r128(Y.gate_bytes), rslot = r128(Y.res_bytes);
  const unsigned seg_bytes = 2u * Y.Rq * ROWS, cond_bytes = 2u * Y.Cq * ROWS, z_bytes = 2u * Y.Gq * ROWS;
  // Where the batch is one pass, the gate's ring segments of the next layer
  // are copied during the residual phase (their buffer is free then), cond_t
  // is copied at layer 0 and kept, and the block's columns of h and skip,
  // (b, m) at st[b * st_ld + m], stay in shared memory; else they are in hs.
  const bool one_pass = Y.passes == 1;
  float* const st = one_pass ? reinterpret_cast<float*>(sm + Y.st) : a.hs + n0;
  const int st_ld = one_pass ? TILE : R + S;
  // the output pair of the reducing threads (tid < 32 NTL): n8 tile, row g of
  // the fragment (gate pair j0 + g, or residual columns g and g + 8), batch
  // rows 2c and 2c + 1 of the tile
  const int rt = tid >> 5, rg = lane >> 2, rc = 2 * (lane & 3);
  // the warp's k16 steps of the gate and residual products; the gate's
  // segments [ring(t-2d) | ring(t-d) | h | cond] in steps
  const int glo = warp * Y.KG / NW, ghi = (warp + 1) * Y.KG / NW;
  const int rlo = warp * Y.KR / NW, rhi = (warp + 1) * Y.KR / NW;
  const int sb[5] = {0, Y.Rq / 16, 2 * Y.Rq / 16, 3 * Y.Rq / 16, Y.KG};
  unsigned crosses[4] = {};  // bit w of crosses[seg]: warp w has steps in segment seg
#pragma unroll
  for (int seg = 0; seg < 4; ++seg)
    for (int w8 = 0; w8 < NW; ++w8)
      crosses[seg] |= (unsigned)(max(w8 * Y.KG / NW, sb[seg]) < min((w8 + 1) * Y.KG / NW, sb[seg + 1])) << w8;
  const Rows<NTL> xrows(smem_addr(xs), ROWS, lane), zrows(smem_addr(zs), ROWS, lane);
  const bool issuer = tid == NT - 32;  // issues the weight copies: a lane of a warp that does not reduce
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
  for (int e = tid; e < B; e += NT) xprev[e] = 0.0f;
  if (tid == 0) {
    for (int q = 0; q < a.depth; ++q) {
      mbar_init(&gbar[q]);
      mbar_init(&rbar[q]);
    }
    mbar_init(&pbar);
    mbar_init(&xbar);
    mbar_init(&zbar);
  }
  __syncthreads();
  // the slices of layer l of each kind into slot q
  auto load_gate = [&](int q, int l) {
    bulk_load(sm + Y.gw + (size_t)q * gslot, a.gate_w + ((size_t)l * gridDim.x + blockIdx.x) * Y.gate_bytes,
              (unsigned)Y.gate_bytes, &gbar[q]);
  };
  auto load_res = [&](int q, int l) {
    bulk_load(sm + Y.rw + (size_t)q * rslot, a.res_w + ((size_t)l * gridDim.x + blockIdx.x) * Y.res_bytes,
              (unsigned)Y.res_bytes, &rbar[q]);
  };
  if (issuer)
    for (int g = 0; g < a.depth && g < total; ++g) {
      if (owns_gate) load_gate(g, g % L);
      if (owns_res) load_res(g, g % L);
    }
  unsigned puse = 0, xuse = 0, zuse = 0;  // the phases pbar, xbar and zbar have completed
  int q = 0;                              // the weight slot of the phase (g mod depth)
  unsigned par = 0;                       // and the parity of its mbarrier ((g / depth) mod 2)

  for (int t = 0; t < a.T; ++t) {
    for (int l = 0; l < L; ++l) {
      const long g = (long)t * L + l;  // the phase of each kind: its slices in slot q, layer l + depth next there
      const int d = a.dil[l], lnext = (l + a.depth) % L;
      // ---- the gate of layer l from [ring(t-2d), ring(t-d), bf16(h_l)] and bf16(cond_t)
      if (owns_gate) {
        const unsigned char* w = sm + Y.gw + (size_t)q * gslot;
        float bias_a = 0.0f, bias_b = 0.0f;  // the reducing thread's tanh and sigmoid biases
        const bool pre = one_pass && l > 0;          // the ring segments copied during the last residual phase
        const bool copy_cond = !one_pass || l == 0;  // cond_t of the pass's rows copied now
        unsigned char* cs = sm + Y.cs;
        for (int b0 = 0; b0 < B; b0 += ROWS) {
          if (tid == 0) {  // the TMA copies: the ring segments, hb from layer 1 on, cond_t
            fence_for_copies();
            const unsigned extra = (l > 0 ? seg_bytes : 0u) + (copy_cond ? cond_bytes : 0u);
            if (pre)
              mbar_expect(&xbar, extra);
            else
              stage_ring(a, Y, xs, l, t, b0, extra, &xbar);
            if (l > 0) tma_load_3d(xs + 2 * seg_bytes, &a.map_hb, &xbar, 0, b0, 0);
            if (copy_cond) tma_load_4d(cs, &a.map_cond, &xbar, 0, b0, 0, t);
          }
          if (l == 0)  // h_0, the first conv of x_prev, into the h segment (zero past R)
            for (int e = tid; e < ROWS * (Y.Rq / 2); e += NT) {
              const int r = e / (Y.Rq / 2), k = 2 * (e - r * (Y.Rq / 2)), b = b0 + r;
              float2 v = make_float2(0.0f, 0.0f);
              if (k < R && b < B)
                v = make_float2(first_conv<SCAN>(a, xprev[b], k), first_conv<SCAN>(a, xprev[b], k + 1));
              *reinterpret_cast<__nv_bfloat162*>(xs + 2 * seg_bytes + sw_off(r, k, ROWS)) = __float22bfloat162_rn(v);
            }
          if (b0 == 0) {
            mbar_wait(&gbar[q], par);
            if (tid < 32 * NTL) {
              const float* bias = reinterpret_cast<const float*>(w + Y.KG * 512);
              bias_a = bias[rg];
              bias_b = bias[rg + 8];
            }
          }
          if (pre) mbar_wait(&pbar, puse++ & 1u);
          mbar_wait(&xbar, xuse++ & 1u);
          if (l == 0) {
            asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");  // h_0 before a later copy there
            __syncthreads();  // the first conv written
          }
          const Rows<NTL> crows(smem_addr(cs), ROWS, lane);
          float acc[SCAN ? 4 : 1][NTL][4] = {};
#pragma unroll
          for (int seg = 0; seg < 4; ++seg)
            product<NTL>(acc[SCAN ? seg : 0], w, seg < 3 ? xrows : crows, seg < 3 ? 0 : sb[3], max(glo, sb[seg]),
                         min(ghi, sb[seg + 1]), lane);
          __syncthreads();  // every warp done with the staged rows
          if constexpr (SCAN) {
#pragma unroll
            for (int seg = 0; seg < 4; ++seg)
              if (crosses[seg] >> warp & 1u) put_sums<NTL>(gpart, acc[seg], warp + seg, lane);
          } else {
            put_sums<NTL>(gpart, acc[0], warp, lane);
          }
          __syncthreads();  // the sums written, the slot read
          if (issuer && b0 + ROWS >= B && g + a.depth < total) load_gate(q, lnext);
          if constexpr (SCAN) {  // each segment's sums over the warps, a warp a (segment, n8 tile)
            for (int p = warp; p < 4 * NTL; p += NW) {
              const int seg = p & 3;
              float4 v = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
#pragma unroll
              for (int w8 = 0; w8 < NW; ++w8)
                if (crosses[seg] >> w8 & 1u) v = add4(v, gpart[((w8 + seg) * NTL + (p >> 2)) * 32 + lane]);
              gpart[((NW + 3) * NTL + p) * 32 + lane] = v;
            }
            __syncthreads();
          }
          if (tid < 32 * NTL) {
            float za[2];  // z of batch rows 2c and 2c + 1 (fragment: x, y tanh; z, w sigmoid)
            if constexpr (SCAN) {
              float4 ds[4];
#pragma unroll
              for (int seg = 0; seg < 4; ++seg) ds[seg] = gpart[((NW + 3) * NTL + 4 * rt + seg) * 32 + lane];
#pragma unroll
              for (int e = 0; e < 2; ++e) {
                float ga = rb(e ? ds[0].y : ds[0].x), gb = rb(e ? ds[0].w : ds[0].z);
                ga = rb(ga + rb(e ? ds[1].y : ds[1].x));
                gb = rb(gb + rb(e ? ds[1].w : ds[1].z));
                ga = rb(ga + rb(e ? ds[2].y : ds[2].x));
                gb = rb(gb + rb(e ? ds[2].w : ds[2].z));
                ga = rb(ga + bias_a);
                gb = rb(gb + bias_b);
                ga = rb(ga + rb(e ? ds[3].y : ds[3].x));
                gb = rb(gb + rb(e ? ds[3].w : ds[3].z));
                za[e] = rb(tanhf(ga)) * sigmoid_scan(gb);
              }
            } else {
              float4 v = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
#pragma unroll
              for (int w8 = 0; w8 < NW; ++w8) v = add4(v, gpart[(w8 * NTL + rt) * 32 + lane]);
              za[0] = tanhf(v.x + bias_a) * sigmoidf_(v.z + bias_b);
              za[1] = tanhf(v.y + bias_a) * sigmoidf_(v.w + bias_b);
            }
            const int j = j0 + rg, b = b0 + 8 * rt + rc;
            if (j < G2) {
              if (b < B) a.z[(size_t)b * Y.Gq + j] = __float2bfloat16_rn(za[0]);
              if (b + 1 < B) a.z[(size_t)(b + 1) * Y.Gq + j] = __float2bfloat16_rn(za[1]);
            }
            asm volatile("fence.proxy.async.global;\n" ::: "memory");  // z, for the other blocks' copies
          }
          if (b0 + ROWS < B) __syncthreads();  // the sums read before the next pass's copies
        }
      }
      grid.sync();
      // the next gate's ring segments, beside this phase (their buffer is read)
      if (tid == 0 && one_pass && owns_gate && l + 1 < L) {
        fence_for_copies();
        stage_ring(a, Y, xs, l + 1, t, 0, 0u, &pbar);
      }
      // ---- the residual update of layer l from z_l: the block's columns of h and skip
      if (owns_res) {
        const unsigned char* w = sm + Y.rw + (size_t)q * rslot;
        bf16* ring_w = a.ring + ((size_t)a.off[l] + t % (2 * d)) * slot_elems;
        float bias_lo = 0.0f, bias_hi = 0.0f;  // the reducing thread's columns g and g + 8
        for (int b0 = 0; b0 < B; b0 += ROWS) {
          if (tid == 0) {
            fence_for_copies();
            mbar_expect(&zbar, z_bytes);
            tma_load_3d(zs, &a.map_z, &zbar, 0, b0, 0);
          }
          if (b0 == 0) {
            mbar_wait(&rbar[q], par);
            if (tid < 32 * NTL) {
              const float* bias = reinterpret_cast<const float*>(w + Y.KR * 512);
              bias_lo = bias[rg];
              bias_hi = bias[rg + 8];
            }
          }
          mbar_wait(&zbar, zuse++ & 1u);
          float acc[NTL][4] = {};
          product<NTL>(acc, w, zrows, 0, rlo, rhi, lane);
          __syncthreads();
          put_sums<NTL>(rpart, acc, warp, lane);
          __syncthreads();
          if (issuer && b0 + ROWS >= B && g + a.depth < total) load_res(q, lnext);
          if (tid < 32 * NTL) {
            float4 v = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
#pragma unroll
            for (int w8 = 0; w8 < NW; ++w8) v = add4(v, rpart[(w8 * NTL + rt) * 32 + lane]);
            const float sums[4] = {v.x, v.y, v.z, v.w};  // (column g, rows 2c, 2c + 1), (column g + 8, ...)
#pragma unroll
            for (int i = 0; i < 4; ++i) {
              const int m = rg + 8 * (i >> 1), n = n0 + m, b = b0 + 8 * rt + rc + (i & 1);
              if (n >= R + S || b >= B) continue;
              // the layer's input h_l or skip: the first conv and 0 at layer 0
              const float prev = l > 0 ? st[(size_t)b * st_ld + m] : n < R ? first_conv<SCAN>(a, xprev[b], n) : 0.0f;
              const float bias = i < 2 ? bias_lo : bias_hi;
              const float out = SCAN ? rb(rb(prev + rb(rb(sums[i]) + bias)) * SQRT_HALF_BF16)
                                     : (prev + (sums[i] + bias)) * SQRT_HALF;
              st[(size_t)b * st_ld + m] = out;
              if (n < R) {
                ring_w[(size_t)b * Y.Rq + n] = __float2bfloat16_rn(prev);  // into the slot x(t-2d) was read from
                if (l + 1 < L) a.hb[(size_t)b * Y.Rq + n] = __float2bfloat16_rn(out);
              } else if (l + 1 == L) {
                a.skip[(size_t)b * S + n - R] = out;
              }
            }
            asm volatile("fence.proxy.async.global;\n" ::: "memory");  // the ring and hb, for the copies
          }
          if (b0 + ROWS < B) __syncthreads();
        }
      }
      grid.sync();
      if (++q == a.depth) {
        q = 0;
        par ^= 1u;
      }
    }
    emit_sample(a, Y, t, reinterpret_cast<float*>(xs), l1s, l2s, lgs, xprev, reinterpret_cast<float*>(zs), l1b, h0,
                nh, grid);
  }
}

// Checks a bfloat16 plan, encodes the staged rows' tensor maps and launches
// wavenet_kernel_bf16<SCAN, rows / 8> (the entry points below).
template <bool SCAN>
int launch_bf16(const void* gate_w, const void* res_w, const float* fk, const float* fb, const float* l1k,
                const float* l1b, const float* l2k, const float* l2b, const void* cond, const float* unif, float* y,
                float* logits, void* ring, void* hb, float* skip, void* z, float* o1, float* hs, const int* dils,
                int L, int B, int T, int R, int G, int S, int C, int NOUT, float log_scale_min, int blocks, int rows,
                int head_cols, int depth, int smem, int* info, cudaStream_t stream) {
  const int G2 = G / 2;
  if (L <= 0 || L > MAX_L || B <= 0 || T <= 0 || G % 16 || R % 8 || S % 4 || C % 8 || NOUT <= 0 || NOUT % 3 ||
      S / 4 > 2 * NT)
    return ERR_PLAN;
  if (blocks <= 0 || (rows != 8 && rows != 16 && rows != 32) || head_cols <= 0 || head_cols > MAXC || depth < 1 ||
      depth > MAX_DEPTH_BF || (long)blocks * (TILE / 2) < G2 || (long)blocks * TILE < R + S ||
      (long)blocks * head_cols < S)
    return ERR_PLAN;
  const LayoutBF Y(B, R, G2, S, C, NOUT, rows, head_cols, depth);
  if (Y.total != smem) return ERR_PLAN;
  ArgsBF a{{}, {}, {}, {}, static_cast<const unsigned char*>(gate_w), static_cast<const unsigned char*>(res_w), fk, fb,
           l1k, l1b, l2k, l2b, unif, y, logits, static_cast<bf16*>(ring), static_cast<bf16*>(hb), skip,
           static_cast<bf16*>(z), o1, hs, L, B, T, R, G2, S, C, NOUT, rows, head_cols, depth, log_scale_min, {}, {}};
  int slots = 0;
  for (int l = 0; l < L; ++l) {
    if (dils[l] < 1) return ERR_PLAN;
    a.dil[l] = dils[l];
    a.off[l] = slots;
    slots += 2 * dils[l];
  }
  const cuuint32_t nb = (cuuint32_t)rows;
  const cuuint64_t ring_dims[4] = {ATOM, (cuuint64_t)B, (cuuint64_t)Y.Rq / ATOM, (cuuint64_t)slots};
  const cuuint64_t ring_strides[3] = {(cuuint64_t)Y.Rq * 2, ATOM * 2, (cuuint64_t)B * Y.Rq * 2};
  const cuuint32_t ring_box[4] = {ATOM, nb, (cuuint32_t)(Y.Rq / ATOM), 1};
  const cuuint64_t z_dims[3] = {ATOM, (cuuint64_t)B, (cuuint64_t)Y.Gq / ATOM};
  const cuuint64_t z_strides[2] = {(cuuint64_t)Y.Gq * 2, ATOM * 2};
  const cuuint32_t z_box[3] = {ATOM, nb, (cuuint32_t)(Y.Gq / ATOM)};
  const cuuint64_t cond_dims[4] = {ATOM, (cuuint64_t)B, (cuuint64_t)Y.Cq / ATOM, (cuuint64_t)T};
  const cuuint64_t cond_strides[3] = {(cuuint64_t)Y.Cq * 2, ATOM * 2, (cuuint64_t)B * Y.Cq * 2};
  const cuuint32_t cond_box[4] = {ATOM, nb, (cuuint32_t)(Y.Cq / ATOM), 1};
  if ((uintptr_t)ring % 16 || (uintptr_t)hb % 16 || (uintptr_t)z % 16 || (uintptr_t)cond % 16 ||
      !encode(&a.map_ring, ring, 4, ring_dims, ring_strides, ring_box, CU_TENSOR_MAP_SWIZZLE_128B) ||
      !encode(&a.map_hb, hb, 3, ring_dims, ring_strides, ring_box, CU_TENSOR_MAP_SWIZZLE_128B) ||
      !encode(&a.map_z, z, 3, z_dims, z_strides, z_box, CU_TENSOR_MAP_SWIZZLE_128B) ||
      !encode(&a.map_cond, cond, 4, cond_dims, cond_strides, cond_box, CU_TENSOR_MAP_SWIZZLE_128B))
    return ERR_TMA;
  if (rows == 8) return launch_cooperative(wavenet_kernel_bf16<SCAN, 1>, a, blocks, NT, smem, info, stream);
  if (rows == 16) return launch_cooperative(wavenet_kernel_bf16<SCAN, 2>, a, blocks, NT, smem, info, stream);
  return launch_cooperative(wavenet_kernel_bf16<SCAN, 4>, a, blocks, NT, smem, info, stream);
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

// The bfloat16 form (the Pallas engine's rounding): as autovc_wavenet_gen,
// with the plan of ops/wavenet.py:generate_plan(..., esize=2) (blocks,
// rows, head_cols, depth, smem), the slices of
// ops/wavenet.py:kernel_weights_bf16 (gate_w (L, blocks, gate bytes), res_w
// (L, blocks, residual bytes)), cond (B, T, C) in bfloat16, and the scratch
// ring (sum 2d, B, R) bfloat16 (zero), hb (B, R) bfloat16, skip (B, S), z
// (B, G/2) bfloat16, o1 (B, S) and hs (B, R + S). Needs G % 16 == 0 and R
// and C multiples of 8 (16-byte rows of bfloat16).
int autovc_wavenet_gen_bf16(const void* gate_w, const void* res_w, const float* fk, const float* fb,
                            const float* l1k, const float* l1b, const float* l2k, const float* l2b, const void* cond,
                            const float* unif, float* y, float* logits, void* ring, void* hb, float* skip, void* z,
                            float* o1, float* hs, const int* dils, int L, int B, int T, int R, int G, int S, int C,
                            int NOUT, float log_scale_min, int blocks, int rows, int head_cols, int depth, int smem,
                            int* info, cudaStream_t stream) {
  return launch_bf16<false>(gate_w, res_w, fk, fb, l1k, l1b, l2k, l2b, cond, unif, y, logits, ring, hb, skip, z, o1,
                            hs, dils, L, B, T, R, G, S, C, NOUT, log_scale_min, blocks, rows, head_cols, depth, smem,
                            info, stream);
}

// The scan rounding: as autovc_wavenet_gen_bf16, with the slices' biases
// and fk, fb bfloat16 values (ops/wavenet.py:scan_weights).
int autovc_wavenet_gen_scan(const void* gate_w, const void* res_w, const float* fk, const float* fb,
                            const float* l1k, const float* l1b, const float* l2k, const float* l2b, const void* cond,
                            const float* unif, float* y, float* logits, void* ring, void* hb, float* skip, void* z,
                            float* o1, float* hs, const int* dils, int L, int B, int T, int R, int G, int S, int C,
                            int NOUT, float log_scale_min, int blocks, int rows, int head_cols, int depth, int smem,
                            int* info, cudaStream_t stream) {
  return launch_bf16<true>(gate_w, res_w, fk, fb, l1k, l1b, l2k, l2b, cond, unif, y, logits, ring, hb, skip, z, o1,
                           hs, dils, L, B, T, R, G, S, C, NOUT, log_scale_min, blocks, rows, head_cols, depth, smem,
                           info, stream);
}

const char* autovc_cuda_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

}  // extern "C"
