// Forward LSTM recurrence over hoisted input projections: one launch per
// sequence, each block holding its slice of w_hh in shared memory for the
// whole sequence.
//
// Replaces the forward Pallas kernels of autovc_tpu/ops/pallas_lstm.py:
//   _chunk_fwd (-> _lstm_kernel, _lstm_kernel_train) and
//   _lstm_chunk_split_impl (-> _lstm_kernel_split, _lstm_kernel_split_train).
// The TPU kernel kept w_hh in VMEM for the whole call, with the (h, c) carry
// on chip; the TPU needed the gate split only because a 16 MB w_hh at H=1024
// does not fit its VMEM. Here the card's 132 SMs hold it together instead,
// up to the width where their shared memory is full; past it (regime (c)
// below) each block streams what does not fit, as the split kernel does.
//
// Computes, for t in time order (or reversed):
//   gates = xproj[:, t] + h_{t-1} @ w_hh        (B, 4H), gate order i, f, g, o
//   c_t = sigmoid(f) * c_{t-1} + sigmoid(i) * tanh(g)
//   h_t = sigmoid(o) * tanh(c_t)                 h_seq[:, t] = h_t
// from (h0, c0), float32 throughout, the formulas of pallas_lstm.py:41-52.
//   xproj (B, T, 4H), w_hh (H, 4H) row-major, h_seq (B, T, H), c (B, H).
// h0 (B, H) may be null (zero initial h: the product of the first step is
// skipped); c holds c0 on entry (the caller zeroes it for a zero state) and
// cN on exit. The training form also writes c_seq (B, T, H) and the gate
// activations (B, T, 4H) = [sigmoid(i), sigmoid(f), tanh(g), sigmoid(o)],
// the backward's residuals (csrc/lstm_bwd.cu); inference passes null for both.
//
// Bound. A step does 8*B*H^2 flops of f32 FMAs on the CUDA cores (67 TFLOP/s
// peak: 4 us at B=32, H=1024, 17 ns at H=32) and depends on the step before,
// so the sequence is T latency-bound steps unless w_hh stays on chip and the
// steps synchronise cheaply. The previous design launched one kernel per step
// and re-read w_hh from L2 on every step; a step cost 4 us of launch latency
// at H=32 and 35 us at H=1024.
//
// Design. The Python wrapper computes a launch plan from (B, H) (ops/lstm.py,
// launch_plan) and passes it here; the launcher checks it against its own
// reading of the shapes and refuses what does not match.
//  (a) w_hh fits one block (4H^2 floats plus staging, H <= 112): one block per
//      tile of batch rows walks all T steps with the whole of w_hh and its
//      rows of h in shared memory, synchronised by __syncthreads alone. No
//      grid barrier; the blocks never exchange anything.
//  (b) larger H: a persistent cooperative kernel, at most one block per SM.
//      Each block owns `units` hidden units and holds their four gate
//      columns of w_hh in shared memory (at H=1024, 8 units: 128 blocks x
//      128 KB). A step stages h_{t-1} of every batch row from global memory
//      in K chunks (cp.async.cg: read through L2, never a stale L1 line,
//      the next chunk in flight while one is multiplied), computes its
//      units' gates and cell update, writes h_t, and meets the other blocks
//      at cooperative_groups' grid barrier. The launch is
//      cudaLaunchCooperativeKernel, which refuses a grid that cannot be
//      resident, after an occupancy check that reports both numbers.
//  (c) a block's slice of w_hh past its shared memory (H=2048: 512 KB in
//      float32 a block of 16 units): (b)'s kernel and blocks, with only the
//      slice's first kres rows of K resident (a multiple of kc). At its
//      start each block writes the rest of its slice, laid out as in shared
//      memory, to its part of wst (device memory); each step then streams
//      those rows chunk by chunk into a ring of two kc-row buffers, each
//      chunk copied (cp.async.cg) in the same commit group as the chunk of
//      h it multiplies, so the next chunk of both is in flight while one is
//      multiplied. The counterpart of _lstm_kernel_split(_train)
//      (pallas_lstm.py:102, 135), which streams w_hh's (H, H) gate blocks
//      from HBM each step where they outgrow VMEM. Bound: w_hh's streamed
//      bytes every step, from L2 where they fit it (the bfloat16 form at
//      H=2048, 32 MB), else from HBM (float32: 64 MB, 67 MB a step less the
//      resident part).
// In all three, a thread computes RB batch rows x the 4 gates of one unit over a
// slice of K (register tile), the slices are added in shared memory, and one
// thread per (row, unit) updates the cell; c stays in place in c_state
// (one thread reads and writes each element). Batch rows are tiled by the
// plan's `rows`, which follows B (8 rows at B=7).
//
// bfloat16 form (autovc_lstm_fwd_bf16). The Pallas kernel's
// bfloat16 path (_cell_step on bf16 xproj and w_hh; layers.LSTM with
// compute_dtype bfloat16) computes gates = f32(xproj_t) + h_{t-1} @
// f32(w_hh) with h_{t-1} and c in float32 scratch, and rounds only the
// stored h to bfloat16 (pallas_lstm.py:41-75). So does this form: the same
// kernels instantiated with bfloat16 xproj, w_hh and h_seq. w_hh sits in
// shared memory as bfloat16 (half the bytes, so regime (a) holds a larger H:
// ops/lstm.py:launch_plan derives it), each weight widened exactly before
// its float32 FMA (a bfloat16 tensor-core product would round h, which the
// reference keeps in float32); the carry stays float32. Regime (a) keeps
// h_{t-1} in shared memory in float32 already. Regime (b) cannot read
// h_{t-1} back from the bfloat16 h_seq, which would round the carry every
// step: the blocks exchange h through a float32 double buffer hbuf (2, B,
// H), step s writing hbuf[s % 2] beside the rounded h_seq and reading
// hbuf[(s - 1) % 2] after the grid barrier (cp.async.cg, through L2); step
// s + 1 overwrites what step s - 1 wrote only after the barrier that ends
// step s, when every block has read it. Bound: the same operations as in
// float32 (4.62 ms a Generator forward on the CUDA cores), half the bytes.
// Its training form (_lstm_kernel_train on bf16 xproj) adds a float32
// initial state (h0, c0), the float32 c_seq and the float32 hN (h_last, the
// carry at the last step, which h_seq holds only rounded); the backward
// recomputes the gate activations from the rounded h_seq (lstm_gates.cu),
// as the Pallas backward does, so no gates are written here.
//
// The scan rounding (JAX's _lstm_scan, a bfloat16 carry) has its own
// kernel, csrc/lstm_scan_fwd.cu, its product on the tensor cores.

#include <type_traits>

#include "lstm_common.cuh"

namespace cg = cooperative_groups;

namespace {

// E is the element type of xproj, w_hh and h_seq: float, or __nv_bfloat16
// (hbuf given in regime (b), gates null).
template <class E>
struct Args {
  const E* xproj;
  const E* w_hh;
  const float* h0;
  E* h_seq;
  float* hbuf;  // (2, B, H) float32 exchange of h between regime (b)'s steps, or null: read h_seq
  float* c_state;
  float* c_seq;
  float* gates;
  float* h_last;  // (B, H) float32 h of the last step, or null
  E* wst;         // regime (c): each block's streamed rows of its slice, (H - kres) x 4 units, or null
  int B, T, H, reverse;
  int units, rows, kc, ks;  // the plan; ks = NT / tasks, derived here
  int kres;                 // rows of K of the slice resident in shared memory: H but in regime (c)
};

__device__ __forceinline__ float sigmoid(float x) { return 1.0f / (1.0f + expf(-x)); }

// The block's shape: units TJ, rows BT, 4*TJ columns of W, tasks = (BT/RB)*TJ
// (row group, unit) pairs, each split KS ways over K.
struct Layout {
  int TJ, BT, NC, RG, tasks, KS;
  template <class E>
  __device__ Layout(const Args<E>& a, int tj)
      : TJ(tj), BT(a.rows), NC(4 * tj), RG(a.rows / RB), tasks(RG * tj), KS(a.ks) {}
};

// Loads rows [k0, k1) of the block's gate columns of w_hh: W[k - k0][4u + g]
// = w_hh[k, g*H + j0 + u] (read in runs of TJ consecutive units); W is
// shared memory, or the block's part of wst in regime (c).
template <class E>
__device__ void load_w(E* W, const Args<E>& a, const Layout& L, int j0, int k0, int k1) {
  const int n = (k1 - k0) * L.NC;
  for (int e = threadIdx.x; e < n; e += NT) {
    const int u = e % L.TJ, g = (e / L.TJ) % 4, k = e / L.NC;
    W[k * L.NC + 4 * u + g] = a.w_hh[(size_t)(k0 + k) * 4 * a.H + (size_t)g * a.H + j0 + u];
  }
}

// One thread's xproj values for its (row, unit) pairs of a tile, loaded
// before the product so that they are in flight during it.
struct Pairs {
  float xp[RB][4];
};

template <class E>
__device__ __forceinline__ void prefetch_x(Pairs& p, const Args<E>& a, const Layout& L, int b0, int j0, int t) {
#pragma unroll
  for (int i = 0; i < RB; ++i) {
    const int q = threadIdx.x + i * NT;
    const int b = q / L.TJ, u = q % L.TJ;
    if (q < L.BT * L.TJ && b0 + b < a.B) {
      const E* xp = a.xproj + ((size_t)(b0 + b) * a.T + t) * 4 * a.H + j0 + u;
#pragma unroll
      for (int g = 0; g < 4; ++g) p.xp[i][g] = load_ro1(xp + (size_t)g * a.H);
    }
  }
}

// The thread's (row group, unit, slice) of the product, or -1 for ks when it
// has none.
__device__ __forceinline__ void task_of(const Layout& L, int& rg, int& u, int& ks) {
  const int tid = threadIdx.x;
  u = tid % L.TJ;
  rg = (tid / L.TJ) % L.RG;
  ks = tid < L.tasks * L.KS ? tid / L.tasks : -1;
}

__device__ __forceinline__ void store_partial(float* red, const Layout& L, const float (&acc)[RB][4], int rg, int u,
                                              int ks) {
  if (ks < 0) return;
#pragma unroll
  for (int r = 0; r < RB; ++r)
    *reinterpret_cast<float4*>(red + (size_t)(ks * L.BT + rg * RB + r) * L.NC + 4 * u) =
        make_float4(acc[r][0], acc[r][1], acc[r][2], acc[r][3]);
}

// Adds the KS partial sums of each (row, unit) of the tile and updates the
// cell; writes h_t to h_seq (and to hs, row stride ldh, when hs is not null,
// to hnext, row stride H, when hnext is not null, and at the `last` step to
// h_last when that is not null), in float32 but for h_seq, which rounds to E.
template <class E>
__device__ void cell_update(const Args<E>& a, const Layout& L, const float* red, const Pairs& p, int b0, int j0,
                            int t, bool last, float* hs, int ldh, float* hnext) {
#pragma unroll
  for (int i = 0; i < RB; ++i) {
    const int q = threadIdx.x + i * NT;
    const int b = q / L.TJ, u = q % L.TJ;
    if (q >= L.BT * L.TJ || b0 + b >= a.B) continue;
    float4 s = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    for (int k = 0; k < L.KS; ++k) {
      const float4 v = *reinterpret_cast<const float4*>(red + (size_t)(k * L.BT + b) * L.NC + 4 * u);
      s.x += v.x;
      s.y += v.y;
      s.z += v.z;
      s.w += v.w;
    }
    const size_t bb = b0 + b, j = j0 + u;
    const float si = sigmoid(p.xp[i][0] + s.x);
    const float sf = sigmoid(p.xp[i][1] + s.y);
    const float tg = tanhf(p.xp[i][2] + s.z);
    const float so = sigmoid(p.xp[i][3] + s.w);
    const float c = sf * a.c_state[bb * a.H + j] + si * tg;
    const float h = so * tanhf(c);
    a.c_state[bb * a.H + j] = c;
    const size_t row = bb * a.T + t;
    store1(a.h_seq + row * a.H + j, h);
    if (hnext != nullptr) hnext[bb * a.H + j] = h;
    if (last && a.h_last != nullptr) a.h_last[bb * a.H + j] = h;
    if (a.c_seq != nullptr) a.c_seq[row * a.H + j] = c;
    if (a.gates != nullptr) {
      float* gt = a.gates + row * 4 * a.H + j;
      gt[0] = si;
      gt[(size_t)a.H] = sf;
      gt[2 * (size_t)a.H] = tg;
      gt[3 * (size_t)a.H] = so;
    }
    if (hs != nullptr) hs[b * ldh + u] = h;
  }
}

// Regime (a): block y owns batch rows [y*rows, y*rows + rows) and all H
// units. Shared memory: W (H x 4H), hs (rows x (H + PAD)), red.
template <class E>
__global__ void __launch_bounds__(NT) lstm_fwd_block_kernel(Args<E> a) {
  extern __shared__ __align__(16) float smem[];
  const Layout L(a, a.H);
  const int ldh = a.H + PAD;
  E* W = reinterpret_cast<E*>(smem);
  float* hs = reinterpret_cast<float*>(W + (size_t)a.H * L.NC);
  float* red = hs + (size_t)L.BT * ldh;
  const int b0 = blockIdx.x * L.BT;

  load_w(W, a, L, 0, 0, a.H);
  for (int e = threadIdx.x; e < L.BT * ldh; e += NT) {
    const int b = e / ldh, k = e % ldh;
    hs[e] = (a.h0 != nullptr && k < a.H && b0 + b < a.B) ? a.h0[(size_t)(b0 + b) * a.H + k] : 0.0f;
  }
  __syncthreads();

  int rg, u, ks;
  task_of(L, rg, u, ks);
  // the next step's xproj is loaded while this step runs: a step here is a
  // few hundred cycles, shorter than a load from device memory
  Pairs p, next;
  prefetch_x(next, a, L, b0, 0, a.reverse ? a.T - 1 : 0);
  for (int s = 0; s < a.T; ++s) {
    const int t = a.reverse ? a.T - 1 - s : s;
    p = next;
    if (s + 1 < a.T) prefetch_x(next, a, L, b0, 0, a.reverse ? t - 1 : t + 1);
    float acc[RB][4] = {};
    if (ks >= 0 && (s > 0 || a.h0 != nullptr)) gemm_slice(acc, hs, ldh, W, L.NC, rg * RB, 4 * u, a.H / 4, ks, L.KS);
    store_partial(red, L, acc, rg, u, ks);
    __syncthreads();  // partials complete; hs (h_{t-1}) no longer read
    cell_update<E>(a, L, red, p, b0, 0, t, s == a.T - 1, hs, ldh, nullptr);
    __syncthreads();  // h_t in hs before the next product
  }
}

// Regimes (b) and (c): block x owns units [x*units, x*units + units) for
// every batch row. Shared memory: W (kres x 4 units: all H rows in (b)), two
// staging buffers (rows x (kc + PAD)), red, and in (c) the ring of two
// streamed chunks of W (kc x 4 units). Launched cooperatively only.
template <class E>
__global__ void __launch_bounds__(NT, 1) lstm_fwd_grid_kernel(Args<E> a) {
  extern __shared__ __align__(16) float smem[];
  const Layout L(a, a.units);
  const int lds = a.kc + PAD;
  E* W = reinterpret_cast<E*>(smem);
  float* stage = reinterpret_cast<float*>(W + (size_t)a.kres * L.NC);
  float* red = stage + 2 * (size_t)L.BT * lds;
  E* ring = reinterpret_cast<E*>(red + (size_t)L.KS * L.BT * L.NC);
  const int j0 = blockIdx.x * L.TJ;
  const int ntiles = (a.B + L.BT - 1) / L.BT;
  const int nch = (a.H + a.kc - 1) / a.kc;
  E* wst = a.wst != nullptr ? a.wst + (size_t)blockIdx.x * (a.H - a.kres) * L.NC : nullptr;
  cg::grid_group grid = cg::this_grid();

  load_w(W, a, L, j0, 0, a.kres);
  if (wst != nullptr) {
    load_w(wst, a, L, j0, a.kres, a.H);
    __threadfence();  // the streamed rows written before any thread's copies read them back
  }
  for (int e = threadIdx.x; e < 2 * L.BT * lds; e += NT) stage[e] = 0.0f;
  __syncthreads();

  int rg, u, ks;
  task_of(L, rg, u, ks);
  Pairs p;
  for (int s = 0; s < a.T; ++s) {
    const int t = a.reverse ? a.T - 1 - s : s;
    const int t_prev = a.reverse ? t + 1 : t - 1;
    // h_{t-1}: row b at src + b * stride (h0, or the previous step's half
    // of hbuf, or the previous slice of h_seq when that is float32)
    const float* src = a.h0;
    size_t stride = a.H;
    float* hnext = a.hbuf != nullptr ? a.hbuf + (size_t)(s & 1) * a.B * a.H : nullptr;
    if (s > 0 && a.hbuf != nullptr) {
      src = a.hbuf + (size_t)((s - 1) & 1) * a.B * a.H;
    } else if (s > 0) {
      if constexpr (std::is_same_v<E, float>) {
        src = a.h_seq + (size_t)t_prev * a.H;
        stride = (size_t)a.T * a.H;
      }
    }
    const int nst = src != nullptr ? ntiles * nch : 0;
    auto stage_in = [&](int q) {  // stage q = (tile, chunk) into buffer q % 2, with its rows of W in (c)
      const int b0 = (q / nch) * L.BT, k0 = (q % nch) * a.kc;
      const int nrow = min(L.BT, a.B - b0), n4 = min(a.kc, a.H - k0) / 4;
      float* buf = stage + (size_t)(q & 1) * L.BT * lds;
      for (int e = threadIdx.x; e < nrow * n4; e += NT) {
        const int r = e / n4, c4 = e % n4;
        cp_async16(buf + r * lds + 4 * c4, src + (b0 + r) * stride + k0 + 4 * c4);
      }
      if (k0 >= a.kres) {  // a streamed chunk: its kc x NC elements are contiguous in wst
        const int n16 = (int)((size_t)min(a.kc, a.H - k0) * L.NC * sizeof(E) / 16);
        const float* from = reinterpret_cast<const float*>(wst + (size_t)(k0 - a.kres) * L.NC);
        float* to = reinterpret_cast<float*>(ring + (size_t)(q & 1) * a.kc * L.NC);
        for (int e = threadIdx.x; e < n16; e += NT) cp_async16(to + 4 * e, from + 4 * e);
      }
      cp_async_commit();
    };
    if (nst > 0) stage_in(0);
    for (int tile = 0; tile < ntiles; ++tile) {
      const int b0 = tile * L.BT;
      prefetch_x(p, a, L, b0, j0, t);
      float acc[RB][4] = {};
      for (int ch = 0; nst > 0 && ch < nch; ++ch) {
        const int q = tile * nch + ch;
        if (q + 1 < nst) {
          stage_in(q + 1);
          cp_async_wait<1>();
        } else {
          cp_async_wait<0>();
        }
        __syncthreads();  // stage q visible to every thread
        const int k0 = ch * a.kc;
        const E* w = k0 < a.kres ? W + (size_t)k0 * L.NC : ring + (size_t)(q & 1) * a.kc * L.NC;
        if (ks >= 0)
          gemm_slice(acc, stage + (size_t)(q & 1) * L.BT * lds, lds, w, L.NC, rg * RB, 4 * u,
                     min(a.kc, a.H - k0) / 4, ks, L.KS);
        __syncthreads();  // buffer q % 2 free for stage q + 2
      }
      store_partial(red, L, acc, rg, u, ks);
      __syncthreads();
      cell_update<E>(a, L, red, p, b0, j0, t, s == a.T - 1, nullptr, 0, hnext);
      __syncthreads();  // red free for the next tile
    }
    if (s + 1 < a.T) grid.sync();  // every h_t written before any block reads it
  }
}

// Shared bytes of a plan, computed as the kernels lay them out: w_hh's
// slice (its kres rows and the ring of two kc-row chunks in regime (c)) in
// elements of `wbytes` bytes, the rest float32.
size_t smem_bytes(int regime, int H, int units, int rows, int kc, int ks, int wbytes, int kres) {
  const size_t nc = 4 * (size_t)units;
  const size_t w = (regime == 2 ? (size_t)kres + 2 * (size_t)kc : (size_t)H) * nc;
  const size_t staged = regime == 0 ? (size_t)rows * (H + PAD) : 2 * (size_t)rows * (kc + PAD);
  return wbytes * w + 4 * (staged + (size_t)ks * rows * nc);
}

template <class E>
int run(const Args<E>& a, int regime, int blocks, int smem, int* info, cudaStream_t stream) {
  return launch(lstm_fwd_block_kernel<E>, lstm_fwd_grid_kernel<E>, a, regime == 0 ? 0 : 1, blocks, smem, info,
                stream);
}

}  // namespace

extern "C" {

// Runs the whole sequence in one launch on `stream`, without synchronising.
// regime 0 is (a), 1 is (b), 2 is (c); blocks, units, rows, kc, kres and
// smem are the plan of ops/lstm.py:launch_plan. h0, c_seq and gates may be
// null; c_state holds c0 on entry and cN on exit; wst, regime (c)'s
// streamed rows (blocks x (H - kres) x 4 units floats, scratch), null
// otherwise. info (2 ints, may be null) receives the blocks
// that can be resident on one SM and the SM count. Returns 0, ERR_PLAN for a
// plan that does not fit the shapes, ERR_RESIDENT for a grid that cannot be
// resident, or the CUDA error of the launch (cudaGetLastError).
int autovc_lstm_fwd(const float* xproj, const float* w_hh, const float* h0, float* h_seq, float* c_state,
                    float* c_seq, float* gates, float* wst, int B, int T, int H, int reverse, int regime, int blocks,
                    int units, int rows, int kc, int kres, int smem, int* info, cudaStream_t stream) {
  const int tasks = rows / RB * (regime == 0 ? H : units);  // (row group, unit)
  int ks = 0;
  if (check_plan(B, T, H, H, regime, blocks, units, rows, kc, kres, tasks, ks) != 0 ||
      smem_bytes(regime, H, units, rows, kc, ks, 4, kres) != (size_t)smem || (regime == 2) != (wst != nullptr))
    return ERR_PLAN;
  const Args<float> a{xproj, w_hh, h0, h_seq, nullptr, c_state, c_seq, gates, nullptr, wst,
                      B, T, H, reverse, units, rows, kc, ks, regime == 2 ? kres : H};
  return run(a, regime, blocks, smem, info, stream);
}

// The bfloat16 form: xproj (B, T, 4H), w_hh (H, 4H) and h_seq (B, T, H) in
// bfloat16; h0 (B, H) float32 or null (zero); c_state (B, H) float32, c0 on
// entry (the caller zeroes it for a zero state), cN on exit; hbuf the
// float32 (2, B, H) exchange buffer of regime (b) (scratch, no initial
// value; may be null in regime (a)); the training form's c_seq (B, T, H)
// and h_last (B, H), float32, may be null (inference); wst as
// autovc_lstm_fwd's, in bfloat16. Returns as autovc_lstm_fwd.
int autovc_lstm_fwd_bf16(const void* xproj, const void* w_hh, const float* h0, void* h_seq, float* hbuf,
                         float* c_state, float* c_seq, float* h_last, void* wst, int B, int T, int H, int reverse,
                         int regime, int blocks, int units, int rows, int kc, int kres, int smem, int* info,
                         cudaStream_t stream) {
  const int tasks = rows / RB * (regime == 0 ? H : units);
  int ks = 0;
  if (check_plan(B, T, H, H, regime, blocks, units, rows, kc, kres, tasks, ks) != 0 ||
      smem_bytes(regime, H, units, rows, kc, ks, 2, kres) != (size_t)smem || (regime != 0 && hbuf == nullptr) ||
      (regime == 2) != (wst != nullptr))
    return ERR_PLAN;
  const Args<__nv_bfloat16> a{static_cast<const __nv_bfloat16*>(xproj), static_cast<const __nv_bfloat16*>(w_hh), h0,
                              static_cast<__nv_bfloat16*>(h_seq), regime != 0 ? hbuf : nullptr, c_state, c_seq,
                              nullptr, h_last, static_cast<__nv_bfloat16*>(wst), B, T, H, reverse, units, rows, kc,
                              ks, regime == 2 ? kres : H};
  return run(a, regime, blocks, smem, info, stream);
}

const char* autovc_cuda_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

}  // extern "C"
