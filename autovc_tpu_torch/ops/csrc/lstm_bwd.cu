// Backward of the LSTM recurrence over hoisted input projections: the
// reversed recurrence with dh0 in one launch per sequence, each block holding
// its rows of w_hh in shared memory for the whole sequence, and the recurrent
// weight gradient as a tiled SGEMM.
//
// Replaces the backward Pallas kernels of autovc_tpu/ops/pallas_lstm.py:
//   _chunk_bwd_call (-> _lstm_bwd_kernel, dW_hh accumulated on-chip) and
//   _split_bwd_rule (-> _lstm_bwd_kernel_split, dW as one matmul outside).
// The TPU split the gates only because a (H, 4H) f32 w_hh of 16 MB at H=1024
// does not fit its VMEM; here one kernel set serves every H, streaming what
// does not fit the blocks' shared memory (regime (c) below).
//
// Inputs are the forward's training form (csrc/lstm_fwd.cu): the gate
// activations act (B, T, 4H) = [sigmoid(i), sigmoid(f), tanh(g), sigmoid(o)],
// c_seq (B, T, H), w_hh (H, 4H) row-major, c0 (B, H) or null (zero), and the
// cotangents dy (B, T, H), dhN (B, H) or null. Walking the steps in the
// reverse of the forward's order (t = T-1 .. 0, or 0 .. T-1 for reverse=1,
// whose forward ran right to left), step t computes, in float32:
//   si, sf, tg, so = act[:, t];  cprev = c_seq at the forward's step before t (or c0)
//   dh = dy[:, t] + (dgates_{t_next} @ w_hh^T, or dhN at the first step taken)
//   do = dh * tanh(c_t) * so * (1 - so)
//   dc = dc + dh * so * (1 - tanh(c_t)^2)
//   di = dc * tg * si * (1 - si);  dg = dc * si * (1 - tg^2);  df = dc * cprev * sf * (1 - sf)
//   dxproj[:, t] = [di, df, dg, do];  dc = dc * sf
// the formulas of pallas_lstm.py:438-453, and after the last step
// dh0 = dgates_{last} @ w_hh^T; dc0 is the carried dc. Then
//   dW[k, g] = sum over (b, t) of hprev[b, t, k] * dxproj[b, t, g]
// is a separate kernel over the whole sequence (K = B*T).
//
// Bound. A step's dh contraction is 8*B*H^2 flops of f32 FMAs and depends on
// the step before, as the forward's product does; dW is 8*B*T*H^2 flops in
// one parallel product. The previous design launched one kernel per step
// and read w_hh twice a step from L2 (as columns for a gate recompute, as
// rows for dh): 101 us a step at H=1024, B=7.
//
// Design. The forward saves the gate activations, so no gate is recomputed
// here and a block needs only the rows of w_hh of its units (4H floats
// each): at H=1024 the columns and the rows together (256 KB a block) would
// not fit. The launch plan comes from ops/lstm.py (launch_plan, kind "bwd"):
//  (a) w_hh fits one block (H <= 112): one block per tile of batch rows
//      walks all T steps and the dh0 step with the whole of w_hh and its
//      rows of dgates in shared memory; __syncthreads only, no grid barrier.
//  (b) larger H: a persistent cooperative kernel, at most one block per SM,
//      each block owning `units` hidden units and their rows of w_hh. Step t
//      stages dgates_{t_next} of every batch row from dxproj (cp.async.cg
//      through L2, double-buffered K chunks), forms dh for its units, writes
//      its columns of dxproj[:, t], and meets the other blocks at
//      cooperative_groups' grid barrier; dh0 is the last step of the launch.
//      cudaLaunchCooperativeKernel, after an occupancy check.
//  (c) a block's rows of w_hh past its shared memory (H=2048: 512 KB in
//      float32 a block of 16 units): (b)'s kernel and blocks, with only the
//      first kres of its 4H rows of K resident (a multiple of kc). At its
//      start each block writes the rest, laid out as in shared memory, to
//      its part of wst (device memory); each step streams them chunk by
//      chunk into a ring of two kc-row buffers in the same commit group as
//      the chunk of dgates they multiply (cp.async.cg). The counterpart of
//      _lstm_bwd_kernel_split (pallas_lstm.py:169), which streams w_hh's
//      gate blocks from HBM each step.
// A thread computes RB batch rows x 4 units over a slice of K = 4H, the
// slices are added in shared memory, and one thread per (row, unit) applies
// the cell gradient and updates dc in place (only it reads and writes it).
// The weight gradient is a pipelined, split-K SGEMM (lstm_dw_kernel, its own
// notes below) whose loader builds hprev's rows from h_seq and h0, so no
// shifted copy of h_seq is made; the reverse direction is walked left to
// right in place, never flipped by a copy.
//
// bfloat16 form (autovc_lstm_bwd_bf16, autovc_lstm_dw with bf16 = 1), the
// Pallas backward on a bfloat16 xproj and w_hh (_lstm_bwd_kernel on the
// _lstm_kernel_train residuals, pallas_lstm.py:410-453, 514-525). The gate
// activations come from lstm_gates.cu, which recomputes them from the
// bfloat16 h_seq as the Pallas backward does (pallas_lstm.py:431, 465),
// not from the forward's float32 carry. Every sum stays float32: dy is read
// as bfloat16 and widened, w_hh's rows sit in shared memory as bfloat16 (half
// the bytes) and are widened before each float32 FMA, the gate gradients are
// written in float32 to `dgates` (B, T, 4H) and, rounded, to the bfloat16
// dxproj from the same registers (pallas_lstm.py:446). dh's carry, dgates_t
// @ w_hh^T, takes the float32 dgates (pallas_lstm.py:450): regime (a) keeps
// them in shared memory, regime (b) stages them from the float32 dgates,
// never from the rounded dxproj (the same trap as the forward's h
// exchange). dW sums hprev (the bfloat16 h_seq widened; h0 in float32) times
// the float32 dgates in float32 and rounds once to bfloat16
// (dw.astype(w_hh.dtype), pallas_lstm.py:525). dh0 and dc0 stay float32.
// Bound: the float32 form's operations (the products stay FMAs on the CUDA
// cores), fewer bytes.
//
// The scan rounding's backward (the bfloat16 carry, every op rounded) is
// csrc/lstm_scan_bwd.cu's, its dW csrc/lstm_scan_dw.cu's.

#include <type_traits>

#include "lstm_common.cuh"

namespace cg = cooperative_groups;

namespace {

// E is the element type of w_hh, dy and dxproj: float (dxproj null: the
// float32 dgates are the result), or __nv_bfloat16.
template <class E>
struct Args {
  const float* act;
  const E* w_hh;
  const float* c0;
  const float* c_seq;
  const E* dy;
  const float* dhn;
  float* dgates;  // (B, T, 4H) float32 gate gradients: exchanged between regime (b)'s steps, read by dW
  E* dxproj;      // the same rounded to E, or null
  float* dc_state;
  float* dh0;
  E* wst;  // regime (c): each block's streamed rows of W, (4H - kres) x NC, or null
  int B, T, H, reverse;
  int units, rows, kc, ks;
  int kres;  // rows of K = 4H of W resident in shared memory: 4H but in regime (c)
};

// The block's shape: units TJ (padded to NC, a multiple of 4, with zero
// columns of W), rows BT, tasks = (BT/RB) * NC/4 (row group, 4 units), each
// split KS ways over K = 4H.
struct Layout {
  int TJ, BT, NC, RG, tasks, KS;
  template <class E>
  __device__ Layout(const Args<E>& a, int tj)
      : TJ(tj), BT(a.rows), NC((tj + 3) / 4 * 4), RG(a.rows / RB), tasks(RG * NC / 4), KS(a.ks) {}
};

// Loads rows [k0, k1) of the block's rows of w_hh, transposed: W[k - k0][u]
// = w_hh[j0 + u, k] (zero for u >= TJ), read along the rows; W is shared
// memory, or the block's part of wst in regime (c).
template <class E>
__device__ void load_w(E* W, const Args<E>& a, const Layout& L, int j0, int k0, int k1) {
  const int K = 4 * a.H, nk = k1 - k0, n = nk * L.NC;
  for (int e = threadIdx.x; e < n; e += NT) {
    const int k = e % nk, u = e / nk;
    W[(size_t)k * L.NC + u] = u < L.TJ ? a.w_hh[(size_t)(j0 + u) * K + k0 + k] : static_cast<E>(0.0f);
  }
}

__device__ __forceinline__ void task_of(const Layout& L, int& rg, int& cgi, int& ks) {
  const int tid = threadIdx.x, ncg = L.NC / 4;
  cgi = tid % ncg;
  rg = (tid / ncg) % L.RG;
  ks = tid < L.tasks * L.KS ? tid / L.tasks : -1;
}

__device__ __forceinline__ void store_partial(float* red, const Layout& L, const float (&acc)[RB][4], int rg, int cgi,
                                              int ks) {
  if (ks < 0) return;
#pragma unroll
  for (int r = 0; r < RB; ++r)
    *reinterpret_cast<float4*>(red + (size_t)(ks * L.BT + rg * RB + r) * L.NC + 4 * cgi) =
        make_float4(acc[r][0], acc[r][1], acc[r][2], acc[r][3]);
}

// The forward's step t: the time step taken s steps into the backward, and
// the step the forward took before it (-1 or T at the sequence's start).
template <class E>
__device__ __forceinline__ int step_t(const Args<E>& a, int s) {
  return a.reverse ? s : a.T - 1 - s;
}

// One thread's residuals for its (row, unit) pairs of a tile at step t,
// loaded before the dh product so that they are in flight during it.
struct Pairs {
  float act[RB][4], c[RB], cprev[RB], dy[RB];
};

template <class E>
__device__ __forceinline__ void prefetch(Pairs& p, const Args<E>& a, const Layout& L, int b0, int j0, int t) {
  const int t_prev = a.reverse ? t + 1 : t - 1;
#pragma unroll
  for (int i = 0; i < RB; ++i) {
    const int q = threadIdx.x + i * NT;
    const int b = q / L.TJ, u = q % L.TJ;
    if (q < L.BT * L.TJ && b0 + b < a.B) {
      const size_t bb = b0 + b, j = j0 + u, row = bb * a.T + t;
      const float* g = a.act + row * 4 * a.H + j;
#pragma unroll
      for (int k = 0; k < 4; ++k) p.act[i][k] = __ldg(g + (size_t)k * a.H);
      p.c[i] = __ldg(a.c_seq + row * a.H + j);
      p.dy[i] = load_ro1(a.dy + row * a.H + j);
      p.cprev[i] = (t_prev < 0 || t_prev >= a.T) ? (a.c0 != nullptr ? __ldg(a.c0 + bb * a.H + j) : 0.0f)
                                                  : __ldg(a.c_seq + (bb * a.T + t_prev) * a.H + j);
    }
  }
}

// Adds the KS partial sums of dh's carry for each (row, unit) of the tile.
// At s == T writes them to dh0; at s == 0 takes dhN as the carry instead;
// otherwise applies the cell gradient at step t, writing dgates[:, t], and
// dxproj[:, t] rounded to E when it is not null (and dgs, row stride ldg,
// when dgs is not null).
template <class E>
__device__ void cell_backward(const Args<E>& a, const Layout& L, const float* red, const Pairs& p, int b0, int j0,
                              int s, float* dgs, int ldg) {
  const int t = s < a.T ? step_t(a, s) : 0;
#pragma unroll
  for (int i = 0; i < RB; ++i) {
    const int q = threadIdx.x + i * NT;
    const int b = q / L.TJ, u = q % L.TJ;
    if (q >= L.BT * L.TJ || b0 + b >= a.B) continue;
    const size_t bb = b0 + b, j = j0 + u;
    float carry = 0.0f;
    if (s > 0) {
      for (int k = 0; k < L.KS; ++k) carry += red[(size_t)(k * L.BT + b) * L.NC + u];
    } else if (a.dhn != nullptr) {
      carry = a.dhn[bb * a.H + j];
    }
    if (s == a.T) {
      if (a.dh0 != nullptr) a.dh0[bb * a.H + j] = carry;
      continue;
    }
    const float si = p.act[i][0], sf = p.act[i][1], tg = p.act[i][2], so = p.act[i][3];
    const float tc = tanhf(p.c[i]);
    const float dh = p.dy[i] + carry;
    const float d_o = dh * tc * so * (1.0f - so);
    const float dc = a.dc_state[bb * a.H + j] + dh * so * (1.0f - tc * tc);
    const float di = dc * tg * si * (1.0f - si);
    const float dg = dc * si * (1.0f - tg * tg);
    const float df = dc * p.cprev[i] * sf * (1.0f - sf);
    const float dc_next = dc * sf;
    const size_t at = (bb * a.T + t) * 4 * a.H + j;
    float* dx = a.dgates + at;
    dx[0] = di;
    dx[(size_t)a.H] = df;
    dx[2 * (size_t)a.H] = dg;
    dx[3 * (size_t)a.H] = d_o;
    if (a.dxproj != nullptr) {
      E* dr = a.dxproj + at;
      store1(dr, di);
      store1(dr + a.H, df);
      store1(dr + 2 * (size_t)a.H, dg);
      store1(dr + 3 * (size_t)a.H, d_o);
    }
    a.dc_state[bb * a.H + j] = dc_next;
    if (dgs != nullptr) {
      float* d = dgs + b * ldg + j;
      d[0] = di;
      d[a.H] = df;
      d[2 * a.H] = dg;
      d[3 * a.H] = d_o;
    }
  }
}

// Regime (a): block x owns batch rows [x*rows, x*rows + rows) and all H
// units. Shared memory: W (4H x H), dgs (rows x (4H + PAD)), red.
template <class E>
__global__ void __launch_bounds__(NT) lstm_bwd_block_kernel(Args<E> a) {
  extern __shared__ __align__(16) float smem[];
  const Layout L(a, a.H);
  const int K = 4 * a.H, ldg = K + PAD;
  E* W = reinterpret_cast<E*>(smem);
  float* dgs = reinterpret_cast<float*>(W + (size_t)K * L.NC);
  float* red = dgs + (size_t)L.BT * ldg;
  const int b0 = blockIdx.x * L.BT;

  load_w(W, a, L, 0, 0, K);
  for (int e = threadIdx.x; e < L.BT * ldg; e += NT) dgs[e] = 0.0f;
  __syncthreads();

  int rg, cgi, ks;
  task_of(L, rg, cgi, ks);
  // the next step's residuals are loaded while this step runs
  Pairs p, next;
  prefetch(next, a, L, b0, 0, step_t(a, 0));
  for (int s = 0; s <= a.T; ++s) {  // s == T: the dh0 step
    p = next;
    if (s + 1 < a.T) prefetch(next, a, L, b0, 0, step_t(a, s + 1));
    float acc[RB][4] = {};
    if (ks >= 0 && s > 0) gemm_slice(acc, dgs, ldg, W, L.NC, rg * RB, 4 * cgi, a.H, ks, L.KS);
    store_partial(red, L, acc, rg, cgi, ks);
    __syncthreads();  // partials complete; dgs (dgates_{t_next}) no longer read
    cell_backward<E>(a, L, red, p, b0, 0, s, dgs, ldg);
    __syncthreads();
  }
}

// Regimes (b) and (c): block x owns units [x*units, x*units + units) for
// every batch row. Shared memory: W (kres x NC: all 4H rows in (b)), two
// staging buffers (rows x (kc + PAD)), red, and in (c) the ring of two
// streamed chunks of W (kc x NC). Launched cooperatively only.
template <class E>
__global__ void __launch_bounds__(NT, 1) lstm_bwd_grid_kernel(Args<E> a) {
  extern __shared__ __align__(16) float smem[];
  const Layout L(a, a.units);
  const int K = 4 * a.H, lds = a.kc + PAD;
  E* W = reinterpret_cast<E*>(smem);
  float* stage = reinterpret_cast<float*>(W + (size_t)a.kres * L.NC);
  float* red = stage + 2 * (size_t)L.BT * lds;
  E* ring = reinterpret_cast<E*>(red + (size_t)L.KS * L.BT * L.NC);
  const int j0 = blockIdx.x * L.TJ;
  const int ntiles = (a.B + L.BT - 1) / L.BT;
  const int nch = (K + a.kc - 1) / a.kc;
  E* wst = a.wst != nullptr ? a.wst + (size_t)blockIdx.x * (K - a.kres) * L.NC : nullptr;
  cg::grid_group grid = cg::this_grid();

  load_w(W, a, L, j0, 0, a.kres);
  if (wst != nullptr) {
    load_w(wst, a, L, j0, a.kres, K);
    __threadfence();  // the streamed rows written before any thread's copies read them back
  }
  for (int e = threadIdx.x; e < 2 * L.BT * lds; e += NT) stage[e] = 0.0f;
  __syncthreads();

  int rg, cgi, ks;
  task_of(L, rg, cgi, ks);
  Pairs p;
  for (int s = 0; s <= a.T; ++s) {  // s == T: the dh0 step
    // dgates of the step taken before: row b at src + b * T * 4H
    const float* src = s == 0 ? nullptr : a.dgates + (size_t)step_t(a, s - 1) * K;
    const size_t stride = (size_t)a.T * K;
    const int nst = src != nullptr ? ntiles * nch : 0;
    auto stage_in = [&](int q) {  // stage q = (tile, chunk) into buffer q % 2, with its rows of W in (c)
      const int b0 = (q / nch) * L.BT, k0 = (q % nch) * a.kc;
      const int nrow = min(L.BT, a.B - b0), n4 = min(a.kc, K - k0) / 4;
      float* buf = stage + (size_t)(q & 1) * L.BT * lds;
      for (int e = threadIdx.x; e < nrow * n4; e += NT) {
        const int r = e / n4, c4 = e % n4;
        cp_async16(buf + r * lds + 4 * c4, src + (b0 + r) * stride + k0 + 4 * c4);
      }
      if (k0 >= a.kres) {  // a streamed chunk: its kc x NC elements are contiguous in wst
        const int n16 = (int)((size_t)min(a.kc, K - k0) * L.NC * sizeof(E) / 16);
        const float* from = reinterpret_cast<const float*>(wst + (size_t)(k0 - a.kres) * L.NC);
        float* to = reinterpret_cast<float*>(ring + (size_t)(q & 1) * a.kc * L.NC);
        for (int e = threadIdx.x; e < n16; e += NT) cp_async16(to + 4 * e, from + 4 * e);
      }
      cp_async_commit();
    };
    if (nst > 0) stage_in(0);
    for (int tile = 0; tile < ntiles; ++tile) {
      const int b0 = tile * L.BT;
      if (s < a.T) prefetch(p, a, L, b0, j0, step_t(a, s));
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
          gemm_slice(acc, stage + (size_t)(q & 1) * L.BT * lds, lds, w, L.NC, rg * RB, 4 * cgi,
                     min(a.kc, K - k0) / 4, ks, L.KS);
        __syncthreads();  // buffer q % 2 free for stage q + 2
      }
      store_partial(red, L, acc, rg, cgi, ks);
      __syncthreads();
      cell_backward<E>(a, L, red, p, b0, j0, s, nullptr, 0);
      __syncthreads();  // red free for the next tile
    }
    if (s < a.T) grid.sync();  // every dgates_t written before any block reads it
  }
}

// Shared bytes of a plan, computed as the kernels lay them out: w_hh's rows
// (its kres rows and the ring of two kc-row chunks in regime (c)) in
// elements of `wbytes` bytes, the rest float32.
size_t smem_bytes(int regime, int H, int units, int rows, int kc, int ks, int wbytes, int kres) {
  const size_t K = 4 * (size_t)H, nc = (size_t)(units + 3) / 4 * 4;
  const size_t w = (regime == 2 ? (size_t)kres + 2 * (size_t)kc : K) * nc;
  const size_t staged = regime == 0 ? (size_t)rows * (K + PAD) : 2 * (size_t)rows * (kc + PAD);
  return wbytes * w + 4 * (staged + (size_t)ks * rows * nc);
}

template <class E>
int run(const Args<E>& a, int regime, int blocks, int smem, int* info, cudaStream_t stream) {
  return launch(lstm_bwd_block_kernel<E>, lstm_bwd_grid_kernel<E>, a, regime == 0 ? 0 : 1, blocks, smem, info,
                stream);
}

// The weight gradient dW (H, 4H) = hprev^T @ dxproj over the K = B*T rows
// (b, t): hprev row (b, t) is h_seq[b, t-1] (t+1 for reverse), or h0[b]
// (zero if null) at the sequence's start. The plan is ops/lstm.py:dw_plan.
//
// Bound: 8*B*T*H^2 flops of f32 FMAs (the tensor cores are not taken: every
// entry point promises exact f32), so it is bound by operations at every
// width of the package. A block owns a DW_TILE x DW_TILE tile of dW; each of
// its 8 warps a 32 x 64 part of it, each thread 8 x 8 outputs (two float4
// of rows by two of columns). It walks its rows of K in tiles of DW_KT rows
// through a DW_STAGES ring filled by 16-byte cp.async copies, so the next
// tiles load while the current one is multiplied. Both operands are read as
// rows of K (row r of hprev is contiguous in m, row r of dxproj in n), so
// nothing is transposed; a warp's reads of a stage row are 64 contiguous
// bytes of hprev and 128 of dxproj, one shared-memory wavefront each, so the
// rows need no padding. A warp whose rows or columns lie past H or 4H skips
// the product, and a tile of at most 32 rows (H=32) spreads each stage's
// rows over its warps instead (see `narrow`). Each thread reads the next
// row's four float4 while it multiplies the current row's (faster at
// H=1024 on an H100 than reading them just before). Where the tiles alone
// cannot fill the card (H=32: one tile; H=512: 64), K is split over
// `splits` blocks a tile: each writes its partial tile to the workspace,
// and the last of them to finish (an integer counter per tile after a
// __threadfence, no spin-wait) adds the partials in the order of the split
// index, reading them through L2, and sets the counter back to zero. No
// float atomics: dW is the same, bit for bit, on every call. In the
// bfloat16 form (TH = __nv_bfloat16) hprev's rows come from the bfloat16
// h_seq, read 8 bytes a thread and widened into the stage by the thread (a
// plain load and store in place of the copy; h0's rows stay float32
// copies), and the result is rounded once to bfloat16 where it is written.
constexpr int DW_TILE = 128;         // rows (m) and columns (n) of dW a block
constexpr int DW_KT = 16;            // rows of K a stage
constexpr int DW_STAGES = 3;         // stages in the ring: 3 x 16 KB, the static shared limit
constexpr int DW_BLOCKS_PER_SM = 2;  // resident blocks an SM (ops/lstm.py:dw_plan counts on them)
constexpr int DW_ZU = 4;             // splits read at once when the partials are added
constexpr int DW_LOADS = DW_KT * DW_TILE / 4 / NT;  // float4 of each operand a thread copies a stage
static_assert(DW_LOADS * 4 * NT == DW_KT * DW_TILE && DW_KT % 4 == 0, "whole float4 rows a stage");
static_assert(2 * 2 * 32 * 64 <= 2 * DW_STAGES * DW_KT * DW_TILE, "a narrow tile's partial sums fit the ring");

// TH is the element type of h_seq and dw: float, or __nv_bfloat16.
template <class TH>
struct DwArgs {
  const TH* h_seq;
  const float* h0;
  const float* dxproj;  // the float32 gate gradients
  TH* dw;
  float* ws;      // splits x H x 4H partial sums (splits > 1)
  int* counters;  // one per tile, zero on entry and on exit (splits > 1)
  int B, T, H, reverse, chunk;
};

// acc += the stage's rows kk = k0, k0 + STRIDE, ...: this thread's rows
// am .. am+3 and am+16 .. am+19 of the tile, its columns gn .. gn+3 and
// gn+32 .. gn+35.
template <int STRIDE>
__device__ __forceinline__ void dw_stage(float (&acc)[8][8], const float (*as)[DW_TILE], const float (*gs)[DW_TILE],
                                         int am, int gn, int k0) {
  // the next row's four float4 are read while this row's 64 FMAs run
  float4 a0 = *reinterpret_cast<const float4*>(&as[k0][am]);
  float4 a1 = *reinterpret_cast<const float4*>(&as[k0][am + 16]);
  float4 g0 = *reinterpret_cast<const float4*>(&gs[k0][gn]);
  float4 g1 = *reinterpret_cast<const float4*>(&gs[k0][gn + 32]);
#pragma unroll
  for (int kk = 0; kk < DW_KT; kk += STRIDE) {
    const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
    const float g[8] = {g0.x, g0.y, g0.z, g0.w, g1.x, g1.y, g1.z, g1.w};
    if (kk + STRIDE < DW_KT) {
      const int k = k0 + kk + STRIDE;
      a0 = *reinterpret_cast<const float4*>(&as[k][am]);
      a1 = *reinterpret_cast<const float4*>(&as[k][am + 16]);
      g0 = *reinterpret_cast<const float4*>(&gs[k][gn]);
      g1 = *reinterpret_cast<const float4*>(&gs[k][gn + 32]);
    }
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], g[j], acc[i][j]);
  }
}

// Four floats stored as float32, or rounded to four bfloat16 (8 bytes).
__device__ __forceinline__ void store4(float* p, const float4& v) { *reinterpret_cast<float4*>(p) = v; }
__device__ __forceinline__ void store4(__nv_bfloat16* p, const float4& v) {
  const __nv_bfloat162 lo = __floats2bfloat162_rn(v.x, v.y), hi = __floats2bfloat162_rn(v.z, v.w);
  *reinterpret_cast<uint2*>(p) =
      make_uint2(*reinterpret_cast<const unsigned*>(&lo), *reinterpret_cast<const unsigned*>(&hi));
}

template <class TH>
__global__ void __launch_bounds__(NT, DW_BLOCKS_PER_SM) lstm_dw_kernel(DwArgs<TH> a) {
  // the ring: stage q of hprev is ring[0][q], of dxproj ring[1][q]
  __shared__ __align__(16) float ring[2][DW_STAGES][DW_KT][DW_TILE];
  float(*as)[DW_KT][DW_TILE] = ring[0];
  float(*gs)[DW_KT][DW_TILE] = ring[1];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int H = a.H, H4 = 4 * H, T = a.T;
  const int m0 = blockIdx.y * DW_TILE, n0 = blockIdx.x * DW_TILE;
  // A tile of at most 32 rows (H=32, the last tile of H=160, ...) is narrow:
  // its warps split the rows of each stage four ways instead of the tile's
  // rows, so that all of them multiply, and add their sums at the end.
  const bool narrow = H - m0 <= 32;
  const int wm = narrow ? 0 : warp % 4, wn = narrow ? warp % 2 : warp / 4, wk = narrow ? warp / 2 : 0;
  const int am = 32 * wm + 4 * (lane / 8), gn = 64 * wn + 4 * (lane % 8);
  const bool busy = m0 + 32 * wm < H && n0 + 64 * wn < H4;
  const int K = a.B * T;
  const int k_begin = blockIdx.z * a.chunk, k_end = min(K, k_begin + a.chunk);
  const int n_tiles = (k_end - k_begin + DW_KT - 1) / DW_KT;

  // This thread copies float4 column c of stage rows lr + 8u: rows
  // r[u] = (b[u], t[u]) of K, advanced DW_KT rows a tile.
  const int lr = tid / (DW_TILE / 4), c = 4 * (tid % (DW_TILE / 4));
  int r[DW_LOADS], b[DW_LOADS], t[DW_LOADS];
#pragma unroll
  for (int u = 0; u < DW_LOADS; ++u) {
    r[u] = k_begin + lr + 8 * u;
    b[u] = r[u] / T;
    t[u] = r[u] % T;
  }
  // the next K tile into stage q: zeros past k_end, past H, or for a zero h0
  auto load = [&](int q) {
#pragma unroll
    for (int u = 0; u < DW_LOADS; ++u) {
      const float* hrow = nullptr;  // h0's row, or h_seq's when TH is float
      const TH* hseq = nullptr;     // h_seq's row when TH is bfloat16
      if (r[u] < k_end) {
        const int tp = a.reverse ? t[u] + 1 : t[u] - 1;
        if (tp < 0 || tp >= T) {
          hrow = a.h0 != nullptr ? a.h0 + (size_t)b[u] * H : nullptr;
        } else if constexpr (std::is_same_v<TH, float>) {
          hrow = a.h_seq + ((size_t)b[u] * T + tp) * H;
        } else {
          hseq = a.h_seq + ((size_t)b[u] * T + tp) * H;
        }
      }
      if (hseq != nullptr) {
        *reinterpret_cast<float4*>(&as[q][lr + 8 * u][c]) =
            m0 + c < H ? load4(hseq + m0 + c) : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      } else {
        const bool h_ok = hrow != nullptr && m0 + c < H;
        cp_async16_fill(&as[q][lr + 8 * u][c], h_ok ? hrow + m0 + c : a.dxproj, h_ok);
      }
      const bool g_ok = r[u] < k_end && n0 + c < H4;
      cp_async16_fill(&gs[q][lr + 8 * u][c], g_ok ? a.dxproj + (size_t)r[u] * H4 + n0 + c : a.dxproj, g_ok);
      r[u] += DW_KT;
      for (t[u] += DW_KT; t[u] >= T; t[u] -= T) ++b[u];
    }
  };

  float acc[8][8] = {};
#pragma unroll
  for (int q = 0; q < DW_STAGES - 1; ++q) {
    if (q < n_tiles) load(q);
    cp_async_commit();
  }
  for (int kt = 0; kt < n_tiles; ++kt) {
    cp_async_wait<DW_STAGES - 2>();  // tile kt has landed (this thread's copies)
    __syncthreads();                 // ... every thread's; stage (kt - 1) % S is free
    if (kt + DW_STAGES - 1 < n_tiles) load((kt + DW_STAGES - 1) % DW_STAGES);
    cp_async_commit();
    const int q = kt % DW_STAGES;
    if (busy && narrow)
      dw_stage<4>(acc, as[q], gs[q], am, gn, wk);
    else if (busy)
      dw_stage<1>(acc, as[q], gs[q], am, gn, 0);
  }
  if (narrow) {  // the four warps of a column half add their sums through the ring: (0 + 2) + (1 + 3)
    float4* part = reinterpret_cast<float4*>(&ring[0][0][0][0]);
    cp_async_wait<0>();
    for (int half = 2; half >= 1; half /= 2) {
      __syncthreads();
      if (wk >= half && wk < 2 * half)
#pragma unroll
        for (int j = 0; j < 16; ++j)
          part[(((wk - half) * 2 + wn) * 16 + j) * 32 + lane] =
              make_float4(acc[j / 2][4 * (j % 2)], acc[j / 2][4 * (j % 2) + 1], acc[j / 2][4 * (j % 2) + 2],
                          acc[j / 2][4 * (j % 2) + 3]);
      __syncthreads();
      if (wk < half)
#pragma unroll
        for (int j = 0; j < 16; ++j) {
          const float4 v = part[((wk * 2 + wn) * 16 + j) * 32 + lane];
          float* o = &acc[j / 2][4 * (j % 2)];
          o[0] += v.x;
          o[1] += v.y;
          o[2] += v.z;
          o[3] += v.w;
        }
    }
  }

  // output (i, q) of this thread: row m0 + am + i (+ 12 from i = 4, rows
  // am + 16 ..), float4 columns n0 + gn + 32 q; H4 % 32 == 0, so a group of
  // 4 columns is whole or past the end
  const bool split = gridDim.z > 1;
  float* partial = split ? a.ws + (size_t)blockIdx.z * H * H4 : nullptr;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int m = m0 + am + (i < 4 ? i : 12 + i);
    if (m >= H || wk > 0) continue;
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      const int n = n0 + gn + 32 * q;
      const float4 v = make_float4(acc[i][4 * q], acc[i][4 * q + 1], acc[i][4 * q + 2], acc[i][4 * q + 3]);
      if (n < H4 && split)
        store4(partial + (size_t)m * H4 + n, v);
      else if (n < H4)
        store4(a.dw + (size_t)m * H4 + n, v);
    }
  }
  if (!split) return;
  // the last block of the tile to finish adds the partials, split 0 first,
  // each thread up to 16 float4 of the tile at once
  __threadfence();
  __syncthreads();
  int last = 0;
  int* counter = a.counters + blockIdx.y * gridDim.x + blockIdx.x;
  if (tid == 0) last = atomicAdd(counter, 1) == (int)gridDim.z - 1;
  if (!__syncthreads_or(last)) return;
  __threadfence();
  if (tid == 0) *counter = 0;  // ready for the next call on this stream
  const size_t plane = (size_t)H * H4;
  const int c4s = min(DW_TILE, H4 - n0) / 4, n4 = min(DW_TILE, H - m0) * c4s, Z = gridDim.z;
  // float4 e = tid + (i0 + j) * NT of the tile, j < 4, for DW_ZU splits at
  // a time: up to 16 loads in flight, added in the order of the split
  for (int i0 = 0; i0 < DW_TILE * DW_TILE / 4 / NT && tid + i0 * NT < n4; i0 += 4) {
    size_t at[4];
    float4 sum[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int e = min(tid + (i0 + j) * NT, n4 - 1);
      at[j] = (size_t)(m0 + e / c4s) * H4 + n0 + 4 * (e % c4s);
    }
    for (int z0 = 0; z0 < Z; z0 += DW_ZU) {
      float4 v[DW_ZU][4];
#pragma unroll
      for (int u = 0; u < DW_ZU; ++u)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (z0 + u < Z) v[u][j] = __ldcg(reinterpret_cast<const float4*>(a.ws + (z0 + u) * plane + at[j]));
#pragma unroll
      for (int u = 0; u < DW_ZU; ++u)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (z0 + u < Z)
            sum[j] = z0 + u == 0 ? v[u][j]
                                 : make_float4(sum[j].x + v[u][j].x, sum[j].y + v[u][j].y, sum[j].z + v[u][j].z,
                                               sum[j].w + v[u][j].w);
    }
#pragma unroll
    for (int j = 0; j < 4; ++j)
      if (tid + (i0 + j) * NT < n4) store4(a.dw + at[j], sum[j]);
  }
}

}  // namespace

extern "C" {

// The backward recurrence over the whole sequence, dh0 included, in one
// launch on `stream`, without synchronising. regime 0 is (a), 1 is (b), 2
// is (c); blocks, units, rows, kc, kres and smem are the plan of
// ops/lstm.py:launch_plan (kind "bwd"). c0 and dhn may be null (zero);
// dc_state holds dcN on entry (the caller zeroes it for a zero cotangent)
// and dc0 on exit; dh0 may be null (not wanted); wst, regime (c)'s streamed
// rows (blocks x (4H - kres) x NC floats, NC = units rounded up to 4,
// scratch), null otherwise. info (2 ints, may be null) receives the blocks
// that can be resident on one SM and the SM count. Returns 0, ERR_PLAN,
// ERR_RESIDENT or the CUDA error of the launch.
int autovc_lstm_bwd(const float* act, const float* w_hh, const float* c0, const float* c_seq, const float* dy,
                    const float* dhn, float* dxproj, float* dc_state, float* dh0, float* wst, int B, int T, int H,
                    int reverse, int regime, int blocks, int units, int rows, int kc, int kres, int smem, int* info,
                    cudaStream_t stream) {
  const int tasks = rows / RB * (((regime == 0 ? H : units) + 3) / 4);  // (row group, 4 units)
  int ks = 0;
  if (check_plan(B, T, H, 4 * H, regime, blocks, units, rows, kc, kres, tasks, ks) != 0 ||
      smem_bytes(regime, H, units, rows, kc, ks, 4, kres) != (size_t)smem || (regime == 2) != (wst != nullptr))
    return ERR_PLAN;
  const Args<float> a{act, w_hh, c0, c_seq, dy, dhn, dxproj, nullptr, dc_state, dh0, wst,
                      B, T, H, reverse, units, rows, kc, ks, regime == 2 ? kres : 4 * H};
  return run(a, regime, blocks, smem, info, stream);
}

// The bfloat16 form: w_hh (H, 4H), dy (B, T, H) and dxproj (B, T, 4H) in
// bfloat16, dgates (B, T, 4H) float32 (both written: the gate gradients,
// rounded and not), wst in bfloat16; the rest as autovc_lstm_bwd. Returns as
// autovc_lstm_bwd.
int autovc_lstm_bwd_bf16(const float* act, const void* w_hh, const float* c0, const float* c_seq, const void* dy,
                         const float* dhn, float* dgates, void* dxproj, float* dc_state, float* dh0, void* wst, int B,
                         int T, int H, int reverse, int regime, int blocks, int units, int rows, int kc, int kres,
                         int smem, int* info, cudaStream_t stream) {
  const int tasks = rows / RB * (((regime == 0 ? H : units) + 3) / 4);
  int ks = 0;
  if (check_plan(B, T, H, 4 * H, regime, blocks, units, rows, kc, kres, tasks, ks) != 0 ||
      smem_bytes(regime, H, units, rows, kc, ks, 2, kres) != (size_t)smem || dgates == nullptr || dxproj == nullptr ||
      (regime == 2) != (wst != nullptr))
    return ERR_PLAN;
  using bf16 = __nv_bfloat16;
  const Args<bf16> a{act, static_cast<const bf16*>(w_hh), c0, c_seq, static_cast<const bf16*>(dy), dhn, dgates,
                     static_cast<bf16*>(dxproj), dc_state, dh0, static_cast<bf16*>(wst), B, T, H, reverse, units, rows,
                     kc, ks, regime == 2 ? kres : 4 * H};
  return run(a, regime, blocks, smem, info, stream);
}

// dW (H, 4H) = hprev^T @ dxproj over all (b, t), one launch of the plan of
// ops/lstm.py:dw_plan: K split into `splits` chunks of `chunk` rows (a
// multiple of DW_KT), ws (splits x H x 4H floats) and counters (one int per
// tile, zero; the kernel leaves them zero, so a stream may keep them for its
// next call) the caller's scratch when splits > 1. dxproj is float32; with
// bf16 = 1, h_seq and dw are bfloat16 (h0 stays float32). h0 may be null.
// Returns 0, ERR_PLAN or the CUDA error of the launch.
int autovc_lstm_dw(const void* h_seq, const float* h0, const float* dxproj, void* dw, float* ws, int* counters, int B,
                   int T, int H, int reverse, int splits, int chunk, int bf16, cudaStream_t stream) {
  const long K = (long)B * T;
  if (B <= 0 || T <= 0 || H <= 0 || H % 8 != 0 || K > (1L << 30) || chunk <= 0 || chunk % DW_KT != 0 || splits < 1 ||
      (K + chunk - 1) / chunk != splits || (splits > 1 && (ws == nullptr || counters == nullptr)) || splits > 65535)
    return ERR_PLAN;
  const dim3 grid((4 * H + DW_TILE - 1) / DW_TILE, (H + DW_TILE - 1) / DW_TILE, splits);
  if (bf16) {
    using bf = __nv_bfloat16;
    const DwArgs<bf> a{static_cast<const bf*>(h_seq), h0, dxproj, static_cast<bf*>(dw), ws, counters,
                       B, T, H, reverse, chunk};
    lstm_dw_kernel<bf><<<grid, NT, 0, stream>>>(a);
  } else {
    const DwArgs<float> a{static_cast<const float*>(h_seq), h0, dxproj, static_cast<float*>(dw), ws, counters,
                          B, T, H, reverse, chunk};
    lstm_dw_kernel<float><<<grid, NT, 0, stream>>>(a);
  }
  return (int)cudaGetLastError();
}

const char* autovc_cuda_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

}  // extern "C"
