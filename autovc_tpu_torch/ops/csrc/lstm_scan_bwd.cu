// The backward LSTM recurrence in the scan rounding, its dh product on the
// bfloat16 tensor cores (mma.sync): one launch per sequence, dh0 included.
//
// Replaces the scan form of lstm_bwd.cu (a SCAN instance of its float32
// kernels, which multiplied on the CUDA cores and exchanged float32 gate
// gradients). Like that form it runs the VJP jax.vjp builds for
// _lstm_scan (autovc_tpu/models/layers.py:123-144) in bfloat16, each op
// rounded as XLA rounds it (ops/lstm.py:lstm_scan_bf16_backward_ref), on the
// residuals the scan forward wrote (csrc/lstm_scan_fwd.cu: act = [si, sf,
// tg, so] and c_seq, float32 arrays of bfloat16 values): nothing is
// recomputed. It serves the frozen d-vector's bfloat16 backward and the
// Generator's default bfloat16 training, where ops/lstm.py then launches the
// scan dW (csrc/lstm_scan_dw.cu) on the dxproj it writes. No TPU kernel: JAX
// runs it as the transposed lax.scan. Walking the steps in the reverse of
// the forward's order (t = T-1 .. 0, or 0 .. T-1 for reverse), with rb
// rounding to bfloat16 and tc = rb(tanh(c_t)):
//   carry = rb(dgates_{t_next} @ w_hh^T)   float32 sums of exact bfloat16 products
//   dh = rb(dy_t + carry);  p = rb(rb(so dh) rb(1 - tc));  dc = rb(rb(dc + p) + rb(p tc))
//   do = rb(rb(dh tc) rb(so (1 - so)));  di = rb(rb(dc tg) rb(si (1 - si)))
//   q = rb(rb(si dc) rb(1 - tg));  dg = rb(q + rb(q tg));  df = rb(rb(dc cprev) rb(sf (1 - sf)))
//   dxproj_t = [di, df, dg, do];  dc = rb(sf dc)
// and after the last step dh0 = carry; dc0 is the carried dc. w_hh (H, 4H),
// dy (B, T, H) and dxproj (B, T, 4H) bfloat16; c0, dhN and dc_state (dcN on
// entry, dc0 on exit) float32 arrays of bfloat16 values, or null (zero) for
// c0 and dhN; dh0 (B, H) float32 of bfloat16 values, or null.
//
// Bound. A step's dh product is 8·B·H² flops of two bfloat16 operands, at
// the tensor cores' peak less than the bytes (act and c_seq read once,
// dxproj written once: 10.7 us a sequence at H=1024, B=7, T=128); the steps
// depend on each other, so what a step costs is latency: dgates_t must
// reach every block, and a grid barrier a step.
//
// Design (the plan is ops/lstm.py:scan_bwd_plan, checked here):
//  - The product. carry (B x units) = dgates (B x 4H) @ W^T (4H x units):
//    mma.sync m16n8k16 with M the batch rows (16 a tile, rows past B zero),
//    N a warp's 8 units, K = 4H in k16 steps. A block's W^T fragments (the
//    B operand: two 32-bit words of w_hh's row a step) are loaded into
//    registers once a launch; dgates is read with ldmatrix from a 128-byte
//    swizzled tile. Why not wgmma: its M is 64, and neither the units of a
//    block (8) nor B (7) fill it; with units on M, 56 of 64 rows would be
//    zero and a warpgroup would issue the K/16 = 256 k16 steps of H=1024
//    alone, where here eight warps issue 32 each, side by side.
//  - The sum's order, as the scan forward's: each k16 step into a fresh
//    float32 accumulator, the steps' sums added pairwise in eights, the
//    eights in order (the 4, 2 and 1 steps of a range not a multiple of 8
//    last, each pairwise); in regime (b) the eight warps' K ranges then
//    pairwise, ((w0 + w1) + (w2 + w3)) + ((w4 + w5) + (w6 + w7)).
//  - Regime (a), H <= 32 (K = 4H <= 128: at most 8 k16 steps): a block owns
//    RA = 8 batch rows and all H units, warp w units [8w, 8w + 8), and walks
//    the sequence alone: its product over all of K, then the cell of its 64
//    (row, unit) pairs from the accumulator's registers (two a lane), dc in
//    registers, dgates written to a double-buffered tile in shared memory
//    for the next step's product: one block barrier a step, no grid barrier.
//  - Regime (b): a persistent cooperative kernel, 8 units a block (H / 8
//    blocks, at most one an SM), eight warps each over an eighth of K. A
//    step reads dgates_{t_next} of each batch tile by TMA (one thread, one
//    4-D box a K half, from the bfloat16 dxproj itself: the batch rows past
//    B and the swizzle applied by the copy engine), multiplies, adds the
//    warps' sums in shared memory, and the first one or two warps (rows 0-7,
//    8-15) run the cell of their pairs, two a lane, and write dxproj_t; then
//    the blocks meet at cooperative groups' grid barrier. No float32 gate
//    gradients are written or exchanged: the carry is the rounded dxproj's
//    product, so the exchange holds half the bytes of the replaced form's.
//  - Regime (c), past (b)'s registers (H > 1024, or H / 8 blocks more than
//    the SMs): (b)'s kernel and step loop (one template, its number of n8
//    groups the parameter), with 16 units a block (H / 16 blocks, at most
//    one an SM), two n8 groups of mma.sync sharing each ldmatrix of the
//    dgates tile, batch tiles of 8 rows (a 16-row tile's 4H x 16 bfloat16
//    would not fit at H=2048), the eight warps' K ranges as in (b). A
//    warp's W^T fragments (4H x 16 bfloat16 a block: 256 KB at H=2048) do
//    not fit its registers:
//    at the launch's start each lane writes its own, in fragment order, for
//    its warp's first kres k16 steps to shared memory and for the rest to
//    its block's part of wst (device memory); each product reads the
//    resident ones with a shared load and streams the rest from L2 (ld.cg:
//    each lane reads back only what it wrote), a group of eight steps'
//    fragments at a time, 256 contiguous bytes a warp a step and group.
//    The sums' order is (b)'s. The first one or two warps run the cells of
//    units 0-7 and 8-15 of the tile's 8 rows.
//  - Ordering (regime (b)). dxproj_t written by the cell's threads (the
//    generic proxy) is read by the other blocks' TMA (the async proxy): the
//    writers fence (fence.proxy.async.global) before the grid barrier, and
//    the one thread that issues the copies fences after it; it also fences
//    shared memory (fence.proxy.async.shared::cta) before a copy overwrites
//    the tile the warps have read.
//  - The residuals of a step's pairs are loaded before its product, so that
//    they are in flight during it; the cell chain is branch-free.
//  - The kernels' names start lstm_bwd_, as the other backwards' do, and
//    their launches count in ops/lstm.py's `bwd_launches` with theirs.

#include <cuda_bf16.h>

#include <cstdint>

#include "lstm_common.cuh"
#include "tma.cuh"

namespace cg = cooperative_groups;

namespace {

using bf16 = __nv_bfloat16;

constexpr int KATOM = 64;  // k of one 128-byte swizzled row
constexpr int RA = 8;      // batch rows a block in regime (a)
constexpr int UNITS = 8;   // units a block in regime (b): mma.sync's N
constexpr int NWB = NT / 32;   // warps a block in regime (b): each an eighth of K
constexpr int MAXKS = 32;      // k16 steps a warp at most: regime (b) takes H <= 1024
constexpr int RED_ROWS = 16;   // rows of a tile's sums in shared memory
constexpr int UNITS_C = 16;    // units a block in regime (c): two n8 groups

struct BwdArgs {
  // regime (b): dxproj (B, T, 4H) seen as (64 k, B, atoms, T), boxes of 64 x rows x kh x 1, 128-byte swizzle
  CUtensorMap map_dx;
  const float* act;
  const bf16* w_hh;
  const float* c0;
  const float* c_seq;
  const bf16* dy;
  const float* dhn;
  bf16* dxproj;
  float* dc_state;
  float* dh0;
  int B, T, H, reverse;
  int rows;     // batch rows a tile: RA in regime (a); 8 or 16 in regime (b); 8 in regime (c)
  int nkc, kh;  // 64-k atoms of K = 4H, ceil(4H / 64); atoms a K half's copy, ceil(nkc / 2)
  // regime (c): the k16 steps of a warp's fragments in shared memory, the steps a warp (whole eights), and
  // each block's streamed fragments (null but in regime (c))
  int kres, per;
  uint2* wst;
};

// Byte offset of element (row, k) in K-major tiles of `rows` rows: 64-k atoms
// rows·128 bytes apart, a row's 16-byte chunks permuted by row % 8 (the
// layout of TMA's 128-byte swizzle).
__device__ __forceinline__ int sw_off(int row, int k, int rows) {
  return (k / KATOM) * rows * 128 + row * 128 + ((((k % KATOM) >> 3) ^ (row & 7)) << 4) + ((k & 7) << 1);
}

__device__ __forceinline__ void ldsm_x4(unsigned (&r)[4], unsigned addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// d = A (16 x 16) x B (16 x 8), bfloat16 in, float32 accumulators from zero.
__device__ __forceinline__ void mma16816(float (&d)[4], const unsigned (&a)[4], unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%10, %10, %10, %10};\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1), "f"(0.0f));
}

__device__ __forceinline__ unsigned ldg32(const bf16* p) { return __ldg(reinterpret_cast<const unsigned*>(p)); }

// A warp's n k16 steps from global step k0: W^T's fragments (the B
// operand) in registers, bw[i] for step k0 + i.
struct Steps {
  unsigned bw[MAXKS][2];
  int k0, n;
};

// Loads the fragments of steps [k0, k0 + n) for units j0 + 0..7: lane (g,
// q) holds w_hh[j0 + g, 16 s + 2q, + 1] and [.., 16 s + 2q + 8, + 9].
__device__ __forceinline__ void load_w(Steps& st, const BwdArgs& a, int j0, int k0, int n) {
  const int lane = threadIdx.x % 32, g = lane / 4, q = lane % 4;
  st.k0 = k0;
  st.n = n;
  const bf16* row = a.w_hh + (size_t)(j0 + g) * 4 * a.H + 2 * q;
#pragma unroll
  for (int i = 0; i < MAXKS; ++i) {
    st.bw[i][0] = st.bw[i][1] = 0u;
    if (i < n) {
      st.bw[i][0] = ldg32(row + 16 * (k0 + i));
      st.bw[i][1] = ldg32(row + 16 * (k0 + i) + 8);
    }
  }
}

// acc += the pairwise sum of the G k16 steps from local step L, each into
// its own accumulator: ((d0 + d1) + (d2 + d3)) + ...
template <int G, int L>
__device__ __forceinline__ void steps_into(float (&acc)[4], const Steps& st, unsigned tile, int rows, unsigned zero) {
  static_assert(L + G <= MAXKS, "within the fragments");
  const int lane = threadIdx.x % 32, r = (lane & 7) + 8 * ((lane >> 3) & 1), kk = 8 * (lane >> 4);
  float d[G][4];
#pragma unroll
  for (int c = 0; c < G; ++c) {
    unsigned af[4];
    ldsm_x4(af, r < rows ? tile + sw_off(r, 16 * (st.k0 + L + c) + kk, rows) : zero);
    mma16816(d[c], af, st.bw[L + c][0], st.bw[L + c][1]);
  }
#pragma unroll
  for (int w = 1; w < G; w *= 2)
#pragma unroll
    for (int c = 0; c < G; c += 2 * w)
#pragma unroll
      for (int i = 0; i < 4; ++i) d[c][i] += d[c + w][i];
#pragma unroll
  for (int i = 0; i < 4; ++i) acc[i] += d[0][i];
}

// The tail of r < 8 steps from local step L: groups of 4, 2 and 1 in order.
template <int L>
__device__ __forceinline__ void tail1(float (&acc)[4], const Steps& st, int r, unsigned tile, int rows, unsigned zero) {
  if constexpr (L < MAXKS)
    if (r & 1) steps_into<1, L>(acc, st, tile, rows, zero);
}
template <int L>
__device__ __forceinline__ void tail2(float (&acc)[4], const Steps& st, int r, unsigned tile, int rows, unsigned zero) {
  if constexpr (L + 2 <= MAXKS) {
    if (r & 2) {
      steps_into<2, L>(acc, st, tile, rows, zero);
      tail1<L + 2>(acc, st, r, tile, rows, zero);
      return;
    }
  }
  tail1<L>(acc, st, r, tile, rows, zero);
}
template <int L>
__device__ __forceinline__ void tail4(float (&acc)[4], const Steps& st, int r, unsigned tile, int rows, unsigned zero) {
  if constexpr (L + 4 <= MAXKS) {
    if (r & 4) {
      steps_into<4, L>(acc, st, tile, rows, zero);
      tail2<L + 4>(acc, st, r, tile, rows, zero);
      return;
    }
  }
  tail2<L>(acc, st, r, tile, rows, zero);
}

// acc (lane (g, q): rows g, g + 8 by units 2q, 2q + 1) = the warp's
// st.n k16 steps of the dgates tile at `tile` by its W^T fragments, in the
// order of the notes.
__device__ __forceinline__ void product(float (&acc)[4], const Steps& st, unsigned tile, int rows, unsigned zero) {
#pragma unroll
  for (int i = 0; i < 4; ++i) acc[i] = 0.0f;
  const int full = st.n / 8, r = st.n % 8;
  if (full > 0) steps_into<8, 0>(acc, st, tile, rows, zero);
  if (full > 1) steps_into<8, 8>(acc, st, tile, rows, zero);
  if (full > 2) steps_into<8, 16>(acc, st, tile, rows, zero);
  if (full > 3) steps_into<8, 24>(acc, st, tile, rows, zero);
  switch (full) {
    case 0:
      tail4<0>(acc, st, r, tile, rows, zero);
      break;
    case 1:
      tail4<8>(acc, st, r, tile, rows, zero);
      break;
    case 2:
      tail4<16>(acc, st, r, tile, rows, zero);
      break;
    case 3:
      tail4<24>(acc, st, r, tile, rows, zero);
      break;
    default:
      break;
  }
}

// One lane's two (row, unit) pairs, units u and u + 1 of batch row b at step
// t: the residuals, loaded before the product.
struct Pairs {
  float2 act[4], c, cprev;
  unsigned dy;
};

__device__ __forceinline__ int step_t(const BwdArgs& a, int s) { return a.reverse ? s : a.T - 1 - s; }

// The residuals of row b (clamped to B - 1: a row past B stores nothing),
// units u, u + 1, at step t.
__device__ __forceinline__ void prefetch(Pairs& p, const BwdArgs& a, int b, int u, int t) {
  const size_t bb = min(b, a.B - 1), row = bb * a.T + t;
  const float* ac = a.act + row * 4 * a.H + u;
#pragma unroll
  for (int g = 0; g < 4; ++g) p.act[g] = __ldg(reinterpret_cast<const float2*>(ac + (size_t)g * a.H));
  p.c = __ldg(reinterpret_cast<const float2*>(a.c_seq + row * a.H + u));
  p.dy = ldg32(a.dy + row * a.H + u);
  const int tp = a.reverse ? t + 1 : t - 1;
  if (tp >= 0 && tp < a.T)
    p.cprev = __ldg(reinterpret_cast<const float2*>(a.c_seq + (bb * a.T + tp) * a.H + u));
  else
    p.cprev = a.c0 != nullptr ? __ldg(reinterpret_cast<const float2*>(a.c0 + bb * a.H + u)) : make_float2(0.f, 0.f);
}

// One pair's cell gradient: dgates (di, df, dg, do) from the carry, the
// residuals and dc, which it updates to rb(sf dc).
__device__ __forceinline__ void cell(float carry, float dy, float si, float sf, float tg, float so, float c,
                                     float cprev, float& dc, float (&dg)[4]) {
  const float tc = rb(tanhf(c));
  const float dh = rb(dy + carry);
  const float pc = rb(rb(so * dh) * rb(1.0f - tc));
  const float dcn = rb(rb(dc + pc) + rb(pc * tc));
  dg[3] = rb(rb(dh * tc) * dsigmoid_scan(so));
  dg[0] = rb(rb(dcn * tg) * dsigmoid_scan(si));
  const float dtg = rb(rb(si * dcn) * rb(1.0f - tg));
  dg[2] = rb(dtg + rb(dtg * tg));
  dg[1] = rb(rb(dcn * cprev) * dsigmoid_scan(sf));
  dc = rb(sf * dcn);
}

__device__ __forceinline__ unsigned pack(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const unsigned*>(&v);
}

// Both pairs' cells; dgates[g] packs gate g of units u, u + 1 (bfloat16).
__device__ __forceinline__ void cells(const Pairs& p, const float (&carry)[2], float (&dc)[2], unsigned (&dgates)[4]) {
  const float2 dy = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&p.dy));
  float d0[4], d1[4];
  cell(carry[0], dy.x, p.act[0].x, p.act[1].x, p.act[2].x, p.act[3].x, p.c.x, p.cprev.x, dc[0], d0);
  cell(carry[1], dy.y, p.act[0].y, p.act[1].y, p.act[2].y, p.act[3].y, p.c.y, p.cprev.y, dc[1], d1);
#pragma unroll
  for (int g = 0; g < 4; ++g) dgates[g] = pack(d0[g], d1[g]);
}

// The initial carry (dhN, or zero) of row b, units u, u + 1.
__device__ __forceinline__ void carry_in(float (&carry)[2], const BwdArgs& a, int b, int u) {
  const float2 v = a.dhn != nullptr && b < a.B ? *reinterpret_cast<const float2*>(a.dhn + (size_t)b * a.H + u)
                                               : make_float2(0.f, 0.f);
  carry[0] = v.x;
  carry[1] = v.y;
}

// Regime (a): block x owns batch rows [x·RA, x·RA + RA) and all H units;
// warp w units [8w, 8w + 8). Shared memory: two dgates tiles (nkc atoms of
// RA rows x 128 bytes each) and a zero line.
__global__ void __launch_bounds__(128) lstm_bwd_scan_block_kernel(const __grid_constant__ BwdArgs a) {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* tiles = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  const int tile_bytes = a.nkc * RA * 128;
  unsigned char* zero = tiles + 2 * tile_bytes;
  const int lane = threadIdx.x % 32, g = lane / 4, q = lane % 4, j0 = 8 * (threadIdx.x / 32);
  const int b0 = blockIdx.x * RA, rows = min(RA, a.B - b0), b = b0 + g, u = j0 + 2 * q, H4 = 4 * a.H;
  for (int e = threadIdx.x; e < (2 * tile_bytes + 128) / 16; e += blockDim.x)
    reinterpret_cast<uint4*>(tiles)[e] = make_uint4(0, 0, 0, 0);
  Steps st;
  load_w(st, a, j0, 0, a.H / 4);
  float carry[2], dc[2] = {0.f, 0.f};
  carry_in(carry, a, b, u);
  if (g < rows) {
    const float2 v = *reinterpret_cast<const float2*>(a.dc_state + (size_t)b * a.H + u);
    dc[0] = v.x;
    dc[1] = v.y;
  }
  __syncthreads();
  const unsigned base = smem_addr(tiles), zero_line = smem_addr(zero);
  Pairs p, next;
  prefetch(next, a, b, u, step_t(a, 0));
  for (int s = 0; s <= a.T; ++s) {  // s == T: the dh0 step
    p = next;
    if (s + 1 < a.T) prefetch(next, a, b, u, step_t(a, s + 1));
    if (s > 0) {
      float acc[4];
      product(acc, st, base + ((s - 1) & 1) * tile_bytes, RA, zero_line);
      carry[0] = rb(acc[0]);
      carry[1] = rb(acc[1]);
    }
    if (s == a.T) {
      if (a.dh0 != nullptr && g < rows)
        *reinterpret_cast<float2*>(a.dh0 + (size_t)b * a.H + u) = make_float2(carry[0], carry[1]);
      break;
    }
    unsigned dgates[4];
    cells(p, carry, dc, dgates);
    if (g < rows) {
      const int t = step_t(a, s);
      unsigned* dx = reinterpret_cast<unsigned*>(a.dxproj + ((size_t)b * a.T + t) * H4 + u);
#pragma unroll
      for (int gate = 0; gate < 4; ++gate) {
        dx[gate * a.H / 2] = dgates[gate];
        *reinterpret_cast<unsigned*>(tiles + (s & 1) * tile_bytes + sw_off(g, gate * a.H + u, RA)) = dgates[gate];
      }
    }
    __syncthreads();  // dgates_t in the tile before the next product
  }
  if (g < rows) *reinterpret_cast<float2*>(a.dc_state + (size_t)b * a.H + u) = make_float2(dc[0], dc[1]);
}

// Regime (c)'s fragments of one k16 step for the lane: group n's (b0, b1),
// w_hh[j0 + 8n + g, 16 s + 2q, + 1] and [.., 16 s + 2q + 8, + 9].
__device__ __forceinline__ uint2 frag_of(const BwdArgs& a, int j0, int n, int s) {
  const int lane = threadIdx.x % 32, g = lane / 4, q = lane % 4;
  const bf16* row = a.w_hh + (size_t)(j0 + 8 * n + g) * 4 * a.H + 2 * q + 16 * s;
  return make_uint2(ldg32(row), ldg32(row + 8));
}

// acc[n] += the pairwise sum of the G k16 steps from the warp's local step
// i (global k0 + i), each into its own accumulator, for both n8 groups; the
// fragments from f (shared memory, or the warp's part of wst read through
// L2), (step, group, lane) apart.
template <int G>
__device__ __forceinline__ void steps_c(float (&acc)[2][4], const uint2* f, bool resident, int k0, int i,
                                        unsigned tile, int rows, unsigned zero) {
  const int lane = threadIdx.x % 32, r = (lane & 7) + 8 * ((lane >> 3) & 1), kk = 8 * (lane >> 4);
  uint2 bw[G][2];
#pragma unroll
  for (int c = 0; c < G; ++c)
#pragma unroll
    for (int n = 0; n < 2; ++n) bw[c][n] = resident ? f[(c * 2 + n) * 32 + lane] : __ldcg(f + (c * 2 + n) * 32 + lane);
  float d[2][G][4];
#pragma unroll
  for (int c = 0; c < G; ++c) {
    unsigned af[4];
    ldsm_x4(af, r < rows ? tile + sw_off(r, 16 * (k0 + i + c) + kk, rows) : zero);
    mma16816(d[0][c], af, bw[c][0].x, bw[c][0].y);
    mma16816(d[1][c], af, bw[c][1].x, bw[c][1].y);
  }
#pragma unroll
  for (int n = 0; n < 2; ++n) {
#pragma unroll
    for (int w = 1; w < G; w *= 2)
#pragma unroll
      for (int c = 0; c < G; c += 2 * w)
#pragma unroll
        for (int e = 0; e < 4; ++e) d[n][c][e] += d[n][c + w][e];
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] += d[n][0][e];
  }
}

// Regime (c)'s product of the warp's n k16 steps from k0: groups of eight
// in order, then 4, 2 and 1 (product's order); steps below kres from the
// shared fragments fs, the rest from the streamed ones fg.
__device__ __forceinline__ void product_c(float (&acc)[2][4], const uint2* fs, const uint2* fg, int kres, int k0,
                                          int n, unsigned tile, int rows, unsigned zero) {
#pragma unroll
  for (int m = 0; m < 2; ++m)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[m][e] = 0.0f;
  auto at = [&](int i) { return i < kres ? fs + (size_t)i * 64 : fg + (size_t)(i - kres) * 64; };
  int i = 0;
  for (; i + 8 <= n; i += 8) steps_c<8>(acc, at(i), i < kres, k0, i, tile, rows, zero);
  if ((n - i) & 4) {
    steps_c<4>(acc, at(i), i < kres, k0, i, tile, rows, zero);
    i += 4;
  }
  if ((n - i) & 2) {
    steps_c<2>(acc, at(i), i < kres, k0, i, tile, rows, zero);
    i += 2;
  }
  if ((n - i) & 1) steps_c<1>(acc, at(i), i < kres, k0, i, tile, rows, zero);
}

// Regimes (b) and (c), one kernel: block x owns U = 8·NG units [Ux, Ux + U)
// for every batch row (NG n8 groups: 1 in (b), 2 in (c)), in tiles of
// `rows` rows; warp w a.per k16 steps of K. Cell warp w (the first
// rows / 8 · NG warps) runs rows 8 (w / NG) .. + 7 of a tile by units
// 8 (w % NG) .. + 7 of the block: in (b) warp 0 rows 0-7 and warp 1 rows
// 8-15, in (c) warp 0 units 0-7 and warp 1 units 8-15. The fragments: in
// registers in (b), from shared memory and wst in (c). Shared memory: the
// dgates tile (two K halves of kh atoms of `rows` rows x 128 bytes), a zero
// line, the warps' sums (NWB x 16 x U floats), dc of its (row, unit) pairs,
// two mbarriers, then in (c) the warps' resident fragments (kres steps x 2
// groups x 32 lanes a warp). Launched cooperatively only.
template <int NG>
__global__ void __launch_bounds__(NT, 1) lstm_bwd_scan_grid_kernel(const __grid_constant__ BwdArgs a) {
  constexpr int U = 8 * NG;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* stage = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  const int R = a.rows, half_bytes = a.kh * R * 128, ntiles = (a.B + R - 1) / R, H4 = 4 * a.H;
  unsigned char* zero = stage + 2 * half_bytes;
  float* red = reinterpret_cast<float*>(zero + 128);
  float* dcs = red + NWB * RED_ROWS * U;
  unsigned long long* bar = reinterpret_cast<unsigned long long*>(dcs + ntiles * R * U);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane / 4, q = lane % 4;
  const int row = 8 * (warp / NG) + g, j0 = U * blockIdx.x, uu = 8 * (warp % NG) + 2 * q, u = j0 + uu;
  const bool cell_warp = warp < R / 8 * NG;
  cg::grid_group grid = cg::this_grid();

  // this warp's k16 steps: whole eights, an equal number a warp, the last ones cut at K
  const int ks = a.H / 4, k0 = min(ks, warp * a.per), n = min(ks, k0 + a.per) - k0;
  Steps st;  // (b)
  uint2* fs = reinterpret_cast<uint2*>(bar + 2) + (size_t)warp * a.kres * 64;     // (c)
  uint2* fg = a.wst + ((size_t)blockIdx.x * NWB + warp) * (a.per - a.kres) * 64;  // (c)
  if constexpr (NG == 1) {
    load_w(st, a, j0, k0, n);
  } else {
    for (int i = 0; i < n; ++i)
#pragma unroll
      for (int m = 0; m < NG; ++m) {
        const uint2 v = frag_of(a, j0, m, k0 + i);
        if (i < a.kres)
          fs[(size_t)(i * 2 + m) * 32 + lane] = v;
        else
          fg[(size_t)((i - a.kres) * 2 + m) * 32 + lane] = v;
      }
  }
  // the K halves this warp reads: atoms [0, kh) and [kh, nkc)
  const bool first_half = n > 0 && (16 * k0) / KATOM < a.kh;
  const bool second_half = n > 0 && (16 * (k0 + n) - 1) / KATOM >= a.kh;
  for (int e = threadIdx.x; e < 128 / 16; e += NT) reinterpret_cast<uint4*>(zero)[e] = make_uint4(0, 0, 0, 0);
  for (int e = threadIdx.x; e < ntiles * R * U; e += NT) {
    const int bb = e / U;
    dcs[e] = bb < a.B ? a.dc_state[(size_t)bb * a.H + j0 + e % U] : 0.f;
  }
  if (threadIdx.x == 0) {
    mbar_init(bar);
    mbar_init(bar + 1);
  }
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  __syncthreads();
  const unsigned tile = smem_addr(stage), zero_line = smem_addr(zero);
  unsigned copies = 0;  // TMA copies of the tile so far: the mbarriers' phase
  Pairs p;
  for (int s = 0; s <= a.T; ++s) {  // s == T: the dh0 step
    const int t = s < a.T ? step_t(a, s) : 0;
    for (int tl = 0; tl < ntiles; ++tl) {
      const int b0 = tl * R, b = b0 + row;
      if (s > 0 && threadIdx.x == 0) {
        // the other blocks' dxproj_{t_next}, and this block's reads of the tile, before the copies
        asm volatile("fence.proxy.async.global;\n" ::: "memory");
        asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
        for (int part = 0; part < 2; ++part) {
          asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_addr(bar + part)),
                       "r"(half_bytes)
                       : "memory");
          tma_load_4d(stage + part * half_bytes, &a.map_dx, bar + part, 0, b0, part * a.kh, step_t(a, s - 1));
        }
      }
      if (cell_warp && s < a.T) prefetch(p, a, b, u, t);
      if (s > 0) {
        float acc[NG][4] = {};
        if (n > 0) {
          if (first_half) mbar_wait(bar, copies & 1u);
          if (second_half) mbar_wait(bar + 1, copies & 1u);
          if constexpr (NG == 1)
            product(acc[0], st, tile, R, zero_line);
          else
            product_c(acc, fs, fg, a.kres, k0, n, tile, R, zero_line);
        }
        // accumulator e of group m: row g + 8 (e / 2), unit 8m + 2q + e % 2
#pragma unroll
        for (int m = 0; m < NG; ++m)
#pragma unroll
          for (int e = 0; e < 4; ++e) red[(warp * RED_ROWS + g + 8 * (e / 2)) * U + 8 * m + 2 * q + e % 2] = acc[m][e];
        ++copies;
      }
      __syncthreads();  // the warps' sums complete
      if (cell_warp) {
        float carry[2];
        if (s > 0) {
          float2 w[NWB];
#pragma unroll
          for (int k = 0; k < NWB; ++k) w[k] = *reinterpret_cast<const float2*>(red + (k * RED_ROWS + row) * U + uu);
#pragma unroll
          for (int h = 1; h < NWB; h *= 2)
#pragma unroll
            for (int k = 0; k < NWB; k += 2 * h) {
              w[k].x += w[k + h].x;
              w[k].y += w[k + h].y;
            }
          carry[0] = rb(w[0].x);
          carry[1] = rb(w[0].y);
        } else {
          carry_in(carry, a, b, u);
        }
        if (s == a.T) {
          if (a.dh0 != nullptr && b < a.B)
            *reinterpret_cast<float2*>(a.dh0 + (size_t)b * a.H + u) = make_float2(carry[0], carry[1]);
        } else {
          float* dcp = dcs + (size_t)b * U + uu;
          float dc[2] = {dcp[0], dcp[1]};
          unsigned dgates[4];
          cells(p, carry, dc, dgates);
          if (b < a.B) {
            unsigned* dx = reinterpret_cast<unsigned*>(a.dxproj + ((size_t)b * a.T + t) * H4 + u);
#pragma unroll
            for (int gate = 0; gate < 4; ++gate) dx[gate * a.H / 2] = dgates[gate];
            dcp[0] = dc[0];
            dcp[1] = dc[1];
          }
          asm volatile("fence.proxy.async.global;\n" ::: "memory");  // dxproj_t, for the other blocks' copies
        }
      }
      __syncthreads();  // the tile and the sums free for the next tile
    }
    if (s < a.T) grid.sync();  // every dxproj_t written before any block reads it
  }
  for (int e = threadIdx.x; e < a.B * U; e += NT) a.dc_state[(size_t)(e / U) * a.H + j0 + e % U] = dcs[e];
}

size_t smem_bytes(int regime, int B, int H, int rows, int kres) {
  const size_t nkc = (4 * (size_t)H + KATOM - 1) / KATOM, kh = (nkc + 1) / 2;
  if (regime == 0) return 1024 + 2 * nkc * RA * 128 + 128;
  const size_t ntiles = (B + rows - 1) / rows, units = regime == 1 ? UNITS : UNITS_C;
  return 1024 + 2 * kh * rows * 128 + 128 + 4 * (NWB * RED_ROWS * units + ntiles * rows * units) + 16 +
         (regime == 2 ? (size_t)kres * NWB * 2 * 32 * sizeof(uint2) : 0);
}

int launch_block(const BwdArgs& a, int blocks, int smem, int* info, cudaStream_t stream) {
  int sms = 0, per_sm = 0;
  const int threads = 32 * (a.H / 8);
  const int err = occupancy((const void*)lstm_bwd_scan_block_kernel, threads, smem, per_sm, sms);
  if (err != 0) return err;
  if (info != nullptr) {
    info[0] = per_sm;
    info[1] = sms;
  }
  if (per_sm < 1) return ERR_RESIDENT;
  lstm_bwd_scan_block_kernel<<<blocks, threads, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// The backward recurrence of the scan rounding over the whole sequence, dh0
// included, in one launch on `stream`, without synchronising. regime 0 is
// (a), 1 is (b), 2 is (c); blocks, units, rows, kres and smem are the plan
// of ops/lstm.py:scan_bwd_plan: (a) units = H <= 32, rows = 8, ceil(B / 8)
// blocks of H / 8 warps; (b) units 8, H / 8 <= the SM count blocks of 256
// threads, H <= 1024, rows 8 (B <= 8) or 16; (c) units 16, H / 16 blocks of
// 256 threads, rows 8, kres resident k16 steps a warp (a multiple of 8),
// wst (scratch) the rest: blocks x 8 warps x (steps a warp - kres) x 512
// bytes, null but in (c). dxproj is written as a whole
// and, in regime (b), read back by TMA boxes of 64-k atoms: it must have
// 64 more elements of memory after its end when 4H % 64 != 0 (the wrapper
// allocates them). info (2 ints, may be null) receives the blocks that can
// be resident on one SM and the SM count. Returns 0, ERR_PLAN for a plan that
// does not fit the shapes, ERR_RESIDENT for a grid that cannot be resident,
// ERR_TMA where dxproj's tensor map cannot be encoded, or the CUDA error of
// the launch.
int autovc_lstm_scan_bwd(const float* act, const void* w_hh, const float* c0, const float* c_seq, const void* dy,
                         const float* dhn, void* dxproj, float* dc_state, float* dh0, void* wst, int B, int T, int H,
                         int reverse, int regime, int blocks, int units, int rows, int kres, int smem, int* info,
                         cudaStream_t stream) {
  if (B <= 0 || T <= 0 || H <= 0 || H % 8 != 0 || regime < 0 || regime > 2 || (long)B * T * 4 * H > (1L << 31))
    return ERR_PLAN;
  const int per = 8 * (((H / 4 + 7) / 8 + NWB - 1) / NWB);  // regime (c): k16 steps a warp
  if (regime == 0 ? (units != H || H > 32 || rows != RA || blocks != (B + RA - 1) / RA)
      : regime == 1 ? (units != UNITS || H > 4 * MAXKS * NWB || blocks != H / UNITS || (rows != 8 && rows != 16) ||
                       (rows == 8) != (B <= 8))
                    : (units != UNITS_C || H % UNITS_C != 0 || blocks != H / UNITS_C || rows != 8 || kres < 0 ||
                       kres % 8 != 0 || kres > per || (kres < per && wst == nullptr) || (uintptr_t)wst % 16 != 0))
    return ERR_PLAN;
  if (smem_bytes(regime, B, H, rows, kres) != (size_t)smem) return ERR_PLAN;
  const int nkc = (4 * H + KATOM - 1) / KATOM;
  BwdArgs a{{},
            act,
            static_cast<const bf16*>(w_hh),
            c0,
            c_seq,
            static_cast<const bf16*>(dy),
            dhn,
            static_cast<bf16*>(dxproj),
            dc_state,
            dh0,
            B,
            T,
            H,
            reverse,
            rows,
            nkc,
            (nkc + 1) / 2,
            kres,
            per,
            static_cast<uint2*>(wst)};
  if (regime == 0) return launch_block(a, blocks, smem, info, stream);
  // (B, T, 4H) seen as (64 k, B, atoms, T): an atom's 64 k are 128 bytes on from the last's
  const cuuint64_t dims[4] = {KATOM, (cuuint64_t)B, (cuuint64_t)nkc, (cuuint64_t)T};
  const cuuint64_t strides[3] = {(cuuint64_t)T * 4 * H * 2, KATOM * 2, (cuuint64_t)4 * H * 2};
  const cuuint32_t box[4] = {KATOM, (cuuint32_t)rows, (cuuint32_t)a.kh, 1};
  if ((uintptr_t)dxproj % 16 || !encode(&a.map_dx, dxproj, 4, dims, strides, box, CU_TENSOR_MAP_SWIZZLE_128B))
    return ERR_TMA;
  if (regime == 2) return launch_cooperative(lstm_bwd_scan_grid_kernel<2>, a, blocks, NT, smem, info, stream);
  return launch_cooperative(lstm_bwd_scan_grid_kernel<1>, a, blocks, NT, smem, info, stream);
}

const char* autovc_cuda_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

}  // extern "C"
