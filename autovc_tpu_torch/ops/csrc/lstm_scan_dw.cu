// The recurrent weight gradient of the LSTM's scan rounding (ops/lstm.py:
// lstm_scan_bf16_weight_grad_ref): dW_hh of _lstm_scan in bfloat16 as XLA
// computes it when it transposes the scan. The transpose carries w_hh's
// cotangent through the reversed loop in bfloat16, so each step's product
// is rounded, added to the carried dW and rounded again:
//   dW = rb(dW + rb(hprev_t^T @ dxproj_t))        t in the backward's order
// with the products of two bfloat16 values exact and their sum over the B
// batch rows in float32. No library product computes this: a GEMM over K =
// B*T sums every step in float32 and rounds once (lstm_dw_kernel in
// lstm_bwd.cu, the Pallas rounding). No TPU kernel: JAX runs it as the
// transposed lax.scan.
//
// Inputs: h_seq (B, T, H) bfloat16, the scan forward's hidden sequence; h0
// (B, H) bfloat16, or null (zero); dxproj (B, T, 4H) bfloat16, the scan
// backward's gate gradients. hprev_t is h0 at the forward's first step (t =
// 0, or t = T-1 for reverse) and h_seq's neighbour (t-1, or t+1) after it.
// Output dw (H, 4H) bfloat16.
//
// Bound. 2·B·T·H·4H flops of bfloat16 operands (0.0076 ms at H=1024, B=7,
// T=128 at the tensor cores' peak) and few bytes; but each output element
// is a chain of T dependent rounded adds, so T times one add's latency
// bounds every H (chip_smoke.py 10b; scripts/scan_dw_phases.py times the
// add).
//
// Design (the plan is ops/lstm.py:scan_dw_plan, checked here):
//  - The product apart from the chain. A step's B-sums do not depend on the
//    accumulator, so the sums of many steps and outputs are in flight at
//    once, and only acc = rb(acc + rb(p)) is serial. Each B-sum is a chain
//    of float32 fused multiply-adds from zero over the batch rows in order:
//    the plain version's order, bit for bit. Two tensor-core forms were
//    measured and left: one m16n8k16 mma.sync over all the rows at once (a
//    fresh accumulator a step) was 99.997% bit-equal to the plain version
//    at H=512 and 1024 but up to 16 bfloat16 ulps off (the tensor cores'
//    float32 sum is not rounded to nearest, and where it flips rb(p) the
//    accumulator moves by an ulp of p, many ulps of a dW element that the
//    later steps cancel); and one m16n8k8 a batch row (exact products, the
//    rows added by float32 adds) matched bit for bit but took 0.74 ms at
//    H=1024, seven mma a fragment a step.
//  - The chain. A lane's two neighbouring columns' sums are rounded to
//    bfloat16 by one packing conversion and added to the bfloat16
//    accumulator pair by add.rn.bf16x2, which rounds the exact sum once:
//    the same value as rb(float32 add) of two bfloat16 values (the float32
//    sum is exact unless their exponents lie more than 15 apart, and then
//    both round to the larger). The accumulators stay in registers.
//  - The grid. A block of NT threads owns a tile of 8·MI units by 32·NJ
//    gate columns; a thread, MI units by 2·NJ columns (8 row
//    groups by 16 column groups, a column group's columns in runs of RJ
//    16·RJ apart, so that a warp's reads of a staged row are contiguous).
//    The plan takes the largest tile that still gives every SM
//    sub-partition a warp (64 x 256 at H=1024, 32 x 128 at 512, 8 x 32 at
//    H=32: 16 blocks), so that the T-step chain, not one SM's issue rate,
//    sets the time where the outputs are few.
//  - The loads. Warp 0 stages `ct` slots at a time by TMA into a
//    two-buffer ring, a slot a box of hprev_t's batch rows (from h_seq, or
//    h0, as they lie: no shifted copy; a box past the sequence's end where
//    h0 is zero) and one of dxproj_t's, counted on the buffer's mbarrier:
//    the next chunk's copies run during this chunk's steps, and the copy
//    engine zero-fills units past H, columns past 4H and rows past B. Each
//    thread widens the bfloat16 operands it reads.
//  - The batch. A step is one slot of all B rows where they fit a box (256
//    rows) and two buffers fit the plan's shared bytes; else `slabs` slots
//    of `rows` rows, in tiles whose thread sums one run of columns: its
//    B-sums then run on from slab to slab in registers, the same chain, and
//    are rounded in after the last. So every B is taken.
// One launch, no atomics: the same bits on every call.

#include <cuda_bf16.h>

#include <cstdint>
#include <type_traits>

#include "tma.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int NW = 4;        // warps a block
constexpr int NT = 32 * NW;  // threads a block: 8 row groups by 16 column groups
constexpr int SHORT_B = 8;   // batches up to this many rows take an unrolled B-sum in the small tiles

struct DwArgs {
  // boxes of a step's B rows: h_seq (H, T, B) and dxproj (4H, T, B) by the
  // tile's units and columns; h0 (H, B) where it is given
  CUtensorMap map_h, map_dx, map_h0;
  bf16* dw;
  int B, T, H, reverse, rows, slabs, ct, has_h0;
  int hstep, gstep;  // bytes of a slot's hprev and dxproj boxes in a buffer, 128-byte aligned
};

// Two bfloat16 values (a 32-bit word, the first in its low half) widened.
__device__ __forceinline__ float lo_of(unsigned w) { return __uint_as_float(w << 16); }
__device__ __forceinline__ float hi_of(unsigned w) { return __uint_as_float(w & 0xffff0000u); }

// n bfloat16 values (n = 1, 2, 4 or 8: 2 to 16 bytes) from shared memory,
// as loaded (one to four words), and widened.
template <int N>
using Words = unsigned[(N + 1) / 2];

template <int N>
__device__ __forceinline__ void load_words(Words<N>& w, const unsigned char* p) {
  if constexpr (N == 1) {
    w[0] = *reinterpret_cast<const unsigned short*>(p);
  } else if constexpr (N == 2) {
    w[0] = *reinterpret_cast<const unsigned*>(p);
  } else if constexpr (N == 4) {
    const uint2 u = *reinterpret_cast<const uint2*>(p);
    w[0] = u.x, w[1] = u.y;
  } else {
    const uint4 u = *reinterpret_cast<const uint4*>(p);
    w[0] = u.x, w[1] = u.y, w[2] = u.z, w[3] = u.w;
  }
}

template <int N>
__device__ __forceinline__ void widen(float (&v)[N], const Words<N>& w) {
  if constexpr (N == 1) {
    v[0] = lo_of(w[0]);
  } else {
#pragma unroll
    for (int k = 0; k < N / 2; ++k) {
      v[2 * k] = lo_of(w[k]);
      v[2 * k + 1] = hi_of(w[k]);
    }
  }
}

// acc (two bfloat16) = rn(acc + rb(lo, hi)): the pair's products rounded to
// bfloat16 by one packing conversion, then added with one rounding.
__device__ __forceinline__ void round_add(unsigned& acc, float lo, float hi) {
  const __nv_bfloat162 p = __floats2bfloat162_rn(lo, hi);
  asm("add.rn.bf16x2 %0, %0, %1;\n" : "+r"(acc) : "r"(*reinterpret_cast<const unsigned*>(&p)));
}

template <int MI, int NJ>
__global__ void __launch_bounds__(NT) lstm_scan_dw_kernel(const __grid_constant__ DwArgs a) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((128 - (smem_addr(smem_raw) & 127)) & 127);
  // bytes of a staged row: 8·MI units of hprev, 32·NJ gate columns of dxproj
  constexpr int HROW = 16 * MI, GROW = 64 * NJ;
  // a thread's outputs: RI units by SUBJ runs of RJ columns
  constexpr int RI = MI, RJ = 2 * NJ < 8 ? 2 * NJ : 8, SUBJ = 2 * NJ / RJ;
  // the small tiles, where a thread's outputs are few: steps interleaved
  // and the rows unrolled (at H=32, B=7 on an H100 SXM 24.3-24.6 us a
  // sequence, the general loop 34.2-34.6: scripts/scan_train_times.py)
  constexpr bool SHORT = MI * NJ <= 4;
  static_assert(!SHORT || SUBJ == 1, "a small tile's columns in one run a thread");
  // slot s holds step s / slabs's rows from `rows` times s % slabs
  const int B = a.B, T = a.T, H = a.H, H4 = 4 * a.H, ct = a.ct, R = a.rows, NB = a.slabs, S = a.T * a.slabs;
  const int i0 = blockIdx.y * 8 * MI, j0 = blockIdx.x * 32 * NJ;
  const int rg = threadIdx.x / 16, cg = threadIdx.x % 16;  // this thread's row and column group
  const int buf_bytes = ct * (a.hstep + a.gstep);  // a buffer: each slot's hprev box, then its dxproj box
  unsigned long long* bar = reinterpret_cast<unsigned long long*>(smem + 2 * buf_bytes);  // one a buffer

  // chunk c's slots into buffer c % 2, by warp 0, a lane a slot: a box of
  // hprev (h_seq's neighbour, or h0, or zeros: a box past the sequence's
  // end) and of dxproj, R rows each, counted on the buffer's mbarrier;
  // units past H, columns past 4H and rows past B zero-filled by the copy
  // engine. Lane 0 sets the transaction count first.
  const int lane = threadIdx.x % 32;
  auto issue = [&](int c) {
    const int s0 = c * ct, ns = min(ct, S - s0);
    unsigned char* buf = smem + (c & 1) * buf_bytes;
    if (lane == 0) {
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");  // the buffer's last reads before the copies
      asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_addr(bar + (c & 1))),
                   "r"(ns * R * (HROW + GROW))
                   : "memory");
    }
    __syncwarp();
    for (int k = lane; k < ns; k += 32) {
      const int step = (s0 + k) / NB, b0 = (s0 + k - step * NB) * R;
      const int t = a.reverse ? step : T - 1 - step, tp = a.reverse ? t + 1 : t - 1;
      unsigned char* hk = buf + k * a.hstep;
      if ((tp < 0 || tp >= T) && a.has_h0)
        tma_load_2d(hk, &a.map_h0, bar + (c & 1), i0, b0);
      else
        tma_load_3d(hk, &a.map_h, bar + (c & 1), i0, tp, b0);
      tma_load_3d(buf + ct * a.hstep + k * a.gstep, &a.map_dx, bar + (c & 1), j0, t, b0);
    }
  };

  unsigned acc[SUBJ][RI][RJ / 2];  // bfloat16 pairs: columns 2c, 2c + 1 of a run
#pragma unroll
  for (int u = 0; u < SUBJ; ++u)
#pragma unroll
    for (int r = 0; r < RI; ++r)
#pragma unroll
      for (int c = 0; c < RJ / 2; ++c) acc[u][r][c] = 0u;
  float part[SUBJ][RI][RJ] = {};  // a step's B-sums, run on from slab to slab where SUBJ == 1
  int slab = 0;  // the next slot's
  const int nchunks = (S + ct - 1) / ct;
  if (threadIdx.x == 0) {
    mbar_init(bar);
    mbar_init(bar + 1);
  }
  if (threadIdx.x < 32) {
    __syncwarp();  // the mbarriers initialised, for warp 0's copies
    issue(0);
    if (nchunks > 1) issue(1);
  }
  __syncthreads();  // the mbarriers initialised, for every thread's waits
  for (int c = 0; c < nchunks; ++c) {
    mbar_wait(bar + (c & 1), (c >> 1) & 1);  // chunk c in its buffer
    const unsigned char* hs = smem + (c & 1) * buf_bytes;
    const unsigned char* gs = hs + ct * a.hstep;
    const int ns = min(ct, S - c * ct);
    // each output's B-sum at a step in the plain version's order (batch
    // rows in turn, fused), then rounded into its accumulator: row b of
    // slot k's boxes (its words from shared memory), and its products added
    // (zeros where not `real`)
    auto load = [&](int k, int u, int b, Words<RI>& hw, Words<RJ>& gw) {
      load_words<RI>(hw, hs + k * a.hstep + 2 * RI * rg + b * HROW);
      load_words<RJ>(gw, gs + k * a.gstep + 2 * RJ * cg + b * GROW + 32 * RJ * u);
    };
    auto add = [&](float (&p)[RI][RJ], const Words<RI>& hw, const Words<RJ>& gw, bool real) {
      float h[RI], g[RJ];
      widen<RI>(h, hw);
      widen<RJ>(g, gw);
#pragma unroll
      for (int r = 0; r < RI; ++r)
#pragma unroll
        for (int j = 0; j < RJ; ++j) p[r][j] = fmaf(real ? h[r] : 0.0f, g[j], p[r][j]);
    };
    auto round_in = [&](int u, const float (&p)[RI][RJ]) {
#pragma unroll
      for (int r = 0; r < RI; ++r)
#pragma unroll
        for (int j = 0; j < RJ / 2; ++j) round_add(acc[u][r][j], p[r][2 * j], p[r][2 * j + 1]);
    };
    if (SHORT && B <= SHORT_B) {  // then a slot is a step
      // NS steps at a time, their rows interleaved, so that each FMA chain's
      // latency is hidden by the other steps'; SHORT_B rows without a
      // branch, those past B adding a zero product to a sum that is never
      // -0 (it starts at +0). The accumulators take the steps in order.
      auto steps = [&](int k0, auto s_count) {
        constexpr int NS = decltype(s_count)::value;
        float p[NS][RI][RJ] = {};
#pragma unroll
        for (int b = 0; b < SHORT_B; ++b)
#pragma unroll
          for (int s = 0; s < NS; ++s) {
            Words<RI> hw;
            Words<RJ> gw;
            load(k0 + s, 0, min(b, B - 1), hw, gw);
            add(p[s], hw, gw, b < B);
          }
#pragma unroll
        for (int s = 0; s < NS; ++s) round_in(0, p[s]);
      };
      int k = 0;
      for (; k + 4 <= ns; k += 4) steps(k, std::integral_constant<int, 4>{});
      for (; k < ns; ++k) steps(k, std::integral_constant<int, 1>{});
    } else {
      for (int k = 0; k < ns; ++k) {
        // SUBJ > 1 only with one slab a step (the plan's): its sums start and end in the slot
        const bool first = SUBJ > 1 || slab == 0, last = SUBJ > 1 || slab == NB - 1;
        const int n = min(R, B - slab * R);
#pragma unroll
        for (int u = 0; u < SUBJ; ++u) {
          if (first) {
#pragma unroll
            for (int r = 0; r < RI; ++r)
#pragma unroll
              for (int j = 0; j < RJ; ++j) part[u][r][j] = 0.0f;
          }
#pragma unroll 2
          for (int b = 0; b < n; ++b) {
            Words<RI> hw;
            Words<RJ> gw;
            load(k, u, b, hw, gw);
            add(part[u], hw, gw, true);
          }
          if (last) round_in(u, part[u]);
        }
        slab = slab + 1 == NB ? 0 : slab + 1;
      }
    }
    __syncthreads();  // buffer c % 2 read by every thread
    if (threadIdx.x < 32 && c + 2 < nchunks) issue(c + 2);
  }
  // unit i0 + RI·rg + r, columns j0 + RJ·cg + 16·RJ·u + 2j and + 1
#pragma unroll
  for (int u = 0; u < SUBJ; ++u)
#pragma unroll
    for (int r = 0; r < RI; ++r)
#pragma unroll
      for (int j = 0; j < RJ / 2; ++j) {
        const int i = i0 + RI * rg + r, col = j0 + RJ * cg + 16 * RJ * u + 2 * j;
        if (i < H && col < H4) *reinterpret_cast<unsigned*>(a.dw + (size_t)i * H4 + col) = acc[u][r][j];
      }
}

template <int MI, int NJ>
int launch(DwArgs& a, const void* h_seq, const void* h0, const void* dxproj, int blocks, int smem, int* info,
           cudaStream_t stream) {
  const cuuint64_t T = a.T, B = a.B, H = a.H;
  const cuuint64_t h_dims[3] = {H, T, B}, h_strides[2] = {H * 2, T * H * 2};
  const cuuint64_t g_dims[3] = {4 * H, T, B}, g_strides[2] = {4 * H * 2, T * 4 * H * 2};
  const cuuint64_t h0_dims[2] = {H, B}, h0_strides[1] = {H * 2};
  const cuuint32_t R = a.rows, h_box[3] = {8 * MI, 1, R}, g_box[3] = {32 * NJ, 1, R}, h0_box[2] = {8 * MI, R};
  if (!encode(&a.map_h, h_seq, 3, h_dims, h_strides, h_box, CU_TENSOR_MAP_SWIZZLE_NONE) ||
      !encode(&a.map_dx, dxproj, 3, g_dims, g_strides, g_box, CU_TENSOR_MAP_SWIZZLE_NONE) ||
      (h0 != nullptr && !encode(&a.map_h0, h0, 2, h0_dims, h0_strides, h0_box, CU_TENSOR_MAP_SWIZZLE_NONE)))
    return ERR_TMA;
  int sms = 0, per_sm = 0;
  const int err = occupancy((const void*)lstm_scan_dw_kernel<MI, NJ>, NT, smem, per_sm, sms);
  if (err != 0) return err;
  if (info != nullptr) {
    info[0] = per_sm;
    info[1] = sms;
  }
  if (per_sm < 1) return ERR_RESIDENT;
  const dim3 grid((4 * a.H + 32 * NJ - 1) / (32 * NJ), (a.H + 8 * MI - 1) / (8 * MI));
  if ((int)(grid.x * grid.y) != blocks) return ERR_PLAN;
  lstm_scan_dw_kernel<MI, NJ><<<grid, NT, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// dW (H, 4H) bfloat16 of the scan rounding, one launch on `stream`, without
// synchronising. h_seq, h0 (or null) and dxproj bfloat16, 16-byte aligned.
// mi, nj, rows, slabs, ct, blocks and smem are the plan of
// ops/lstm.py:scan_dw_plan: a block's tile (8·mi units by 32·nj columns), a
// step's batch as slabs boxes of rows rows, the slots a buffer of the ring
// holds, the grid and the dynamic shared bytes (128 of alignment slack, two
// buffers of ct slots' boxes, each box's rows of the tile's units or columns
// rounded up to 128 bytes, and two mbarriers). info (2 ints, may be
// null) receives the blocks that fit an SM and the SM count. Returns 0,
// ERR_PLAN for shapes or a plan it does not take, ERR_RESIDENT, ERR_TMA where
// a tensor map cannot be encoded, or the CUDA error of the launch.
int autovc_lstm_scan_dw(const void* h_seq, const void* h0, const void* dxproj, void* dw, int B, int T, int H,
                        int reverse, int mi, int nj, int rows, int slabs, int ct, int blocks, int smem, int* info,
                        cudaStream_t stream) {
  const int hstep = (rows * 16 * mi + 127) / 128 * 128, gstep = (rows * 64 * nj + 127) / 128 * 128;
  if (B <= 0 || T <= 0 || H <= 0 || H % 8 != 0 || (long)B * T * 4 * H > (1L << 31) || rows <= 0 || rows > 256 ||
      slabs != (B + rows - 1) / rows || (slabs > 1 && nj > 4) || ct <= 0 || ct > (long)T * slabs ||
      128 + 2L * ct * (hstep + gstep) + 16 != smem)
    return ERR_PLAN;
  if ((uintptr_t)h_seq % 16 || (uintptr_t)h0 % 16 || (uintptr_t)dxproj % 16) return ERR_TMA;
  DwArgs a{{}, {}, {}, static_cast<bf16*>(dw), B, T, H, reverse, rows, slabs, ct, h0 != nullptr, hstep, gstep};
  if (mi == 8 && nj == 8) return launch<8, 8>(a, h_seq, h0, dxproj, blocks, smem, info, stream);
  if (mi == 4 && nj == 4) return launch<4, 4>(a, h_seq, h0, dxproj, blocks, smem, info, stream);
  if (mi == 2 && nj == 2) return launch<2, 2>(a, h_seq, h0, dxproj, blocks, smem, info, stream);
  if (mi == 1 && nj == 1) return launch<1, 1>(a, h_seq, h0, dxproj, blocks, smem, info, stream);
  return ERR_PLAN;
}

const char* autovc_cuda_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

}  // extern "C"
