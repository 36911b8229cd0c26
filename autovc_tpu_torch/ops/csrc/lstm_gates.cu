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
// Bound. The kernel reads xproj (2·M·4H bytes, M = B·T), w_hh (2·H·4H) and
// h_seq (2·M·H) once and writes act (4·M·4H): at B=7, T=128 (M=896) 32.2 MB
// at H=1024 (9.6 us at 3.35 TB/s), 14.0 MB at H=512 (4.2 us), 0.75 MB at
// H=32 (0.22 us); its 2·M·H·4H operations at the bfloat16 tensor cores'
// 989 TFLOP/s take 7.6, 1.9 and 0.007 us. So it is bound by bytes, the f32
// act the largest stream. Both operands of the product are exactly bfloat16
// (h_seq rounded, w_hh the layer's bfloat16 cast), so the tensor cores
// multiply them exactly and sum in float32: the product equals the float32
// reference up to the order of the sum. The rows whose hprev is h0, a
// float32 state that need not be bfloat16 exactly, take a zero row in the
// product (the box one step off) and add h0 @ w_hh in float32 FMAs: the
// consumers multiply each stage's w_hh tile, already in shared memory, by
// h0's slice while the tensor cores run, and the epilogue adds the sums to
// the first step's row (none in the model, whose state starts at zero).
//
// Design (Hopper: TMA, wgmma, an mbarrier ring). A block computes a tile of
// 128 rows (one batch row b, 128 consecutive steps t0 ..) by 128·NSUB
// columns of pre over K = H in steps of 64:
//  - Loads by TMA. h_seq is a 3-D tensor map (H, T, B); the tile's hprev is
//    the box {64 k, 128 t, 1 b} at (k0, t0 - 1, b), or t0 + 1 for reverse:
//    the box one step off IS the shifted sequence, and TMA fills the step
//    outside [0, T) with zeros, which is the zero-state row. w_hh is a 2-D
//    map (4H, H) read in boxes of {64 n, 64 k}, in its own MN-major layout.
//    Both with the 128-byte swizzle that wgmma reads without bank conflicts;
//    k and n past H and 4H are zero-filled too, so no shape is padded.
//  - A ring of STAGES stages (4, or 3 beside the wider tile), each a full
//    and an empty mbarrier. One producer warp starts the loads (expect-tx on
//    the full barrier), then xproj's tile of the block by a third map
//    (4H, T, B), unswizzled, on its own barrier; two consumer warpgroups, 64
//    rows each, wait on the ring, run wgmma m64n128k16 (bfloat16 in,
//    float32 accumulators in registers; A K-major, B MN-major, transposed by
//    the instruction) and release the stage.
//  - The epilogue through shared memory: the accumulators are written over
//    the ring, then each thread takes four columns of a row at a time, adds
//    xproj from its tile, applies the gate's activation and writes act with
//    16-byte stores, a warp on 4 rows x 32 columns: whole lines of act, one
//    gate where H % 32 == 0 (at H=32 a tile spans all four), the
//    accumulators' registers free so that activations overlap. expf and
//    tanhf stay exact (the gate is 1e-5 against lstm_gates_ref); the
//    sigmoid's reciprocal is the hardware's with a Newton step, without the
//    special-case branch of IEEE division, which serialised the activations
//    (scripts/gates_phases.py: the epilogue took 5x its time).
//  - The tensor maps are encoded on the host (cuTensorMapEncodeTiled, found
//    with dlsym in the loaded libcuda.so.1: no -lcuda), kept in a small cache keyed
//    by (pointers, shape), and passed as __grid_constant__ parameters.
//  - NSUB (1 or 2) comes from ops/lstm.py:gates_plan: 128×256 tiles where
//    they still make a wave of blocks (H=1024 at B=7, T=128: 112 blocks;
//    L2 reads of the operands 88 MB, against 229 MB for the 64×64 wmma
//    tiles of the design this replaces), else 128×128.
// Where the time goes (scripts/gates_phases.py, H100, B=7, T=128,
// H=1024): the first stage lands at 2.4 us, the product runs at the tensor
// cores' rate (1.1 k cycles a 64-deep stage of a 128 x 256 tile) for 9 us,
// the epilogue 7 us; so the kernel stays at about half its bytes bound.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <mutex>

#include "coop.cuh"
#include "tma.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int BM = 128;               // rows of pre a block: two consumer warpgroups of 64
constexpr int BK = 64;                // K a stage: one 128-byte swizzle row of bfloat16
constexpr int BN_SUB = 128;           // columns a wgmma
template <int NSUB>
constexpr int STAGES = NSUB == 2 ? 3 : 4;  // the ring, beside xproj's tile, within 227 KB
constexpr int CONSUMERS = 256;        // two warpgroups
constexpr int THREADS = CONSUMERS + 32;  // and the producer warp
constexpr int A_BYTES = BM * BK * 2;      // 16 KB a stage
constexpr int B_BOX_BYTES = BK * 64 * 2;  // one {64 n, 64 k} box: 8 KB
constexpr int B_SUB_BYTES = 2 * B_BOX_BYTES;  // 128 columns
constexpr int X_BOX_BYTES = BM * 64 * 2;      // one {64 n, 128 t} box of xproj: 16 KB

struct GateArgs {
  const float* h0;
  float* act;
  int B, T, H, reverse;
};

// 1 / (1 + exp(-x)), expf exact, the reciprocal without a branch: the
// hardware's approximation and one Newton step (within an ulp of IEEE
// division, whose special-case branch kept the compiler from interleaving
// the epilogue's activations: 5x its time); 1 + exp(-x) is at least 1, and
// infinite (sigmoid 0) only where -x overflows
__device__ __forceinline__ float sigmoid(float x) {
  const float y = 1.0f + expf(-x);
  float r;
  asm("rcp.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(y));
  return y == INFINITY ? 0.0f : fmaf(r, fmaf(-y, r, 1.0f), r);
}

__device__ __forceinline__ void bar_init(uint64_t* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(count));
}
__device__ __forceinline__ void bar_expect(uint64_t* bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void bar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_addr(bar)) : "memory");
}
// Waits for the phase of the given parity; traps (a launch error, not a
// hung card) after about 2^32 cycles without it, which only a fault in the
// ring's accounting could cause.
__device__ __forceinline__ void bar_wait(uint64_t* bar, unsigned parity) {
  const long long start = clock64();
  unsigned done = 0;
  while (true) {
    asm volatile(
        "{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
    if (done) return;
    if (clock64() - start > (1LL << 32)) __trap();
  }
}

// Named barrier `id` over `count` threads (0 is __syncthreads').
__device__ __forceinline__ void named_sync(int id, int count) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}

// d (64 rows x 128 columns, this warpgroup's fragment) += A (64 x 16,
// K-major) x B (16 x 128, MN-major: imm-trans-b 1).
__device__ __forceinline__ void wgmma_128(float (&d)[64], uint64_t desc_a, uint64_t desc_b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
      "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
      "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
      "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
      "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
      "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
      "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
      "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(desc_a), "l"(desc_b), "r"(1));
}

template <int NSUB>
__global__ void __launch_bounds__(THREADS, 1)
    lstm_gates_kernel(const GateArgs a, const __grid_constant__ CUtensorMap map_h,
                      const __grid_constant__ CUtensorMap map_w, const __grid_constant__ CUtensorMap map_x) {
  constexpr int S = STAGES<NSUB>;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  // the swizzled tiles need 1024-byte alignment: the launch adds 1 KB of slack
  unsigned char* smem = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  unsigned char* a_tiles = smem;                             // S x A_BYTES
  unsigned char* b_tiles = smem + S * A_BYTES;               // S x NSUB x B_SUB_BYTES
  unsigned char* x_tile = b_tiles + S * NSUB * B_SUB_BYTES;  // 2 NSUB x X_BOX_BYTES
  uint64_t* full = reinterpret_cast<uint64_t*>(x_tile + 2 * NSUB * X_BOX_BYTES);
  uint64_t* empty = full + S;
  uint64_t* x_full = empty + S;

  const int H = a.H, N = 4 * H, T = a.T;
  const int n0 = blockIdx.x * (NSUB * BN_SUB);
  const int tiles_t = (T + BM - 1) / BM;
  const int b = blockIdx.y / tiles_t, t0 = (blockIdx.y % tiles_t) * BM;
  const int nk = (H + BK - 1) / BK;
  const int tid = threadIdx.x;

  if (tid == 0) {
    for (int s = 0; s < S; ++s) {
      bar_init(&full[s], 1);
      bar_init(&empty[s], 2);  // one arrival a consumer warpgroup
    }
    bar_init(x_full, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (tid >= CONSUMERS) {  // the producer warp: one thread starts the loads
    if (tid == CONSUMERS) {
      const int t_src = a.reverse ? t0 + 1 : t0 - 1;  // the box one step off: hprev, zeros outside [0, T)
      for (int ks = 0; ks < nk; ++ks) {
        const int s = ks % S;
        if (ks >= S) bar_wait(&empty[s], ((ks / S) + 1) & 1);
        bar_expect(&full[s], A_BYTES + NSUB * B_SUB_BYTES);
        tma_load_3d(a_tiles + s * A_BYTES, &map_h, &full[s], ks * BK, t_src, b);
        unsigned char* bt = b_tiles + s * NSUB * B_SUB_BYTES;
#pragma unroll
        for (int j = 0; j < 2 * NSUB; ++j) tma_load_2d(bt + j * B_BOX_BYTES, &map_w, &full[s], n0 + 64 * j, ks * BK);
      }
      // the epilogue's xproj tile, behind the product's loads: it lands while the last stages run
      bar_expect(x_full, 2 * NSUB * X_BOX_BYTES);
#pragma unroll
      for (int j = 0; j < 2 * NSUB; ++j) tma_load_3d(x_tile + j * X_BOX_BYTES, &map_x, x_full, n0 + 64 * j, t0, b);
    }
    return;
  }

  const int wg = tid / 128;  // this warpgroup's 64 rows: wg * 64 ..
  // h0's row: this thread's column of the tile and its share of each
  // stage's 64 k (every SPLIT-th), summed over the stages in h0w
  constexpr int NCOL = NSUB * BN_SUB, SPLIT = CONSUMERS / NCOL;
  const int t_first = a.reverse ? T - 1 : 0;
  const bool with_h0 = a.h0 != nullptr && t_first >= t0 && t_first < t0 + BM;
  const int hcol = tid % NCOL, hpart = tid / NCOL;
  float h0w = 0.0f;
  float acc[NSUB][64];
#pragma unroll
  for (int j = 0; j < NSUB; ++j)
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[j][i] = 0.0f;

  for (int ks = 0; ks < nk; ++ks) {
    const int s = ks % S;
    bar_wait(&full[s], (ks / S) & 1);
    const unsigned char* at = a_tiles + s * A_BYTES + wg * (64 * BK * 2);
    const unsigned char* bt = b_tiles + s * NSUB * B_SUB_BYTES;
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      // A: 128-byte rows of 64 k, 8-row groups 1024 bytes apart; k16 step = 32 bytes.
      // B: 64-column boxes B_BOX_BYTES apart (LBO), 8-k-row groups 1024 apart (SBO); k16 step = 2048 bytes.
      const uint64_t da = sw128_desc(at + kk * 32, 16, 1024);
#pragma unroll
      for (int j = 0; j < NSUB; ++j)
        wgmma_128(acc[j], da, sw128_desc(bt + j * B_SUB_BYTES + kk * 2048, B_BOX_BYTES, 1024));
    }
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
    if (with_h0) {
      // w_hh[k0 + k, n0 + hcol] in the swizzled box: row k at k * 128 bytes,
      // its 16-byte chunks permuted by k % 8; four sums, so that the FMAs
      // do not wait on each other
      const unsigned char* box = bt + (hcol / 64) * B_BOX_BYTES;
      const int c = hcol % 64, kb = hpart * (BK / SPLIT), k0 = ks * BK + kb;
      const float* h = a.h0 + (size_t)b * H + k0;
      float part[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
      for (int i = 0; i < BK / SPLIT; i += 4) {
        if (k0 + i >= H) break;  // H % 8 == 0: whole groups of four
        const float4 hv = __ldg(reinterpret_cast<const float4*>(h + i));
        const float hk[4] = {hv.x, hv.y, hv.z, hv.w};
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const int k = kb + i + u;
          const bf16 w = *reinterpret_cast<const bf16*>(box + k * 128 + ((((c >> 3) ^ (k & 7)) << 4) | ((c & 7) << 1)));
          part[u] = fmaf(hk[u], __bfloat162float(w), part[u]);
        }
      }
      h0w += (part[0] + part[1]) + (part[2] + part[3]);
    }
    asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
    if (with_h0) named_sync(1 + wg, 128);  // every thread of the warpgroup done with the stage
    if (tid % 128 == 0) bar_arrive(&empty[s]);
  }
  __shared__ float h0s[SPLIT][NCOL];
  if (with_h0) h0s[hpart][hcol] = h0w;
  named_sync(3, CONSUMERS);  // both warpgroups' products done: the ring is free

  // epilogue, (1): the accumulators to shared memory, over the ring. Accumulator
  // (j, i) of this thread is row 16w + lane/4 + 8((i/2) % 2) of its warpgroup's
  // 64 and column 128j + 8(i/4) + 2(lane % 4) + i % 2 of the tile; rows LDC
  // floats apart, 8 banks on from the row before
  constexpr int LDC = NCOL + 8;
  float* cs = reinterpret_cast<float*>(smem);
  {
    const int lane = tid % 32, r = wg * 64 + 16 * ((tid % 128) / 32) + lane / 4;
#pragma unroll
    for (int j = 0; j < NSUB; ++j)
#pragma unroll
      for (int nb = 0; nb < 16; ++nb)
#pragma unroll
        for (int half = 0; half < 2; ++half)
          *reinterpret_cast<float2*>(cs + (r + 8 * half) * LDC + BN_SUB * j + 8 * nb + 2 * (lane % 4)) =
              make_float2(acc[j][4 * nb + 2 * half], acc[j][4 * nb + 2 * half + 1]);
  }
  named_sync(3, CONSUMERS);
  bar_wait(x_full, 0);
  // (2): four columns a thread, a warp on 4 rows x 32 columns (whole 128-byte
  // lines of act; one gate where H % 32 == 0, so that no warp runs both
  // activations), xproj read from its tile (TMA, zero past T and 4H), the
  // registers of the accumulators free. Four columns lie in one gate (H % 8 == 0).
  constexpr int GROUPS = NCOL / 32, PER_THREAD = BM * NCOL / 4 / CONSUMERS;
  static_assert(PER_THREAD % 2 == 0, "the epilogue takes its quads two at a time");
  for (int i = 0; i < PER_THREAD; i += 2) {
    // two quads' inputs loaded before either is computed: independent chains
    int rs[2], cs4[2];
    float4 p[2];
    uint2 xr[2];
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int e = tid + (i + u) * CONSUMERS;  // (row block, 32 columns, row, quad)
      rs[u] = (e / (32 * GROUPS)) * 4 + (e / 8) % 4;
      cs4[u] = 32 * ((e / 32) % GROUPS) + 4 * (e % 8);
      p[u] = *reinterpret_cast<const float4*>(cs + rs[u] * LDC + cs4[u]);
      xr[u] = *reinterpret_cast<const uint2*>(x_tile + (cs4[u] / 64) * X_BOX_BYTES + (rs[u] * 64 + cs4[u] % 64) * 2);
    }
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int r = rs[u], c = cs4[u], t = t0 + r, n = n0 + c;
      if (t >= T || n >= N) continue;
      const float2 x01 = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&xr[u].x));
      const float2 x23 = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&xr[u].y));
      float4 v = make_float4(p[u].x + x01.x, p[u].y + x01.y, p[u].z + x23.x, p[u].w + x23.y);
      if (with_h0 && t == t_first) {
#pragma unroll
        for (int part = 0; part < SPLIT; ++part) {
          v.x += h0s[part][c];
          v.y += h0s[part][c + 1];
          v.z += h0s[part][c + 2];
          v.w += h0s[part][c + 3];
        }
      }
      if (n >= 2 * H && n < 3 * H)
        v = make_float4(tanhf(v.x), tanhf(v.y), tanhf(v.z), tanhf(v.w));
      else
        v = make_float4(sigmoid(v.x), sigmoid(v.y), sigmoid(v.z), sigmoid(v.w));
      *reinterpret_cast<float4*>(a.act + ((size_t)b * T + t) * N + n) = v;
    }
  }
}

// The maps of the last calls, by (pointer, shape): a map holds only the
// address and the shape, so a hit is the map the call would encode.
struct Maps {
  const void* h_seq;
  const void* w_hh;
  const void* xproj;
  int B, T, H;
  CUtensorMap map_h, map_w, map_x;
};

bool maps_for(const void* h_seq, const void* w_hh, const void* xproj, int B, int T, int H, CUtensorMap& map_h,
              CUtensorMap& map_w, CUtensorMap& map_x) {
  constexpr int KEEP = 16;
  static std::mutex mu;
  static Maps seen[KEEP];
  static int used = 0, next = 0;
  std::lock_guard<std::mutex> lock(mu);
  for (int i = 0; i < used; ++i) {
    const Maps& s = seen[i];
    if (s.h_seq == h_seq && s.w_hh == w_hh && s.xproj == xproj && s.B == B && s.T == T && s.H == H) {
      map_h = s.map_h;
      map_w = s.map_w;
      map_x = s.map_x;
      return true;
    }
  }
  const cuuint64_t dims_h[3] = {(cuuint64_t)H, (cuuint64_t)T, (cuuint64_t)B};
  const cuuint64_t strides_h[2] = {(cuuint64_t)H * 2, (cuuint64_t)T * H * 2};
  const cuuint32_t box_h[3] = {BK, BM, 1};
  const cuuint64_t dims_w[2] = {(cuuint64_t)4 * H, (cuuint64_t)H};
  const cuuint64_t strides_w[1] = {(cuuint64_t)4 * H * 2};
  const cuuint32_t box_w[2] = {64, BK};
  const cuuint64_t dims_x[3] = {(cuuint64_t)4 * H, (cuuint64_t)T, (cuuint64_t)B};
  const cuuint64_t strides_x[2] = {(cuuint64_t)4 * H * 2, (cuuint64_t)T * 4 * H * 2};
  const cuuint32_t box_x[3] = {64, BM, 1};
  if (!encode(&map_h, h_seq, 3, dims_h, strides_h, box_h, CU_TENSOR_MAP_SWIZZLE_128B) ||
      !encode(&map_w, w_hh, 2, dims_w, strides_w, box_w, CU_TENSOR_MAP_SWIZZLE_128B) ||
      !encode(&map_x, xproj, 3, dims_x, strides_x, box_x, CU_TENSOR_MAP_SWIZZLE_NONE))
    return false;
  seen[next] = {h_seq, w_hh, xproj, B, T, H, map_h, map_w, map_x};
  next = (next + 1) % KEEP;
  used = used < KEEP ? used + 1 : KEEP;
  return true;
}

template <int NSUB>
int launch_gates(const GateArgs& a, const CUtensorMap& map_h, const CUtensorMap& map_w, const CUtensorMap& map_x,
                 cudaStream_t stream) {
  constexpr int S = STAGES<NSUB>;
  constexpr int smem = S * (A_BYTES + NSUB * B_SUB_BYTES) + 2 * NSUB * X_BOX_BYTES + (2 * S + 1) * 8 + 1024;
  static_assert(BM * (NSUB * BN_SUB + 8) * 4 <= S * (A_BYTES + NSUB * B_SUB_BYTES), "the epilogue's tile fits the ring");
  static std::once_flag raised;
  static cudaError_t err = cudaSuccess;
  std::call_once(raised, [] {
    err = cudaFuncSetAttribute(lstm_gates_kernel<NSUB>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  });
  if (err != cudaSuccess) return (int)err;
  const int tiles_t = (a.T + BM - 1) / BM;
  const dim3 grid((4 * a.H + NSUB * BN_SUB - 1) / (NSUB * BN_SUB), (unsigned)(a.B * tiles_t));
  lstm_gates_kernel<NSUB><<<grid, THREADS, smem, stream>>>(a, map_h, map_w, map_x);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// act (B, T, 4H) float32 from xproj, w_hh, h_seq (bfloat16) and h0 (float32,
// may be null), one launch on `stream`, without synchronising, in tiles of
// 128 x 128·nsub (nsub 1 or 2: ops/lstm.py:gates_plan). Returns 0, ERR_PLAN
// for shapes or pointers it does not take (H % 8 != 0: TMA's 16-byte
// strides; an operand not 16-byte aligned), ERR_TMA when the tensor maps
// cannot be encoded, or the
// CUDA error of the launch.
int autovc_lstm_gates(const void* xproj, const void* w_hh, const float* h0, const void* h_seq, float* act, int B,
                      int T, int H, int reverse, int nsub, cudaStream_t stream) {
  const long M = (long)B * T;
  if (B <= 0 || T <= 0 || H <= 0 || H % 8 != 0 || M > (1L << 30) || (nsub != 1 && nsub != 2) ||
      (long)B * ((T + BM - 1) / BM) > 65535 || (uintptr_t)h_seq % 16 || (uintptr_t)w_hh % 16 ||
      (uintptr_t)xproj % 16 || (uintptr_t)act % 16)
    return ERR_PLAN;
  CUtensorMap map_h, map_w, map_x;
  if (!maps_for(h_seq, w_hh, xproj, B, T, H, map_h, map_w, map_x)) return ERR_TMA;
  const GateArgs a{h0, act, B, T, H, reverse};
  return nsub == 2 ? launch_gates<2>(a, map_h, map_w, map_x, stream) : launch_gates<1>(a, map_h, map_w, map_x, stream);
}

const char* autovc_cuda_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

}  // extern "C"
