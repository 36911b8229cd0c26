// Mel projection fused with the dB normalization.
//
// Replaces the Pallas kernel of autovc_tpu/ops/pallas_mel.py:
//   mel_normalize :34 (pallas_call :53) -> _kernel :25.
// Computes, float32 throughout:
//   m[t, j]   = sum over k of mag[t, k] * basis[k, j]      k in increasing order
//   out[t, j] = clip((20 * log10(max(1e-5, m)) - ref_db - min_db) / -min_db, 0, 1)
//   mag (T, K) and out (T, M) row-major; basis_t (M, K) row-major, the mel
//   basis transposed (ops.mel keeps one per basis), so that a filter's
//   weights are contiguous; spans (M, 2) int32: [lo, hi) of filter j's
//   nonzero bins (ops.mel.filter_spans).
// Any K (513 for the 1024-point STFT, 257 for the 512-point one) and any M:
// the ragged edges are masked, nothing is padded in device memory (the TPU
// padded K and M to 128 lanes for its matrix unit).
//
// Each output is one chain of fmaf from 0.0f over its filter's span [lo, hi)
// in increasing k: the bins outside the span hold zero weights, whose
// products are exact zeros that leave the sum as it is, so for finite
// magnitudes the result is bit for bit that of a chain of fmaf over all K
// bins in order. A NaN or inf magnitude in a bin of zero weight does not
// reach the output, as it would through the dense product (|rfft| of finite
// audio is finite).
//
// Design. A filter spans at most 34 of the 513 bins (941 nonzeros of 41,040
// in the spmel basis, all within bins 6..486), so a walk over all bins would
// spend 98% of its products on zeros and, at a file's ~300 frames, its time
// on the latency of walking them. Each block owns a tile of TT = 32 frames
// and all M mels:
//   1. the tile's TT x K magnitudes are one contiguous run of mag, copied
//      into shared memory with an odd pitch (K, or K + 1 for an even K): where
//      the pitch is K and mag is 16-byte aligned (a block's run starts at
//      32 K floats), one bulk copy by the TMA engine (a 513-float row, 2052
//      bytes, is not 16-byte aligned, so TMA's 2-D copy does not apply, but
//      the tile's whole run is) and 4-byte cp.async for its last < 4 floats;
//      else 4-byte cp.async throughout. The copy is in flight while the
//      filters are laid out;
//   2. warp 0 reads the spans (clamped into [0, K]) and forms their packed
//      offsets, a prefix sum of the widths by warp shuffles;
//   3. each filter's weights basis_t[j, lo..hi) packed into shared memory, a
//      coalesced copy a filter (one group of filters whose packed weights fit
//      `wcap` floats at a time: a single group for a mel basis, several for a
//      dense one);
//   4. lane = frame, warp = four adjacent filters at once (four independent
//      chains, each its own filter's span in order, the loads of four steps
//      made before their fmaf): the weights broadcast reads, the frames'
//      magnitudes 32 banks apart (odd pitch); the dB epilogue runs on the sums
//      (its multiply an explicit intrinsic so that nvcc does not fuse it with
//      the subtraction; log10f is the accurate one, no fast math), and the
//      values go to a shared (TT x M) tile;
//   5. the tile's TT x M outputs, one contiguous run of out, stored coalesced.
//
// Bound. At T = 16416 frames (32 utterances of 513), K = 513, M = 80: the
// work is 2 * T * nnz = 30.9 MFLOP (941 nonzeros), 0.5 us at 67 TFLOP/s,
// against 33.7 MB of mag read once and 5.3 MB of out written once, 11.6 us
// at 3.35 TB/s: the bytes bound it (the dense product would be 2 * T * K * M
// = 1.35 GFLOP, 20 us). At a file's ~300 frames it is latency: one copy of
// 64 KB a block, the spans, one round of the weights, ~12 dependent fmaf a
// filter.

#include <cuda_runtime.h>

#include "coop.cuh"

namespace {

constexpr int TT = 32;   // frames a block: a warp's lanes
constexpr int NT = 640;  // threads: 20 warps, each four filters of the tile at a time (80 mels: one quad a warp)
constexpr int CHAINS = 4;
constexpr int WARPS = NT / 32;
constexpr float MIN_LEVEL = 1e-5f;

// The block's shared memory (byte offsets), as ops.mel.tile_plan counts it.
struct Layout {
  int pitch, mpitch;  // floats a frame of the magnitude tile and of the output tile: odd
  size_t weights, outs, spans, bar, end;
};

__host__ __device__ inline Layout layout(int K, int M, int wcap) {
  Layout l;
  l.pitch = K | 1;
  l.mpitch = M | 1;
  l.weights = (size_t)TT * l.pitch * 4;
  l.outs = l.weights + (size_t)wcap * 4;
  l.spans = l.outs + (size_t)TT * l.mpitch * 4;
  l.bar = (l.spans + (size_t)(3 * M + 1) * 4 + 7) / 8 * 8;  // lo, hi, off (M + 1); the copy's mbarrier
  l.end = l.bar + 8;
  return l;
}

__device__ __forceinline__ float normalize(float m, float ref_db, float min_db) {
  const float db = __fsub_rn(__fmul_rn(20.0f, log10f(fmaxf(MIN_LEVEL, m))), ref_db);
  const float v = (db - min_db) / -min_db;
  return fminf(fmaxf(v, 0.0f), 1.0f);
}

__global__ void __launch_bounds__(NT)
mel_norm_kernel(const float* __restrict__ mag, const float* __restrict__ basis_t, const int* __restrict__ spans,
                float* __restrict__ out, int T, int K, int M, float ref_db, float min_db, int wcap) {
  extern __shared__ __align__(16) unsigned char smem[];
  const Layout l = layout(K, M, wcap);
  float* tile = reinterpret_cast<float*>(smem);
  float* wts = reinterpret_cast<float*>(smem + l.weights);
  float* outs = reinterpret_cast<float*>(smem + l.outs);
  int* lo = reinterpret_cast<int*>(smem + l.spans);
  int* hi = lo + M;
  int* off = hi + M;
  unsigned long long* bar = reinterpret_cast<unsigned long long*>(smem + l.bar);
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int f0 = blockIdx.x * TT;
  const int rows = T - f0 < TT ? T - f0 : TT;

  // 1. the tile's magnitudes, in flight while the filters are laid out
  const float* src = mag + (size_t)f0 * K;
  const int n = rows * K;
  const bool bulk = l.pitch == K && reinterpret_cast<size_t>(mag) % 16 == 0 && n >= 4;
  if (bulk) {
    if (tid == 0) {
      mbar_init(bar);
      bulk_load(tile, src, (unsigned)(n / 4 * 16), bar);
    }
    for (int e = n / 4 * 4 + tid; e < n; e += NT) cp_async4_fill(tile + e, src + e, true);
  } else if (l.pitch == K) {
    for (int e = tid; e < n; e += NT) cp_async4_fill(tile + e, src + e, true);
  } else {
    for (int e = tid; e < n; e += NT) cp_async4_fill(tile + e + e / K, src + e, true);
  }
  cp_async_commit();

  // 2. the spans and the packed offsets
  if (warp == 0) {
    int run = 0;
    for (int j0 = 0; j0 < M; j0 += 32) {
      const int j = j0 + lane;
      int a = 0, b = 0;
      if (j < M) {
        a = max(0, min(K, spans[2 * j]));
        b = max(a, min(K, spans[2 * j + 1]));
        lo[j] = a;
        hi[j] = b;
      }
      int incl = b - a;  // inclusive prefix sum of the widths over the lanes
#pragma unroll
      for (int d = 1; d < 32; d *= 2) {
        const int o = __shfl_up_sync(0xffffffffu, incl, d);
        if (lane >= d) incl += o;
      }
      if (j < M) off[j] = run + incl - (b - a);
      run += __shfl_sync(0xffffffffu, incl, 31);
    }
    if (lane == 0) off[M] = run;
  }
  __syncthreads();

  // 3-4. the filters, a group whose packed weights fit wcap at a time (one
  // group, the mel basis's case, without a search)
  const float* a = tile + lane * l.pitch;
  bool tile_in = !bulk;
  for (int j0 = 0; j0 < M;) {
    int j1 = j0 + 1;
    if (off[M] - off[j0] <= wcap) {
      j1 = M;
    } else {
      while (j1 < M && off[j1 + 1] - off[j0] <= wcap) ++j1;
    }
    for (int j = j0 + warp; j < j1; j += WARPS) {
      const int base = off[j] - off[j0] - lo[j];  // filter j's weight of bin k is wts[base + k]
      for (int k = lo[j] + lane; k < hi[j]; k += 32) cp_async4_fill(wts + base + k, basis_t + (size_t)j * K + k, true);
    }
    cp_async_commit();
    cp_async_wait<0>();  // this group's weights, and the first time the tile
    if (!tile_in) {
      mbar_wait(bar, 0);
      tile_in = true;
    }
    __syncthreads();
    // warp w takes the group's filters [j0 + w per, j0 + (w + 1) per),
    // CHAINS at a time (past the range, a chain repeats the range's last)
    const int per = (j1 - j0 + WARPS - 1) / WARPS;
    const int jw = j0 + warp * per, jend = min(j1, jw + per);
    for (int j = jw; j < jend; j += CHAINS) {
      int jc[CHAINS], lc[CHAINS], nc[CHAINS], longest = 0;
      const float* wc[CHAINS];
      float acc[CHAINS];
#pragma unroll
      for (int c = 0; c < CHAINS; ++c) {
        jc[c] = min(j + c, jend - 1);
        lc[c] = lo[jc[c]];
        nc[c] = hi[jc[c]] - lc[c];
        wc[c] = wts + (off[jc[c]] - off[j0]);
        acc[c] = 0.0f;
        longest = max(longest, nc[c]);
      }
      for (int i = 0; i < longest; i += 4) {
        float m[CHAINS][4], w[CHAINS][4];
#pragma unroll
        for (int c = 0; c < CHAINS; ++c) {
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            const bool in = i + u < nc[c];
            m[c][u] = in ? a[lc[c] + i + u] : 0.0f;
            w[c][u] = in ? wc[c][i + u] : 0.0f;
          }
        }
#pragma unroll
        for (int u = 0; u < 4; ++u) {
#pragma unroll
          for (int c = 0; c < CHAINS; ++c) {
            if (i + u < nc[c]) acc[c] = fmaf(m[c][u], w[c][u], acc[c]);
          }
        }
      }
#pragma unroll
      for (int c = 0; c < CHAINS; ++c) outs[lane * l.mpitch + jc[c]] = normalize(acc[c], ref_db, min_db);
    }
    __syncthreads();  // the group's weights are read before the next group's replace them
    j0 = j1;
  }

  // 5. the tile's outputs
  float* dst = out + (size_t)f0 * M;
  for (int e = tid; e < rows * M; e += NT) {
    const int f = e / M;
    dst[e] = outs[f * l.mpitch + (e - f * M)];
  }
}

}  // namespace

extern "C" {

// One launch on `stream`, not synchronising, with the plan of
// ops.mel.tile_plan (wcap packed weights, smem bytes a block). Returns 0,
// ERR_PLAN (-1) for a plan whose shared memory does not hold the layout, or
// the CUDA error of the launch (cudaErrorInvalidValue for T, K or M below 1).
int autovc_mel_norm(const float* mag, const float* basis_t, const int* spans, float* out, int T, int K, int M,
                    float ref_db, float min_db, int wcap, int smem, cudaStream_t stream) {
  if (T <= 0 || K <= 0 || M <= 0) return (int)cudaErrorInvalidValue;
  if (wcap < K || smem < 0 || (size_t)smem < layout(K, M, wcap).end) return ERR_PLAN;
  int per_sm = 0, sms = 0;  // raises the kernel's dynamic shared limit to smem
  const int err = occupancy((const void*)mel_norm_kernel, NT, smem, per_sm, sms);
  if (err != 0) return err;
  if (per_sm < 1) return ERR_PLAN;
  mel_norm_kernel<<<(T + TT - 1) / TT, NT, smem, stream>>>(mag, basis_t, spans, out, T, K, M, ref_db, min_db, wcap);
  return (int)cudaGetLastError();
}

const char* autovc_cuda_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

}  // extern "C"
