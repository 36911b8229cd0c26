// One pass of a cascade of second-order sections over the time axis.
//
// A port-only kernel: it replaces the lax.scan of
// autovc_tpu/dsp/filters.py::_sosfilt (:135-161), run twice by
// _sos_filtfilt_jit (:164-173); there is no Pallas counterpart.
//
// Computes, for each row b, each sample t in order and each section s in
// order (direct form II transposed, a0 = 1):
//   y_new = b0 y + z0
//   z0    = b1 y - a1 y_new + z1
//   z1    = b2 y - a2 y_new
//   y     = y_new
// with y = x[b, t] entering section 0 and y[b, t] the last section's output.
//   x, y (B, L) float32, row b at b * ld (ld a multiple of 4, both 16-byte
//   aligned); sos (S, 6) = [b0 b1 b2 a0 a1 a2] float32; zi (B, S, 2) the
//   initial state; powers (levels, 2S, 2S) and resp (C, 2S) float64
//   (ops.sosfilt.scan_tables).
//
// Design: a chunked scan over time, one block a row. The recurrence is
// linear, so across a chunk of C samples the joint state s = [z0, z1 of each
// section] (N = 2S values) evolves as s_end = M s_start + e, M = A^C the map
// of C zero-input steps and e = sum over i of G[i] x_i the chunk's end state
// from a zero state, G[i] = A^(C-1-i) B the state response to sample i of the
// chunk (B the state after one step from zero with a unit input). The host
// computes the powers M^(2^j) and G in float64 from the float32 sos, once per
// (sos, C). The row is cut into chunks of C samples (a multiple of 4), one a
// thread (ops.sosfilt.scan_plan: at most 512 threads, C >= 32):
//   phase 1  each thread forms its chunk's e as a float64 dot product of its
//            samples with G (thread 0 adds M zi): N independent FMAs a sample.
//   phase 2  a Kogge-Stone scan in float64 over the block's chunks turns the
//            e_k into the state at the end of each chunk: at level j a thread
//            adds M^(2^j) times the value 2^j chunks back. A is block lower
//            triangular (a section's state does not depend on the later
//            sections'), so are its powers, and a row of the product reads
//            only its first 2(s + 1) columns.
//   phase 3  each thread runs the cascade over its chunk from the state its
//            predecessor ended in and writes y: in float64, each output
//            rounded once to float32; thread 0 runs chunk 0 from zi in the
//            float32 arithmetic of the plain version (ops/sosfilt.py: every
//            operation an explicit round-to-nearest intrinsic, the fused
//            multiply-adds of _sosfilt's step as XLA compiles it for the
//            CPU), so chunk 0, and a whole row of up to C samples, is the
//            sequential pass bit for bit.
// The carry stays inside the block: no grid barrier, no spin-wait, nothing
// between blocks.
//
// Why float64 in phases 1 and 3. The 30 Hz highpass has its poles at radius
// 0.988-0.996, and the DF2T states run far larger than the signal. Run in
// float32 from a zero state, phase 1's rounding, carried forward by the scan,
// left low-frequency rows several times farther from the float64 filter than
// the sequential float32 pass; run in float32 from a carry rounded to
// float32, phase 3 restarts its rounding error at every chunk boundary, a
// step every C samples whose spectrum reaches the mel bands and, through the
// dB step, moved quiet frames of the spmel features close to the 1e-3 that
// the front end is held to. In float64 the chunks join without a step and
// the output is the float64 filter's to within its float32 rounding.
//
// Data movement: the chunks are read through shared tiles, ROUND samples of
// every chunk a round, copied with 16-byte cp.async (C is a multiple of 4, so
// no copy straddles a chunk; one straddling the row's end reads only the row)
// beside the round's ROUND rows of G; NBUF - 1 rounds' copies are in flight
// while one is computed (one SM streams a row: latency, not the card's
// bandwidth, limits it). A chunk's row of the tile is PITCH = ROUND + 4
// floats, so that the 128-bit reads of 8 threads (a quarter warp) fall in 32
// distinct banks. Phase 3 writes y back through the same tile, 16 bytes a
// store. Phase 2's carries (N doubles a chunk, read 16 bytes at a time,
// conflict-free) take the tiles' place; the powers sit after both.
//
// Bound. Bytes: x read once and y written once, 8 bytes a sample: at B=32,
// L=131072 two passes move 67 MB, 20 us at 3.35 TB/s. The serial chain: a
// pass walks one chunk twice (phase 1's N sums are independent chains of C
// float64 FMAs; phase 3's cascade carries z0 -> y_new -> z0 through three
// dependent float64 FMAs a sample) plus the scan's levels, 160 * 8 + 9 * 48 +
// 160 * 24 = 5552 cycles at C = 160, 2.8 us a pass at 1.98 GHz, instead of
// L * 16 cycles (0.65 ms at L = 80,036) for the sequential float32 pass. One
// block runs on one SM, and its float64 pipe bounds it harder: N FMAs a
// sample in phase 1 and 5S in phase 3, L * 21 / 64 cycles a pass on the SM's
// 64 float64 lanes (13 us at L = 80,036), and the conversions between
// float32 and float64 (three a sample, 16 an SM a cycle) come on top. The
// tiles' copies of a row's scattered chunk segments reach about a fifth of
// the rate of one SM's contiguous copies.

#include <cuda_runtime.h>

#include "coop.cuh"

namespace {

constexpr int ROUND = 16;         // samples of each chunk staged a round
constexpr int PITCH = ROUND + 4;  // floats a chunk in the tile
constexpr int NBUF = 4;           // staging buffers: NBUF - 1 rounds in flight while one is computed
constexpr int MAX_THREADS = 512;
constexpr int MAX_LEVELS = 9;  // 2^9 = MAX_THREADS chunks

static_assert(ROUND % 4 == 0 && PITCH % 4 == 0, "16-byte copies");

// The plain version's step on one sample: every section in order, y its
// input and output, float32 with the rounding of _sosfilt's step.
template <int S>
__device__ __forceinline__ float cascade32(float y, const float (&c)[S][5], float (&z0)[S], float (&z1)[S]) {
#pragma unroll
  for (int s = 0; s < S; ++s) {
    const float yn = __fmaf_rn(c[s][0], y, z0[s]);
    z0[s] = __fadd_rn(__fmaf_rn(c[s][1], y, -__fmul_rn(c[s][3], yn)), z1[s]);
    z1[s] = __fmaf_rn(c[s][2], y, -__fmul_rn(c[s][4], yn));
    y = yn;
  }
  return y;
}

// The same step in float64; c holds b0, b1, b2, -a1, -a2.
template <int S>
__device__ __forceinline__ double cascade64(double y, const double (&c)[S][5], double (&z0)[S], double (&z1)[S]) {
#pragma unroll
  for (int s = 0; s < S; ++s) {
    const double yn = fma(c[s][0], y, z0[s]);
    z0[s] = fma(c[s][1], y, fma(c[s][3], yn, z1[s]));
    z1[s] = fma(c[s][2], y, c[s][4] * yn);
    y = yn;
  }
  return y;
}

// Round r of every chunk into `tile`: chunk k's samples k * chunk + r * ROUND
// + [0, ROUND), 4 a copy, zero where they fall outside the chunk or the row;
// with `resp`, the round's ROUND rows of G (N doubles each, zero past the
// chunk) into `g`.
__device__ __forceinline__ void stage(float* tile, double* g, const float* xr, const double* resp, int N, long long L,
                                      int chunk, int r) {
  const int vecs = blockDim.x * (ROUND / 4);
  for (int e = threadIdx.x; e < vecs; e += blockDim.x) {
    const int k = e / (ROUND / 4), v = e % (ROUND / 4), off = r * ROUND + 4 * v;
    const long long t = (long long)k * chunk + off;
    const long long left = off < chunk && t < L ? L - t : 0;
    cp_async16_part(tile + k * PITCH + 4 * v, left > 0 ? xr + t : xr, left >= 4 ? 16 : (int)left * 4);
  }
  if (resp != nullptr) {
    for (int e = threadIdx.x; e < ROUND * N / 2; e += blockDim.x) {
      const bool valid = r * ROUND + 2 * e / N < chunk;
      cp_async16_part(g + 2 * e, valid ? resp + (size_t)r * ROUND * N + 2 * e : resp, valid ? 16 : 0);
    }
  }
  cp_async_commit();
}

// The same mapping, shared -> y, the samples inside the row's chunks only.
__device__ __forceinline__ void unstage(const float* tile, float* yr, long long L, int chunk, int r) {
  const int vecs = blockDim.x * (ROUND / 4);
  for (int e = threadIdx.x; e < vecs; e += blockDim.x) {
    const int k = e / (ROUND / 4), v = e % (ROUND / 4), off = r * ROUND + 4 * v;
    const long long t = (long long)k * chunk + off;
    if (off >= chunk || t >= L) continue;
    const float4 val = *reinterpret_cast<const float4*>(tile + k * PITCH + 4 * v);
    if (t + 4 <= L) {
      *reinterpret_cast<float4*>(yr + t) = val;
    } else {  // the row's last, partial vector
      yr[t] = val.x;
      if (t + 1 < L) yr[t + 1] = val.y;
      if (t + 2 < L) yr[t + 2] = val.z;
    }
  }
}

// Shared memory, as ops.sosfilt.scan_plan counts it: NBUF staging buffers,
// each the round's rows of G (ROUND x N doubles) then the tile (threads x
// PITCH floats); in phase 2 two buffers of carries (threads x N doubles) in
// their place; then the powers (levels x N x N doubles). The buffers'
// addresses are computed from the shared array itself (a pointer kept in an
// array indexed at run time would lose its address space: generic loads).
__host__ __device__ constexpr size_t stage_bytes(int threads, int N) {
  return (size_t)ROUND * N * 8 + (size_t)threads * PITCH * 4;
}
__host__ __device__ constexpr size_t powers_offset(int threads, int N) {
  return NBUF * stage_bytes(threads, N) > 2 * (size_t)threads * N * 8 ? NBUF * stage_bytes(threads, N)
                                                                      : 2 * (size_t)threads * N * 8;
}
__device__ __forceinline__ double* g_buf(unsigned char* smem, int r, int threads, int N) {
  return reinterpret_cast<double*>(smem + (r % NBUF) * stage_bytes(threads, N));
}
__device__ __forceinline__ float* tile_buf(unsigned char* smem, int r, int threads, int N) {
  return reinterpret_cast<float*>(smem + (r % NBUF) * stage_bytes(threads, N) + (size_t)ROUND * N * 8);
}

// acc[m] += (P v)[m] for a block lower-triangular P (N x N, row-major in
// shared memory, read 16 bytes at a time): row m reads columns < 2(m/2 + 1).
template <int N>
__device__ __forceinline__ void add_product(double (&acc)[N], const double* P, const double (&v)[N]) {
  const double2* p2 = reinterpret_cast<const double2*>(P);
#pragma unroll
  for (int m = 0; m < N; ++m) {
#pragma unroll
    for (int q2 = 0; q2 <= m / 2; ++q2) {
      const double2 p = p2[m * (N / 2) + q2];
      acc[m] = fma(p.x, v[2 * q2], acc[m]);
      acc[m] = fma(p.y, v[2 * q2 + 1], acc[m]);
    }
  }
}

template <int S>
__global__ void __launch_bounds__(MAX_THREADS)
sosfilt_scan_kernel(const float* __restrict__ x, float* __restrict__ y, const float* __restrict__ sos,
                    const float* __restrict__ zi, const double* __restrict__ powers,
                    const double* __restrict__ resp, long long L, long long ld, int chunk, int levels) {
  constexpr int N = 2 * S;  // the joint state
  extern __shared__ __align__(16) unsigned char smem[];
  const int tid = threadIdx.x, threads = blockDim.x;
  const int b = blockIdx.x;
  double* pw = reinterpret_cast<double*>(smem + powers_offset(threads, N));
  const float* xr = x + (size_t)b * ld;
  float* yr = y + (size_t)b * ld;
  for (int i = tid; i < levels * N * N; i += threads) pw[i] = powers[i];

  // samples of this thread's chunk inside the row
  const long long first = (long long)tid * chunk;
  const int mine = first >= L ? 0 : (int)(L - first < chunk ? L - first : chunk);
  const int rounds = (chunk + ROUND - 1) / ROUND;

  // phase 1: the chunk's end state from a zero state, the sum of G[i] x_i
  double e[N];
#pragma unroll
  for (int m = 0; m < N; ++m) e[m] = 0.0;
  for (int r = 0; r < NBUF - 1; ++r) {  // NBUF - 1 groups in flight, empty ones past the chunk
    if (r < rounds) stage(tile_buf(smem, r, threads, N), g_buf(smem, r, threads, N), xr, resp, N, L, chunk, r);
    else cp_async_commit();
  }
  for (int r = 0; r < rounds; ++r) {
    cp_async_wait<NBUF - 2>();  // round r's group
    __syncthreads();            // ... for every thread; and round r - 1's buffer is free
    const int ahead = r + NBUF - 1;
    if (ahead < rounds) stage(tile_buf(smem, ahead, threads, N), g_buf(smem, ahead, threads, N), xr, resp, N, L,
                              chunk, ahead);
    else cp_async_commit();
    const float4* row = reinterpret_cast<const float4*>(tile_buf(smem, r, threads, N) + tid * PITCH);
    const double2* g = reinterpret_cast<const double2*>(g_buf(smem, r, threads, N));
    const int n = mine - r * ROUND;
#pragma unroll
    for (int q = 0; q < ROUND / 4; ++q) {
      const float4 xv = row[q];
      const float xs[4] = {xv.x, xv.y, xv.z, xv.w};
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        if (4 * q + u < n) {
          const double v = xs[u];
#pragma unroll
          for (int m2 = 0; m2 < N / 2; ++m2) {
            const double2 gg = g[(4 * q + u) * (N / 2) + m2];
            e[2 * m2] = fma(gg.x, v, e[2 * m2]);
            e[2 * m2 + 1] = fma(gg.y, v, e[2 * m2 + 1]);
          }
        }
      }
    }
  }
  if (tid == 0 && levels > 0) {  // chunk 0 starts from zi: add M zi (M = pw[0])
    double z[N];
#pragma unroll
    for (int m = 0; m < N; ++m) z[m] = zi[(size_t)b * N + m];
    add_product<N>(e, pw, z);
  }

  // phase 2: the carries, a Kogge-Stone scan in float64 over the chunks
  double* cur = reinterpret_cast<double*>(smem);
  double* nxt = cur + threads * N;
  cp_async_wait<0>();
  __syncthreads();  // phase 1's reads of the staging buffers are done
#pragma unroll
  for (int m2 = 0; m2 < N / 2; ++m2)
    reinterpret_cast<double2*>(cur + tid * N)[m2] = make_double2(e[2 * m2], e[2 * m2 + 1]);
  __syncthreads();
  for (int j = 0; j < levels; ++j) {
    const int d = 1 << j;
    if (tid >= d) {
      const double2* o = reinterpret_cast<const double2*>(cur + (tid - d) * N);
      double ov[N];
#pragma unroll
      for (int m2 = 0; m2 < N / 2; ++m2) {
        const double2 t = o[m2];
        ov[2 * m2] = t.x;
        ov[2 * m2 + 1] = t.y;
      }
      add_product<N>(e, pw + j * N * N, ov);
    }
#pragma unroll
    for (int m2 = 0; m2 < N / 2; ++m2)
      reinterpret_cast<double2*>(nxt + tid * N)[m2] = make_double2(e[2 * m2], e[2 * m2 + 1]);
    __syncthreads();
    double* t = cur;
    cur = nxt;
    nxt = t;
  }

  // phase 3: the cascade over each chunk from where its predecessor ended:
  // chunk 0 from zi in float32, the others in float64
  float c32[S][5], z32a[S], z32b[S];
  double c64[S][5], z0[S], z1[S];
#pragma unroll
  for (int s = 0; s < S; ++s) {
    c32[s][0] = sos[s * 6 + 0];
    c32[s][1] = sos[s * 6 + 1];
    c32[s][2] = sos[s * 6 + 2];
    c32[s][3] = sos[s * 6 + 4];
    c32[s][4] = sos[s * 6 + 5];
    c64[s][0] = c32[s][0];
    c64[s][1] = c32[s][1];
    c64[s][2] = c32[s][2];
    c64[s][3] = -(double)c32[s][3];
    c64[s][4] = -(double)c32[s][4];
    z32a[s] = zi[((size_t)b * S + s) * 2 + 0];
    z32b[s] = zi[((size_t)b * S + s) * 2 + 1];
    z0[s] = tid > 0 ? cur[(tid - 1) * N + 2 * s] : 0.0;
    z1[s] = tid > 0 ? cur[(tid - 1) * N + 2 * s + 1] : 0.0;
  }
  __syncthreads();  // the carries are read: the staging buffers take their place again

  for (int r = 0; r < NBUF - 1; ++r) {
    if (r < rounds) stage(tile_buf(smem, r, threads, N), nullptr, xr, nullptr, N, L, chunk, r);
    else cp_async_commit();
  }
  for (int r = 0; r < rounds; ++r) {
    cp_async_wait<NBUF - 2>();
    __syncthreads();  // round r is in; round r - 1's buffer is written back and free
    const int ahead = r + NBUF - 1;
    if (ahead < rounds) stage(tile_buf(smem, ahead, threads, N), nullptr, xr, nullptr, N, L, chunk, ahead);
    else cp_async_commit();
    float* row = tile_buf(smem, r, threads, N) + tid * PITCH;
    const int n = mine - r * ROUND;
    if (tid == 0) {
      for (int i = 0; i < ROUND && i < n; ++i) row[i] = cascade32<S>(row[i], c32, z32a, z32b);
    } else {
#pragma unroll
      for (int q = 0; q < ROUND / 4; ++q) {
        float4 v = reinterpret_cast<float4*>(row)[q];
        if (4 * q + 0 < n) v.x = __double2float_rn(cascade64<S>(v.x, c64, z0, z1));
        if (4 * q + 1 < n) v.y = __double2float_rn(cascade64<S>(v.y, c64, z0, z1));
        if (4 * q + 2 < n) v.z = __double2float_rn(cascade64<S>(v.z, c64, z0, z1));
        if (4 * q + 3 < n) v.w = __double2float_rn(cascade64<S>(v.w, c64, z0, z1));
        reinterpret_cast<float4*>(row)[q] = v;
      }
    }
    __syncthreads();
    unstage(tile_buf(smem, r, threads, N), yr, L, chunk, r);
  }
}

template <int S>
int launch(const float* x, float* y, const float* sos, const float* zi, const double* powers, const double* resp,
           int B, long long L, long long ld, int chunk, int threads, int levels, int smem, cudaStream_t stream) {
  const long long chunks = chunk > 0 ? (L + chunk - 1) / chunk : 0;
  const size_t need = powers_offset(threads, 2 * S) + (size_t)levels * 4 * S * S * 8;
  if (chunk < 1 || chunk % 4 || ld < L || ld % 4 || ((size_t)x | (size_t)y) % 16 || threads < 32 ||
      threads > MAX_THREADS || threads % 32 || chunks > threads || levels < 0 || levels > MAX_LEVELS ||
      (1LL << levels) < chunks || smem < 0 || (size_t)smem < need)
    return ERR_PLAN;
  int per_sm = 0, sms = 0;  // raises the kernel's dynamic shared limit to smem
  const int err = occupancy((const void*)sosfilt_scan_kernel<S>, threads, smem, per_sm, sms);
  if (err != 0) return err;
  if (per_sm < 1) return ERR_PLAN;
  sosfilt_scan_kernel<S><<<B, threads, smem, stream>>>(x, y, sos, zi, powers, resp, L, ld, chunk, levels);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// One pass over every row on `stream`, not synchronising: one block a row
// with the plan of ops.sosfilt.scan_plan (chunk, threads, levels, smem); rows
// ld floats apart. Returns 0, ERR_PLAN (-1) for a plan that does not cover
// the row or fit its shared memory, or for rows that are not 16-byte
// aligned, or the CUDA error of the launch (cudaErrorInvalidValue for B or L
// below 1 or S outside 1..4).
int autovc_sosfilt(const float* x, float* y, const float* sos, const float* zi, const double* powers,
                   const double* resp, int B, long long L, long long ld, int S, int chunk, int threads, int levels,
                   int smem, cudaStream_t stream) {
  if (B <= 0 || L <= 0) return (int)cudaErrorInvalidValue;
  switch (S) {
    case 1: return launch<1>(x, y, sos, zi, powers, resp, B, L, ld, chunk, threads, levels, smem, stream);
    case 2: return launch<2>(x, y, sos, zi, powers, resp, B, L, ld, chunk, threads, levels, smem, stream);
    case 3: return launch<3>(x, y, sos, zi, powers, resp, B, L, ld, chunk, threads, levels, smem, stream);
    case 4: return launch<4>(x, y, sos, zi, powers, resp, B, L, ld, chunk, threads, levels, smem, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

const char* autovc_cuda_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

}  // extern "C"
