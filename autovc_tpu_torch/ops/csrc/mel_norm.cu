// Mel projection fused with the dB normalization.
//
// Replaces the Pallas kernel of autovc_tpu/ops/pallas_mel.py:
//   mel_normalize :34 (pallas_call :53) -> _kernel :25.
// Computes, float32 throughout:
//   m[t, j]   = sum over k of mag[t, k] * basis[k, j]      k = 0 .. K-1 in order
//   out[t, j] = clip((20 * log10(max(1e-5, m)) - ref_db - min_db) / -min_db, 0, 1)
//   mag (T, K) and basis (K, M) row-major, out (T, M) row-major.
// Any K (513 for the 1024-point STFT, 257 for the 512-point one) and any M:
// the ragged edges are masked, nothing is padded in device memory (the TPU
// padded K and M to 128 lanes for its matrix unit).
//
// Design. Each block owns a tile of TT frames x TM mels. It walks K in
// chunks of KC: the mag chunk (TT x KC, read along k so that a warp reads
// one row's consecutive bins) is stored transposed in shared memory with a
// padded row so that neither the store nor the reads conflict, the basis
// chunk (KC x TM) beside it; the next chunk is loaded into registers while
// the current one is computed. Each thread accumulates 4 frames x 4 mels in
// registers, frames 32 apart (a warp reads 32 consecutive frames) and 4
// consecutive mels (one float4 broadcast to the warp). The dB epilogue runs
// on the accumulators: the projection never reaches device memory. The
// epilogue's multiply is an explicit intrinsic so that nvcc does not fuse it
// with the subtraction; log10f is the accurate one (no fast math).
//
// Bound. At T = 16416 frames (32 utterances of 513), K = 513, M = 80: 1.35
// GFLOP, 20 us at the 67 TFLOP/s of f32 outside the tensor cores, against
// 39 MB of mag, basis and out, 12 us at 3.35 TB/s: the operations bound it.
// This version uses no tensor cores (TF32 would change the result); at the
// main path's few hundred frames a file it is latency-bound (one block
// walks all of K); the basis is 98%
// zeros (a filter spans at most 34 of the 513 bins), so a walk over each
// filter's own bins is the larger later gain.

#include <cuda_runtime.h>

namespace {

constexpr int TT = 128;  // frames per block
constexpr int TM = 16;   // mels per block
constexpr int KC = 32;   // bins per shared-memory chunk
constexpr int NT = 128;  // threads: 32 frame lanes x 4 mel groups
constexpr int RF = TT / 32;  // frames per thread
constexpr float MIN_LEVEL = 1e-5f;

static_assert(NT == 32 * (TM / 4), "thread layout");
static_assert((KC * TT) % NT == 0 && (KC * TM) % NT == 0, "tile loads");

__global__ void __launch_bounds__(NT)
mel_norm_kernel(const float* __restrict__ mag, const float* __restrict__ basis, float* __restrict__ out,
                int T, int K, int M, float ref_db, float min_db) {
  __shared__ float ms[KC][TT + 1];              // mag chunk, transposed: [k][frame]
  __shared__ __align__(16) float bs[KC][TM];    // basis chunk: [k][mel]

  const int tid = threadIdx.x;
  const int fl = tid % 32;  // frame lane: frames fl + 32 i
  const int mg = tid / 32;  // mel group: mels 4 mg .. 4 mg + 3
  const int f0 = blockIdx.x * TT;
  const int m0 = blockIdx.y * TM;

  float acc[RF][4];
#pragma unroll
  for (int i = 0; i < RF; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.0f;

  // the next chunk's tiles are loaded into registers while this one is
  // computed from shared memory
  float pm[KC * TT / NT], pb[KC * TM / NT];
  auto load_chunk = [&](int k0) {
#pragma unroll
    for (int r = 0; r < KC * TT / NT; ++r) {
      const int idx = r * NT + tid;
      const int gf = f0 + idx / KC, gk = k0 + idx % KC;
      pm[r] = (gf < T && gk < K) ? __ldg(mag + (size_t)gf * K + gk) : 0.0f;
    }
#pragma unroll
    for (int r = 0; r < KC * TM / NT; ++r) {
      const int idx = r * NT + tid;
      const int gk = k0 + idx / TM, gm = m0 + idx % TM;
      pb[r] = (gk < K && gm < M) ? __ldg(basis + (size_t)gk * M + gm) : 0.0f;
    }
  };
  load_chunk(0);
  for (int k0 = 0; k0 < K; k0 += KC) {
#pragma unroll
    for (int r = 0; r < KC * TT / NT; ++r) {
      const int idx = r * NT + tid;
      ms[idx % KC][idx / KC] = pm[r];
    }
#pragma unroll
    for (int r = 0; r < KC * TM / NT; ++r) {
      const int idx = r * NT + tid;
      bs[idx / TM][idx % TM] = pb[r];
    }
    __syncthreads();
    if (k0 + KC < K) load_chunk(k0 + KC);
#pragma unroll 8
    for (int k = 0; k < KC; ++k) {
      const float4 b = reinterpret_cast<const float4*>(bs[k])[mg];
#pragma unroll
      for (int i = 0; i < RF; ++i) {
        const float a = ms[k][fl + 32 * i];
        acc[i][0] = fmaf(a, b.x, acc[i][0]);
        acc[i][1] = fmaf(a, b.y, acc[i][1]);
        acc[i][2] = fmaf(a, b.z, acc[i][2]);
        acc[i][3] = fmaf(a, b.w, acc[i][3]);
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < RF; ++i) {
    const int gf = f0 + fl + 32 * i;
    if (gf >= T) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int gm = m0 + 4 * mg + j;
      if (gm >= M) continue;
      const float db = __fsub_rn(__fmul_rn(20.0f, log10f(fmaxf(MIN_LEVEL, acc[i][j]))), ref_db);
      const float v = (db - min_db) / -min_db;
      out[(size_t)gf * M + gm] = fminf(fmaxf(v, 0.0f), 1.0f);
    }
  }
}

}  // namespace

extern "C" {

// One launch on `stream`, not synchronising. Returns 0, or the CUDA error
// of the launch (cudaErrorInvalidValue for T, K or M below 1).
int autovc_mel_norm(const float* mag, const float* basis, float* out, int T, int K, int M, float ref_db,
                    float min_db, cudaStream_t stream) {
  if (T <= 0 || K <= 0 || M <= 0) return (int)cudaErrorInvalidValue;
  const dim3 grid((T + TT - 1) / TT, (M + TM - 1) / TM);
  mel_norm_kernel<<<grid, NT, 0, stream>>>(mag, basis, out, T, K, M, ref_db, min_db);
  return (int)cudaGetLastError();
}

const char* autovc_cuda_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

}  // extern "C"
