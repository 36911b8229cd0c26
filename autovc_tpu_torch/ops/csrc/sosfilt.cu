// One pass of a cascade of second-order sections over the time axis.
//
// A port-only kernel: it replaces the lax.scan of
// autovc_tpu/dsp/filters.py::_sosfilt (:135-161), run twice by
// _sos_filtfilt_jit (:164-173); there is no Pallas counterpart.
//
// Computes, for each row b, each sample t in order and each section s in
// order (direct form II transposed, a0 = 1):
//   y_new = fma(b0, y, z0)
//   z0    = fma(b1, y, -(a1 * y_new)) + z1
//   z1    = fma(b2, y, -(a2 * y_new))
//   y     = y_new
// with y = x[b, t] entering section 0 and y[b, t] the last section's output.
// Every operation is an explicit round-to-nearest intrinsic, so nvcc
// contracts nothing further: this is the rounding of _sosfilt's step as XLA
// compiles it for the CPU, and the plain version (ops/sosfilt.py) emulates
// it exactly. The order matters: the 30 Hz highpass has its poles near
// z = 1 and amplifies each step's rounding at low frequencies.
//   x, y (B, L) row-major float32; sos (S, 6) = [b0 b1 b2 a0 a1 a2];
//   zi (B, S, 2) the initial state.
//
// Design. The recurrence is serial in t, so each row is one thread and its
// sections' coefficients and state live in registers. A thread reads its
// row in chunks of CH samples: the next chunk's loads are issued before the
// current chunk is computed, so the memory latency overlaps the arithmetic.
// Rows are independent; blocks of 32 threads take 32 rows each. A warp's
// loads and stores then touch 32 rows' lines at once (not coalesced); the
// main path filters one row (one utterance) at a time.
//
// Bound. Bytes: x read once and y written once, 8 bytes a sample: at B=32,
// L=131072 two passes move 67 MB, 20 us at 3.35 TB/s. The operations are
// fewer (27 flops a sample). What sets the pace is the serial chain: per
// sample and section the loop-carried dependence z0 -> y_new -> a1*y_new ->
// fma -> add -> z0 is four dependent float32 operations (about 16 cycles),
// so a row of L samples takes at least L * 16 cycles, 1.1 ms a pass at
// L=131072 and 1.98 GHz, whatever B is up to the card's thread count. The
// kernel takes more than twice that a sample (PERF.md): the per-sample
// loads, stores and issue, not the chain, are the next thing to cut; a
// chunked parallel scan over time would shorten the chain itself, at the
// price of another rounding than the JAX package's (later work).

#include <cuda_runtime.h>

namespace {

constexpr int CH = 32;    // samples a thread loads ahead: one 128-byte line
constexpr int ROWS = 32;  // rows (threads) per block

// The cascade on one sample: every section in order, y its input and output.
template <int S>
__device__ __forceinline__ float cascade(float y, const float (&c)[S][5], float (&z0)[S], float (&z1)[S]) {
#pragma unroll
  for (int s = 0; s < S; ++s) {
    const float yn = __fmaf_rn(c[s][0], y, z0[s]);
    z0[s] = __fadd_rn(__fmaf_rn(c[s][1], y, -__fmul_rn(c[s][3], yn)), z1[s]);
    z1[s] = __fmaf_rn(c[s][2], y, -__fmul_rn(c[s][4], yn));
    y = yn;
  }
  return y;
}

template <int S>
__global__ void __launch_bounds__(ROWS)
sosfilt_kernel(const float* __restrict__ x, float* __restrict__ y, const float* __restrict__ sos,
               const float* __restrict__ zi, int B, long long L) {
  const int b = blockIdx.x * ROWS + threadIdx.x;
  if (b >= B) return;
  float c[S][5], z0[S], z1[S];
#pragma unroll
  for (int s = 0; s < S; ++s) {
    c[s][0] = sos[s * 6 + 0];
    c[s][1] = sos[s * 6 + 1];
    c[s][2] = sos[s * 6 + 2];
    c[s][3] = sos[s * 6 + 4];
    c[s][4] = sos[s * 6 + 5];
    z0[s] = zi[((size_t)b * S + s) * 2 + 0];
    z1[s] = zi[((size_t)b * S + s) * 2 + 1];
  }
  const float* xr = x + (size_t)b * L;
  float* yr = y + (size_t)b * L;

  float cur[CH], nxt[CH];
#pragma unroll
  for (int i = 0; i < CH; ++i) cur[i] = i < L ? __ldg(xr + i) : 0.0f;
  for (long long t0 = 0; t0 < L; t0 += CH) {
    const long long t1 = t0 + CH;
#pragma unroll
    for (int i = 0; i < CH; ++i) nxt[i] = t1 + i < L ? __ldg(xr + t1 + i) : 0.0f;
    if (t1 <= L) {
#pragma unroll
      for (int i = 0; i < CH; ++i) cur[i] = cascade<S>(cur[i], c, z0, z1);
#pragma unroll
      for (int i = 0; i < CH; ++i) yr[t0 + i] = cur[i];
    } else {  // the last, partial chunk; unrolled so that cur stays in registers
#pragma unroll
      for (int i = 0; i < CH; ++i) {
        if (t0 + i < L) yr[t0 + i] = cascade<S>(cur[i], c, z0, z1);
      }
    }
#pragma unroll
    for (int i = 0; i < CH; ++i) cur[i] = nxt[i];
  }
}

template <int S>
cudaError_t launch(const float* x, float* y, const float* sos, const float* zi, int B, long long L,
                   cudaStream_t stream) {
  sosfilt_kernel<S><<<(B + ROWS - 1) / ROWS, ROWS, 0, stream>>>(x, y, sos, zi, B, L);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// One pass over every row on `stream`, not synchronising. Returns 0, or the
// CUDA error of the launch (cudaErrorInvalidValue for a shape it does not
// take: B or L below 1, S outside 1..4).
int autovc_sosfilt(const float* x, float* y, const float* sos, const float* zi, int B, long long L,
                   int S, cudaStream_t stream) {
  if (B <= 0 || L <= 0) return (int)cudaErrorInvalidValue;
  switch (S) {
    case 1: return (int)launch<1>(x, y, sos, zi, B, L, stream);
    case 2: return (int)launch<2>(x, y, sos, zi, B, L, stream);
    case 3: return (int)launch<3>(x, y, sos, zi, B, L, stream);
    case 4: return (int)launch<4>(x, y, sos, zi, B, L, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

const char* autovc_cuda_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

}  // extern "C"
