// The scan rounding's helpers, shared by the kernels that run JAX's bfloat16
// lax.scan forms (the LSTM's, ops/lstm.py:lstm_scan_bf16_train_ref, and
// WaveNet's, ops/wavenet.py:generate_ref(scan=True)): each op rounded as XLA
// rounds it. Products of two bfloat16 values are exact in float32, so a
// contracted multiply-add could not change them; the conversions keep every
// sum from fusing with a product.
#pragma once

#include <cuda_bf16.h>

namespace {

// A float32 value rounded to bfloat16 and widened back, by one packing
// conversion (bfloat16 x in the high half and 0 in the low: the float32 word
// is rb(x)). The scalar conversion, __float2bfloat16_rn, takes the slower
// conversion unit and a shift back.
__device__ __forceinline__ float rb(float x) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(0.0f, x);
  return __uint_as_float(*reinterpret_cast<const unsigned*>(&v));
}

// XLA's logistic on bfloat16: 1 / (1 + exp(-x)), each op rounded (IEEE
// division, no fast math).
__device__ __forceinline__ float sigmoid_scan(float x) { return rb(1.0f / rb(1.0f + rb(expf(-x)))); }

// logistic's VJP residual s * (1 - s), each op rounded
__device__ __forceinline__ float dsigmoid_scan(float s) { return rb(s * rb(1.0f - s)); }

}  // namespace
