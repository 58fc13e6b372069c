// The frame constants and load/store helpers the spectrum and IIR kernels
// share (through fft128.cuh and iir_blocks.cuh; iir_summaries.cu for the
// constants). A frame is N = 16384 samples, x[n] with n = n1 + 128*n2,
// viewed as X[n2][n1].

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "error_string.cuh"

namespace tpu_sdr {

constexpr int kN1 = 128;
constexpr int kN2 = 128;
constexpr int kN = kN1 * kN2;

__device__ __forceinline__ void load8(const float* x, int i, float v[8]) {
  const float4 a = reinterpret_cast<const float4*>(x)[2 * i];
  const float4 b = reinterpret_cast<const float4*>(x)[2 * i + 1];
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}

__device__ __forceinline__ void store4(float* out, int idx, const float m[4]) {
  *reinterpret_cast<float4*>(out + idx) = make_float4(m[0], m[1], m[2], m[3]);
}

__device__ __forceinline__ void store4(__nv_bfloat16* out, int idx,
                                      const float m[4]) {
  __nv_bfloat162 h[2];
  h[0] = __floats2bfloat162_rn(m[0], m[1]);
  h[1] = __floats2bfloat162_rn(m[2], m[3]);
  *reinterpret_cast<uint2*>(out + idx) = *reinterpret_cast<const uint2*>(h);
}

// One fp32 frame (16384 samples, 16-byte aligned) into shared memory, 8
// samples per step of each of kT threads, times the window when win is not
// null.
template <int kT>
__device__ __forceinline__ void load_frame(const float* __restrict__ x,
                                           const float* __restrict__ win,
                                           float* xs) {
#pragma unroll
  for (int r = 0; r < kN / 8 / kT; ++r) {
    const int i = threadIdx.x + r * kT;
    float v[8];
    load8(x, i, v);
    if (win != nullptr) {
      float w[8];
      load8(win, i, w);
#pragma unroll
      for (int q = 0; q < 8; ++q) v[q] *= w[q];
    }
    reinterpret_cast<float4*>(xs)[2 * i] = make_float4(v[0], v[1], v[2], v[3]);
    reinterpret_cast<float4*>(xs)[2 * i + 1] =
        make_float4(v[4], v[5], v[6], v[7]);
  }
}

__device__ __forceinline__ float magnitude(float re, float im) {
  return sqrtf(re * re + im * im);
}

}  // namespace tpu_sdr
