// The 16384-point four-step DFT + magnitude of one frame as dense 128-point
// DFTs on CUDA cores (the half spectrum of spectrum_half.cu), and the frame
// helpers the other spectrum kernels share (load_frame, store4, magnitude,
// launch_frames; through iir_blocks.cuh and fft128.cuh). One 512-thread
// block owns one frame. Per frame x[n], n = n1 + 128*n2, viewed as
// X[n2][n1]:
//
//   1. column DFTs  Y[k2][n1] = sum_n2 W2[k2][n2] * X[n2][n1]
//   2. twiddle      T[k2][n1] = Y[k2][n1] * tw[k2][n1]
//   3. row DFTs     Z[k2][k1] = sum_n1 T[k2][n1] * W1[k1][n1]
//   4. store        out[128*k1 + k2] = |Z[k2][k1]|            (natural order)
//
// TableDft reads W[k][n] = W128[k*n mod 128] from a 128-entry table in
// shared memory (row 1 of the plan's DFT plane). The twiddle planes are read
// once per element through the read-only cache. Each thread holds a register
// tile, so one pair of coefficient loads feeds 8 to 16 FMAs. Arithmetic is
// IEEE fp32 in a fixed order per output element, so a frame's bits do not
// depend on how many frames a launch holds.
//
// The half spectrum (real input): |X[N - k]| = |X[k]|, so only k2 in
// [0, 64] is computed (steps 1-3 on 65 of the 128 rows of Y) and
// out[k1][k2] for k2 in [65, 127] is the stored |Z[128 - k2][127 - k1]|:
// the same float, copied, never recomputed.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "error_string.cuh"

namespace tpu_sdr {

constexpr int kN1 = 128;
constexpr int kN2 = 128;
constexpr int kN = kN1 * kN2;
constexpr int kThreads = 512;
// Row stride of the transposed twiddled planes: 132 floats keeps the
// float4 loads of step 3 free of bank conflicts, and rows 16-byte aligned.
constexpr int kTStride = 132;
// Floats of the twiddled planes tr, ti ([n1][kTStride] each).
constexpr int kTwiddledFloats = 2 * kN1 * kTStride;
// Floats of the DFT tables: W_N2 row 1 re, im, W_N1 row 1 re, im.
constexpr int kTableFloats = 4 * 128;

// W[k][n] of a 128-point DFT as W128[(k*n) mod 128] from two 128-entry
// tables (re, im) in shared memory.
struct TableDft {
  const float* re;
  const float* im;
  __device__ __forceinline__ float2 operator()(int k, int n) const {
    const int i = (k * n) & (kN1 - 1);
    return make_float2(re[i], im[i]);
  }
};

// The column (W_N2) and row (W_N1) DFT tables of load_tables.
__device__ __forceinline__ TableDft w_n2(const float* tabs) { return {tabs, tabs + 128}; }
__device__ __forceinline__ TableDft w_n1(const float* tabs) { return {tabs + 256, tabs + 384}; }

__device__ __forceinline__ void load8(const float* x, int i, float v[8]) {
  const float4 a = reinterpret_cast<const float4*>(x)[2 * i];
  const float4 b = reinterpret_cast<const float4*>(x)[2 * i + 1];
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}

__device__ __forceinline__ void load8(const __nv_bfloat16* x, int i,
                                      float v[8]) {
  const uint4 raw = reinterpret_cast<const uint4*>(x)[i];
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const float2 f = __bfloat1622float2(h[q]);
    v[2 * q] = f.x;
    v[2 * q + 1] = f.y;
  }
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

// The 4 x 128 DFT table into shared memory, one entry per thread.
__device__ __forceinline__ void load_tables(const float* __restrict__ tab,
                                            float* tabs) {
  tabs[threadIdx.x] = tab[threadIdx.x];
}

// One frame (16384 samples, 16-byte aligned) into shared memory as fp32,
// 8 samples per step of each of kT threads, times the window when win is
// not null.
template <typename TIn, int kT = kThreads>
__device__ __forceinline__ void load_frame(const TIn* __restrict__ x,
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

// Steps 1 and 2 of the half spectrum: column DFTs of rows k2 in [0, 63] of
// the real frame in xr, twiddled and stored transposed as tr/ti [n1][k2].
// Thread tile k2 = 2*ty + i (i < 2), n1 = 16*c + tx.
template <typename Dft>
__device__ __forceinline__ void column_dft_twiddle_half(
    const float* xr, Dft w2, const float* __restrict__ twr,
    const float* __restrict__ twi, float* tr, float* ti) {
  constexpr int kR = 2;
  const int tx = threadIdx.x & 15;  // 16 column groups
  const int ty = threadIdx.x >> 4;  // 32 row groups
  float yr[kR][8], yi[kR][8];
#pragma unroll
  for (int i = 0; i < kR; ++i)
#pragma unroll
    for (int c = 0; c < 8; ++c) yr[i][c] = yi[i][c] = 0.f;
  for (int n2 = 0; n2 < kN2; ++n2) {
    float xv[8];
#pragma unroll
    for (int c = 0; c < 8; ++c) xv[c] = xr[n2 * kN1 + 16 * c + tx];
#pragma unroll
    for (int i = 0; i < kR; ++i) {
      const float2 w = w2(kR * ty + i, n2);
#pragma unroll
      for (int c = 0; c < 8; ++c) {
        yr[i][c] = fmaf(w.x, xv[c], yr[i][c]);
        yi[i][c] = fmaf(w.y, xv[c], yi[i][c]);
      }
    }
  }
#pragma unroll
  for (int c = 0; c < 8; ++c) {
    const int n1 = 16 * c + tx;
#pragma unroll
    for (int i = 0; i < kR; ++i) {
      const int k2 = kR * ty + i;
      const float a = __ldg(twr + k2 * kN1 + n1);
      const float b = __ldg(twi + k2 * kN1 + n1);
      tr[n1 * kTStride + k2] = yr[i][c] * a - yi[i][c] * b;
      ti[n1 * kTStride + k2] = yr[i][c] * b + yi[i][c] * a;
    }
  }
}

// Steps 1 and 2 for the single row k2 of a real input, one column n1 per
// thread of the first 128 (the half spectrum's row 64); the same
// arithmetic per element as column_dft_twiddle_half.
template <typename Dft>
__device__ __forceinline__ void column_dft_twiddle_row(
    const float* xr, Dft w2, const float* __restrict__ twr,
    const float* __restrict__ twi, float* tr, float* ti, int k2) {
  const int n1 = threadIdx.x;
  if (n1 >= kN1) return;
  float yr = 0.f, yi = 0.f;
  for (int n2 = 0; n2 < kN2; ++n2) {
    const float xv = xr[n2 * kN1 + n1];
    const float2 w = w2(k2, n2);
    yr = fmaf(w.x, xv, yr);
    yi = fmaf(w.y, xv, yi);
  }
  const float a = __ldg(twr + k2 * kN1 + n1);
  const float b = __ldg(twi + k2 * kN1 + n1);
  tr[n1 * kTStride + k2] = yr * a - yi * b;
  ti[n1 * kTStride + k2] = yr * b + yi * a;
}

// Step 3: row DFTs of the twiddled planes' rows k2 in [0, 63] into the
// thread's accumulators, k1 = 4*ty + i and k2 = 4*tx + q.
template <typename Dft>
__device__ __forceinline__ void row_dft(const float* tr, const float* ti,
                                        Dft w1, float (&zr)[4][4],
                                        float (&zi)[4][4]) {
  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) zr[i][j] = zi[i][j] = 0.f;
  for (int n1 = 0; n1 < kN1; ++n1) {
    float pr[4], pi[4];
    const float4 ar0 = *reinterpret_cast<const float4*>(tr + n1 * kTStride + 4 * tx);
    const float4 ai0 = *reinterpret_cast<const float4*>(ti + n1 * kTStride + 4 * tx);
    pr[0] = ar0.x; pr[1] = ar0.y; pr[2] = ar0.z; pr[3] = ar0.w;
    pi[0] = ai0.x; pi[1] = ai0.y; pi[2] = ai0.z; pi[3] = ai0.w;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 w = w1(4 * ty + i, n1);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        zr[i][j] = fmaf(pr[j], w.x, zr[i][j]);
        zr[i][j] = fmaf(-pi[j], w.y, zr[i][j]);
        zi[i][j] = fmaf(pr[j], w.y, zi[i][j]);
        zi[i][j] = fmaf(pi[j], w.x, zi[i][j]);
      }
    }
  }
}

__device__ __forceinline__ float magnitude(float re, float im) {
  return sqrtf(re * re + im * im);
}

// Steps 3 and 4 of the half spectrum: the row DFTs of rows k2 in [0, 64]
// and their magnitudes into mag [k1][k2] (a 128 x 128 frame in shared
// memory), each |Z[k2][k1]| with k2 in [1, 63] also at its mirror
// [127 - k1][128 - k2]. Rows 0..63 as tiles of row_dft, row 64 one k1 per
// thread of the first 128.
template <typename Dft>
__device__ __forceinline__ void row_dft_half_magnitude(const float* tr,
                                                       const float* ti,
                                                       Dft w1, float* mag) {
  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;
  float zr[4][4], zi[4][4];
  row_dft(tr, ti, w1, zr, zi);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int k1 = 4 * ty + i;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int k2 = 4 * tx + q;
      const float m = magnitude(zr[i][q], zi[i][q]);
      mag[k1 * kN2 + k2] = m;
      if (k2 != 0) mag[(kN1 - 1 - k1) * kN2 + kN2 - k2] = m;
    }
  }
  const int k1 = threadIdx.x;
  if (k1 >= kN1) return;
  constexpr int k2 = kN2 / 2;
  float zr1 = 0.f, zi1 = 0.f;
  for (int n1 = 0; n1 < kN1; ++n1) {
    const float pr = tr[n1 * kTStride + k2];
    const float pi = ti[n1 * kTStride + k2];
    const float2 w = w1(k1, n1);
    zr1 = fmaf(pr, w.x, zr1);
    zr1 = fmaf(-pi, w.y, zr1);
    zi1 = fmaf(pr, w.y, zi1);
    zi1 = fmaf(pi, w.x, zi1);
  }
  mag[k1 * kN2 + k2] = magnitude(zr1, zi1);
}

// A frame of fp32 magnitudes in shared memory to out, rounded once to TOut.
template <typename TOut>
__device__ __forceinline__ void store_frame(const float* mag,
                                            TOut* __restrict__ out) {
#pragma unroll
  for (int r = 0; r < kN / 4 / kThreads; ++r) {
    const int i = threadIdx.x + r * kThreads;
    const float4 v = reinterpret_cast<const float4*>(mag)[i];
    const float m[4] = {v.x, v.y, v.z, v.w};
    store4(out, 4 * i, m);
  }
}

// Opt the kernel into `smem` bytes of dynamic shared memory and launch one
// block per frame. Returns the CUDA error code (0 on success): a refused
// attribute or launch never runs, and synchronising would not report it.
template <typename... Params, typename... Args>
int launch_frames(void (*kernel)(Params...), size_t smem, int frames,
                  cudaStream_t stream, Args... args) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return int(err);
  kernel<<<frames, kThreads, smem, stream>>>(args...);
  return int(cudaGetLastError());
}

}  // namespace tpu_sdr
