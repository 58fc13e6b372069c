// The 16384-point four-step DFT + magnitude of one frame, shared by the
// spectrum kernels (spectrum_bypass.cu, spectrum_iir.cu,
// spectrum_complex.cu). One 512-thread block owns one frame. Per frame
// x[n], n = n1 + 128*n2, viewed as X[n2][n1]:
//
//   1. column DFTs  Y[k2][n1] = sum_n2 W128[k2*n2] * X[n2][n1]
//   2. twiddle      T[k2][n1] = Y[k2][n1] * tw[k2][n1]
//   3. row DFTs     Z[k2][k1] = sum_n1 T[k2][n1] * W128[k1*n1]
//   4. store        out[128*k1 + k2] = |Z[k2][k1]|            (natural order)
//
// W128[k*n] depends only on (k*n) mod 128, so both DFT matrices are read
// from four 128-entry tables in shared memory (row 1 of the plan's DFT
// planes). The twiddle planes are read once per element through the
// read-only cache. Each thread holds a 4 x 8 (step 1) or 4 x 8 complex
// (step 3) register tile, so one pair of shared-memory loads feeds 8 to 16
// FMAs. Arithmetic is IEEE fp32 in a fixed order that depends only on the
// frame, so a frame's bits do not depend on how many frames a launch holds.

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
// float4 stores of step 2 and the float4 loads of step 3 free of bank
// conflicts, and rows 16-byte aligned.
constexpr int kTStride = 132;
// Floats of the twiddled planes tr, ti ([n1][kTStride] each).
constexpr int kTwiddledFloats = 2 * kN1 * kTStride;
// Floats of the DFT tables: W_N2 row 1 re, im, W_N1 row 1 re, im.
constexpr int kTableFloats = 4 * 128;

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
// 8 samples per step, times the window when win is not null.
template <typename TIn>
__device__ __forceinline__ void load_frame(const TIn* __restrict__ x,
                                           const float* __restrict__ win,
                                           float* xs) {
#pragma unroll
  for (int r = 0; r < kN / 8 / kThreads; ++r) {
    const int i = threadIdx.x + r * kThreads;
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

// Steps 1 and 2: column DFTs of the frame in xr (real input) or xr + i*xi
// (kComplex), twiddled and stored transposed as tr/ti [n1][k2]. Thread tile
// k2 = 4*ty + i, n1 = 16*c + tx. The column results stay in registers until
// every thread has read its inputs, so with kComplex tr/ti may overlay the
// input planes (the routine synchronises the block before storing).
template <bool kComplex>
__device__ __forceinline__ void column_dft_twiddle(
    const float* xr, const float* xi, const float* tabs,
    const float* __restrict__ twr, const float* __restrict__ twi, float* tr,
    float* ti) {
  const float* c2 = tabs;  // W_N2 row 1, re then im
  const float* s2 = tabs + 128;
  const int tx = threadIdx.x & 15;  // 16 column groups
  const int ty = threadIdx.x >> 4;  // 32 row groups
  float yr[4][8], yi[4][8];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < 8; ++c) yr[i][c] = yi[i][c] = 0.f;
  int idx[4] = {0, 0, 0, 0};  // (k2 * n2) mod 128
  for (int n2 = 0; n2 < kN2; ++n2) {
    float xv[8], xv_i[8];
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      xv[c] = xr[n2 * kN1 + 16 * c + tx];
      if constexpr (kComplex) xv_i[c] = xi[n2 * kN1 + 16 * c + tx];
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float wr = c2[idx[i]];
      const float wi = s2[idx[i]];
#pragma unroll
      for (int c = 0; c < 8; ++c) {
        if constexpr (kComplex) {
          yr[i][c] = fmaf(wr, xv[c], yr[i][c]);
          yr[i][c] = fmaf(-wi, xv_i[c], yr[i][c]);
          yi[i][c] = fmaf(wi, xv[c], yi[i][c]);
          yi[i][c] = fmaf(wr, xv_i[c], yi[i][c]);
        } else {
          yr[i][c] = fmaf(wr, xv[c], yr[i][c]);
          yi[i][c] = fmaf(wi, xv[c], yi[i][c]);
        }
      }
      idx[i] = (idx[i] + 4 * ty + i) & 127;
    }
  }
  if constexpr (kComplex) __syncthreads();  // tr/ti overlay xr/xi
#pragma unroll
  for (int c = 0; c < 8; ++c) {
    const int n1 = 16 * c + tx;
    float vr[4], vi[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int k2 = 4 * ty + i;
      const float a = __ldg(twr + k2 * kN1 + n1);
      const float b = __ldg(twi + k2 * kN1 + n1);
      vr[i] = yr[i][c] * a - yi[i][c] * b;
      vi[i] = yr[i][c] * b + yi[i][c] * a;
    }
    store4(tr, n1 * kTStride + 4 * ty, vr);
    store4(ti, n1 * kTStride + 4 * ty, vi);
  }
}

// Steps 3 and 4: row DFTs of the twiddled planes and the magnitude, stored
// in natural order out[128*k1 + k2]. Thread tile k1 = 4*ty + i,
// k2 = 4*tx + q and 64 + 4*tx + q.
template <typename TOut>
__device__ __forceinline__ void row_dft_magnitude(const float* tr,
                                                  const float* ti,
                                                  const float* tabs,
                                                  TOut* __restrict__ out) {
  const float* c1 = tabs + 256;  // W_N1 row 1, re then im
  const float* s1 = tabs + 384;
  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;
  float zr[4][8], zi[4][8];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) zr[i][j] = zi[i][j] = 0.f;
  int idx[4] = {0, 0, 0, 0};  // (k1 * n1) mod 128
  for (int n1 = 0; n1 < kN1; ++n1) {
    const float4 ar0 = *reinterpret_cast<const float4*>(tr + n1 * kTStride + 4 * tx);
    const float4 ar1 = *reinterpret_cast<const float4*>(tr + n1 * kTStride + 64 + 4 * tx);
    const float4 ai0 = *reinterpret_cast<const float4*>(ti + n1 * kTStride + 4 * tx);
    const float4 ai1 = *reinterpret_cast<const float4*>(ti + n1 * kTStride + 64 + 4 * tx);
    const float pr[8] = {ar0.x, ar0.y, ar0.z, ar0.w, ar1.x, ar1.y, ar1.z, ar1.w};
    const float pi[8] = {ai0.x, ai0.y, ai0.z, ai0.w, ai1.x, ai1.y, ai1.z, ai1.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float wr = c1[idx[i]];
      const float wi = s1[idx[i]];
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        zr[i][j] = fmaf(pr[j], wr, zr[i][j]);
        zr[i][j] = fmaf(-pi[j], wi, zr[i][j]);
        zi[i][j] = fmaf(pr[j], wi, zi[i][j]);
        zi[i][j] = fmaf(pi[j], wr, zi[i][j]);
      }
      idx[i] = (idx[i] + 4 * ty + i) & 127;
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int k1 = 4 * ty + i;
    float m[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) m[j] = sqrtf(zr[i][j] * zr[i][j] + zi[i][j] * zi[i][j]);
    store4(out, k1 * kN2 + 4 * tx, m);
    store4(out, k1 * kN2 + 64 + 4 * tx, m + 4);
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
