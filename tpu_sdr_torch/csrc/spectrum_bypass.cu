// Window + 16384-point four-step DFT + magnitude, one thread block per frame.
//
// Replaces the TPU kernel tpu_sdr/kernels/pallas/iir_fft.py
// spectrum_from_state (bypass=True form; body _spectrum_kernel -> _fft_mag,
// _cdots). Per frame x[n], n = n1 + 128*n2, viewed as X[n2][n1]:
//
//   1. column DFTs  Y[k2][n1] = sum_n2 W128[k2*n2] * X[n2][n1]   (X real)
//   2. twiddle      T[k2][n1] = Y[k2][n1] * tw[k2][n1]
//   3. row DFTs     Z[k2][k1] = sum_n1 T[k2][n1] * W128[k1*n1]
//   4. store        out[128*k1 + k2] = |Z[k2][k1]|            (natural order)
//
// What bounds it on an H100: the function (an FFT of a real frame and its
// magnitude, about 0.64 MFLOP per frame) takes less time in arithmetic
// than in its 64 KB read and 64 KB written (fp32), so its floor is memory
// traffic at 3.35 TB/s. As written here (the DFT as two dense 128x128
// products) a frame costs 2*128^3 real FMAs in step 1 and 4*128^3 in
// step 3, 25.2 MFLOP, about 40 times the FFT's count: at 67 TFLOP/s fp32
// on CUDA cores that is about 4 times the memory floor, so this kernel is
// bound by the rate of fp32 FMAs, well above the function's floor; a radix
// FFT is the way down. The design keeps everything else off the FMA path:
//
// - The frame (64 KB) and the twiddled intermediate (2 x 66 KB, padded
//   rows) stay in shared memory (198 KiB of dynamic shared memory, one block
//   per SM). Device memory sees each input byte once and each output byte
//   once.
// - W128[k*n] depends only on (k*n) mod 128, so both DFT matrices are read
//   from four 128-entry tables in shared memory (row 1 of the plan's DFT
//   planes), not from 128 KB planes. The twiddle planes are read once per
//   element from global memory, where they stay in L2.
// - Each thread holds a 4 x 8 (step 1) or 4 x 8 complex (step 3) register
//   tile, so one pair of shared-memory loads feeds 8 to 16 FMAs.
//
// Arithmetic is IEEE fp32 with fp32 accumulation at every precision tier.
// Each frame's result depends only on that frame: no atomics, a fixed
// summation order, and nothing shared between blocks, so the bits of a
// frame do not depend on how many frames a launch holds.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kN1 = 128;
constexpr int kN2 = 128;
constexpr int kN = kN1 * kN2;
constexpr int kThreads = 512;
// Row stride of the transposed twiddled planes: 132 floats keeps the
// float4 stores of step 1 and the float4 loads of step 3 free of bank
// conflicts, and rows 16-byte aligned.
constexpr int kTStride = 132;
constexpr size_t kSmemBytes =
    (size_t(kN) + 2 * size_t(kN1) * kTStride + 4 * 128) * sizeof(float);

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

template <typename TIn, typename TOut>
__global__ void __launch_bounds__(kThreads, 1)
spectrum_bypass_kernel(const TIn* __restrict__ x,
                       const float* __restrict__ win,
                       const float* __restrict__ tab,
                       const float* __restrict__ twr,
                       const float* __restrict__ twi,
                       TOut* __restrict__ out) {
  extern __shared__ __align__(16) float smem[];
  float* xs = smem;                  // [n2][n1], the windowed frame
  float* tr = xs + kN;               // [n1][kTStride], k2 fastest
  float* ti = tr + kN1 * kTStride;
  float* c2 = ti + kN1 * kTStride;   // W_N2 row 1, re then im
  float* s2 = c2 + 128;
  float* c1 = s2 + 128;              // W_N1 row 1, re then im
  float* s1 = c1 + 128;

  const int tid = threadIdx.x;
  const size_t base = size_t(blockIdx.x) * kN;
  c2[tid] = tab[tid];  // 4 x 128 table entries, one per thread

  // Load the frame, 8 samples per step, windowed in fp32.
#pragma unroll
  for (int r = 0; r < kN / 8 / kThreads; ++r) {
    const int i = tid + r * kThreads;
    float v[8];
    load8(x + base, i, v);
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
  __syncthreads();

  const int tx = tid & 15;  // 16 column groups
  const int ty = tid >> 4;  // 32 row groups

  // Step 1: thread tile k2 = 4*ty + i, n1 = 16*c + tx.
  {
    float yr[4][8], yi[4][8];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int c = 0; c < 8; ++c) yr[i][c] = yi[i][c] = 0.f;
    int idx[4] = {0, 0, 0, 0};  // (k2 * n2) mod 128
    for (int n2 = 0; n2 < kN2; ++n2) {
      float xv[8];
#pragma unroll
      for (int c = 0; c < 8; ++c) xv[c] = xs[n2 * kN1 + 16 * c + tx];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float wr = c2[idx[i]];
        const float wi = s2[idx[i]];
#pragma unroll
        for (int c = 0; c < 8; ++c) {
          yr[i][c] = fmaf(wr, xv[c], yr[i][c]);
          yi[i][c] = fmaf(wi, xv[c], yi[i][c]);
        }
        idx[i] = (idx[i] + 4 * ty + i) & 127;
      }
    }
    // Step 2: twiddle, stored transposed as [n1][k2].
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
  __syncthreads();

  // Step 3: thread tile k1 = 4*ty + i, k2 = 4*tx + q and 64 + 4*tx + q.
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

  // Step 4: magnitude, natural-order store out[128*k1 + k2].
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int k1 = 4 * ty + i;
    float m[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) m[j] = sqrtf(zr[i][j] * zr[i][j] + zi[i][j] * zi[i][j]);
    store4(out + base, k1 * kN2 + 4 * tx, m);
    store4(out + base, k1 * kN2 + 64 + 4 * tx, m + 4);
  }
}

template <typename TIn, typename TOut>
int launch(const void* x, const float* win, const float* tab, const float* twr,
           const float* twi, void* out, int frames, cudaStream_t stream) {
  auto kernel = spectrum_bypass_kernel<TIn, TOut>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(kSmemBytes));
  if (err != cudaSuccess) return int(err);
  kernel<<<frames, kThreads, kSmemBytes, stream>>>(
      static_cast<const TIn*>(x), win, tab, twr, twi, static_cast<TOut*>(out));
  return int(cudaGetLastError());
}

}  // namespace

extern "C" {

// x: (frames, 16384) fp32 or bf16; win: (16384,) fp32 or null (no window);
// tab: (4, 128) fp32 = W_N2 row 1 re, im, W_N1 row 1 re, im;
// twr, twi: (128, 128) fp32 twiddle planes [k2][n1];
// out: (frames, 16384) fp32 or bf16. All contiguous, on the current device.
// Returns the CUDA error code of the launch (0 on success).
int tpu_sdr_spectrum_bypass(const void* x, int in_bf16, const float* win,
                            const float* tab, const float* twr,
                            const float* twi, void* out, int out_bf16,
                            int frames, void* stream) {
  if (frames <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (in_bf16) {
    return out_bf16
               ? launch<__nv_bfloat16, __nv_bfloat16>(x, win, tab, twr, twi, out, frames, s)
               : launch<__nv_bfloat16, float>(x, win, tab, twr, twi, out, frames, s);
  }
  return out_bf16 ? launch<float, __nv_bfloat16>(x, win, tab, twr, twi, out, frames, s)
                  : launch<float, float>(x, win, tab, twr, twi, out, frames, s);
}

const char* tpu_sdr_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
