// Window + 16384-point four-step FFT + magnitude with the caller's plan
// planes, one thread block per frame.
//
// Replaces the TPU kernel tpu_sdr/kernels/pallas/spectrum.py fft_mag_fused
// (body _spectrum_kernel): xw = x * win, Y = W2 xw, T = Y * tw,
// Z = T W1^T, out = |Z|^T in natural order. The function takes its window
// and all six plan planes as arguments, so the kernel computes with the
// planes it is given: W2 and W1 are read from the full (128, 128) planes
// (PlaneDft of four_step.cuh), never rebuilt from a 128-entry table (that
// identity holds only for fft.plan_constants' planes, and only to 1 ulp).
//
// What bounds it on an H100: as spectrum_bypass.cu, the function's floor is
// its bytes (64 KB read and 64 KB written a frame); the dense DFT makes the
// kernel bound by the rate of fp32 FMAs. The six planes (64 KiB each) do
// not fit in shared memory beside the frame and the twiddled planes, so
// each step reads its DFT plane through the read-only cache: a warp's
// threads share two rows of the plane per load (a broadcast), and a block
// touches one 128-byte line a row for 32 steps of the sum, which the L1
// left beside the 196 KiB of shared memory holds.
//
// Shared memory (dynamic, 196 KiB, one block per SM): the windowed frame
// (64 KiB) and the twiddled planes (2 x 66 KiB). IEEE fp32; a frame's
// result depends only on that frame.

#include "four_step.cuh"

namespace {

using namespace tpu_sdr;

constexpr size_t kSmemBytes = (size_t(kN) + kTwiddledFloats) * sizeof(float);

__global__ void __launch_bounds__(kThreads, 1)
fft_mag_fused_kernel(const float* __restrict__ x,
                     const float* __restrict__ win,
                     const float* __restrict__ w2r,
                     const float* __restrict__ w2i,
                     const float* __restrict__ twr,
                     const float* __restrict__ twi,
                     const float* __restrict__ w1r,
                     const float* __restrict__ w1i,
                     float* __restrict__ out) {
  extern __shared__ __align__(16) float smem[];
  float* xs = smem;                  // [n2][n1], the windowed frame
  float* tr = xs + kN;               // [n1][kTStride], k2 fastest
  float* ti = tr + kN1 * kTStride;

  const size_t base = size_t(blockIdx.x) * kN;
  load_frame(x + base, win, xs);
  __syncthreads();
  column_dft_twiddle<false>(xs, nullptr, PlaneDft{w2r, w2i}, twr, twi, tr, ti);
  __syncthreads();
  row_dft_magnitude(tr, ti, PlaneDft{w1r, w1i}, out + base);
}

}  // namespace

extern "C" {

// x: (frames, 16384) fp32; win: (16384,) fp32; w2r, w2i: (128, 128) column
// DFT planes [k2][n2]; twr, twi: (128, 128) twiddle planes [k2][n1]; w1r,
// w1i: (128, 128) row DFT planes [k1][n1]; out: (frames, 16384) fp32. All
// contiguous, 16-byte aligned, on the current device. Returns the CUDA
// error code of the launch (0 on success).
int tpu_sdr_fft_mag_fused(const float* x, const float* win, const float* w2r,
                          const float* w2i, const float* twr,
                          const float* twi, const float* w1r,
                          const float* w1i, float* out, int frames,
                          void* stream) {
  if (frames <= 0) return 0;
  return launch_frames(fft_mag_fused_kernel, kSmemBytes, frames,
                       static_cast<cudaStream_t>(stream), x, win, w2r, w2i,
                       twr, twi, w1r, w1i, out);
}

}  // extern "C"
