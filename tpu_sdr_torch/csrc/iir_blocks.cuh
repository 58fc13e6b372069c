// The blocked composite IIR of one frame, shared by iir_summaries.cu and
// spectrum_iir.cu. The 12th-order cascade is one m = 12 state linear system;
// a frame of 16384 samples is B = 128 blocks of L = 128 samples, and with
// AL = A^L the block states follow
//
//   f[j]     = P xw[j]                        (forcing, f = xw @ PT)
//   z_in[0]  = z_start
//   z_in[j]  = AL z_in[j-1] + f[j-1]          (j = 1 .. 127)
//   z_end    = AL z_in[127] + f[127]          (the state after the frame)
//
// The reference (tpu_sdr/kernels/pallas/iir_fft.py _masked_scan) takes this
// prefix as a Hillis-Steele doubling over frames stacked in the TPU's
// lanes. Here one warp walks the 128 blocks of its frame in order: 12 lanes
// hold the 12 state components and read each other's through shuffles, a
// 12 x 12 mat-vec per block, about 18 K FMAs per frame. The order is fixed
// per frame, so the result does not depend on how many frames a launch
// holds.

#pragma once

#include "four_step.cuh"

namespace tpu_sdr {

constexpr int kM = 12;  // composite state size (6 sections)
constexpr int kBlocks = kN / kN1;  // 128 blocks of 128 samples

// f[j][a] = sum_k xs[j][k] * pt[k][a], all in shared memory: thread t
// computes block j = t / 4 and states a = t % 4 + 4q (q < 3). Each thread
// starts its sum at k = j, so the 8 blocks of a warp read 8 different banks
// of xs, and pt's rows (12 floats apart) spread over all 32 banks.
__device__ __forceinline__ void block_forcing(const float* xs, const float* pt,
                                              float* f) {
  const int j = threadIdx.x >> 2;
  const int a = threadIdx.x & 3;
  float acc[3] = {0.f, 0.f, 0.f};
  for (int kk = 0; kk < kN1; ++kk) {
    const int k = (kk + j) & (kN1 - 1);
    const float xv = xs[j * kN1 + k];
#pragma unroll
    for (int q = 0; q < 3; ++q) acc[q] = fmaf(xv, pt[k * kM + a + 4 * q], acc[q]);
  }
#pragma unroll
  for (int q = 0; q < 3; ++q) f[j * kM + a + 4 * q] = acc[q];
}

// The block chain of one frame, run by one whole warp (threadIdx.x < 32).
// Lane a < 12 enters with z_start[a] in z; al1t is AL^T (12 x 12, global),
// f the forcing (128 x 12, shared). Stores z_in (128 x 12, shared) unless it
// is null and returns, in lane a < 12, the state after the frame.
__device__ __forceinline__ float block_chain(const float* __restrict__ al1t,
                                             const float* f, float z,
                                             float* z_in) {
  const int lane = threadIdx.x & 31;
  const bool live = lane < kM;
  float al[kM];  // row `lane` of AL
#pragma unroll
  for (int b = 0; b < kM; ++b) al[b] = live ? __ldg(al1t + b * kM + lane) : 0.f;
  for (int j = 0; j < kBlocks; ++j) {
    if (z_in != nullptr && live) z_in[j * kM + lane] = z;
    float acc = 0.f;
#pragma unroll
    for (int b = 0; b < kM; ++b) acc = fmaf(al[b], __shfl_sync(0xffffffffu, z, b), acc);
    z = acc + (live ? f[j * kM + lane] : 0.f);
  }
  return z;
}

}  // namespace tpu_sdr
