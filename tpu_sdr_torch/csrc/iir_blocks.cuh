// The blocked composite IIR of one frame, run by spectrum_iir.cu
// (iir_frame_radix) before its FFT. The 12th-order cascade is one m = 12
// state linear system; a frame of 16384 samples is B = 128 blocks of L = 128
// samples, and with AL = A^L the block states follow
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
// holds. (iir_summaries.cu, which needs only z_end from rest, takes it as
// one product with the plan's summary_matrix instead.)

#pragma once

#include "frame.cuh"

namespace tpu_sdr {

constexpr int kM = 12;  // composite state size (6 sections)
constexpr int kBlocks = kN / kN1;  // 128 blocks of 128 samples

// f[j][a] = sum_k xs[j][k] * pt[k][a], all in shared memory: thread t of
// kT computes blocks j = t / 4 + (kT / 4) p and states a = t % 4 + 4q
// (q < 3). Each thread starts its sum at k = j, so the 8 blocks of a warp
// read 8 different banks of xs, and pt's rows (12 floats apart) spread over
// all 32 banks.
template <int kT>
__device__ __forceinline__ void block_forcing(const float* xs, const float* pt,
                                              float* f) {
  const int a = threadIdx.x & 3;
  for (int j = threadIdx.x >> 2; j < kBlocks; j += kT / 4) {
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
}

// The block chain of one frame, run by one whole warp (threadIdx.x < 32).
// Lane a < 12 enters with z_start[a] in z; al1t is AL^T (12 x 12, global),
// f the forcing (128 x 12, shared). Stores z_in (128 x 12, shared), the
// state entering each block.
__device__ __forceinline__ void block_chain(const float* __restrict__ al1t,
                                            const float* f, float z, float* z_in) {
  const int lane = threadIdx.x & 31;
  const bool live = lane < kM;
  float al[kM];  // row `lane` of AL
#pragma unroll
  for (int b = 0; b < kM; ++b) al[b] = live ? __ldg(al1t + b * kM + lane) : 0.f;
  for (int j = 0; j < kBlocks; ++j) {
    if (live) z_in[j * kM + lane] = z;
    float acc = 0.f;
#pragma unroll
    for (int b = 0; b < kM; ++b) acc = fmaf(al[b], __shfl_sync(0xffffffffu, z, b), acc);
    z = acc + (live ? f[j * kM + lane] : 0.f);
  }
}

// The composite IIR of one frame from its entry state, written over the
// frame in shared memory, by a 256-thread block. Per frame:
//
//   xw       = x * win                         (optional)
//   y_zs[j]  = T xw[j]                         (128 x 128 Toeplitz, per block)
//   f[j]     = P xw[j]; z_in from block_chain
//   y[j]     = y_zs[j] + z_in[j] @ MT
//
// x: the frame (16384 fp32, 16-byte aligned); zs: its entry state (12
// floats); h: the impulse response (column 0 of the Toeplitz T); pt = P^T
// (128 x 12), mt = M^T (12 x 128), al1t = AL^T. xs receives y. scratch
// (kIirScratchFloats, shared) holds h padded with 128 zeros in front
// (T[i][k] = h[i - k] for i >= k), PT, MT, the forcing and z_in. The block
// chain runs in warp 0 while the other 7 warps start their share of the
// zero-state product, laid out for warps: warp w takes rows j = 16w + r (r <
// 16) across all 128 columns i = 32c + lane (c < 4), so each xs load is a
// broadcast and each h load 32 consecutive floats. The product skips the
// zeros above T's diagonal by column blocks of 32: for k in [32kb, 32kb +
// 32) only the column blocks c >= kb are summed (within c = kb the padded
// zeros of h remain, adding exact zeros), about 5/8 of the 2.1 M FMAs a
// frame. Each y_zs[j][i] sums k in increasing order from 0. Ends with the
// block synchronised.
constexpr int kIirScratchFloats = 2 * kN1 + 4 * kBlocks * kM;
constexpr int kRadixThreads = 256;

__device__ __forceinline__ void iir_frame_radix(const float* __restrict__ x,
                                                const float* __restrict__ zs,
                                                const float* __restrict__ win,
                                                const float* __restrict__ h,
                                                const float* __restrict__ pt,
                                                const float* __restrict__ mt,
                                                const float* __restrict__ al1t,
                                                float* xs, float* scratch) {
  float* hp = scratch;               // hp[128 + d] = h[d], hp[0..127] = 0
  float* pts = hp + 2 * kN1;         // PT [k][a]
  float* mts = pts + kN1 * kM;       // MT [a][i]
  float* f = mts + kM * kN1;         // forcing [j][a]
  float* z_in = f + kBlocks * kM;    // entry state of each block [j][a], 16-byte rows

  const int tid = threadIdx.x;
  hp[tid] = tid < kN1 ? 0.f : h[tid - kN1];
  for (int i = tid; i < kN1 * kM; i += kRadixThreads) {
    pts[i] = pt[i];
    mts[i] = mt[i];
  }
  load_frame<kRadixThreads>(x, win, xs);
  __syncthreads();
  block_forcing<kRadixThreads>(xs, pts, f);
  __syncthreads();

  const int warp = tid >> 5;
  const int lane = tid & 31;
  if (warp == 0) block_chain(al1t, f, lane < kM ? zs[lane] : 0.f, z_in);
  constexpr int kRows = kBlocks / (kRadixThreads / 32);  // 16 rows a warp
  const int j0 = kRows * warp;
  float y[kRows][4];
#pragma unroll
  for (int r = 0; r < kRows; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c) y[r][c] = 0.f;
  for (int kb = 0; kb < 4; ++kb) {
    for (int kk = 0; kk < 32; kk += 2) {  // k and k + 1: one 8-byte load a row
      const int k = 32 * kb + kk;
      float2 xv[kRows];
#pragma unroll
      for (int r = 0; r < kRows; ++r)
        xv[r] = *reinterpret_cast<const float2*>(xs + (j0 + r) * kN1 + k);
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        if (c < kb) continue;  // columns i < 32kb <= k: T[i][k] = 0
        const float t0 = hp[kN1 + 32 * c + lane - k];
        const float t1 = hp[kN1 + 32 * c + lane - k - 1];
#pragma unroll
        for (int r = 0; r < kRows; ++r) {
          y[r][c] = fmaf(t0, xv[r].x, y[r][c]);
          y[r][c] = fmaf(t1, xv[r].y, y[r][c]);
        }
      }
    }
  }
  __syncthreads();  // z_in is complete and every read of xw is done

  // y = y_zs + z_in @ MT, written over the frame: column i of MT in
  // registers, row j of z_in as three 16-byte broadcasts.
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    const int i = 32 * c + lane;
    float m[kM];
#pragma unroll
    for (int a = 0; a < kM; ++a) m[a] = mts[a * kN1 + i];
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const int j = j0 + r;
      const float4* zj = reinterpret_cast<const float4*>(z_in + j * kM);
      const float4 z[3] = {zj[0], zj[1], zj[2]};
      const float zv[kM] = {z[0].x, z[0].y, z[0].z, z[0].w, z[1].x, z[1].y,
                            z[1].z, z[1].w, z[2].x, z[2].y, z[2].z, z[2].w};
      float s = 0.f;
#pragma unroll
      for (int a = 0; a < kM; ++a) s = fmaf(zv[a], m[a], s);
      xs[j * kN1 + i] = y[r][c] + s;
    }
  }
  __syncthreads();
}

}  // namespace tpu_sdr
