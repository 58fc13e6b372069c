// The state path of the composite IIR on the hybrid route: every block's
// entry state of every frame, the frame chain, and the state after the
// dispatch, from the forcing of the P product.
//
// Replaces no TPU kernel: JAX runs this part of
// tpu_sdr/kernels/biquad.py sosfilt_blocked_composite as XLA products (the
// block-Toeplitz W, the APow product) and a jitted scan (the frame chain).
// The port ran the same as two batched GEMMs, a Python loop of three launches
// a frame, an add and a cat; on an H100 the W product streamed each channel's
// (128 * 12)^2 W from device memory for a few rows and took most of the IIR's
// device time, and the chain most of its host time.
//
// With P_d = (A^L)^d (P_0 = I, P_d = apow[d - 1], 128 powers of 144 floats a
// channel), f[i] the forcing of block i of a frame and z_f its entry state:
//
//   step 1  w_f      = sum_{i < 128} P_{127 - i} f[i]        (its end from rest)
//   step 2  z_{f+1}  = P_128 z_f + w_f                       (the frame chain)
//   step 3  z_in[j]  = sum_{1 <= k <= j} P_{j - k} f[k - 1] + P_j z_f
//
// Every term is a product with an exactly rounded power, as W's entries are,
// and no state is carried from block to block: the sums do not drift where a
// 128-step fp32 recurrence does (iir_blocks.cuh block_chain).
//
// What bounds it on an H100: step 3's triangle, 128 * 129 / 2 * 144 FMAs a
// frame (2.43 GFLOP at 64 channels x 16 frames, 0.036 ms at 67 TFLOP/s
// fp32), against about 17 MB read and written (0.005 ms). The design keeps
// the FMAs fed from shared memory:
//
// - Two launches. step_ends (step 1) sums each frame's end state; under a
//   time axis the caller all-gathers them before step_entries (steps 2 and
//   3), so both forms run the same arithmetic.
// - step_entries: a block of 8 frames of one row holds the row's powers (P_-7
//   .. P_127, P_-7 .. P_-1 zero, each padded to 148 floats so that the powers
//   of 8 consecutive blocks lie in 8 different groups of 4 banks; 78 KB) and
//   its frames' forcing (48 KB) in shared memory; one CTA an SM, 8 frames x
//   132 SMs in flight.
// - Its 8 compute warps share the triangle: a lane owns 2 frames x 1 block x
//   12 states (lane l: frames 2 (l % 4) and + 1, block 8 q + l / 4), a warp
//   the block groups q = w and 15 - w of 8 blocks each, so every warp sums
//   136 block steps. Per step k a lane loads its power's 12 columns (3
//   16-byte loads a column, one wavefront a warp) and its frames' forcing (6
//   loads, one wavefront each) for 288 FMAs. Blocks j < k of a group add the
//   zero powers.
// - The chain runs in a ninth warp, beside the compute warps: lane a walks
//   component a through the row's frames up to the block's last (every
//   block walks from the dispatch's first frame; the last block on to the
//   end and stores the final state), a fixed-order 12-term FMA sum a frame,
//   the other components by shuffles, the w's loaded 32 frames ahead. The z
//   term of step 3 comes last, after one barrier.
// - step_ends: a thread holds 72 entries of one power (block i, half h of the
//   columns) and sums its 6 products per frame; a butterfly over the warp's
//   lanes, then the 8 warps in ascending order.
//
// Each sum's order is fixed by (frame, block, state) alone: chunked and
// one-shot dispatches, and a time-sharded one, give the same bits. IEEE fp32.

#include <cuda_runtime.h>

#include "error_string.cuh"

namespace {

constexpr int kM = 12;            // composite state size (6 sections)
constexpr int kB = 128;           // blocks a frame
constexpr int kPower = kM * kM;   // floats a power
constexpr int kFrames = 8;        // frames a CTA
constexpr int kPad = 7;           // zero powers below P_0: a group of 8 blocks reaches j - k = -7
constexpr int kPStride = kPower + 4;  // 148: 8 consecutive powers in 8 groups of 4 banks
constexpr int kPowers = kPad + kB;    // P_-7 .. P_127
constexpr int kWarps = 8;             // compute warps of step_entries
constexpr int kEntriesThreads = 32 * (kWarps + 1);  // and the chain warp
constexpr int kGroups = kB / 8;       // groups of 8 blocks
constexpr int kAhead = 32;            // w's the chain loads ahead
constexpr int kEndsThreads = 2 * kB;  // step_ends: a block and half its columns a thread
constexpr size_t kEntriesSmem = size_t(kPowers * kPStride + kB * kFrames * kM) * sizeof(float);
static_assert((kPowers * kPStride) % 4 == 0, "the forcing rows start 16-byte aligned");

// The CTA's rows of constants: row r uses set r / set_rows, set_stride
// floats apart (0 for a design shared by every row).
__device__ __forceinline__ const float* row_powers(const float* apow, long long set_stride,
                                                   int set_rows) {
  return apow + (blockIdx.y / set_rows) * set_stride;
}

__global__ void __launch_bounds__(kEndsThreads)
iir_state_ends_kernel(const float* __restrict__ f, const float* __restrict__ apow,
                      long long set_stride, int set_rows, float* __restrict__ w, int frames) {
  __shared__ float sums[kFrames][kEndsThreads / 32][kM];
  const int t = threadIdx.x;
  const int lane = t & 31, warp = t >> 5;
  const int i = t >> 1, h = t & 1;  // block i, columns 6h .. 6h + 5
  const int d = kB - 1 - i;
  const float* pw = row_powers(apow, set_stride, set_rows);
  float p[kM][6];
  if (d == 0) {
#pragma unroll
    for (int a = 0; a < kM; ++a)
#pragma unroll
      for (int c = 0; c < 6; ++c) p[a][c] = a == 6 * h + c ? 1.f : 0.f;
  } else {
    const float* src = pw + (d - 1) * kPower + 6 * h;
#pragma unroll
    for (int a = 0; a < kM; ++a)
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        const float2 v = __ldg(reinterpret_cast<const float2*>(src + a * kM) + c);
        p[a][2 * c] = v.x;
        p[a][2 * c + 1] = v.y;
      }
  }
  const int f0 = blockIdx.x * kFrames;
  const int nf = min(kFrames, frames - f0);
  const size_t row = size_t(blockIdx.y) * frames;
  for (int fr = 0; fr < nf; ++fr) {
    const float2* src =
        reinterpret_cast<const float2*>(f + ((row + f0 + fr) * kB + i) * kM + 6 * h);
    float x[6];
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      const float2 v = __ldg(src + c);
      x[2 * c] = v.x;
      x[2 * c + 1] = v.y;
    }
    float s[kM];
#pragma unroll
    for (int a = 0; a < kM; ++a) {
      s[a] = 0.f;
#pragma unroll
      for (int c = 0; c < 6; ++c) s[a] = fmaf(p[a][c], x[c], s[a]);
    }
    // Lane 2 (i % 16) + h: the butterfly sums the warp's 16 blocks pairwise,
    // and every lane ends with the same bits.
#pragma unroll
    for (int m = 1; m < 32; m <<= 1)
#pragma unroll
      for (int a = 0; a < kM; ++a) s[a] += __shfl_xor_sync(0xffffffffu, s[a], m);
    if (lane == 0)
#pragma unroll
      for (int a = 0; a < kM; ++a) sums[fr][warp][a] = s[a];
  }
  __syncthreads();
  if (t < nf * kM) {
    const int fr = t / kM, a = t % kM;
    float acc = sums[fr][0][a];
#pragma unroll
    for (int v = 1; v < kEndsThreads / 32; ++v) acc += sums[fr][v][a];
    w[(row + f0 + fr) * kM + a] = acc;
  }
}

// The frame chain of the CTA's row, in one warp: stores z_f (row 0 of the
// forcing table) for the CTA's frames, and the final state when the CTA
// holds the dispatch's last frames. Frames are global indices: the CTA's
// own are frame_lo + f0 + [0, nf); w holds frames_global of them.
__device__ __forceinline__ void walk_chain(const float* pw, const float* __restrict__ z0,
                                           const float* __restrict__ w, float* __restrict__ zf,
                                           float* gs, int frames, int frames_global, int frame_lo,
                                           int f0, int nf) {
  const int lane = threadIdx.x & 31;
  const bool live = lane < kM;
  const bool last = f0 + kFrames >= frames;
  const int glo = frame_lo + f0, ghi = glo + nf;
  const int end = last ? frames_global : ghi;
  float al[kM];  // row `lane` of P_128
#pragma unroll
  for (int b = 0; b < kM; ++b) al[b] = live ? __ldg(pw + (kB - 1) * kPower + lane * kM + b) : 0.f;
  float z = live ? z0[blockIdx.y * kM + lane] : 0.f;
  const float* wr = w + size_t(blockIdx.y) * frames_global * kM + lane;
  float wc[kAhead];
#pragma unroll
  for (int s = 0; s < kAhead; ++s) wc[s] = live && s < end ? __ldg(wr + s * kM) : 0.f;
  for (int g0 = 0; g0 < end; g0 += kAhead) {
    float wn[kAhead];
#pragma unroll
    for (int s = 0; s < kAhead; ++s) {
      const int g = g0 + kAhead + s;
      wn[s] = live && g < end ? __ldg(wr + size_t(g) * kM) : 0.f;
    }
#pragma unroll
    for (int s = 0; s < kAhead; ++s) {
      const int g = g0 + s;
      if (g < end) {
        if (live && g >= glo && g < ghi) gs[(g - glo) * kM + lane] = z;
        float acc = 0.f;
#pragma unroll
        for (int b = 0; b < kM; ++b) acc = fmaf(al[b], __shfl_sync(0xffffffffu, z, b), acc);
        z = acc + wc[s];
      }
    }
#pragma unroll
    for (int s = 0; s < kAhead; ++s) wc[s] = wn[s];
  }
  if (last && live) zf[blockIdx.y * kM + lane] = z;
}

// acc[fr][a] += sum_b P_d[a][b] g[fr][b], b ascending; pd = P_d's columns
// (pd[b * 12 + a]), g = 2 frames x 12 floats.
__device__ __forceinline__ void power_step(float (&acc)[2][kM], const float* pd, const float* g) {
  float gv[2][kM];
#pragma unroll
  for (int q = 0; q < 6; ++q) {
    const float4 v = reinterpret_cast<const float4*>(g)[q];
    gv[q / 3][4 * (q % 3)] = v.x;
    gv[q / 3][4 * (q % 3) + 1] = v.y;
    gv[q / 3][4 * (q % 3) + 2] = v.z;
    gv[q / 3][4 * (q % 3) + 3] = v.w;
  }
#pragma unroll
  for (int b = 0; b < kM; ++b) {
    float pv[kM];
#pragma unroll
    for (int q = 0; q < 3; ++q) {
      const float4 v = reinterpret_cast<const float4*>(pd + b * kM)[q];
      pv[4 * q] = v.x;
      pv[4 * q + 1] = v.y;
      pv[4 * q + 2] = v.z;
      pv[4 * q + 3] = v.w;
    }
#pragma unroll
    for (int a = 0; a < kM; ++a) {
      acc[0][a] = fmaf(pv[a], gv[0][b], acc[0][a]);
      acc[1][a] = fmaf(pv[a], gv[1][b], acc[1][a]);
    }
  }
}

__global__ void __launch_bounds__(kEntriesThreads, 1)
iir_state_entries_kernel(const float* __restrict__ f, const float* __restrict__ apow,
                         long long set_stride, int set_rows, const float* __restrict__ z0,
                         const float* __restrict__ w, float* __restrict__ z_in,
                         float* __restrict__ zf, int frames, int frames_global, int frame_lo) {
  extern __shared__ float4 smem4[];
  float* pt = reinterpret_cast<float*>(smem4);  // pt[(d + 7) * 148 + b * 12 + a] = P_d[a][b]
  float* gs = pt + kPowers * kPStride;           // gs[(k * 8 + fr) * 12 + b]: k = 0 z_f, else f[k - 1]
  const int t = threadIdx.x;
  const float* pw = row_powers(apow, set_stride, set_rows);
  const int f0 = blockIdx.x * kFrames;
  const int nf = min(kFrames, frames - f0);
  const size_t row = size_t(blockIdx.y) * frames;

  // P_-7 .. P_0 (zeros, the identity), then P_1 .. P_127 transposed.
  for (int e = t; e < (kPad + 1) * kPStride; e += kEntriesThreads) {
    const int rem = e % kPStride;
    const bool diag = e >= kPad * kPStride && rem < kPower && rem / kM == rem % kM;
    pt[e] = diag ? 1.f : 0.f;
  }
  for (int e = t; e < (kB - 1) * (kPower / 4); e += kEntriesThreads) {
    const int dd = e / (kPower / 4), q = e % (kPower / 4);  // power dd + 1, floats 4q .. 4q + 3
    const float4 v = __ldg(reinterpret_cast<const float4*>(pw + dd * kPower) + q);
    const int a = 4 * q / kM, b = 4 * q % kM;
    float* dst = pt + (dd + 1 + kPad) * kPStride + b * kM + a;
    dst[0] = v.x;
    dst[kM] = v.y;
    dst[2 * kM] = v.z;
    dst[3 * kM] = v.w;
  }
  for (int e = t; e < kFrames * kM; e += kEntriesThreads) gs[e] = 0.f;
  for (int e = t; e < (kB - 1) * kFrames * 3; e += kEntriesThreads) {
    const int k = e / (kFrames * 3), fr = e / 3 % kFrames, q = e % 3;  // block k of frame fr
    const float4 v = fr < nf ? __ldg(reinterpret_cast<const float4*>(
                                         f + ((row + f0 + fr) * kB + k) * kM) + q)
                             : make_float4(0.f, 0.f, 0.f, 0.f);
    reinterpret_cast<float4*>(gs + ((k + 1) * kFrames + fr) * kM)[q] = v;
  }
  __syncthreads();

  const int warp = t >> 5, lane = t & 31;
  const int fp = lane & 3;  // frames 2 fp and 2 fp + 1
  const int groups[2] = {warp, kGroups - 1 - warp};
  float acc[2][2][kM];
  if (warp == kWarps) {
    walk_chain(pw, z0, w, zf, gs, frames, frames_global, frame_lo, f0, nf);
  } else {
#pragma unroll
    for (int u = 0; u < 2; ++u) {
#pragma unroll
      for (int fr = 0; fr < 2; ++fr)
#pragma unroll
        for (int a = 0; a < kM; ++a) acc[u][fr][a] = 0.f;
      const int j = 8 * groups[u] + (lane >> 2);
      const int kmax = 8 * groups[u] + 7;
      for (int k = 1; k <= kmax; ++k)
        power_step(acc[u], pt + (j - k + kPad) * kPStride, gs + (k * kFrames + 2 * fp) * kM);
    }
  }
  __syncthreads();  // the chain has stored every z_f
  if (warp == kWarps) return;
#pragma unroll
  for (int u = 0; u < 2; ++u) {
    const int j = 8 * groups[u] + (lane >> 2);
    power_step(acc[u], pt + (j + kPad) * kPStride, gs + 2 * fp * kM);
#pragma unroll
    for (int fr = 0; fr < 2; ++fr) {
      if (2 * fp + fr >= nf) continue;
      float4* dst = reinterpret_cast<float4*>(z_in + ((row + f0 + 2 * fp + fr) * kB + j) * kM);
#pragma unroll
      for (int q = 0; q < 3; ++q)
        dst[q] = make_float4(acc[u][fr][4 * q], acc[u][fr][4 * q + 1], acc[u][fr][4 * q + 2],
                             acc[u][fr][4 * q + 3]);
    }
  }
}

}  // namespace

extern "C" {

// step 0: w (rows, frames, 12) from f; step 1: z_in (rows, frames, 128, 12)
// and zf (rows, 12) from f, z0 (rows, 12) and w (rows, frames_global, 12),
// the rows' frames being frame_lo .. frame_lo + frames - 1 of frames_global.
// f: (rows, frames, 128, 12) fp32; apow: P_1 .. P_128 (128, 12, 12) a set,
// row r using set r / set_rows, set_stride floats apart. Every pointer
// 16-byte aligned, on the current device. Returns the CUDA error code of
// the launch (0 on success).
int tpu_sdr_iir_state(int step, const float* f, const float* apow, int set_stride,
                      int set_rows, const float* z0, float* w, float* z_in, float* zf, int rows,
                      int frames, int frames_global, int frame_lo, void* stream) {
  if (rows <= 0 || frames <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid((frames + kFrames - 1) / kFrames, rows);
  if (step == 0) {
    iir_state_ends_kernel<<<grid, kEndsThreads, 0, s>>>(f, apow, set_stride, set_rows, w, frames);
    return int(cudaGetLastError());
  }
  cudaError_t err = cudaFuncSetAttribute(
      iir_state_entries_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(kEntriesSmem));
  if (err != cudaSuccess) return int(err);
  iir_state_entries_kernel<<<grid, kEntriesThreads, kEntriesSmem, s>>>(
      f, apow, set_stride, set_rows, z0, w, z_in, zf, frames, frames_global, frame_lo);
  return int(cudaGetLastError());
}

}  // extern "C"
