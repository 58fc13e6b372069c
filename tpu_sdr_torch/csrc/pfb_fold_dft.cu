// PFB channelizer core: the weighted overlap-fold of `taps` shifted rows and
// the two 128 x 128 real DFT products of the folded rows.
//
// Replaces the TPU kernel tpu_sdr/kernels/pallas/pfb_kernel.py pfb_fold_dft
// (body _pfb_kernel). For batch row b and output step s of a (batch, R, 128)
// row array, R = steps + taps - 1:
//
//   fold[s][p] = sum_t rows[b][s + t][p] * h2[t][p]       (t = 0 .. taps-1)
//   A[b][s][k] = sum_p fold[s][p] * cos[p][k]
//   B[b][s][k] = sum_p fold[s][p] * sin[p][k]             (negated if neg_b)
//
// One 256-thread block per (batch row, group of 64 steps). The group's 64
// rows and its taps - 1 halo rows are loaded into shared memory once (the
// TPU kernel passes the same array twice, body and halo, because a BlockSpec
// cannot express an overlapping slide; here the block computes its own
// offsets). The fold goes to shared memory; then warp w computes steps
// 8w .. 8w+7 and lane l columns 4l .. 4l+3 of both products, 64 fp32
// accumulators a thread, reading cos and sin (64 KB each, shared by every
// block) through the read-only cache. The last group of a row masks the
// steps past its end itself: nothing is padded in device memory.
//
// The fold's multiplies and adds are __fmul_rn / __fadd_rn in the order of
// the plain PyTorch version (pfb_kernel.pfb_fold_dft_plain), so the folded
// rows equal it bit for bit; the products sum over p in order with FMAs. A
// step's result depends only on its own rows, so it does not depend on the
// group it falls in, on the number of steps or on the batch.
//
// What bounds it on an H100: the function reads 4 bytes and writes 8 per
// input sample (100.8 MB, 0.030 ms at 8 x 2^20 samples). Its operations,
// 2 * taps of fold and a real 128-point FFT's 2.5 * 7 a sample, take less
// (0.28 GFLOP at taps = 8), so it is bound by bytes. This kernel computes
// the two products densely, 512 operations a sample (4.3 GFLOP), on the
// CUDA cores in fp32, as every tier does in the port so far (tensor cores
// or a radix DFT are later work). Its times on the card are in PERF.md.

#include <cuda_runtime.h>
#include <stdint.h>

#include "error_string.cuh"

namespace {

constexpr int kM = 128;          // channels (the DFT size)
constexpr int kGroup = 64;       // output steps per block
constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kStepsPerWarp = kGroup / kWarps;

__host__ __device__ constexpr size_t smem_bytes(int taps) {
  return size_t(kGroup + taps - 1 + kGroup) * kM * sizeof(float);
}

__global__ void __launch_bounds__(kThreads)
pfb_fold_dft_kernel(const float* __restrict__ rows, const float* __restrict__ h2,
                    const float4* __restrict__ cos4,
                    const float4* __restrict__ sin4, float* __restrict__ a_out,
                    float* __restrict__ b_out, int r_rows, int taps, int neg_b) {
  extern __shared__ __align__(16) float smem[];
  const int halo = taps - 1;
  const int steps = r_rows - halo;
  const int s0 = blockIdx.x * kGroup;
  const int b = blockIdx.y;
  const int n_rows = min(kGroup + halo, r_rows - s0);  // rows this group reads
  float* xs = smem;                                    // [kGroup + halo][kM]
  float* fold = smem + size_t(kGroup + halo) * kM;     // [kGroup][kM]

  // 1. The group's rows and halo; rows past the end of the array are zero.
  const float4* src = reinterpret_cast<const float4*>(rows + (size_t(b) * r_rows + s0) * kM);
  float4* xs4 = reinterpret_cast<float4*>(xs);
  for (int i = threadIdx.x; i < (kGroup + halo) * (kM / 4); i += kThreads) {
    xs4[i] = i < n_rows * (kM / 4) ? src[i] : make_float4(0.f, 0.f, 0.f, 0.f);
  }
  __syncthreads();

  // 2. The fold, t in order: acc = x[s] h[0]; acc = acc + x[s + t] h[t].
  {
    const int p = threadIdx.x & (kM - 1);
    for (int s = threadIdx.x >> 7; s < kGroup; s += kThreads / kM) {
      float acc = __fmul_rn(xs[s * kM + p], __ldg(h2 + p));
      for (int t = 1; t < taps; ++t) {
        acc = __fadd_rn(acc, __fmul_rn(xs[(s + t) * kM + p], __ldg(h2 + t * kM + p)));
      }
      fold[s * kM + p] = acc;
    }
  }
  __syncthreads();

  // 3. Both products: warp w, steps 8w .. 8w+7; lane l, columns 4l .. 4l+3.
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const float* fw = fold + warp * kStepsPerWarp * kM;
  float ac[kStepsPerWarp][4], as[kStepsPerWarp][4];
#pragma unroll
  for (int i = 0; i < kStepsPerWarp; ++i) {
#pragma unroll
    for (int q = 0; q < 4; ++q) ac[i][q] = as[i][q] = 0.f;
  }
#pragma unroll 4
  for (int p = 0; p < kM; ++p) {
    const float4 c = __ldg(cos4 + p * (kM / 4) + lane);
    const float4 sn = __ldg(sin4 + p * (kM / 4) + lane);
#pragma unroll
    for (int i = 0; i < kStepsPerWarp; ++i) {
      const float f = fw[i * kM + p];
      ac[i][0] = fmaf(f, c.x, ac[i][0]);
      ac[i][1] = fmaf(f, c.y, ac[i][1]);
      ac[i][2] = fmaf(f, c.z, ac[i][2]);
      ac[i][3] = fmaf(f, c.w, ac[i][3]);
      as[i][0] = fmaf(f, sn.x, as[i][0]);
      as[i][1] = fmaf(f, sn.y, as[i][1]);
      as[i][2] = fmaf(f, sn.z, as[i][2]);
      as[i][3] = fmaf(f, sn.w, as[i][3]);
    }
  }

  // 4. Store the steps that exist.
  const float sign = neg_b ? -1.f : 1.f;
#pragma unroll
  for (int i = 0; i < kStepsPerWarp; ++i) {
    const int s = s0 + warp * kStepsPerWarp + i;
    if (s >= steps) break;
    const size_t o = (size_t(b) * steps + s) * kM + 4 * lane;
    *reinterpret_cast<float4*>(a_out + o) = make_float4(ac[i][0], ac[i][1], ac[i][2], ac[i][3]);
    *reinterpret_cast<float4*>(b_out + o) = make_float4(
        sign * as[i][0], sign * as[i][1], sign * as[i][2], sign * as[i][3]);
  }
}

}  // namespace

extern "C" {

// rows: (batch, r_rows, 128) fp32; h2: (taps, 128) fp32; cos, sin: (128, 128)
// fp32; a, b: (batch, r_rows - taps + 1, 128) fp32. All contiguous and
// 16-byte aligned, on the current device; 1 <= taps <= r_rows, batch <
// 65536. Returns the CUDA error code of the launch (0 on success).
int tpu_sdr_pfb_fold_dft(const float* rows, const float* h2, const float* cos,
                         const float* sin, float* a, float* b, int batch,
                         int r_rows, int taps, int neg_b, void* stream) {
  const int steps = r_rows - taps + 1;
  if (batch <= 0 || steps <= 0) return 0;
  const size_t smem = smem_bytes(taps);
  cudaError_t err = cudaFuncSetAttribute(
      pfb_fold_dft_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return int(err);
  const dim3 grid((steps + kGroup - 1) / kGroup, batch);
  pfb_fold_dft_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      rows, h2, reinterpret_cast<const float4*>(cos),
      reinterpret_cast<const float4*>(sin), a, b, r_rows, taps, neg_b);
  return int(cudaGetLastError());
}

}  // extern "C"
