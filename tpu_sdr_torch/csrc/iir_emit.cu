// The output step of the composite IIR on the hybrid route: every block's
// output from its windowed input and its entry state, in one pass.
//
// Replaces no TPU kernel: JAX runs this part of
// tpu_sdr/kernels/biquad.py sosfilt_blocked_composite as two XLA products
// (the Toeplitz T and the state response M) and their sum. The port ran the
// same as two cuBLAS GEMMs and an add; on an H100 they wrote the zero-state
// output y_zs and the M product to device memory and read both back, and
// the dense T product multiplied T's upper triangle of zeros.
//
// With h = T[:, 0] (T is Toeplitz, T[n][k] = h[n - k] for k <= n, else 0, the
// same rounded values), xw[k] the block's windowed input and z its entry
// state (12 floats), each of the block's 128 outputs is
//
//   y[n] = sum_{j < 12} M[n][j] z[j] + sum_{k <= n} h[n - k] xw[k]
//
// as one fp32 FMA chain in a fixed order: the z term first, j ascending,
// from 0; then k ascending. The order depends on (n, j, k) alone, so
// chunked and one-shot dispatches, a time-sharded one and a graph's replay
// give the same bits. IEEE fp32, on the CUDA cores.
//
// What bounds it on an H100: about 141 MB moved at 64 channels x 16 frames
// (xw and y 67 MB each, z 6.3 MB; 0.042 ms at 3.35 TB/s) against 2.57
// GFLOP (the triangle's 128 * 129 / 2 and the z term's 128 * 12 FMAs a block;
// 0.038 ms at 67 TFLOP/s). The design:
//
// - A CTA takes 64 blocks of one row (a channel's run of blocks) and holds
//   their inputs (each row padded to 132 floats), their entry states, the
//   row's M (6 KB) and h (zero below index 0) in shared memory, 43 KB,
//   filled by cp.async; three CTAs an SM, so some load while others sum.
// - Warp w owns the output groups n0 = 8w and 8(15 - w) of 8 outputs, so
//   every warp sums 136 k steps; a lane owns 2 blocks (lane + 32 r), and
//   holds 8 outputs x 2 blocks of sums. Per 4 k steps a lane loads its 2
//   blocks' inputs (one 16-byte load each; the 132-float rows put 8 lanes in
//   8 different groups of 4 banks) and the group's h window (3 broadcast
//   loads) for 64 FMAs. Outputs of a group below its last k add h's zeros.
// - Once every warp has summed, the outputs go into the inputs' rows in
//   shared memory and leave as whole 512-byte rows (a lane's own 16-byte
//   stores, 512 bytes apart across the warp, took 8 % longer on an H100).
//
// On an H100 the sums alone (no device memory read or written) take about
// two thirds of the kernel's time, and the card draws near its 700 W limit;
// a persistent CTA with a loading warp, a double-buffered cp.async ring and
// groups of 16 outputs were no faster.

#include <cuda_runtime.h>

#include "error_string.cuh"

namespace {

constexpr int kL = 128;                // samples a block, and outputs
constexpr int kM = 12;                 // composite state size (6 sections)
constexpr int kR = 2;                  // blocks a lane
constexpr int kTile = 32 * kR;         // blocks a CTA
constexpr int kWarps = kL / 16;        // warp w: output groups w and 15 - w
constexpr int kThreads = 32 * kWarps;
constexpr int kCtasPerSm = 3;
constexpr int kXStride = kL + 4;       // 132: 8 lanes' rows in 8 groups of 4 banks
constexpr int kHOff = 11;              // hp[kHOff + d] = h[d], 0 for d < 0
constexpr int kHLen = kHOff + kL + 1;  // 140: the windows reach hp[4 .. 139]
constexpr size_t kSmem = size_t(kTile * kXStride + kTile * kM + kL * kM + kHLen) * sizeof(float);
static_assert((kTile * kXStride) % 4 == 0 && (kTile * kM) % 4 == 0 && (kL * kM) % 4 == 0,
              "every table starts 16-byte aligned");

// 16 bytes from device to shared memory, through no register.
__device__ __forceinline__ void copy16_async(float* dst, const float* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src) : "memory");
}

__device__ __forceinline__ float part(const float4& v, int s) {
  return s == 0 ? v.x : s == 1 ? v.y : s == 2 ? v.z : v.w;
}

__global__ void __launch_bounds__(kThreads, kCtasPerSm)
iir_emit_kernel(const float* __restrict__ x, const float* __restrict__ z_in,
                const float* __restrict__ t, const float* __restrict__ m, int t_stride,
                int m_stride, int set_rows, float* __restrict__ y, int blocks) {
  extern __shared__ float4 smem4[];
  float* xs = reinterpret_cast<float*>(smem4);  // xs[b * 132 + k] = xw of block b
  float* zs = xs + kTile * kXStride;            // zs[b * 12 + j]
  float* ms = zs + kTile * kM;                  // ms[n * 12 + j] = M[n][j]
  float* hp = ms + kL * kM;                     // hp[11 + d] = h[d]
  const int tid = threadIdx.x;
  const int set = blockIdx.y / set_rows;
  const float* tr = t + size_t(set) * t_stride;
  const float* mr = m + size_t(set) * m_stride;
  const size_t blk0 = size_t(blockIdx.y) * blocks + size_t(blockIdx.x) * kTile;
  const float* xg = x + blk0 * kL;
  const float* zg = z_in + blk0 * kM;

  for (int e = tid; e < kTile * (kL / 4); e += kThreads) {
    const int b = e / (kL / 4), q = e % (kL / 4);
    copy16_async(xs + b * kXStride + 4 * q, xg + size_t(b) * kL + 4 * q);
  }
  for (int e = tid; e < kTile * kM / 4; e += kThreads) copy16_async(zs + 4 * e, zg + 4 * e);
  for (int e = tid; e < kL * kM / 4; e += kThreads) copy16_async(ms + 4 * e, mr + 4 * e);
  for (int e = tid; e < kHLen; e += kThreads) {
    const int d = e - kHOff;
    hp[e] = d >= 0 && d < kL ? __ldg(tr + size_t(d) * kL) : 0.f;
  }
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  __syncthreads();

  const int warp = tid >> 5, lane = tid & 31;
  const float* xl = xs + lane * kXStride;
  const float* zl = zs + lane * kM;
  float acc[2][8][kR];  // the warp's two output groups, held until every warp has summed
#pragma unroll
  for (int u = 0; u < 2; ++u) {
    const int n0 = 8 * (u == 0 ? warp : 2 * kWarps - 1 - warp);
#pragma unroll
    for (int p = 0; p < 8; ++p)
#pragma unroll
      for (int r = 0; r < kR; ++r) acc[u][p][r] = 0.f;
    // The z term, j ascending.
#pragma unroll
    for (int jg = 0; jg < kM / 4; ++jg) {
      float4 zv[kR];
#pragma unroll
      for (int r = 0; r < kR; ++r)
        zv[r] = *reinterpret_cast<const float4*>(zl + 32 * r * kM + 4 * jg);
#pragma unroll
      for (int p = 0; p < 8; ++p) {
        const float4 mv = *reinterpret_cast<const float4*>(ms + (n0 + p) * kM + 4 * jg);
#pragma unroll
        for (int s = 0; s < 4; ++s)
#pragma unroll
          for (int r = 0; r < kR; ++r)
            acc[u][p][r] = fmaf(part(mv, s), part(zv[r], s), acc[u][p][r]);
      }
    }
    // The triangle, k ascending: h[n0 + p - k] = hw[p - s + 3] at k = k0 + s.
#pragma unroll 2
    for (int k0 = 0; k0 <= n0 + 4; k0 += 4) {
      float4 xv[kR];
#pragma unroll
      for (int r = 0; r < kR; ++r)
        xv[r] = *reinterpret_cast<const float4*>(xl + 32 * r * kXStride + k0);
      float hw[12];
#pragma unroll
      for (int q = 0; q < 3; ++q) {
        const float4 v = *reinterpret_cast<const float4*>(hp + n0 - k0 + 8 + 4 * q);
        hw[4 * q] = v.x;
        hw[4 * q + 1] = v.y;
        hw[4 * q + 2] = v.z;
        hw[4 * q + 3] = v.w;
      }
#pragma unroll
      for (int s = 0; s < 4; ++s)
#pragma unroll
        for (int p = 0; p < 8; ++p)
#pragma unroll
          for (int r = 0; r < kR; ++r)
            acc[u][p][r] = fmaf(hw[p - s + 3], part(xv[r], s), acc[u][p][r]);
    }
  }
  __syncthreads();  // every warp has read the inputs: their rows take the outputs
#pragma unroll
  for (int u = 0; u < 2; ++u) {
    const int n0 = 8 * (u == 0 ? warp : 2 * kWarps - 1 - warp);
#pragma unroll
    for (int r = 0; r < kR; ++r) {
      float4* dst = reinterpret_cast<float4*>(xs + (lane + 32 * r) * kXStride + n0);
      dst[0] = make_float4(acc[u][0][r], acc[u][1][r], acc[u][2][r], acc[u][3][r]);
      dst[1] = make_float4(acc[u][4][r], acc[u][5][r], acc[u][6][r], acc[u][7][r]);
    }
  }
  __syncthreads();
  float* yg = y + blk0 * kL;
  for (int e = tid; e < kTile * (kL / 4); e += kThreads) {
    const int b = e / (kL / 4), q = e % (kL / 4);
    reinterpret_cast<float4*>(yg + size_t(b) * kL)[q] =
        *reinterpret_cast<const float4*>(xs + b * kXStride + 4 * q);
  }
}

}  // namespace

extern "C" {

// y (rows, blocks, 128) from x (rows, blocks, 128) and z_in (rows, blocks,
// 12), fp32, blocks a multiple of 64; t (128, 128) and m (128, 12) a set,
// row r using set r / set_rows, t_stride and m_stride floats apart (0 for a
// design shared by every row). x, z_in, m and y 16-byte aligned, on the
// current device. Returns the CUDA error code of the launch (0 on success).
int tpu_sdr_iir_emit(const float* x, const float* z_in, const float* t, const float* m,
                     int t_stride, int m_stride, int set_rows, float* y, int rows, int blocks,
                     void* stream) {
  if (rows <= 0 || blocks <= 0) return 0;
  if (blocks % kTile || set_rows <= 0) return int(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(iir_emit_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, int(kSmem));
  if (err != cudaSuccess) return int(err);
  const dim3 grid(blocks / kTile, rows);
  iir_emit_kernel<<<grid, kThreads, kSmem, static_cast<cudaStream_t>(stream)>>>(
      x, z_in, t, m, t_stride, m_stride, set_rows, y, blocks);
  return int(cudaGetLastError());
}

}  // extern "C"
