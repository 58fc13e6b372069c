// The forcing step of the composite IIR on the hybrid route: every block's
// windowed input and its forcing, from the chunk, in one pass.
//
// Replaces no TPU kernel: JAX runs this part of
// tpu_sdr/kernels/biquad.py sosfilt_blocked_composite as the window multiply
// and an XLA product with P. The port ran the same as an elementwise multiply
// (x read, xw written) and cuBLAS GEMMs in canonical calls that read all of
// xw again to write the forcing.
//
// With w the window of a frame of 128 blocks (w[b * 128 + k] for block b of
// the frame) and P the operator's (12, 128) forcing matrix of the row's set,
// each block's input is rounded on its own and its 12 forcing terms are
//
//   xw[k] = x[k] * w[b * 128 + k]        (__fmul_rn: torch.mul's bits)
//   f[j]  = sum_k P[j][k] xw[k]
//
// where lane l of a warp holds k = 4l .. 4l + 3. Each f[j] is one fixed
// order: lane l's four products as an fp32 FMA chain from 0, k ascending;
// then the 32 lanes' partial sums pairwise, l with l + 16, then + 8, + 4,
// + 2 and + 1 (a butterfly whose adds are commutative, so each pair's sum has
// one value whichever lane forms it). The order depends on (j, k) alone, so
// chunked and one-shot dispatches, a time-sharded one and a graph's dispatch
// give the same bits. IEEE fp32, on the CUDA cores. Without a window xw = x
// and is stored only where the caller asks (the steps' layout differs from
// x's). The plain version (biquad.block_forcing_plain) sums in this order
// but rounds each product before its add: on an H100 the kernel's f lay
// within 1.24e-7 of max |f| of it at 64 channels x 16 frames of bank64's
// designs with the window (1.12e-7 without; 1.0e-7 for a shared design's
// frame), and its xw equalled torch.mul's bit for bit.
//
// What bounds it on an H100: bytes. At 64 channels x 16 frames it reads x
// (67.1 MB) and writes xw (67.1 MB) and f (6.3 MB): 140.5 MB, 0.042 ms at
// 3.35 TB/s, against 0.4 GFLOP (1536 FMAs a block; 6 us at 67 TFLOP/s).
// The design keeps bytes in flight without holding them in registers:
//
// - A CTA of 8 warps takes 8 neighbouring blocks of the frame in one row,
//   warp w block b = 8 blockIdx.x + w of every frame of the row, so a lane
//   holds its 16 bytes of the window (w[b * 128 + 4l ..]) and its 12 float4
//   of the row's P in registers for the whole row.
// - Each lane streams its 16 bytes of the warp's blocks, frame after frame
//   (a warp's copy is a whole 512-byte block), through a ring of 8 stages
//   in shared memory (cp.async, past L1), 7 blocks ahead of the one it
//   sums; it reads back only what it copied, so no warp waits on another.
//   32 KB of rings a CTA, 2 CTAs an SM (93 registers a thread, no spill).
//   On an H100 16 stages, 3 CTAs an SM or 4 and 64 registers were no faster
//   (the last spilled and took 37 % longer at 64 x 16).
// - A block's xw leaves as one 16-byte streaming store a lane; its 12 sums
//   meet in 18 shuffles: at the strides 16 and 8 a lane hands on half of its
//   sums and keeps the other half, and the last 3 take the strides 4, 2 and
//   1 whole. Lanes (l & 7) < 3 then hold the 12 terms in order and store
//   them as 48 contiguous bytes.

#include <cuda_runtime.h>

#include "error_string.cuh"

namespace {

constexpr int kL = 128;                 // samples a block
constexpr int kM = 12;                  // composite state size (6 sections)
constexpr int kFrame = 128;             // blocks a frame: the window's length / kL
constexpr int kWarps = 8;               // warps a CTA, each a block of every frame
constexpr int kThreads = 32 * kWarps;
constexpr int kDepth = 8;               // ring stages a warp (a power of 2)
constexpr int kCtasPerSm = 2;
constexpr unsigned kAll = 0xffffffffu;

// 16 bytes from device to shared memory, through no register.
__device__ __forceinline__ void copy16_async(float4* dst, const float* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src) : "memory");
}

__device__ __forceinline__ void commit_group() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Every group but the newest kDepth - 1 has landed.
__device__ __forceinline__ void wait_ring() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kDepth - 1) : "memory");
}

__device__ __forceinline__ float4 window4(float4 v, float4 w) {
  return make_float4(__fmul_rn(v.x, w.x), __fmul_rn(v.y, w.y), __fmul_rn(v.z, w.z),
                     __fmul_rn(v.w, w.w));
}

// lane's 4 products of one block with one float4 of P, k ascending, from 0
__device__ __forceinline__ float dot4(float4 v, float4 p) {
  return fmaf(v.w, p.w, fmaf(v.z, p.z, fmaf(v.y, p.y, fmaf(v.x, p.x, 0.f))));
}

template <bool kWindow, bool kStore>
__global__ void __launch_bounds__(kThreads, kCtasPerSm)
iir_force_kernel(const float* __restrict__ x, const float* __restrict__ window,
                 const float* __restrict__ p, int p_stride, int set_rows, int chans,
                 int x_stride, float* __restrict__ xw, float* __restrict__ f, int blocks) {
  __shared__ float4 rings[kWarps * kDepth * 32];  // [(warp * kDepth + stage) * 32 + lane]
  const int row = blockIdx.y;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int pos = blockIdx.x * kWarps + warp;  // the warp's block of each frame
  const int frames = blocks / kFrame;
  float4 pr[kM];  // pr[j] = P[j][4l .. 4l + 3] of the row's set
  const float4* pg = reinterpret_cast<const float4*>(p + size_t(row / set_rows) * p_stride);
#pragma unroll
  for (int j = 0; j < kM; ++j) pr[j] = __ldg(pg + j * (kL / 4) + lane);
  float4 w4 = make_float4(1.f, 1.f, 1.f, 1.f);
  if (kWindow) w4 = __ldg(reinterpret_cast<const float4*>(window + pos * kL) + lane);
  // The steps' rows are channel-major, row = c * set_rows + n; x's are
  // (n, c) (a shared design: chans = 1 and set_rows = rows, the same row).
  const int in_row = (row % set_rows) * chans + row / set_rows;
  const float* xg = x + size_t(in_row) * x_stride + pos * kL + 4 * lane;
  const size_t frame_stride = size_t(kFrame) * kL;
  float4* ring = rings + warp * kDepth * 32 + lane;
#pragma unroll
  for (int s = 0; s < kDepth - 1; ++s) {
    if (s < frames) copy16_async(ring + s * 32, xg + s * frame_stride);
    commit_group();
  }
  // lane's share of the result: terms j0 .. j0 + 2; lanes q < 3 store j0 + q
  const bool h16 = lane & 16, h8 = lane & 8;
  const int q = lane & 7;
  const int j0 = (h16 ? 6 : 0) + (h8 ? 3 : 0);

  for (int fr = 0; fr < frames; ++fr) {
    const int ahead = fr + kDepth - 1;
    if (ahead < frames)
      copy16_async(ring + (ahead & (kDepth - 1)) * 32, xg + size_t(ahead) * frame_stride);
    commit_group();
    wait_ring();
    float4 v = ring[(fr & (kDepth - 1)) * 32];
    if (kWindow) v = window4(v, w4);
    const size_t blk = size_t(row) * blocks + size_t(fr) * kFrame + pos;
    if (kStore) __stcs(reinterpret_cast<float4*>(xw + blk * kL) + lane, v);
    float acc[kM];
#pragma unroll
    for (int j = 0; j < kM; ++j) acc[j] = dot4(v, pr[j]);
    // stride 16: lanes with bit 4 keep terms 6 .. 11, the others 0 .. 5
    float s1[6];
#pragma unroll
    for (int j = 0; j < 6; ++j) {
      const float give = h16 ? acc[j] : acc[6 + j];
      s1[j] = (h16 ? acc[6 + j] : acc[j]) + __shfl_xor_sync(kAll, give, 16);
    }
    // stride 8: bit 3 keeps the upper 3 of the 6, then strides 4, 2, 1 whole
    float s2[3];
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      const float give = h8 ? s1[j] : s1[3 + j];
      s2[j] = (h8 ? s1[3 + j] : s1[j]) + __shfl_xor_sync(kAll, give, 8);
      s2[j] += __shfl_xor_sync(kAll, s2[j], 4);
      s2[j] += __shfl_xor_sync(kAll, s2[j], 2);
      s2[j] += __shfl_xor_sync(kAll, s2[j], 1);
    }
    if (q < 3) f[blk * kM + j0 + q] = q == 0 ? s2[0] : q == 1 ? s2[1] : s2[2];
  }
}

template <bool kWindow, bool kStore>
int launch(const float* x, const float* window, const float* p, int p_stride, int set_rows,
           int chans, int x_stride, float* xw, float* f, int rows, int blocks,
           cudaStream_t stream) {
  const dim3 grid(kFrame / kWarps, rows);
  iir_force_kernel<kWindow, kStore><<<grid, kThreads, 0, stream>>>(
      x, window, p, p_stride, set_rows, chans, x_stride, xw, f, blocks);
  return int(cudaGetLastError());
}

}  // namespace

extern "C" {

// xw (rows, blocks, 128) and f (rows, blocks, 12) from x, fp32, blocks a
// multiple of 128 (whole frames). Row r of the outputs reads row (r %
// set_rows) * chans + r / set_rows of x (rows of blocks * 128 floats,
// x_stride floats apart, a multiple of 4) and P (12, 128) of set r /
// set_rows, p_stride floats apart (0 for a design shared by every row). window (128 * 128), where not null, multiplies each frame;
// xw, where not null, takes the input as multiplied (a window needs it). x,
// window, p and xw 16-byte aligned, on the current device. Returns the CUDA
// error code of the launch (0 on success).
int tpu_sdr_iir_force(const float* x, const float* window, const float* p, int p_stride,
                      int set_rows, int chans, int x_stride, float* xw, float* f, int rows,
                      int blocks, void* stream) {
  if (rows <= 0 || blocks <= 0) return 0;
  if (blocks % kFrame || set_rows <= 0 || chans <= 0 || x_stride % 4 || (window && !xw))
    return int(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (window)
    return launch<true, true>(x, window, p, p_stride, set_rows, chans, x_stride, xw, f, rows,
                              blocks, s);
  if (xw)
    return launch<false, true>(x, window, p, p_stride, set_rows, chans, x_stride, xw, f, rows,
                               blocks, s);
  return launch<false, false>(x, window, p, p_stride, set_rows, chans, x_stride, xw, f, rows,
                              blocks, s);
}

}  // extern "C"
