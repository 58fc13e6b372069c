// Window + 16384-point four-step DFT + magnitude with the caller's plan
// planes, on the tensor cores with fp32 operands split into three bf16
// pieces.
//
// Replaces the TPU kernel tpu_sdr/kernels/pallas/spectrum.py fft_mag_fused
// (body _spectrum_kernel): per frame, xw = x * win viewed as [n2][n1],
//
//   1. Y = W2 xw               Yr = W2r xw, Yi = W2i xw (xw real)
//   2. T = Y * tw              elementwise, fp32
//   3. Z = T W1^T              complex
//   4. out[k1][k2] = |Z[k2][k1]|
//
// The kernel computes with the six (128, 128) planes it is given, whatever
// their values: no DFT structure is assumed (planes scaled by 0.5 give
// |X| / 8), so its work is two dense complex 128 x 128 x 128 products a
// frame, 25.2 MFLOP, and the function's bytes bound (64 KB in and out a
// frame) is out of reach for arbitrary planes.
//
// Precision: each fp32 operand a is split in registers into bf16 pieces
// a = a0 + a1 + a2 (a0 = bf16(a), a1 = bf16(a - a0), a2 = bf16(a - a0 - a1);
// the subtractions are exact), 24 significant bits. A product a.b takes the
// six piece products with i + j <= 2 (the TPU's precision="highest"), each
// exact in fp32, as mma.sync m16n8k16 bf16 with fp32 accumulation, smallest
// first: a2b0, a1b1, a0b2, a1b0, a0b1, a0b0. Each k-step of 16 is summed
// into a fresh accumulator and added to the running fp32 sum with one IEEE
// add, so the tensor cores' own rounding inside an MMA acts on one k-step's
// partial sum only. The twiddle and magnitude are IEEE fp32 operations
// (__fmul_rn etc.: no contraction into FMAs), as the plain version computes
// them. tests/test_torch_split_precision.py is the NumPy model of this
// arithmetic.
//
// Design (one 256-thread block per SM, persistent over frames; a frame's
// result depends only on that frame and the order of operations is fixed per
// element, so its bits do not depend on how many frames a launch holds):
//
// - The frame, times the window, goes through an fp32 staging area into
//   shared memory as B fragments of step 1, split into three pieces and
//   stored in fragment order (a lane reads its 16 bytes: no bank conflicts).
// - Step 1: warp w computes Y for rows k2 in [16w, 16w + 16) over all 128 n1
//   (Yr, Yi: 128 fp32 accumulators a lane); its A fragments (rows of W2r,
//   W2i) come from device memory (L2) once a frame, split in registers.
// - Step 2: the accumulators, twiddled in registers, are the A fragments of
//   step 3 (the C layout of an m16n8 pair is the A layout of one m16k16), so
//   each lane splits its own values and stores them, in fragment order, to
//   shared memory (192 KiB for the three pieces of Tr and Ti). The twiddles
//   come from L2 into shared memory by cp.async during step 1, each lane's
//   own, so that all blocks do not fetch them in one burst after it.
// - Step 3: warp w computes Z for k1 in [16w, 16w + 16) over all 128 k2
//   (128 accumulators); its B fragments (rows of W1, [k1][n1] row-major is
//   the column-major B) come from L2 once a frame, split in registers; the A
//   fragments of every warp's T come from shared memory. Meanwhile the
//   block's next frame is prefetched into L2.
// - Step 4: |Z| into shared memory as [k1][k2], then 16-byte coalesced
//   stores in natural order.
//
// What bounds it on an H100: the tensor cores. Six bf16 passes of 25.2 MFLOP
// a frame (151 MFLOP) at 989 TFLOP/s give 0.078 ms at 512 frames; mma.sync
// reaches a fraction of that peak. Shared memory (dynamic): 224 KiB, one
// block per SM; up to 255 registers a thread.

#include <cuda_runtime.h>
#include <stdint.h>

#include "error_string.cuh"
#include "split_bf16.cuh"

namespace {

using split_bf16::add4;
using split_bf16::kPieces;
using split_bf16::mma;
using split_bf16::mma6;
using split_bf16::split_frag;
using split_bf16::split_pair;

constexpr int kN1 = 128;
constexpr int kN = kN1 * kN1;
constexpr int kThreads = 256;  // 8 warps
constexpr int kStage = 132;  // row stride (floats) of the fp32 staging areas
// Shared memory (16-byte units): T pieces [piece][re/im][m-tile][k-step][lane];
// the xw pieces [piece][k-step][n-tile pair][lane] over its first half; the
// fp32 frame staging [n2][kStage] after them; |Z| [k1][kStage] at the start;
// the twiddles, copied during step 1 (tw_slot), in T slots that step 1 leaves
// free and a region [warp][k-step][lane] after the T pieces.
constexpr int kTSlots = kPieces * 2 * 8 * 8 * 32;
constexpr int kXSlots = kPieces * 8 * 8 * 32;
constexpr size_t kSmemBytes = size_t(kTSlots + 8 * 8 * 32) * 16;
static_assert(kXSlots * 16 + kN1 * kStage * 4 <= int(kSmemBytes), "staging fits beside the xw pieces");

// mma6 of two products into one accumulator, interleaved: at each of the
// six steps, a's product and then c's.
__device__ __forceinline__ void mma6x2(float (&acc)[4], const uint32_t (&a)[kPieces][4],
                                       const uint32_t (&b0)[kPieces],
                                       const uint32_t (&b1)[kPieces],
                                       const uint32_t (&c)[kPieces][4],
                                       const uint32_t (&d0)[kPieces],
                                       const uint32_t (&d1)[kPieces]) {
  mma(acc, a[2], b0[0], b1[0]);
  mma(acc, c[2], d0[0], d1[0]);
  mma(acc, a[1], b0[1], b1[1]);
  mma(acc, c[1], d0[1], d1[1]);
  mma(acc, a[0], b0[2], b1[2]);
  mma(acc, c[0], d0[2], d1[2]);
  mma(acc, a[1], b0[0], b1[0]);
  mma(acc, c[1], d0[0], d1[0]);
  mma(acc, a[0], b0[1], b1[1]);
  mma(acc, c[0], d0[1], d1[1]);
  mma(acc, a[0], b0[0], b1[0]);
  mma(acc, c[0], d0[0], d1[0]);
}

// The fp32 A fragment of rows r0, r0 + 8 and columns c0 + {0, 1}, c0 + 8 +
// {0, 1} of a row-major (128, 128) plane, as four float2.
__device__ __forceinline__ void load_frag(const float* __restrict__ m, int r0, int c0,
                                          float2 (&v)[4]) {
  v[0] = __ldg(reinterpret_cast<const float2*>(m + r0 * kN1 + c0));
  v[1] = __ldg(reinterpret_cast<const float2*>(m + (r0 + 8) * kN1 + c0));
  v[2] = __ldg(reinterpret_cast<const float2*>(m + r0 * kN1 + c0 + 8));
  v[3] = __ldg(reinterpret_cast<const float2*>(m + (r0 + 8) * kN1 + c0 + 8));
}

// 8 bytes from device to shared memory, through no register (cp.async).
__device__ __forceinline__ void copy8_async(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(d), "l"(src) : "memory");
}

// This thread's cp.async copies are complete and visible to it.
__device__ __forceinline__ void wait_async() { asm volatile("cp.async.wait_all;\n" ::: "memory"); }

__device__ __forceinline__ void prefetch_l2(const void* p) {
  asm volatile("prefetch.global.L2 [%0];\n" ::"l"(p));
}

// Slot of chunk c (< 4) of lane's twiddles for k-step s of warp w's step 2:
// chunks 0-2 are T slots (piece, re/im) = (1, im), (2, re), (2, im) of the
// same (w, s, lane), which step 1 leaves free and step 2 overwrites only
// after this lane has read them; chunk 3 lies past the T pieces.
__device__ __forceinline__ int tw_slot(int c, int w, int s, int lane) {
  return c < 3 ? (((3 + c) * 8 + w) * 8 + s) * 32 + lane : kTSlots + (w * 8 + s) * 32 + lane;
}

// The twiddles of step 2's A fragments q < 4 of k-step s (rows r0 + 8 (q &
// 1), columns 16 s + 8 (q >> 1) + c0 + {0, 1}) from L2 into this lane's
// chunks: twr of q = 0, 1 | twr of q = 2, 3 | twi of q = 0, 1 | twi of q = 2, 3.
__device__ __forceinline__ void stage_twiddles(const float* __restrict__ twr,
                                               const float* __restrict__ twi, uint4* smem,
                                               int w, int s, int lane) {
  const int r0 = 16 * w + (lane >> 2), c0 = 2 * (lane & 3);
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const int off = (r0 + 8 * (q & 1)) * kN1 + 16 * s + 8 * (q >> 1) + c0;
    float2* re = reinterpret_cast<float2*>(smem + tw_slot(q >> 1, w, s, lane)) + (q & 1);
    float2* im = reinterpret_cast<float2*>(smem + tw_slot(2 + (q >> 1), w, s, lane)) + (q & 1);
    copy8_async(re, twr + off);
    copy8_async(im, twi + off);
  }
}

__global__ void __launch_bounds__(kThreads, 1)
fft_mag_fused_kernel(const float* __restrict__ x,
                     const float* __restrict__ win,
                     const float* __restrict__ w2r,
                     const float* __restrict__ w2i,
                     const float* __restrict__ twr,
                     const float* __restrict__ twi,
                     const float* __restrict__ w1r,
                     const float* __restrict__ w1i,
                     float* __restrict__ out, int frames) {
  extern __shared__ __align__(16) uint4 smem[];
  uint4* tp = smem;                                         // T pieces
  uint4* xp = smem;                                         // xw pieces
  float* stage = reinterpret_cast<float*>(smem + kXSlots);  // the windowed frame [n2][kStage]
  float* mag = reinterpret_cast<float*>(smem);              // |Z| [k1][kStage]
  const int tid = threadIdx.x;
  const int w = tid >> 5;
  const int lane = tid & 31;
  const int gid = lane >> 2;  // fragment row (A, C) or column (B)
  const int tig = lane & 3;   // fragment column pair (A, C) or row pair (B)

  for (int f = blockIdx.x; f < frames; f += gridDim.x) {
    const size_t base = size_t(f) * kN;
    // The frame times the window into the staging area, 16 bytes a thread
    // (unrolled: every load is in flight before the first store).
#pragma unroll
    for (int r = 0; r < kN / 4 / kThreads; ++r) {
      const int i = tid + r * kThreads;
      float4 v = __ldg(reinterpret_cast<const float4*>(x + base) + i);
      const float4 u = __ldg(reinterpret_cast<const float4*>(win) + i);
      v.x *= u.x; v.y *= u.y; v.z *= u.z; v.w *= u.w;
      *reinterpret_cast<float4*>(stage + (i >> 5) * kStage + 4 * (i & 31)) = v;
    }
    __syncthreads();
    // xw pieces as step 1's B fragments: slot (s, pair jp, lane L) holds, per
    // piece, b01 and b23 of n-tiles 2jp and 2jp + 1: xw[16s + 2 tig + {0, 1}
    // (+8)][8 nt + gid].
#pragma unroll 2
    for (int r = 0; r < 8 * 8 * 32 / kThreads; ++r) {
      const int slot = tid + r * kThreads;
      const int L = slot & 31, jp = (slot >> 5) & 7, s = slot >> 8;
      const int n2 = 16 * s + 2 * (L & 3);
      uint32_t wd[4][kPieces];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int n1 = 8 * (2 * jp + (q >> 1)) + (L >> 2);
        const int row = n2 + 8 * (q & 1);
        split_pair(stage[row * kStage + n1], stage[(row + 1) * kStage + n1], wd[q]);
      }
#pragma unroll
      for (int k = 0; k < kPieces; ++k)
        xp[(k * 8 + s) * 8 * 32 + (slot & 255)] = make_uint4(wd[0][k], wd[1][k], wd[2][k], wd[3][k]);
    }
    __syncthreads();

    // Step 1: Y[16w + ..][all n1], 16 n-tiles.
    float yr[16][4], yi[16][4];
#pragma unroll
    for (int j = 0; j < 16; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c) yr[j][c] = yi[j][c] = 0.f;
    float2 raw_r[4], raw_i[4];
    load_frag(w2r, 16 * w + gid, 2 * tig, raw_r);
    load_frag(w2i, 16 * w + gid, 2 * tig, raw_i);
#pragma unroll 1
    for (int s = 0; s < 8; ++s) {
      uint32_t ar[kPieces][4], ai[kPieces][4];
      split_frag(raw_r, ar);
      split_frag(raw_i, ai);
      if (s < 7) {
        load_frag(w2r, 16 * w + gid, 16 * (s + 1) + 2 * tig, raw_r);
        load_frag(w2i, 16 * w + gid, 16 * (s + 1) + 2 * tig, raw_i);
      }
      // Step 2's twiddles, spread over step 1: had every block fetched them
      // at once after it, L2 would serve 132 x 128 KiB in one burst.
      stage_twiddles(twr, twi, smem, w, s, lane);
#pragma unroll
      for (int jp = 0; jp < 8; ++jp) {
        uint32_t b[4][kPieces];  // b01, b23 of n-tile 2jp, then of 2jp + 1
#pragma unroll
        for (int k = 0; k < kPieces; ++k) {
          const uint4 v = xp[((k * 8 + s) * 8 + jp) * 32 + lane];
          b[0][k] = v.x; b[1][k] = v.y; b[2][k] = v.z; b[3][k] = v.w;
        }
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          float t[4] = {0.f, 0.f, 0.f, 0.f};
          mma6(t, ar, b[2 * h], b[2 * h + 1]);
          add4(yr[2 * jp + h], t);
          float u[4] = {0.f, 0.f, 0.f, 0.f};
          mma6(u, ai, b[2 * h], b[2 * h + 1]);
          add4(yi[2 * jp + h], u);
        }
      }
    }
    __syncthreads();  // every warp is done with the xw pieces: T overlays them

    // Step 2: twiddle, split, store as step 3's A fragments (m-tile w).
    wait_async();  // this lane's twiddle chunks; no other lane reads them
#pragma unroll
    for (int s = 0; s < 8; ++s) {
      float2 twa[4], twb[4];  // twr, twi at the elements of fragment q
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const float4 vr = *reinterpret_cast<const float4*>(smem + tw_slot(c, w, s, lane));
        const float4 vi = *reinterpret_cast<const float4*>(smem + tw_slot(2 + c, w, s, lane));
        twa[2 * c] = make_float2(vr.x, vr.y);
        twa[2 * c + 1] = make_float2(vr.z, vr.w);
        twb[2 * c] = make_float2(vi.x, vi.y);
        twb[2 * c + 1] = make_float2(vi.z, vi.w);
      }
      uint32_t tr[4][kPieces], ti[4][kPieces];  // a01, a23, a45, a67
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int nt = 2 * s + (q >> 1);
        const int hi = q & 1;  // rows + 8: c2, c3
        const float2 a = twa[q];
        const float2 bb = twb[q];
        const float y0r = yr[nt][2 * hi], y1r = yr[nt][2 * hi + 1];
        const float y0i = yi[nt][2 * hi], y1i = yi[nt][2 * hi + 1];
        split_pair(__fsub_rn(__fmul_rn(y0r, a.x), __fmul_rn(y0i, bb.x)),
                   __fsub_rn(__fmul_rn(y1r, a.y), __fmul_rn(y1i, bb.y)), tr[q]);
        split_pair(__fadd_rn(__fmul_rn(y0r, bb.x), __fmul_rn(y0i, a.x)),
                   __fadd_rn(__fmul_rn(y1r, bb.y), __fmul_rn(y1i, a.y)), ti[q]);
      }
#pragma unroll
      for (int k = 0; k < kPieces; ++k) {
        tp[(((k * 2 + 0) * 8 + w) * 8 + s) * 32 + lane] =
            make_uint4(tr[0][k], tr[1][k], tr[2][k], tr[3][k]);
        tp[(((k * 2 + 1) * 8 + w) * 8 + s) * 32 + lane] =
            make_uint4(ti[0][k], ti[1][k], ti[2][k], ti[3][k]);
      }
    }
    __syncthreads();

    // Step 3: Z[all k2][k1 in 16w + ..], n-tiles 2w and 2w + 1.
    float zr[8][2][4], zi[8][2][4];
#pragma unroll
    for (int m = 0; m < 8; ++m)
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int c = 0; c < 4; ++c) zr[m][h][c] = zi[m][h][c] = 0.f;
    // B fragments of W1 rows k1 = 16w + 8h + gid: columns 16s + 2tig + {0,
    // 1} (b01) and + 8 (b23), re and im; as load_frag's v[0], v[2] (h = 0)
    // and v[1], v[3] (h = 1).
    float2 braw_r[4], braw_i[4];
    load_frag(w1r, 16 * w + gid, 2 * tig, braw_r);
    load_frag(w1i, 16 * w + gid, 2 * tig, braw_i);
    // The block's next frame into L2 meanwhile (2 lines a thread): every
    // block stages its frame at the same time, which DRAM alone would serve
    // as one burst.
    if (f + int(gridDim.x) < frames) {
      const float* next = x + size_t(f + gridDim.x) * kN + tid * 64;
      prefetch_l2(next);
      prefetch_l2(next + 32);
    }
#pragma unroll 1
    for (int s = 0; s < 8; ++s) {
      uint32_t br[2][2][kPieces], bi[2][2][kPieces];  // [h][b01, b23][piece]
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        split_pair(braw_r[h].x, braw_r[h].y, br[h][0]);
        split_pair(braw_r[h + 2].x, braw_r[h + 2].y, br[h][1]);
        split_pair(braw_i[h].x, braw_i[h].y, bi[h][0]);
        split_pair(braw_i[h + 2].x, braw_i[h + 2].y, bi[h][1]);
      }
      if (s < 7) {
        load_frag(w1r, 16 * w + gid, 16 * (s + 1) + 2 * tig, braw_r);
        load_frag(w1i, 16 * w + gid, 16 * (s + 1) + 2 * tig, braw_i);
      }
#pragma unroll
      for (int m = 0; m < 8; ++m) {
        uint32_t ar[kPieces][4], ai[kPieces][4];
#pragma unroll
        for (int k = 0; k < kPieces; ++k) {
          const uint4 vr = tp[(((k * 2 + 0) * 8 + m) * 8 + s) * 32 + lane];
          const uint4 vi = tp[(((k * 2 + 1) * 8 + m) * 8 + s) * 32 + lane];
          ar[k][0] = vr.x; ar[k][1] = vr.y; ar[k][2] = vr.z; ar[k][3] = vr.w;
          ai[k][0] = vi.x; ai[k][1] = vi.y; ai[k][2] = vi.z; ai[k][3] = vi.w;
        }
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          float p[4] = {0.f, 0.f, 0.f, 0.f};  // Tr W1r^T
          float q[4] = {0.f, 0.f, 0.f, 0.f};  // Ti W1i^T
          float t[4] = {0.f, 0.f, 0.f, 0.f};  // Tr W1i^T + Ti W1r^T
          mma6(p, ar, br[h][0], br[h][1]);
          mma6(q, ai, bi[h][0], bi[h][1]);
          mma6x2(t, ar, bi[h][0], bi[h][1], ai, br[h][0], br[h][1]);
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            zr[m][h][c] = __fadd_rn(zr[m][h][c], __fsub_rn(p[c], q[c]));
            zi[m][h][c] = __fadd_rn(zi[m][h][c], t[c]);
          }
        }
      }
    }
    __syncthreads();  // every warp is done with T: |Z| overlays it

    // Step 4: |Z[k2][k1]| into mag[k1][k2], then natural-order stores.
#pragma unroll
    for (int m = 0; m < 8; ++m)
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int k2 = 16 * m + gid + 8 * (c >> 1);
          const int k1 = 16 * w + 8 * h + 2 * tig + (c & 1);
          mag[k1 * kStage + k2] = __fsqrt_rn(
              __fadd_rn(__fmul_rn(zr[m][h][c], zr[m][h][c]), __fmul_rn(zi[m][h][c], zi[m][h][c])));
        }
    __syncthreads();
#pragma unroll 4
    for (int r = 0; r < kN / 4 / kThreads; ++r) {
      const int i = tid + r * kThreads;
      reinterpret_cast<float4*>(out + base)[i] =
          *reinterpret_cast<const float4*>(mag + (i >> 5) * kStage + 4 * (i & 31));
    }
    // The next frame's staging area lies beyond mag, and its xw pieces are
    // written only after the barrier that follows the staging.
  }
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
  int device = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(fft_mag_fused_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               int(kSmemBytes));
  if (err != cudaSuccess) return int(err);
  const int blocks = frames < sms ? frames : sms;
  fft_mag_fused_kernel<<<blocks, kThreads, kSmemBytes, static_cast<cudaStream_t>(stream)>>>(
      x, win, w2r, w2i, twr, twi, w1r, w1i, out, frames);
  return int(cudaGetLastError());
}

}  // extern "C"
