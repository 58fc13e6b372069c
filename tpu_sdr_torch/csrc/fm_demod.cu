// FM demodulation: quadrature discriminator, deviation scale and one-pole
// de-emphasis over (channels, T) re/im planes, with the carried state
// (previous complex sample, filter state) of each channel.
//
// Replaces the TPU kernel tpu_sdr/kernels/pallas/affine_scan.py
// fm_demod_pallas (body _fm_kernel). Per sample n of a channel:
//
//   dot   = re[n] re[n-1] + im[n] im[n-1]
//   cross = im[n] re[n-1] - re[n] im[n-1]
//   audio = atan2(cross, dot) * (fs / 2pi) * (1 / dev)
//   y[n]  = a y[n-1] + (1 - a) audio            (de-emphasis, pole a)
//
// The atan2 is the reference's octant-reduced degree-17 polynomial
// (_atan2_poly), with the signs taken from the IEEE sign bits, so a
// zero-state first sample gives atan2(+-0, -0) = +-pi. The recurrence is
// solved as the reference solves it: inside each 128-sample block a
// Hillis-Steele prefix of the affine maps (A, B) (y_k = A_k y_in + B_k), then
// the sequential chain y_in[g+1] = A_last[g] y_in[g] + B_last[g] over the
// blocks of the channel in order, then y = A y_in + B.
//
// The TPU runs its grid in order and carries the chain in VMEM from one step
// to the next; Hopper blocks run in parallel, so the chain is a pass of its
// own, between two that are parallel over blocks:
//
//   pass 1 (one warp per 128-sample block, 4 samples a lane): the
//     discriminator and the block's tree; writes only (A_last, B_last),
//     8 bytes per block;
//   pass 2 (a 256-thread block per channel, affine_chain.cuh): the chain
//     over the channel's blocks in order, one lane walking maps that the
//     other warps stream through shared memory; writes each block's entry
//     state y_in and the carried state;
//   pass 3 (as pass 1): recomputes the discriminator and the tree, reads
//     y_in and writes y = A y_in + B.
//
// All three run in one launch (fm_fused_kernel): blocks take tickets in an
// order in which each waits only on blocks that hold earlier tickets (flags
// and counters with release / acquire at GPU scope), so a channel's walker
// starts once its first maps are stored and pass 3's tiles follow the
// walkers stage by stage. Without a pole only the discriminator runs (one
// pass).
//
// Every multiply and add is __fmul_rn / __fadd_rn / __fsub_rn, so nvcc does
// not contract them into FMAs: the arithmetic is the plain PyTorch version's
// (affine_scan.fm_demod_plain), operation for operation. A sample's result
// depends only on its channel's samples up to it, so it does not depend on
// how the stream is chunked, nor on how many channels share the launch.
//
// What bounds it on an H100: the function reads re and im and writes the
// audio, 12 bytes a sample, against about 57 fp32 operations a sample: it is
// bound by memory (0.030 ms at 8 channels x 2^20 samples). Pass 3 re-reads
// re/im (8 bytes a sample) rather than storing and reloading each sample's
// (A, B), which would cost 16. Pass 2 is a dependent sequence of one
// multiply and one add per block (8192 steps at 2^20 samples a channel):
// its floor is that latency, about 8 cycles a block (0.033-0.037 ms at
// 8192 blocks). Its times on the card are in PERF.md.

#include <cuda_runtime.h>
#include <stdint.h>

#include "affine_chain.cuh"
#include "error_string.cuh"

namespace {

constexpr int kL = 128;            // samples per affine block
constexpr int kWarps = 8;          // blocks (warps) per CTA
constexpr int kThreads = 32 * kWarps;
constexpr unsigned kFull = 0xffffffffu;

struct Scale {
  float k_hz;   // fs / (2 pi), rounded to fp32
  float k_dev;  // 1 / dev, rounded to fp32
  float a;      // the pole, rounded to fp32
  float oma;    // 1 - a in fp32
};

// atan(r) ~= r * P(r^2) on [0, 1]: the reference's degree-17 odd polynomial
// (affine_scan.py _ATAN_C), each coefficient rounded from double to fp32.
__device__ __forceinline__ float atan2_poly(float y, float x) {
  const float ax = fabsf(x);
  const float ay = fabsf(y);
  const float hi = fmaxf(ax, ay);
  const float lo = fminf(ax, ay);
  const float r = __fdiv_rn(lo, hi > 0.f ? hi : 1.f);
  const float r2 = __fmul_rn(r, r);
  float p = static_cast<float>(2.468246625e-03);
  p = __fadd_rn(__fmul_rn(p, r2), static_cast<float>(-1.445869707e-02));
  p = __fadd_rn(__fmul_rn(p, r2), static_cast<float>(3.989956004e-02));
  p = __fadd_rn(__fmul_rn(p, r2), static_cast<float>(-7.247950662e-02));
  p = __fadd_rn(__fmul_rn(p, r2), static_cast<float>(1.050731979e-01));
  p = __fadd_rn(__fmul_rn(p, r2), static_cast<float>(-1.416433338e-01));
  p = __fadd_rn(__fmul_rn(p, r2), static_cast<float>(1.998653749e-01));
  p = __fadd_rn(__fmul_rn(p, r2), static_cast<float>(-3.333265785e-01));
  p = __fadd_rn(__fmul_rn(p, r2), static_cast<float>(9.999999055e-01));
  float a = __fmul_rn(p, r);
  if (ay > ax) a = __fsub_rn(static_cast<float>(1.5707963267948966), a);
  if (__float_as_int(x) < 0) a = __fsub_rn(static_cast<float>(3.141592653589793), a);
  return __float_as_int(y) < 0 ? -a : a;
}

// The discriminator of one warp's block: lane l holds samples 4l .. 4l+3 of
// the block starting at base; prev is the sample before the block. Returns
// the scaled audio in v[0..3].
__device__ __forceinline__ void discriminate(const float* __restrict__ re,
                                             const float* __restrict__ im,
                                             size_t base, float prev_re,
                                             float prev_im, const Scale& s,
                                             float v[4]) {
  const int lane = threadIdx.x & 31;
  const float4 r4 = reinterpret_cast<const float4*>(re + base)[lane];
  const float4 i4 = reinterpret_cast<const float4*>(im + base)[lane];
  const float r[4] = {r4.x, r4.y, r4.z, r4.w};
  const float i[4] = {i4.x, i4.y, i4.z, i4.w};
  float r1 = __shfl_up_sync(kFull, r[3], 1);
  float i1 = __shfl_up_sync(kFull, i[3], 1);
  if (lane == 0) {
    r1 = prev_re;
    i1 = prev_im;
  }
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const float rp = j == 0 ? r1 : r[j - 1];
    const float ip = j == 0 ? i1 : i[j - 1];
    const float dot = __fadd_rn(__fmul_rn(r[j], rp), __fmul_rn(i[j], ip));
    const float cross = __fsub_rn(__fmul_rn(i[j], rp), __fmul_rn(r[j], ip));
    v[j] = __fmul_rn(__fmul_rn(atan2_poly(cross, dot), s.k_hz), s.k_dev);
  }
}

// The in-block Hillis-Steele prefix of y_k = a y_{k-1} + b_k over the 128
// samples of the warp's block: on entry B[j] = b of sample 4 lane + j, on
// exit (A[j], B[j]) with y_k = A[j] y_in + B[j]. Step d combines each
// element with the one d before it (identity maps before the block start):
// A, B <- A A_e, A B_e + B, the reference's roll-and-mask tree.
__device__ __forceinline__ void block_tree(float a, float A[4], float B[4]) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int j = 0; j < 4; ++j) A[j] = a;
#pragma unroll
  for (int s = 0; s < 7; ++s) {
    const int d = 1 << s;
    float Ae[4], Be[4];
    if (d < 4) {
      float upA[4], upB[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        upA[j] = __shfl_up_sync(kFull, A[j], 1);
        upB[j] = __shfl_up_sync(kFull, B[j], 1);
      }
      // element 4 lane + j - d: own register j - d, or register j - d + 4
      // of the lane before (both are (j - d) & 3)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int src = (j - d) & 3;
        Ae[j] = j >= d ? A[src] : upA[src];
        Be[j] = j >= d ? B[src] : upB[src];
      }
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        Ae[j] = __shfl_up_sync(kFull, A[j], d >> 2);
        Be[j] = __shfl_up_sync(kFull, B[j], d >> 2);
      }
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      if (4 * lane + j < d) {
        Ae[j] = 1.f;
        Be[j] = 0.f;
      }
      const float aj = A[j];
      A[j] = __fmul_rn(aj, Ae[j]);
      B[j] = __fadd_rn(__fmul_rn(aj, Be[j]), B[j]);
    }
  }
}

// Global block index of this warp, its channel and its block in the channel.
struct BlockPos {
  size_t gb;
  int c;
  int g;
  bool live;
};

__device__ __forceinline__ BlockPos block_pos(int channels, int blocks) {
  BlockPos p;
  p.gb = size_t(blockIdx.x) * kWarps + (threadIdx.x >> 5);
  p.live = p.gb < size_t(channels) * blocks;
  p.c = p.live ? int(p.gb / blocks) : 0;
  p.g = p.live ? int(p.gb % blocks) : 0;
  return p;
}

// The sample before block g of channel c: the carried one for g == 0.
__device__ __forceinline__ void prev_sample(const float* re, const float* im,
                                            const float* prev_re,
                                            const float* prev_im, size_t base,
                                            int c, int g, float* pr,
                                            float* pi) {
  if (g == 0) {
    *pr = prev_re[c];
    *pi = prev_im[c];
  } else {
    *pr = re[base - 1];
    *pi = im[base - 1];
  }
}

// No pole: audio = the scaled discriminator. The last block of each channel
// also writes the carried state (last sample; the filter state unchanged).
__global__ void __launch_bounds__(kThreads)
fm_disc_kernel(const float* __restrict__ re, const float* __restrict__ im,
               const float* __restrict__ prev_re,
               const float* __restrict__ prev_im, const float* __restrict__ y0,
               float* __restrict__ audio, float* __restrict__ prev_re_out,
               float* __restrict__ prev_im_out, float* __restrict__ filt_out,
               int channels, int blocks, Scale s) {
  const BlockPos p = block_pos(channels, blocks);
  if (!p.live) return;
  const size_t base = p.gb * kL;
  float pr, pi;
  prev_sample(re, im, prev_re, prev_im, base, p.c, p.g, &pr, &pi);
  float v[4];
  discriminate(re, im, base, pr, pi, s, v);
  const int lane = threadIdx.x & 31;
  reinterpret_cast<float4*>(audio + base)[lane] = make_float4(v[0], v[1], v[2], v[3]);
  if (p.g == blocks - 1 && lane == 31) {
    prev_re_out[p.c] = re[base + kL - 1];
    prev_im_out[p.c] = im[base + kL - 1];
    filt_out[p.c] = y0[p.c];
  }
}

// The final affine map (A_last, B_last) of block g of channel c (one warp).
__device__ __forceinline__ void map_block(const float* __restrict__ re,
                                          const float* __restrict__ im,
                                          const float* __restrict__ prev_re,
                                          const float* __restrict__ prev_im,
                                          float2* __restrict__ ab, size_t gb, int c, int g,
                                          const Scale& s) {
  const size_t base = gb * kL;
  float pr, pi;
  prev_sample(re, im, prev_re, prev_im, base, c, g, &pr, &pi);
  float A[4], B[4];
  discriminate(re, im, base, pr, pi, s, B);
#pragma unroll
  for (int j = 0; j < 4; ++j) B[j] = __fmul_rn(s.oma, B[j]);
  block_tree(s.a, A, B);
  if ((threadIdx.x & 31) == 31) ab[gb] = make_float2(A[3], B[3]);
}

// y = A y_in + B for the 128 samples of block g of channel c (one warp).
__device__ __forceinline__ void emit_block(const float* __restrict__ re,
                                           const float* __restrict__ im,
                                           const float* __restrict__ prev_re,
                                           const float* __restrict__ prev_im, float y,
                                           float* __restrict__ audio, size_t gb, int c, int g,
                                           const Scale& s) {
  const size_t base = gb * kL;
  float pr, pi;
  prev_sample(re, im, prev_re, prev_im, base, c, g, &pr, &pi);
  float A[4], B[4];
  discriminate(re, im, base, pr, pi, s, B);
#pragma unroll
  for (int j = 0; j < 4; ++j) B[j] = __fmul_rn(s.oma, B[j]);
  block_tree(s.a, A, B);
  float out[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) out[j] = __fadd_rn(__fmul_rn(A[j], y), B[j]);
  reinterpret_cast<float4*>(audio + base)[threadIdx.x & 31] =
      make_float4(out[0], out[1], out[2], out[3]);
}

// The carried state of channel c after the chain: its last sample and the
// filter state y.
__device__ __forceinline__ void carried_state(const float* __restrict__ re,
                                              const float* __restrict__ im, int c, int blocks,
                                              float y, float* __restrict__ prev_re_out,
                                              float* __restrict__ prev_im_out,
                                              float* __restrict__ filt_out) {
  const size_t last = (size_t(c) + 1) * blocks * kL - 1;
  filt_out[c] = y;
  prev_re_out[c] = re[last];
  prev_im_out[c] = im[last];
}

// ---- The three passes in one launch.
//
// Every block takes a ticket from a counter (zeroed before the launch) and
// does the work of that ticket: for each channel in turn, its map tiles
// (kTileBlocks blocks of pass 1 each) and then its walker (pass 2); after
// all channels, the emit tiles (pass 3), block-major over the channels. A
// map tile publishes a flag when its maps are stored; the walker's helpers
// wait on the flags of the maps they load; the walker publishes how many
// entry states are stored; an emit tile waits for its blocks' entry states.
// Every wait is on a ticket that an earlier block holds, and map tiles never
// wait, so every awaited block is running and the launch cannot deadlock,
// however few blocks fit on the card at once.

constexpr int kTileBlocks = 64;  // 128-sample blocks of a map or emit tile
static_assert(affine_chain::kChunk % kTileBlocks == 0, "a stage holds whole map tiles");
static_assert(affine_chain::kChunk / kTileBlocks <= affine_chain::kHelpers,
              "a helper waits on one tile's flag");
static_assert(kThreads == affine_chain::kThreads, "a fused block can be a walker");

// Polls before a wait gives up and traps: a wait that never ends is a bug,
// and a trap turns it into a launch error instead of a hung card.
constexpr long long kMaxPolls = 1LL << 26;

__device__ __forceinline__ int load_acquire(const int* p) {
  int v;
  asm volatile("ld.acquire.gpu.global.s32 %0, [%1];\n" : "=r"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void store_release(int* p, int v) {
  asm volatile("st.release.gpu.global.s32 [%0], %1;\n" ::"l"(p), "r"(v) : "memory");
}

// Wait until *p >= want.
__device__ __forceinline__ void wait_at_least(const int* p, int want) {
  unsigned ns = 32;
  for (long long polls = 0; load_acquire(p) < want; ++polls) {
    if (polls > kMaxPolls) __trap();
    __nanosleep(ns);
    ns = ns < 256 ? 2 * ns : ns;
  }
}

// The walker's hooks: its helpers wait on the flags of the map tiles they
// load, and thread 32 publishes the stored entry states.
struct FusedHooks {
  const int* flags;  // the channel's map tile flags
  int* progress;     // the channel's stored entry states
  __device__ void wait_maps(int lo, int hi) const {
    const int first = lo / kTileBlocks;
    const int h = threadIdx.x - 32;
    if (first + h <= (hi - 1) / kTileBlocks) wait_at_least(flags + first + h, 1);
    affine_chain::helpers_sync();
  }
  __device__ void stored(int count) const {
    if (threadIdx.x == 32) {
      __threadfence();
      store_release(progress, count);
    }
  }
};

__global__ void __launch_bounds__(kThreads, 4)
fm_fused_kernel(const float* __restrict__ re, const float* __restrict__ im,
                const float* __restrict__ prev_re, const float* __restrict__ prev_im,
                const float* __restrict__ y0, float* __restrict__ audio,
                float* __restrict__ prev_re_out, float* __restrict__ prev_im_out,
                float* __restrict__ filt_out, float2* __restrict__ ab,
                float* __restrict__ y_in, int* __restrict__ sync, int channels, int blocks,
                Scale s) {
  __shared__ affine_chain::Stages st;
  __shared__ int ticket;
  const int tid = threadIdx.x;
  if (tid == 0) ticket = atomicAdd(sync, 1);
  __syncthreads();
  const int id = ticket;
  const int tiles = (blocks + kTileBlocks - 1) / kTileBlocks;  // map (or emit) tiles a channel
  int* progress = sync + 1;                                     // [channels]
  int* flags = sync + 1 + channels;                             // [channels][tiles]
  const int w = tid >> 5;
  if (id < channels * (tiles + 1)) {
    const int c = id / (tiles + 1);
    const int j = id % (tiles + 1);
    if (j == tiles) {  // the walker of channel c
      const FusedHooks hooks{flags + size_t(c) * tiles, progress + c};
      const float y = affine_chain::walk_chain(ab + size_t(c) * blocks,
                                               y_in + size_t(c) * blocks, blocks, y0[c], st,
                                               hooks);
      if (tid == 0) carried_state(re, im, c, blocks, y, prev_re_out, prev_im_out, filt_out);
    } else {  // map tile j of channel c
      for (int g = j * kTileBlocks + w; g < min(blocks, (j + 1) * kTileBlocks); g += kWarps)
        map_block(re, im, prev_re, prev_im, ab, size_t(c) * blocks + g, c, g, s);
      __syncthreads();
      if (tid == 0) {
        __threadfence();
        store_release(flags + size_t(c) * tiles + j, 1);
      }
    }
  } else {  // emit tile j of channel c
    const int e = id - channels * (tiles + 1);
    const int j = e / channels;
    const int c = e % channels;
    const int end = min(blocks, (j + 1) * kTileBlocks);
    if (tid == 0) wait_at_least(progress + c, end);
    __syncthreads();
    for (int g = j * kTileBlocks + w; g < end; g += kWarps) {
      const size_t gb = size_t(c) * blocks + g;
      emit_block(re, im, prev_re, prev_im, __ldcg(y_in + gb), audio, gb, c, g, s);
    }
  }
}

}  // namespace

extern "C" {

// re, im: (channels, blocks * 128) fp32, 16-byte aligned; prev_re, prev_im,
// y0: (channels,) fp32; audio: (channels, blocks * 128) fp32, 16-byte
// aligned; prev_re_out, prev_im_out, filt_out: (channels,) fp32. Scratch
// (null without a pole): ab (channels * blocks * 2,) fp32, y_in (channels *
// blocks,) fp32 and sync (1 + channels * (1 + blocks),) int32, of which the
// launch zeroes the prefix it uses on the stream first. k_hz = fs / (2 pi),
// k_dev = 1 / dev, pole and one_minus_pole as fp32; has_pole 0 skips the
// de-emphasis. All contiguous, on the current device. Returns the CUDA error
// code of the launch (0 on success).
int tpu_sdr_fm_demod(const float* re, const float* im, const float* prev_re,
                     const float* prev_im, const float* y0, float* audio,
                     float* prev_re_out, float* prev_im_out, float* filt_out,
                     float* ab, float* y_in, int* sync, int channels, int blocks,
                     float k_hz, float k_dev, float pole, float one_minus_pole,
                     int has_pole, void* stream) {
  if (channels <= 0 || blocks <= 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Scale s{k_hz, k_dev, pole, one_minus_pole};
  const size_t total = size_t(channels) * blocks;
  const unsigned grid = unsigned((total + kWarps - 1) / kWarps);
  if (!has_pole) {
    fm_disc_kernel<<<grid, kThreads, 0, st>>>(re, im, prev_re, prev_im, y0,
                                              audio, prev_re_out, prev_im_out,
                                              filt_out, channels, blocks, s);
    return int(cudaGetLastError());
  }
  const size_t tiles = (size_t(blocks) + kTileBlocks - 1) / kTileBlocks;
  const cudaError_t err = cudaMemsetAsync(sync, 0, (1 + channels * (1 + tiles)) * sizeof(int), st);
  if (err != cudaSuccess) return int(err);
  fm_fused_kernel<<<unsigned(channels * (2 * tiles + 1)), kThreads, 0, st>>>(
      re, im, prev_re, prev_im, y0, audio, prev_re_out, prev_im_out, filt_out,
      reinterpret_cast<float2*>(ab), y_in, sync, channels, blocks, s);
  return int(cudaGetLastError());
}

}  // extern "C"
