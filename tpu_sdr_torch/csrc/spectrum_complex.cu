// Complex (IQ) input: window + 16384-point complex four-step FFT +
// magnitude, one thread block per frame.
//
// Replaces the TPU kernel tpu_sdr/kernels/pallas/iir_fft.py
// spectrum_mag_complex (body _spectrum_complex_kernel).
//
// What bounds it on an H100: the function (a complex FFT and its magnitude,
// about 1.2 MFLOP a frame) reads 128 KB and writes 64 KB a frame (fp32); at
// 3.35 TB/s against 67 TFLOP/s fp32 its floor is memory traffic. Dense
// 128-point DFTs (33.6 MFLOP a frame) would be bound by the fp32 FMA rate
// instead; the radix FFTs of fft128.cuh do about 1 MFLOP a frame, so what
// is left is moving the bytes with enough frames in flight to hide their
// latency. That needs two blocks per SM, and a complex fp32 frame (128 KiB)
// does not fit twice in an SM's shared memory, nor does its twiddled
// intermediate (another 128 KiB). So:
//
// - The column FFTs read their inputs straight from device memory into
//   registers, in four rounds of 32 columns, one column a lane: each warp
//   load reads 128 contiguous bytes of a row of one plane. (Four columns a
//   lane, for 16-byte loads, would hold 64 complex inputs a thread; the
//   bytes moved are the same.)
// - Half of the twiddled intermediate lives in shared memory and half in
//   registers: stage 2's thread t takes c = t and t + 8; rows k2 = t + 16d
//   (k2 mod 16 < 8) go to shared memory, rows k2 = t + 8 + 16d stay in the
//   thread (8 complex a round, 64 floats; once the exchange buffer is free,
//   half of them wait there, so that the row FFTs do not spill). The row
//   FFTs run on the first half; the held half is then written over the rows
//   and transformed. The first half's magnitudes go to the exchange buffer,
//   the second's over the rows' first 32 KiB.
// - The magnitudes leave in natural order as 16-byte stores, rounded once to
//   the output type.
// - Shared memory: the exchange buffer (32 KiB), 64 rows of 130 complex
//   (65 KiB) and the tables: 99 KiB, two blocks (two frames) per SM;
//   __launch_bounds__(256, 2) caps registers at 128 a thread.
//
// IEEE fp32 throughout; a frame's result depends only on that frame.

#include "fft128.cuh"

namespace {

using namespace tpu_sdr::fft128;
using tpu_sdr::kN;
using tpu_sdr::kN1;
using tpu_sdr::kN2;
using tpu_sdr::store4;

constexpr int kHalfRows = kN2 / 2;  // rows k2 with k2 mod 16 in one half of [0, 16)
constexpr size_t kSmemBytes =
    size_t(kExchangeFloats + kHalfRows * kRowStride + kTableFloats) * sizeof(float);

// Row FFTs of the 64 rows held in `rows` (row r is k2 = (r mod 8) + 8h +
// 16 (r / 8) of half h): m0, m1 = |Z[k2][t + 8v]| of rows lane, lane + 32.
// Synchronises the block between the two stages.
__device__ __forceinline__ void half_row_ffts(float* rows, W128 w, int t, int lane,
                                              float (&m0)[16], float (&m1)[16]) {
  row_stage1(rows + lane * kRowStride, t, w);
  row_stage1(rows + (lane + 32) * kRowStride, t, w);
  __syncthreads();
  row_stage2(rows + lane * kRowStride, t, w, m0);
  row_stage2(rows + (lane + 32) * kRowStride, t, w, m1);
}

__device__ __forceinline__ void put_half(float* mag, int t, int lane, const float (&m0)[16],
                                         const float (&m1)[16]) {
#pragma unroll
  for (int v = 0; v < 16; ++v) {
    mag[(t + 8 * v) * kHalfRows + lane] = m0[v];
    mag[(t + 8 * v) * kHalfRows + lane + 32] = m1[v];
  }
}

template <typename TIn, typename TOut>
__global__ void __launch_bounds__(kThreads, 2)
spectrum_complex_kernel(const TIn* __restrict__ xr,
                        const TIn* __restrict__ xi,
                        const float* __restrict__ win,
                        const float* __restrict__ tab,
                        const float* __restrict__ twr,
                        const float* __restrict__ twi,
                        TOut* __restrict__ out) {
  extern __shared__ __align__(16) float smem[];
  float2* e = reinterpret_cast<float2*>(smem);  // [slot][lane]; then |Z| of half 0
  float* rows = smem + kExchangeFloats;         // [r][kRowStride]; then |Z| of half 1
  float* tabs = rows + kHalfRows * kRowStride;
  const W128 wc{tabs, tabs + 128}, wr{tabs + 256, tabs + 384};
  const int w = threadIdx.x / kLanes;
  const int lane = threadIdx.x % kLanes;
  const size_t base = size_t(blockIdx.x) * kN;

  load_tables(tab, tabs);
  float2 held[4][8];  // twiddled Y[w + 8 + 16d][32q + lane]
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const int n1 = 32 * q + lane;
    float2 v[16];
#pragma unroll
    for (int b = 0; b < 16; ++b) {
      const int i = (w + 8 * b) * kN1 + n1;
      float re = load1(xr + base, i), im = load1(xi + base, i);
      if (win != nullptr) {
        const float wv = win[i];
        re *= wv;
        im *= wv;
      }
      v[b] = make_float2(re, im);
    }
    __syncthreads();  // the tables (q = 0); the last round's exchange reads
    column_stage1(v, w, wc);
    exchange_store(e, v, w, lane);
    __syncthreads();
    float2 za[8], zb[8];
    column_stage2(e, w, lane, wc, za);
    column_stage2(e, w + 8, lane, wc, zb);
#pragma unroll
    for (int d = 0; d < 8; ++d) {
      const float2 t = twiddle(za[d], twr, twi, w + 16 * d, n1);
      *reinterpret_cast<float2*>(rows + (w + 8 * d) * kRowStride + 2 * n1) = t;
      held[q][d] = twiddle(zb[d], twr, twi, w + 8 + 16 * d, n1);
    }
  }
  __syncthreads();

  // Rounds 2 and 3 of the held rows wait in the exchange buffer, each
  // thread's own slots (threadIdx.x fastest), so that the row FFTs of the
  // first half do not spill registers.
  float2* parked = e;
#pragma unroll
  for (int q = 2; q < 4; ++q)
#pragma unroll
    for (int d = 0; d < 8; ++d) parked[((q - 2) * 8 + d) * kThreads + threadIdx.x] = held[q][d];
  float m0[16], m1[16];
  half_row_ffts(rows, wr, w, lane, m0, m1);
  __syncthreads();  // every read of the first half's rows done
#pragma unroll
  for (int q = 0; q < 4; ++q)
#pragma unroll
    for (int d = 0; d < 8; ++d)
      *reinterpret_cast<float2*>(rows + (w + 8 * d) * kRowStride + 2 * (32 * q + lane)) =
          q < 2 ? held[q][d] : parked[((q - 2) * 8 + d) * kThreads + threadIdx.x];
  __syncthreads();  // every parked value read
  float* mag0 = smem;  // over the exchange buffer
  put_half(mag0, w, lane, m0, m1);
  half_row_ffts(rows, wr, w, lane, m0, m1);
  __syncthreads();
  float* mag1 = rows;
  put_half(mag1, w, lane, m0, m1);
  __syncthreads();
  // out[128 k1 + k2], k2 = c + 16d: |Z| at [k1][(c mod 8) + 8d] of half c / 8.
#pragma unroll
  for (int r = 0; r < kN / 4 / kThreads; ++r) {
    const int i = threadIdx.x + r * kThreads;
    const int k1 = i / (kN2 / 4);
    const int k2 = 4 * (i % (kN2 / 4));
    const float* half = (k2 & 8) ? mag1 : mag0;
    const float4 v = *reinterpret_cast<const float4*>(half + k1 * kHalfRows + (k2 & 7) +
                                                      8 * (k2 / 16));
    const float m[4] = {v.x, v.y, v.z, v.w};
    store4(out + base, 4 * i, m);
  }
}

template <typename TIn, typename TOut>
int launch(const void* xr, const void* xi, const float* win, const float* tab,
           const float* twr, const float* twi, void* out, int frames,
           cudaStream_t stream) {
  return tpu_sdr::fft128::launch_frames(spectrum_complex_kernel<TIn, TOut>, kSmemBytes, frames,
                               stream, static_cast<const TIn*>(xr),
                               static_cast<const TIn*>(xi), win, tab, twr, twi,
                               static_cast<TOut*>(out));
}

}  // namespace

extern "C" {

// xr, xi: (frames, 16384) fp32 or bf16 (both the same type), 16-byte
// aligned; win: (16384,) fp32 or null (no window); tab, twr, twi: the DFT
// constants of spectrum_bypass; out: (frames, 16384) fp32 or bf16. All
// contiguous, on the current device. Returns the CUDA error code of the
// launch (0 on success).
int tpu_sdr_spectrum_complex(const void* xr, const void* xi, int in_bf16,
                             const float* win, const float* tab,
                             const float* twr, const float* twi, void* out,
                             int out_bf16, int frames, void* stream) {
  if (frames <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (in_bf16) {
    return out_bf16
               ? launch<__nv_bfloat16, __nv_bfloat16>(xr, xi, win, tab, twr, twi, out, frames, s)
               : launch<__nv_bfloat16, float>(xr, xi, win, tab, twr, twi, out, frames, s);
  }
  return out_bf16 ? launch<float, __nv_bfloat16>(xr, xi, win, tab, twr, twi, out, frames, s)
                  : launch<float, float>(xr, xi, win, tab, twr, twi, out, frames, s);
}

}  // extern "C"
