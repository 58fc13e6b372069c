// The Q15 pipeline's device stage: [the RTL window,] the scaled 16-bit
// fixed-point FFT of the reference's xfft core and the magnitude of its
// wire words, on int16 frames.
//
// Replaces the device stage of tpu_sdr/runtime/q15.py (_window_fft,
// :121-153) and tpu_sdr/kernels/fft_q15.py fft_q15 (:149-207), which the
// JAX package runs as jitted XLA code (no Pallas kernel). Per frame of
// n = 2^m samples (n <= 16384):
//
//   window (with a ROM):  p = x * rom[i] (int32);
//                         x' = int16((p >> 15) + ((p >> 14) & 1))
//   m radix-2 DIF ranks:  half = n >> (t + 1); for each pair (a, b) half
//                         apart, j = the pair's offset in its group:
//     sum = sat16((a + b) >> s),  d = sat16((a - b) >> s)      (s = schedule[t])
//     p   = j == 0 ? d : sat16((d * W_n^(j << t)) >> 15)       (complex, Q15)
//   output:               re/im[k] = value[bitrev(k)] (int16), and
//                         |X|[k] = sqrt(re^2 + im^2) in fp32.
//
// Every value is saturated to int16 after every rank, so a frame lives in
// shared memory as int16 (re, im) pairs: 64 KB at n = 16384 (dynamic shared
// memory, opted in above 48 KB). One block of 1024 threads a frame; each
// rank is one pass over the n / 2 butterflies, in place, then a barrier.
// The twiddles are the host's plan_q15 tables (np round then clip), never
// recomputed here: rank 0's table W_n^e, e < n / 2, holds rank t's entry j
// at e = j << t. The two products of the complex multiply add in int32
// before the shift, as in the reference (|d| |w| < 2^15 sqrt(2) 2^15 <
// 2^31); right shifts of negative int32 are arithmetic. The magnitude is
// __fmul_rn / __fadd_rn / __fsqrt_rn, the plain version's operations, so
// nvcc contracts nothing into an FMA.
//
// What bounds it on an H100: it reads 2 bytes a sample and writes 8
// (re, im, |X|), 160 KB a frame at n = 16384, against about 14 x 15 integer
// operations a sample: bytes, 0.049 us a frame at 3.35 TB/s. This first
// version is one block a frame with a barrier a rank, so a launch of F <
// 132 frames uses F SMs; its times on the card are in PERF.md.

#include <cuda_runtime.h>
#include <stdint.h>

#include "error_string.cuh"

namespace {

constexpr int kThreads = 1024;
constexpr int kMaxLog2 = 14;

__device__ __forceinline__ int sat16(int v) { return min(max(v, -32768), 32767); }

__global__ void __launch_bounds__(kThreads)
q15_fft_kernel(const int16_t* __restrict__ x_re, const int16_t* __restrict__ x_im,
               const int16_t* __restrict__ rom, const short2* __restrict__ tw,
               const int* __restrict__ sched, int log2n, int16_t* __restrict__ out_re,
               int16_t* __restrict__ out_im, float* __restrict__ mag) {
  extern __shared__ short2 buf[];  // the frame, (re, im) int16 pairs
  const int n = 1 << log2n;
  const size_t base = size_t(blockIdx.x) * size_t(n);

  for (int i = threadIdx.x; i < n; i += kThreads) {
    int re = x_re[base + i];
    int im = x_im != nullptr ? x_im[base + i] : 0;
    if (rom != nullptr) {
      const int w = rom[i];
      const int pr = re * w;
      const int pi = im * w;
      re = int16_t((pr >> 15) + ((pr >> 14) & 1));  // wraps like the RTL's slice
      im = int16_t((pi >> 15) + ((pi >> 14) & 1));
    }
    buf[i] = make_short2(short(re), short(im));
  }
  __syncthreads();

  for (int t = 0; t < log2n; ++t) {
    const int s = sched[t];
    const int hb = log2n - 1 - t;  // half = 2^hb
    const int half = 1 << hb;
    for (int b = threadIdx.x; b < (n >> 1); b += kThreads) {
      const int j = b & (half - 1);
      const int ia = ((b >> hb) << (hb + 1)) | j;
      const int ib = ia | half;
      const short2 A = buf[ia];
      const short2 B = buf[ib];
      const int sr = sat16((int(A.x) + int(B.x)) >> s);
      const int si = sat16((int(A.y) + int(B.y)) >> s);
      const int dr = sat16((int(A.x) - int(B.x)) >> s);
      const int di = sat16((int(A.y) - int(B.y)) >> s);
      int pr = dr;
      int pi = di;
      if (j != 0) {
        const short2 w = tw[j << t];
        pr = sat16((dr * int(w.x) - di * int(w.y)) >> 15);
        pi = sat16((dr * int(w.y) + di * int(w.x)) >> 15);
      }
      buf[ia] = make_short2(short(sr), short(si));
      buf[ib] = make_short2(short(pr), short(pi));
    }
    __syncthreads();
  }

  for (int k = threadIdx.x; k < n; k += kThreads) {
    const short2 v = buf[__brev(unsigned(k)) >> (32 - log2n)];
    out_re[base + k] = v.x;
    out_im[base + k] = v.y;
    if (mag != nullptr) {
      const float fr = float(v.x);
      const float fi = float(v.y);
      mag[base + k] = __fsqrt_rn(__fadd_rn(__fmul_rn(fr, fr), __fmul_rn(fi, fi)));
    }
  }
}

}  // namespace

extern "C" {

// x_re, x_im (optional): (frames, 2^log2n) int16; rom (optional): (2^log2n,)
// int16, the window ROM; tw: (2^(log2n - 1), 2) int16, rank 0's Q15
// twiddles; sched: (log2n,) int32 shifts; out_re, out_im: (frames,
// 2^log2n) int16; mag (optional): (frames, 2^log2n) fp32. All contiguous,
// on the current device; 1 <= log2n <= 14. Returns the CUDA error code of
// the launch (0 on success).
int tpu_sdr_q15_fft(const int16_t* x_re, const int16_t* x_im, const int16_t* rom,
                    const void* tw, const int* sched, int16_t* out_re, int16_t* out_im,
                    float* mag, int frames, int log2n, void* stream) {
  if (frames <= 0) return 0;
  if (log2n < 1 || log2n > kMaxLog2) return int(cudaErrorInvalidValue);
  const int smem = int(sizeof(short2)) << log2n;
  cudaError_t err = cudaFuncSetAttribute(q15_fft_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return int(err);
  q15_fft_kernel<<<frames, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      x_re, x_im, rom, static_cast<const short2*>(tw), sched, log2n, out_re, out_im, mag);
  return int(cudaGetLastError());
}

}  // extern "C"
