// Window + 16384-point four-step DFT + magnitude, one thread block per frame.
//
// Replaces the TPU kernel tpu_sdr/kernels/pallas/iir_fft.py
// spectrum_from_state (bypass=True form; body _spectrum_kernel -> _fft_mag,
// _cdots). The DFT steps are those of four_step.cuh.
//
// What bounds it on an H100: the function (an FFT of a real frame and its
// magnitude, about 0.64 MFLOP per frame) takes less time in arithmetic
// than in its 64 KB read and 64 KB written (fp32), so its floor is memory
// traffic at 3.35 TB/s. As written here (the DFT as two dense 128x128
// products) a frame costs 2*128^3 real FMAs in step 1 and 4*128^3 in
// step 3, 25.2 MFLOP, about 40 times the FFT's count: at 67 TFLOP/s fp32
// on CUDA cores that is about 4 times the memory floor, so this kernel is
// bound by the rate of fp32 FMAs, well above the function's floor; a radix
// FFT is the way down. The design keeps everything else off the FMA path:
//
// - The frame (64 KB) and the twiddled intermediate (2 x 66 KB, padded
//   rows) stay in shared memory (198 KiB of dynamic shared memory, one block
//   per SM). Device memory sees each input byte once and each output byte
//   once.
// - The DFT matrices are four 128-entry tables in shared memory and each
//   thread works on a register tile (four_step.cuh).
//
// Arithmetic is IEEE fp32 with fp32 accumulation at every precision tier.
// Each frame's result depends only on that frame: no atomics, a fixed
// summation order, and nothing shared between blocks, so the bits of a
// frame do not depend on how many frames a launch holds.

#include "four_step.cuh"

namespace {

using namespace tpu_sdr;

constexpr size_t kSmemBytes =
    (size_t(kN) + kTwiddledFloats + kTableFloats) * sizeof(float);

template <typename TIn, typename TOut>
__global__ void __launch_bounds__(kThreads, 1)
spectrum_bypass_kernel(const TIn* __restrict__ x,
                       const float* __restrict__ win,
                       const float* __restrict__ tab,
                       const float* __restrict__ twr,
                       const float* __restrict__ twi,
                       TOut* __restrict__ out) {
  extern __shared__ __align__(16) float smem[];
  float* xs = smem;                  // [n2][n1], the windowed frame
  float* tr = xs + kN;               // [n1][kTStride], k2 fastest
  float* ti = tr + kN1 * kTStride;
  float* tabs = ti + kN1 * kTStride;

  const size_t base = size_t(blockIdx.x) * kN;
  load_tables(tab, tabs);
  load_frame(x + base, win, xs);
  __syncthreads();
  column_dft_twiddle<false>(xs, nullptr, w_n2(tabs), twr, twi, tr, ti);
  __syncthreads();
  row_dft_magnitude(tr, ti, w_n1(tabs), out + base);
}

template <typename TIn, typename TOut>
int launch(const void* x, const float* win, const float* tab, const float* twr,
           const float* twi, void* out, int frames, cudaStream_t stream) {
  return launch_frames(spectrum_bypass_kernel<TIn, TOut>, kSmemBytes, frames,
                       stream, static_cast<const TIn*>(x), win, tab, twr, twi,
                       static_cast<TOut*>(out));
}

}  // namespace

extern "C" {

// x: (frames, 16384) fp32 or bf16; win: (16384,) fp32 or null (no window);
// tab: (4, 128) fp32 = W_N2 row 1 re, im, W_N1 row 1 re, im;
// twr, twi: (128, 128) fp32 twiddle planes [k2][n1];
// out: (frames, 16384) fp32 or bf16. All contiguous, on the current device.
// Returns the CUDA error code of the launch (0 on success).
int tpu_sdr_spectrum_bypass(const void* x, int in_bf16, const float* win,
                            const float* tab, const float* twr,
                            const float* twi, void* out, int out_bf16,
                            int frames, void* stream) {
  if (frames <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (in_bf16) {
    return out_bf16
               ? launch<__nv_bfloat16, __nv_bfloat16>(x, win, tab, twr, twi, out, frames, s)
               : launch<__nv_bfloat16, float>(x, win, tab, twr, twi, out, frames, s);
  }
  return out_bf16 ? launch<float, __nv_bfloat16>(x, win, tab, twr, twi, out, frames, s)
                  : launch<float, float>(x, win, tab, twr, twi, out, frames, s);
}

}  // extern "C"
