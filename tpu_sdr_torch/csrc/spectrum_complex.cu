// Complex (IQ) input: window + 16384-point complex four-step DFT +
// magnitude, one thread block per frame.
//
// Replaces the TPU kernel tpu_sdr/kernels/pallas/iir_fft.py
// spectrum_mag_complex (body _spectrum_complex_kernel). Per frame the re and
// im planes are windowed (optional) into shared memory, the column DFT is
// the full complex product (four FMAs per term instead of the real input's
// two), and twiddle, row DFT and magnitude are those of four_step.cuh,
// stored in natural order.
//
// What bounds it on an H100: the function (a complex FFT and its magnitude,
// about 1.2 MFLOP per frame) reads 128 KB and writes 64 KB per frame (fp32);
// its floor is memory traffic at 3.35 TB/s. As written, the dense DFT is
// 4 x 128^3 FMAs in each step, about 1.33 times the real-input kernel's
// work, so the kernel is bound by the rate of fp32 FMAs.
//
// Shared memory (dynamic, 134 KiB, one block per SM): the two input planes
// (2 x 64 KiB) and the twiddled planes (2 x 66 KiB) do not fit side by
// side, so the twiddled planes overlay the input planes. The column DFT's
// results stay in registers (a 4 x 8 complex tile per thread) until every
// thread has read the planes; column_dft_twiddle<true> synchronises the
// block before it stores over them. Then the DFT tables (2 KiB). IEEE fp32
// throughout; a frame's result depends only on that frame.

#include "four_step.cuh"

namespace {

using namespace tpu_sdr;

constexpr int kPlaneFloats = kTwiddledFloats > 2 * kN ? kTwiddledFloats : 2 * kN;
constexpr size_t kSmemBytes = (size_t(kPlaneFloats) + kTableFloats) * sizeof(float);

template <typename TIn, typename TOut>
__global__ void __launch_bounds__(kThreads, 1)
spectrum_complex_kernel(const TIn* __restrict__ xr,
                        const TIn* __restrict__ xi,
                        const float* __restrict__ win,
                        const float* __restrict__ tab,
                        const float* __restrict__ twr,
                        const float* __restrict__ twi,
                        TOut* __restrict__ out) {
  extern __shared__ __align__(16) float smem[];
  float* xrs = smem;                 // [n2][n1] windowed re plane
  float* xis = smem + kN;            // [n2][n1] windowed im plane
  float* tr = smem;                  // [n1][kTStride], over the planes
  float* ti = smem + kN1 * kTStride;
  float* tabs = smem + kPlaneFloats;

  const size_t base = size_t(blockIdx.x) * kN;
  load_tables(tab, tabs);
  load_frame(xr + base, win, xrs);
  load_frame(xi + base, win, xis);
  __syncthreads();
  column_dft_twiddle<true>(xrs, xis, w_n2(tabs), twr, twi, tr, ti);
  __syncthreads();
  row_dft_magnitude(tr, ti, w_n1(tabs), out + base);
}

template <typename TIn, typename TOut>
int launch(const void* xr, const void* xi, const float* win, const float* tab,
           const float* twr, const float* twi, void* out, int frames,
           cudaStream_t stream) {
  return launch_frames(spectrum_complex_kernel<TIn, TOut>, kSmemBytes, frames,
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
