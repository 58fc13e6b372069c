// The half spectrum of a real frame: window (optional) and, in the IIR
// form, the composite 12th-order IIR from the frame's entry state, then the
// 16384-point four-step DFT of rows k2 in [0, 64] only, the magnitude, and
// the mirror |X[N - k]| = |X[k]|; natural-order output. One thread block
// per frame.
//
// Replaces the TPU kernel tpu_sdr/kernels/pallas/iir_fft.py
// spectrum_from_state with half_spectrum=True (both bypass forms; body
// _spectrum_kernel's `half` branch, the half-row plan planes w2r_h ... and
// the in-kernel mirror). Steps (four_step.cuh):
//
//   1-2. column DFTs of rows 0..63 as 2 x 8 register tiles, row 64 one
//        column per thread; twiddled into tr/ti [n1][k2]
//   3.   row DFTs of those 65 rows; |Z[k2][k1]| into the frame's shared
//        memory in natural order, each value with k2 in [1, 63] also at
//        its mirror [127 - k1][128 - k2]
//   4.   the frame from shared memory to out, rounded once to the output
//        type, so a mirrored bin has its partner's bits in fp32 and bf16.
//
// The mirror crosses rows (127 - k1), so the whole frame's magnitudes are
// assembled in shared memory before the store; the input frame's 64 KiB
// hold them (the frame is dead after step 1).
//
// What bounds it on an H100: as spectrum_bypass.cu, the function's floor
// is its bytes (64 KB read and 64 KB written a frame, fp32); the dense DFT
// of 65 rows is 65/128 of step 1 and of step 3, about half of the full
// kernel's FMAs, so the kernel is bound by the rate of fp32 FMAs. Row 64
// run in the first 128 threads only (one column or one k1 each) while the
// others wait at the next barrier. Shared memory as spectrum_iir.cu (198
// KiB, one block per SM). IEEE fp32; a frame's result depends only on that
// frame (and its entry state).

#include "iir_blocks.cuh"

namespace {

using namespace tpu_sdr;

constexpr size_t kSmemBytes =
    (size_t(kN) + kTwiddledFloats + kTableFloats) * sizeof(float);
static_assert(kIirScratchFloats <= kTwiddledFloats,
              "the IIR scratch must fit in the twiddled planes");

template <bool kIIR, typename TIn, typename TOut>
__global__ void __launch_bounds__(kThreads, 1)
spectrum_half_kernel(const TIn* __restrict__ x,
                     const float* __restrict__ zs,
                     const float* __restrict__ win,
                     const float* __restrict__ h,
                     const float* __restrict__ pt,
                     const float* __restrict__ mt,
                     const float* __restrict__ al1t,
                     const float* __restrict__ tab,
                     const float* __restrict__ twr,
                     const float* __restrict__ twi,
                     TOut* __restrict__ out) {
  extern __shared__ __align__(16) float smem[];
  float* xs = smem;                  // [n2][n1] the frame, then the magnitudes
  float* tr = xs + kN;               // [n1][kTStride], k2 fastest
  float* ti = tr + kN1 * kTStride;
  float* tabs = ti + kN1 * kTStride;

  const size_t frame = blockIdx.x;
  load_tables(tab, tabs);
  if constexpr (kIIR) {
    iir_frame(x + frame * kN, zs + frame * kM, win, h, pt, mt, al1t, xs, tr);
  } else {
    load_frame(x + frame * kN, win, xs);
    __syncthreads();
  }
  column_dft_twiddle_half(xs, w_n2(tabs), twr, twi, tr, ti);
  column_dft_twiddle_row(xs, w_n2(tabs), twr, twi, tr, ti, kN2 / 2);
  __syncthreads();
  row_dft_half_magnitude(tr, ti, w_n1(tabs), xs);
  __syncthreads();
  store_frame(xs, out + frame * kN);
}

template <bool kIIR, typename TIn, typename TOut>
int launch(const void* x, const float* zs, const float* win, const float* h,
           const float* pt, const float* mt, const float* al1t,
           const float* tab, const float* twr, const float* twi, void* out,
           int frames, cudaStream_t stream) {
  return launch_frames(spectrum_half_kernel<kIIR, TIn, TOut>, kSmemBytes,
                       frames, stream, static_cast<const TIn*>(x), zs, win, h,
                       pt, mt, al1t, tab, twr, twi, static_cast<TOut*>(out));
}

}  // namespace

extern "C" {

// x: (frames, 16384) fp32 or bf16 (fp32 only with zs), 16-byte aligned;
// zs: (frames, 12) fp32 entry states, or null for the bypass form (no IIR);
// win: (16384,) fp32 or null (no window); h, pt, mt, al1t: the IIR
// constants of spectrum_iir (unused and may be null without zs); tab, twr,
// twi: the DFT constants of spectrum_bypass; out: (frames, 16384) fp32 or
// bf16. All contiguous, on the current device. Returns the CUDA error code
// of the launch (0 on success), or cudaErrorInvalidValue for bf16 input
// with zs.
int tpu_sdr_spectrum_half(const void* x, int in_bf16, const float* zs,
                          const float* win, const float* h, const float* pt,
                          const float* mt, const float* al1t,
                          const float* tab, const float* twr,
                          const float* twi, void* out, int out_bf16,
                          int frames, void* stream) {
  if (frames <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  using bf16 = __nv_bfloat16;
  if (zs != nullptr) {
    if (in_bf16) return int(cudaErrorInvalidValue);
    return out_bf16
               ? launch<true, float, bf16>(x, zs, win, h, pt, mt, al1t, tab, twr, twi, out, frames, s)
               : launch<true, float, float>(x, zs, win, h, pt, mt, al1t, tab, twr, twi, out, frames, s);
  }
  if (in_bf16) {
    return out_bf16
               ? launch<false, bf16, bf16>(x, zs, win, h, pt, mt, al1t, tab, twr, twi, out, frames, s)
               : launch<false, bf16, float>(x, zs, win, h, pt, mt, al1t, tab, twr, twi, out, frames, s);
  }
  return out_bf16
             ? launch<false, float, bf16>(x, zs, win, h, pt, mt, al1t, tab, twr, twi, out, frames, s)
             : launch<false, float, float>(x, zs, win, h, pt, mt, al1t, tab, twr, twi, out, frames, s);
}

}  // extern "C"
