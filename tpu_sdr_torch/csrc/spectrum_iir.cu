// Window + composite 12th-order IIR from a per-frame entry state + the
// 16384-point four-step DFT + magnitude, one thread block per frame.
//
// Replaces the TPU kernel tpu_sdr/kernels/pallas/iir_fft.py
// spectrum_from_state (bypass=False form; body _spectrum_kernel with
// _masked_scan). Per frame, from its entry state z_start (the fused
// two-pass pipeline gets it from iir_summaries and the frame chain), the
// composite IIR of iir_blocks.cuh (iir_frame: window, Toeplitz
// zero-state response, forcing, block chain, state injection), then the DFT
// and magnitude of y (four_step.cuh), natural order. y never leaves shared
// memory.
//
// What bounds it on an H100: the function (window, a 12th-order IIR at
// about 54 FLOP per sample as six biquads, an FFT and the magnitude) needs
// less time in arithmetic than its 64 KB read and 64 KB written per frame,
// so its floor is memory traffic. As written, the dense DFT (2 + 4 x 128^3
// FMAs) and the Toeplitz product (128^3 FMAs, zeros above the diagonal
// included) make it bound by the rate of fp32 FMAs, as spectrum_bypass.cu
// is, plus the block chain: 128 dependent steps in warp 0, which the other
// 15 warps overlap with their share of the Toeplitz product. Warp 0 starts
// its own share only after the chain, so the chain's latency stays on each
// frame's critical path; its time on the card is in PERF.md.
//
// Shared memory (dynamic, 198 KiB, one block per SM): the frame (64 KiB),
// which the block overwrites with y; the twiddled planes (132 KiB), which
// hold the IIR's scratch until y is complete: the impulse response h padded
// with 128 zeros in front (1 KiB, T[i][k] = h[i - k] for i >= k), PT, MT,
// the forcing and z_in (6 KiB each); the DFT tables (2 KiB). IEEE fp32
// throughout; a frame's result depends only on that frame and its entry
// state.

#include "iir_blocks.cuh"

namespace {

using namespace tpu_sdr;

constexpr size_t kSmemBytes =
    (size_t(kN) + kTwiddledFloats + kTableFloats) * sizeof(float);
static_assert(kIirScratchFloats <= kTwiddledFloats,
              "the IIR scratch must fit in the twiddled planes");

template <typename TOut>
__global__ void __launch_bounds__(kThreads, 1)
spectrum_iir_kernel(const float* __restrict__ x,
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
  float* xs = smem;                  // [j][k] the windowed frame, then y
  float* tr = xs + kN;               // [n1][kTStride], k2 fastest
  float* ti = tr + kN1 * kTStride;
  float* tabs = ti + kN1 * kTStride;

  const size_t frame = blockIdx.x;
  load_tables(tab, tabs);
  // The IIR's scratch lies in tr/ti, free until step 2 of the DFT.
  iir_frame(x + frame * kN, zs + frame * kM, win, h, pt, mt, al1t, xs, tr);
  column_dft_twiddle<false>(xs, nullptr, w_n2(tabs), twr, twi, tr, ti);
  __syncthreads();
  row_dft_magnitude(tr, ti, w_n1(tabs), out + frame * kN);
}

template <typename TOut>
int launch(const float* x, const float* zs, const float* win, const float* h,
           const float* pt, const float* mt, const float* al1t,
           const float* tab, const float* twr, const float* twi, void* out,
           int frames, cudaStream_t stream) {
  return launch_frames(spectrum_iir_kernel<TOut>, kSmemBytes, frames, stream,
                       x, zs, win, h, pt, mt, al1t, tab, twr, twi,
                       static_cast<TOut*>(out));
}

}  // namespace

extern "C" {

// x: (frames, 16384) fp32, 16-byte aligned; zs: (frames, 12) fp32 entry
// states; win: (16384,) fp32 or null (no window); h: (128,) fp32 impulse
// response (column 0 of the plan's Toeplitz T); pt: (128, 12) = P^T;
// mt: (12, 128) = M^T; al1t: (12, 12) = AL^T; tab, twr, twi: the DFT
// constants of spectrum_bypass; out: (frames, 16384) fp32 or bf16. All
// contiguous fp32, on the current device. Returns the CUDA error code of
// the launch (0 on success).
int tpu_sdr_spectrum_iir(const float* x, const float* zs, const float* win,
                         const float* h, const float* pt, const float* mt,
                         const float* al1t, const float* tab,
                         const float* twr, const float* twi, void* out,
                         int out_bf16, int frames, void* stream) {
  if (frames <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return out_bf16
             ? launch<__nv_bfloat16>(x, zs, win, h, pt, mt, al1t, tab, twr, twi, out, frames, s)
             : launch<float>(x, zs, win, h, pt, mt, al1t, tab, twr, twi, out, frames, s);
}

}  // extern "C"
