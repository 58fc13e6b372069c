// Per-frame zero-state IIR summaries: the state that the composite 12th-order
// cascade reaches at the end of each windowed frame when it enters the frame
// at rest. One thread block per frame.
//
// Replaces the TPU kernel tpu_sdr/kernels/pallas/iir_fft.py iir_summaries
// (body _summaries_kernel: window, forcing xw @ PT, masked doubling scan,
// frame-end gather through V). Per frame: window the 16384 samples into
// shared memory, the forcing f = xw @ PT (128 blocks x 12 states), then the
// block chain from z = 0 (iir_blocks.cuh); out[frame] = the state after
// block 127. The fused two-pass pipeline chains these summaries from frame
// to frame (z_{f+1} = ALB z_f + w_f) to get each frame's entry state.
//
// What bounds it on an H100: the function reads 64 KB per frame and writes
// 48 bytes; its arithmetic (window, 0.39 MFLOP of forcing, 37 KFLOP of
// chain per frame) is far below the memory time at 3.35 TB/s, so its floor
// is the read. As written, the chain is a dependent sequence of 128 steps
// in one warp, long next to a frame's load and forcing, so the kernel is
// latency-bound: it keeps 76 KB of shared memory and at most 64 registers
// per thread so that two blocks share an SM and one block's loads and
// forcing overlap the other's chain. Its time on the card is in PERF.md.
//
// Shared memory (dynamic, 76 KiB): the windowed frame (64 KiB), PT
// (6 KiB), the forcing (6 KiB). IEEE fp32 throughout; a frame's result
// depends only on that frame.

#include "iir_blocks.cuh"

namespace {

using namespace tpu_sdr;

constexpr size_t kSmemBytes = (size_t(kN) + 2 * kBlocks * kM) * sizeof(float);

__global__ void __launch_bounds__(kThreads, 2)
iir_summaries_kernel(const float* __restrict__ x,
                     const float* __restrict__ win,
                     const float* __restrict__ pt,
                     const float* __restrict__ al1t,
                     float* __restrict__ out) {
  extern __shared__ __align__(16) float smem[];
  float* xs = smem;               // [block j][sample k], windowed
  float* pts = xs + kN;           // PT [k][a]
  float* f = pts + kN1 * kM;      // forcing [j][a]

  const int tid = threadIdx.x;
  for (int i = tid; i < kN1 * kM; i += kThreads) pts[i] = pt[i];
  load_frame(x + size_t(blockIdx.x) * kN, win, xs);
  __syncthreads();
  block_forcing(xs, pts, f);
  __syncthreads();
  if (tid < 32) {
    const float z = block_chain(al1t, f, 0.f, nullptr);
    if (tid < kM) out[size_t(blockIdx.x) * kM + tid] = z;
  }
}

}  // namespace

extern "C" {

// x: (frames, 16384) fp32, 16-byte aligned; win: (16384,) fp32;
// pt: (128, 12) fp32 = P^T; al1t: (12, 12) fp32 = AL^T;
// out: (frames, 12) fp32. All contiguous, on the current device.
// Returns the CUDA error code of the launch (0 on success).
int tpu_sdr_iir_summaries(const float* x, const float* win, const float* pt,
                          const float* al1t, float* out, int frames,
                          void* stream) {
  if (frames <= 0) return 0;
  return launch_frames(iir_summaries_kernel, kSmemBytes, frames,
                       static_cast<cudaStream_t>(stream), x, win, pt, al1t, out);
}

}  // extern "C"
