// Window + composite 12th-order IIR from a per-frame entry state + the
// 16384-point four-step FFT + magnitude, one thread block per frame.
//
// Replaces the TPU kernel tpu_sdr/kernels/pallas/iir_fft.py
// spectrum_from_state (bypass=False form; body _spectrum_kernel with
// _masked_scan), and its half_spectrum=True IIR form (the FFT below keeps
// rows k2 in [0, 64] and copies the mirrored bins). Per frame, from its
// entry state z_start (the fused two-pass pipeline gets it from
// iir_summaries and the frame chain), the
// composite IIR of iir_blocks.cuh (iir_frame_radix: window, Toeplitz
// zero-state response, forcing, block chain, state injection), then the
// radix FFT and magnitude of y as spectrum_bypass.cu computes them for a
// real frame (fft128.cuh: Hermitian column pairs, rows k2 0..64, the mirror
// assembled in shared memory, 16-byte natural-order stores). y never leaves
// shared memory; its columns are read from there into registers.
//
// What bounds it on an H100: the function (window, a 12th-order IIR at
// about 54 FLOP per sample as six biquads, an FFT and the magnitude) needs
// less time in arithmetic than its 64 KB read and 64 KB written per frame,
// so its floor is memory traffic. As written, the blocked IIR does more
// work than six biquads: the Toeplitz product (about 1.3 M FMAs a frame
// once the zeros above the diagonal are skipped), the forcing and the
// injection (0.2 M FMAs each) on CUDA cores, and the block chain, 128
// dependent 12 x 12 mat-vecs in warp 0, which the other warps overlap with
// their share of the Toeplitz product. The radix FFT adds about 0.5 MFLOP.
//
// Shared memory (dynamic, 100 KiB: two blocks, two frames, per SM, so one
// frame's block chain overlaps the other's FFT; __launch_bounds__(256, 2)
// caps registers at 128): the FFT's exchange buffer (32 KiB), twiddled rows
// (66 KiB) and tables (2 KiB); during the IIR, y (64 KiB) and the IIR's
// scratch (25 KiB) overlay the exchange buffer and the rows. IEEE fp32
// throughout; a frame's result depends only on that frame and its entry
// state.

#include "fft128.cuh"
#include "iir_blocks.cuh"

namespace {

using namespace tpu_sdr::fft128;
using tpu_sdr::iir_frame_radix;
using tpu_sdr::kIirScratchFloats;
using tpu_sdr::kM;
using tpu_sdr::kN;
using tpu_sdr::kN1;
using tpu_sdr::kN2;
using tpu_sdr::kRadixThreads;
using tpu_sdr::store4;

constexpr int kFftFloats = kExchangeFloats + kRealRows * kRowStride;
constexpr size_t kSmemBytes = size_t(kFftFloats + kTableFloats) * sizeof(float);
static_assert(kN + kIirScratchFloats <= kFftFloats,
              "y and the IIR scratch overlay the exchange buffer and the rows");
static_assert(kRadixThreads == kThreads, "one block runs the IIR and the radix FFT");

template <typename TOut>
__global__ void __launch_bounds__(kThreads, 2)
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
  float2* e = reinterpret_cast<float2*>(smem);  // [slot][lane]
  float* rows = smem + kExchangeFloats;         // T [k2][kRowStride], then |Z| [k1][k2]
  float* tabs = smem + kFftFloats;
  float* ys = smem;                             // y [n2][n1], until the columns are read
  const W128 wc{tabs, tabs + 128}, wr{tabs + 256, tabs + 384};
  const int w = threadIdx.x / kLanes;  // a in the column and row stage 1, t in stage 2
  const int lane = threadIdx.x % kLanes;
  const size_t frame = blockIdx.x;

  load_tables(tab, tabs);
  iir_frame_radix(x + frame * kN, zs + frame * kM, win, h, pt, mt, al1t, ys, ys + kN);
  // Rows n2 = w + 8b of columns 4*lane .. 4*lane + 3: pairs 2*lane, 2*lane + 1.
  float2 z0[16], z1[16];
#pragma unroll
  for (int b = 0; b < 16; ++b) {
    const float4 v = *reinterpret_cast<const float4*>(ys + (w + 8 * b) * kN1 + 4 * lane);
    z0[b] = make_float2(v.x, v.y);
    z1[b] = make_float2(v.z, v.w);
  }
  __syncthreads();  // every read of y is done: the exchange buffer and rows overlay it
  column_stage1(z0, w, wc);
  exchange_store(e, z0, w, lane);
  column_stage1(z1, w, wc);
  __syncthreads();
  column_pair_rows(e, rows, twr, twi, w, lane, 4 * lane, wc);
  __syncthreads();  // every read of the first pair's slots done
  exchange_store(e, z1, w, lane);
  __syncthreads();
  column_pair_rows(e, rows, twr, twi, w, lane, 4 * lane + 2, wc);
  __syncthreads();

  const bool row64 = w == 0 && lane < 8;  // row 64: a' (stage 1) and t (stage 2) = lane
  row_stage1(rows + lane * kRowStride, w, wr);
  row_stage1(rows + (lane + 32) * kRowStride, w, wr);
  if (row64) row_stage1(rows + 64 * kRowStride, lane, wr);
  __syncthreads();
  float m0[16], m1[16], m2[16];
  row_stage2(rows + lane * kRowStride, w, wr, m0);
  row_stage2(rows + (lane + 32) * kRowStride, w, wr, m1);
  if (row64) row_stage2(rows + 64 * kRowStride, lane, wr, m2);
  __syncthreads();  // the magnitudes overlay the rows
  float* mag = rows;
  put_magnitudes(mag, lane, w, m0);
  put_magnitudes(mag, lane + 32, w, m1);
  if (row64) {
#pragma unroll
    for (int v = 0; v < 16; ++v) mag[(lane + 8 * v) * kN2 + kN2 / 2] = m2[v];
  }
  __syncthreads();
#pragma unroll
  for (int r = 0; r < kN / 4 / kThreads; ++r) {
    const int i = threadIdx.x + r * kThreads;
    const float4 v = reinterpret_cast<const float4*>(mag)[i];
    const float m[4] = {v.x, v.y, v.z, v.w};
    store4(out + frame * kN, 4 * i, m);
  }
}

template <typename TOut>
int launch(const float* x, const float* zs, const float* win, const float* h,
           const float* pt, const float* mt, const float* al1t,
           const float* tab, const float* twr, const float* twi, void* out,
           int frames, cudaStream_t stream) {
  return tpu_sdr::fft128::launch_frames(spectrum_iir_kernel<TOut>, kSmemBytes, frames, stream,
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
