// Window + 16384-point four-step FFT + magnitude of real frames, one thread
// block per frame.
//
// Replaces the TPU kernel tpu_sdr/kernels/pallas/iir_fft.py
// spectrum_from_state (bypass=True form; body _spectrum_kernel -> _fft_mag,
// _cdots), and its half_spectrum=True bypass form: the kernel computes only
// rows k2 in [0, 64] and copies the mirrored bins, which is that form's
// function (below).
//
// What bounds it on an H100: the function (an FFT of a real frame and its
// magnitude, about 0.6 MFLOP a frame) reads 64 KB and writes 64 KB a frame
// (fp32); at 3.35 TB/s against 67 TFLOP/s fp32 its floor is memory
// traffic. Dense 128-point DFTs (25.2 MFLOP a frame) would be bound by the
// fp32 FMA rate instead; the radix FFTs of fft128.cuh do about 0.5 MFLOP a
// frame, so what is left is moving the bytes and keeping enough frames in
// flight to hide their latency:
//
// - No input staging: each thread loads its 16 rows of four consecutive
//   columns straight into registers (16-byte loads, a warp reads 512
//   contiguous bytes a row; 8-byte loads for bf16 input), times the window.
// - Real input, Hermitian column FFT: columns 2P and 2P + 1 are one complex
//   128-point FFT, Z = FFT(x[:, 2P] + i x[:, 2P+1]), split as
//   Y_2P[k] = (Z[k] + conj Z[-k]) / 2 and Y_2P+1[k] = (Z[k] - conj Z[-k]) / 2i,
//   and only rows k2 in [0, 64] are kept (Y[128 - k2] = conj Y[k2]). Stage
//   2's thread t takes c = t and 16 - t (t = 0: c = 0 and 8), so Z[k] and
//   Z[-k] meet in one thread: 9 rows for t = 0, 8 for the others.
// - Rows 0..63 run as lanes of the 8 warps (two rounds), row 64 in 8 lanes
//   of warp 0. The magnitudes go to shared memory in natural order, each
//   |Z[k2][k1]| with k2 in [1, 63] also at its mirror [127 - k1][128 - k2]
//   (|X[N - k]| = |X[k]|; a mirrored bin carries its partner's bits), and
//   leave as 16-byte stores rounded once to the output type.
// - Shared memory: the exchange buffer (32 KiB), the twiddled rows (65 x
//   130 complex, 66 KiB, the magnitudes over them) and the tables: 100 KiB,
//   two blocks (two frames) per SM; __launch_bounds__(256, 2) caps
//   registers at 128 a thread.
//
// IEEE fp32 at every precision tier. Each frame's result depends only on
// that frame: no atomics, a fixed order of operations, nothing shared
// between blocks, so the bits of a frame do not depend on how many frames a
// launch holds.

#include "fft128.cuh"

namespace {

using namespace tpu_sdr::fft128;
using tpu_sdr::kN;
using tpu_sdr::kN1;
using tpu_sdr::kN2;
using tpu_sdr::store4;

constexpr size_t kSmemBytes =
    size_t(kExchangeFloats + kRealRows * kRowStride + kTableFloats) * sizeof(float);

template <typename TIn, typename TOut>
__global__ void __launch_bounds__(kThreads, 2)
spectrum_bypass_kernel(const TIn* __restrict__ x,
                       const float* __restrict__ win,
                       const float* __restrict__ tab,
                       const float* __restrict__ twr,
                       const float* __restrict__ twi,
                       TOut* __restrict__ out) {
  extern __shared__ __align__(16) float smem[];
  float2* e = reinterpret_cast<float2*>(smem);  // [slot][lane]
  float* rows = smem + kExchangeFloats;         // T [k2][kRowStride], then |Z| [k1][k2]
  float* tabs = rows + kRealRows * kRowStride;
  const W128 wc{tabs, tabs + 128}, wr{tabs + 256, tabs + 384};
  const int w = threadIdx.x / kLanes;  // a in the column and row stage 1, t in stage 2
  const int lane = threadIdx.x % kLanes;
  const size_t base = size_t(blockIdx.x) * kN;

  load_tables(tab, tabs);
  // Rows n2 = w + 8b of columns 4*lane .. 4*lane + 3: pairs 2*lane, 2*lane + 1.
  float2 z0[16], z1[16];
#pragma unroll
  for (int b = 0; b < 16; ++b) {
    const int i = (w + 8 * b) * kN1 + 4 * lane;
    float v[4];
    load4(x + base, i, v);
    if (win != nullptr) {
      float wv[4];
      load4(win, i, wv);
#pragma unroll
      for (int q = 0; q < 4; ++q) v[q] *= wv[q];
    }
    z0[b] = make_float2(v[0], v[1]);
    z1[b] = make_float2(v[2], v[3]);
  }
  __syncthreads();  // tables
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
    store4(out + base, 4 * i, m);
  }
}

template <typename TIn, typename TOut>
int launch(const void* x, const float* win, const float* tab, const float* twr,
           const float* twi, void* out, int frames, cudaStream_t stream) {
  return tpu_sdr::fft128::launch_frames(spectrum_bypass_kernel<TIn, TOut>, kSmemBytes, frames,
                               stream, static_cast<const TIn*>(x), win, tab, twr, twi,
                               static_cast<TOut*>(out));
}

}  // namespace

extern "C" {

// x: (frames, 16384) fp32 or bf16, 16-byte aligned; win: (16384,) fp32 or
// null (no window); tab: (4, 128) fp32 = W_N2 row 1 re, im, W_N1 row 1 re,
// im (W128^j); twr, twi: (128, 128) fp32 twiddle planes [k2][n1]; out:
// (frames, 16384) fp32 or bf16. All contiguous, on the current device.
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
