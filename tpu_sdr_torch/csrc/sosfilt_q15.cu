// The Q15 pipeline's all-device filter: the RTL window (optional) and the
// saturating integer SOS cascade, int8 x64 coefficients, over int16 rows.
//
// Replaces the all-device path's window and filter, tpu_sdr/runtime/q15.py
// (:99-110) and tpu_sdr/kernels/biquad.py sosfilt_q15_scan (:746-773), which
// the JAX package runs as a per-sample lax.scan (no Pallas kernel). Per row,
// sample by sample, section by section (transposed direct form II):
//
//   window (with a ROM):  p = x * rom[i mod n]; v = int16((p >> 15) + ((p >> 14) & 1))
//   per section:          acc = b0 v + z0
//                         y   = clip(rshift6_round(acc), -32768, 32767)
//                         z0  = b1 v - a1 y + z1
//                         z1  = b2 v - a2 y
//                         v   = y
//
// rshift6_round(acc) is acc >= 0 ? (acc + 32) >> 6 : -((-acc + 32) >> 6),
// round half away from zero. It is computed as (acc + 32 + (acc >> 31)) >> 6:
// for acc < 0, -floor((32 - acc) / 64) = ceil((acc - 32) / 64) =
// floor((acc + 31) / 64), and acc >> 31 is -1 exactly there.
//
// The arithmetic is int32 throughout, as the JAX scan's. The int64 oracle
// (golden.sosfilt_q15_intended) gives the same bits because nothing leaves
// int32: with int8 coefficients (|c| <= 128) and int16 values
// (|v|, |y| <= 2^15), |z1| <= 2 * 2^7 * 2^15 = 2^23, |z0| <= 2^22 + 2^22 +
// 2^23 = 2^24 and |acc| <= 2^22 + 2^24 < 2^25, far inside 2^31.
//
// One thread walks one row; the chain is sequential by nature (the clip is
// not linear), so this kernel is bound by the latency of its dependent
// integer operations, not by bytes. Samples move 8 at a time (16-byte loads
// and stores), the next 8 loaded before the current 8 are filtered, and the
// coefficients and state stay in registers (one instantiation per section
// count, at most 8). Each (sample, section) step depends on the step of the
// previous section at its sample (v) and of its section at the previous
// sample (z0): the longest path through that grid is T + S - 1 steps, which
// is the latency floor (chip_smoke.py states it in cycles); the compiler may
// overlap steps along it from the unrolled body of 8 samples. Its times on
// the card are in PERF.md.

#include <cuda_runtime.h>
#include <stdint.h>

#include "error_string.cuh"

namespace {

constexpr int kThreads = 64;
constexpr int kVec = 8;  // int16 samples a 16-byte access
constexpr int kMaxSections = 8;

union Vec8 {
  uint4 u;
  int16_t s[kVec];
};

__device__ __forceinline__ int window_q15(int x, int w) {
  const int p = x * w;
  return int16_t((p >> 15) + ((p >> 14) & 1));  // wraps like the RTL's slice
}

template <int S>
__global__ void __launch_bounds__(kThreads)
sosfilt_q15_kernel(const int* __restrict__ sos, const int16_t* __restrict__ x, int rows,
                   int t_len, const int16_t* __restrict__ rom, int n_rom,
                   const int* __restrict__ zi, int16_t* __restrict__ xw,
                   int16_t* __restrict__ y, int* __restrict__ zf) {
  const int r = blockIdx.x * kThreads + threadIdx.x;
  if (r >= rows) return;
  int b0[S], b1[S], b2[S], a1[S], a2[S], z0[S], z1[S];
#pragma unroll
  for (int s = 0; s < S; ++s) {
    b0[s] = sos[6 * s + 0];
    b1[s] = sos[6 * s + 1];
    b2[s] = sos[6 * s + 2];
    a1[s] = sos[6 * s + 4];
    a2[s] = sos[6 * s + 5];
    z0[s] = zi[(size_t(r) * S + s) * 2 + 0];
    z1[s] = zi[(size_t(r) * S + s) * 2 + 1];
  }
  const size_t row = size_t(r) * size_t(t_len);
  const uint4* xv = reinterpret_cast<const uint4*>(x + row);
  uint4* yv = reinterpret_cast<uint4*>(y + row);
  uint4* xwv = xw != nullptr ? reinterpret_cast<uint4*>(xw + row) : nullptr;
  const uint4* romv = reinterpret_cast<const uint4*>(rom);
  const int steps = t_len / kVec;
  const int rom_steps = n_rom / kVec;
  Vec8 next;
  next.u = xv[0];
  int k = 0;  // the ROM's 8-sample step
  for (int i = 0; i < steps; ++i) {
    Vec8 in = next;
    if (i + 1 < steps) next.u = xv[i + 1];
    if (rom != nullptr) {
      Vec8 w;
      w.u = romv[k];
      if (++k == rom_steps) k = 0;
#pragma unroll
      for (int e = 0; e < kVec; ++e) in.s[e] = int16_t(window_q15(in.s[e], w.s[e]));
      if (xwv != nullptr) xwv[i] = in.u;
    }
    Vec8 out;
#pragma unroll
    for (int e = 0; e < kVec; ++e) {
      int v = in.s[e];
#pragma unroll
      for (int s = 0; s < S; ++s) {
        const int acc = b0[s] * v + z0[s];
        const int q = min(max((acc + 32 + (acc >> 31)) >> 6, -32768), 32767);
        z0[s] = b1[s] * v - a1[s] * q + z1[s];
        z1[s] = b2[s] * v - a2[s] * q;
        v = q;
      }
      out.s[e] = int16_t(v);
    }
    yv[i] = out.u;
  }
#pragma unroll
  for (int s = 0; s < S; ++s) {
    zf[(size_t(r) * S + s) * 2 + 0] = z0[s];
    zf[(size_t(r) * S + s) * 2 + 1] = z1[s];
  }
}

template <int S>
cudaError_t launch_sections(const int* sos, const int16_t* x, int rows, int t_len,
                            const int16_t* rom, int n_rom, const int* zi, int16_t* xw,
                            int16_t* y, int* zf, cudaStream_t stream) {
  const int blocks = (rows + kThreads - 1) / kThreads;
  sosfilt_q15_kernel<S><<<blocks, kThreads, 0, stream>>>(sos, x, rows, t_len, rom, n_rom, zi,
                                                          xw, y, zf);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// sos: (sections, 6) int32 [b0, b1, b2, a0, a1, a2] x64 (a0 is not read:
// the >> 6 divides by a0 == 64); x: (rows, t_len) int16; rom (optional):
// (n_rom,) int16, the window ROM, sample i of a row taking rom[i mod n_rom];
// zi, zf: (rows, sections, 2) int32; xw (optional, with rom): (rows, t_len) int16, the
// windowed samples; y: (rows, t_len) int16. All contiguous and 16-byte
// aligned, on the current device; t_len and n_rom multiples of 8, 1 <=
// sections <= 8. Returns the CUDA error code of the launch (0 on success).
int tpu_sdr_sosfilt_q15(const int* sos, int sections, const int16_t* x, int rows, int t_len,
                        const int16_t* rom, int n_rom, const int* zi, int16_t* xw, int16_t* y,
                        int* zf, void* stream) {
  if (rows <= 0) return 0;
  if (t_len <= 0 || t_len % kVec != 0) return int(cudaErrorInvalidValue);
  if (rom != nullptr && (n_rom <= 0 || n_rom % kVec != 0)) return int(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (sections) {
    case 1: err = launch_sections<1>(sos, x, rows, t_len, rom, n_rom, zi, xw, y, zf, st); break;
    case 2: err = launch_sections<2>(sos, x, rows, t_len, rom, n_rom, zi, xw, y, zf, st); break;
    case 3: err = launch_sections<3>(sos, x, rows, t_len, rom, n_rom, zi, xw, y, zf, st); break;
    case 4: err = launch_sections<4>(sos, x, rows, t_len, rom, n_rom, zi, xw, y, zf, st); break;
    case 5: err = launch_sections<5>(sos, x, rows, t_len, rom, n_rom, zi, xw, y, zf, st); break;
    case 6: err = launch_sections<6>(sos, x, rows, t_len, rom, n_rom, zi, xw, y, zf, st); break;
    case 7: err = launch_sections<7>(sos, x, rows, t_len, rom, n_rom, zi, xw, y, zf, st); break;
    case 8: err = launch_sections<8>(sos, x, rows, t_len, rom, n_rom, zi, xw, y, zf, st); break;
    default: return int(cudaErrorInvalidValue);
  }
  static_assert(kMaxSections == 8, "the switch above instantiates 1..8 sections");
  return int(err);
}

}  // extern "C"
