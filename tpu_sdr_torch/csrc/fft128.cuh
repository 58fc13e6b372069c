// Radix FFTs of the 16384-point four-step spectrum, shared by
// spectrum_bypass.cu and spectrum_iir.cu (real frames) and
// spectrum_complex.cu (IQ frames).
// N = 128 x 128 as in frame.cuh: per frame x[n], n = n1 + 128*n2,
// viewed as X[n2][n1],
//
//   1. column FFTs  Y[k2][n1] = sum_n2 W128^(k2*n2) X[n2][n1]
//   2. twiddle      T[k2][n1] = Y[k2][n1] * tw[k2][n1]   (the plan's planes)
//   3. row FFTs     Z[k2][k1] = sum_n1 W128^(k1*n1) T[k2][n1]
//   4. store        out[128*k1 + k2] = |Z[k2][k1]|         (natural order)
//
// Each 128-point transform is two radix stages in registers with one
// shared-memory exchange between them:
//
//   column (n2 = a + 8b, k2 = c + 16d): thread a of 8 holds z[a + 8b],
//     b < 16; stage 1 is a 16-point FFT over b times W128^(a*c); stage 2,
//     per c, an 8-point FFT over a, giving Y[c + 16d].
//   row (n1 = u + 16b, k1 = t + 8v): thread a' of 8 holds T[2a' + e + 16b],
//     e < 2, b < 8; stage 1 is two 8-point FFTs over b times W128^(u*t),
//     u = 2a' + e; stage 2, in thread t, a 16-point FFT over u, giving
//     Z[t + 8v].
//
// The 8- and 16-point FFTs are radix-2 decimation in frequency with the
// output permuted back to natural order by register renaming. Every twiddle
// is an entry of the 128-entry W128 table the kernel is given (W_L^j =
// W128^(j*128/L)): no sincosf, no new plan constant. The factors 1 and
// W128^32 = -i are applied exactly (the table holds cos(pi/2) as 6.1e-17).
// IEEE fp32 on CUDA cores, a fixed order of operations per element, nothing
// shared between frames.
//
// Shared-memory layout (floats): the exchange buffer E [slot][lane] of
// float2 (slot = a + 8c; 32 KiB) and the twiddled rows T [k2][kRowStride]
// of complex n1 (130 complex a row: float4 accesses of 8 lanes on
// consecutive rows fall in distinct banks). The magnitudes are assembled
// over T (real frames) or over E and T (IQ frames) for 16-byte stores.

#pragma once

#include "frame.cuh"

namespace tpu_sdr {
namespace fft128 {

constexpr int kThreads = 256;  // 8 warps: warp w is a (or t) of each group of 8
constexpr int kLanes = 32;
constexpr int kRowStride = 260;  // floats per row of T
constexpr int kExchangeFloats = 128 * kLanes * 2;
constexpr int kTableFloats = 512;  // W_N2 re, im, W_N1 re, im (128 each)

// W128^j = (re[j], im[j]), a table in shared memory.
struct W128 {
  const float* re;
  const float* im;
  __device__ __forceinline__ float2 operator()(int j) const {
    return make_float2(re[j], im[j]);
  }
};

__device__ __forceinline__ float2 cmul(float2 a, float2 w) {
  return make_float2(a.x * w.x - a.y * w.y, a.x * w.y + a.y * w.x);
}

__host__ __device__ constexpr int bitrev(int k, int bits) {
  int r = 0;
  for (int i = 0; i < bits; ++i) r |= ((k >> i) & 1) << (bits - 1 - i);
  return r;
}

__host__ __device__ constexpr int log2i(int n) { return n <= 1 ? 0 : 1 + log2i(n / 2); }

// r[k] = v[bitrev(k)], each index a constant expression: an index the
// compiler does not fold (it did not fold bitrev(k) in an unrolled loop)
// puts the register array in local memory.
template <int L, int K = 0>
__device__ __forceinline__ void unscramble(float2 (&r)[L], const float2 (&v)[L]) {
  if constexpr (K < L) {
    constexpr int j = bitrev(K, log2i(L));
    r[K] = v[j];
    unscramble<L, K + 1>(r, v);
  }
}

// In-place L-point DFT (L = 8 or 16), natural order in and out: radix-2
// decimation in frequency, stage s pairs v[i] and v[i + h], h = L >> (s+1),
// and multiplies the difference by W_2h^j = W128^(j * 64 / h).
template <int L>
__device__ __forceinline__ void dft(float2 (&v)[L], W128 w) {
  constexpr int kBits = log2i(L);
#pragma unroll
  for (int s = 0; s < kBits; ++s) {
    const int h = L >> (s + 1);
#pragma unroll
    for (int i = 0; i < L; ++i) {
      if (i & h) continue;
      const int j = i & (h - 1);
      const float2 a = v[i], b = v[i + h];
      v[i] = make_float2(a.x + b.x, a.y + b.y);
      const float2 d = make_float2(a.x - b.x, a.y - b.y);
      const int idx = j * (64 / h);
      if (idx == 0) {
        v[i + h] = d;
      } else if (idx == 32) {  // -i
        v[i + h] = make_float2(d.y, -d.x);
      } else {
        v[i + h] = cmul(d, w(idx));
      }
    }
  }
  float2 r[L];
  unscramble<L>(r, v);
#pragma unroll
  for (int k = 0; k < L; ++k) v[k] = r[k];
}

// Column stage 1 of thread a: v[b] = z[a + 8b] -> V[c] = FFT16(v)[c] *
// W128^(a*c).
__device__ __forceinline__ void column_stage1(float2 (&v)[16], int a, W128 w) {
  dft<16>(v, w);
#pragma unroll
  for (int c = 1; c < 16; ++c) v[c] = cmul(v[c], w(a * c));
}

// V[c] into the exchange buffer at slot a + 8c, this lane's column.
__device__ __forceinline__ void exchange_store(float2* e, const float2 (&v)[16],
                                               int a, int lane) {
#pragma unroll
  for (int c = 0; c < 16; ++c) e[(a + 8 * c) * kLanes + lane] = v[c];
}

// Column stage 2 for one c: z[d] = Y[c + 16d] = FFT8 over a of V_a[c].
__device__ __forceinline__ void column_stage2(const float2* e, int c, int lane,
                                              W128 w, float2 (&z)[8]) {
#pragma unroll
  for (int a = 0; a < 8; ++a) z[a] = e[(a + 8 * c) * kLanes + lane];
  dft<8>(z, w);
}

// y * tw[k2][n1], the plan's twiddle planes read through the read-only
// cache.
__device__ __forceinline__ float2 twiddle(float2 y, const float* __restrict__ twr,
                                          const float* __restrict__ twi, int k2,
                                          int n1) {
  const float a = __ldg(twr + k2 * kN1 + n1);
  const float b = __ldg(twi + k2 * kN1 + n1);
  return make_float2(y.x * a - y.y * b, y.x * b + y.y * a);
}

// Row stage 1 of thread a' on one row of T (in place): reads T[u + 16b],
// u = 2a' + e, and writes V_u[t] = FFT8 over b (at t) * W128^(u*t) to the
// slots it read (slot u + 16t), so no other thread's input is overwritten.
__device__ __forceinline__ void row_stage1(float* row, int ap, W128 w) {
  float2 v0[8], v1[8];
#pragma unroll
  for (int b = 0; b < 8; ++b) {
    const float4 q = *reinterpret_cast<const float4*>(row + 2 * (2 * ap + 16 * b));
    v0[b] = make_float2(q.x, q.y);
    v1[b] = make_float2(q.z, q.w);
  }
  dft<8>(v0, w);
  dft<8>(v1, w);
  const int u0 = 2 * ap;
#pragma unroll
  for (int t = 0; t < 8; ++t) {
    const float2 a = t == 0 ? v0[0] : cmul(v0[t], w(u0 * t));
    const float2 b = t == 0 ? v1[0] : cmul(v1[t], w((u0 + 1) * t));
    *reinterpret_cast<float4*>(row + 2 * (u0 + 16 * t)) = make_float4(a.x, a.y, b.x, b.y);
  }
}

// Row stage 2 of thread t on one row: m[v] = |Z[t + 8v]|, Z = FFT16 over u
// of V_u[t] (slots 16t .. 16t + 15).
__device__ __forceinline__ void row_stage2(const float* row, int t, W128 w,
                                           float (&m)[16]) {
  float2 v[16];
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const float4 q = *reinterpret_cast<const float4*>(row + 2 * (16 * t + 2 * j));
    v[2 * j] = make_float2(q.x, q.y);
    v[2 * j + 1] = make_float2(q.z, q.w);
  }
  dft<16>(v, w);
#pragma unroll
  for (int k = 0; k < 16; ++k) m[k] = magnitude(v[k].x, v[k].y);
}

// Real frames (spectrum_bypass.cu, spectrum_iir.cu): Hermitian column pairs.
// Columns 2P and 2P + 1 are one complex 128-point FFT, Z = FFT(x[:, 2P] +
// i x[:, 2P+1]), split as Y_2P[k] = (Z[k] + conj Z[-k]) / 2 and Y_2P+1[k] =
// (Z[k] - conj Z[-k]) / 2i; only rows k2 in [0, 64] are kept (Y[128 - k2] =
// conj Y[k2]). Stage 2's thread t takes c = t and 16 - t (t = 0: c = 0 and
// 8), so Z[k] and Z[-k] meet in one thread.
constexpr int kRealRows = kN2 / 2 + 1;  // k2 in [0, 64]

// Rows k2 (of Z[k] with partner Z[kk] = Z[128 - k2]) of a column pair, split
// into the two real columns n1 and n1 + 1, twiddled, into T.
__device__ __forceinline__ void emit_rows(float* tw_rows, const float* __restrict__ twr,
                                          const float* __restrict__ twi, int k2, int n1,
                                          float2 zk, float2 zkk) {
  const float2 ya = make_float2((zk.x + zkk.x) * 0.5f, (zk.y - zkk.y) * 0.5f);
  const float2 yb = make_float2((zk.y + zkk.y) * 0.5f, (zkk.x - zk.x) * 0.5f);
  const float2 a = __ldg(reinterpret_cast<const float2*>(twr + k2 * kN1 + n1));
  const float2 b = __ldg(reinterpret_cast<const float2*>(twi + k2 * kN1 + n1));
  const float2 ta = make_float2(ya.x * a.x - ya.y * b.x, ya.x * b.x + ya.y * a.x);
  const float2 tb = make_float2(yb.x * a.y - yb.y * b.y, yb.x * b.y + yb.y * a.y);
  *reinterpret_cast<float4*>(tw_rows + k2 * kRowStride + 2 * n1) =
      make_float4(ta.x, ta.y, tb.x, tb.y);
}

// Stage 2 of the column FFT of pair n1/2 and its split: thread t's rows.
__device__ __forceinline__ void column_pair_rows(const float2* e, float* tw_rows,
                                                 const float* __restrict__ twr,
                                                 const float* __restrict__ twi, int t,
                                                 int lane, int n1, W128 w) {
  const int c0 = t == 0 ? 0 : t;
  const int c1 = t == 0 ? 8 : 16 - t;
  float2 za[8], zb[8];  // Z[c0 + 16d], Z[c1 + 16d]
  column_stage2(e, c0, lane, w, za);
  column_stage2(e, c1, lane, w, zb);
  if (t == 0) {
    // c = 0: Z[16d] with Z[16(8 - d)]; c = 8: Z[8 + 16d] with Z[8 + 16(7 - d)].
#pragma unroll
    for (int d = 0; d <= 4; ++d) emit_rows(tw_rows, twr, twi, 16 * d, n1, za[d], za[(8 - d) & 7]);
#pragma unroll
    for (int d = 0; d < 4; ++d) emit_rows(tw_rows, twr, twi, 8 + 16 * d, n1, zb[d], zb[7 - d]);
  } else {
    // Z[t + 16d] with Z[16 - t + 16(7 - d)], and the other way round.
#pragma unroll
    for (int d = 0; d < 4; ++d) emit_rows(tw_rows, twr, twi, t + 16 * d, n1, za[d], zb[7 - d]);
#pragma unroll
    for (int d = 0; d < 4; ++d) emit_rows(tw_rows, twr, twi, c1 + 16 * d, n1, zb[d], za[7 - d]);
  }
}

// |Z[k2][t + 8v]| into the frame's magnitudes and, for k2 in [1, 63], at
// the mirror.
__device__ __forceinline__ void put_magnitudes(float* mag, int k2, int t, const float (&m)[16]) {
#pragma unroll
  for (int v = 0; v < 16; ++v) {
    const int k1 = t + 8 * v;
    mag[k1 * kN2 + k2] = m[v];
    if (k2 != 0) mag[(kN1 - 1 - k1) * kN2 + kN2 - k2] = m[v];
  }
}

// Four consecutive inputs as fp32: one 16-byte load (fp32) or 8-byte (bf16).
__device__ __forceinline__ void load4(const float* __restrict__ x, int i, float v[4]) {
  const float4 a = *reinterpret_cast<const float4*>(x + i);
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
}

__device__ __forceinline__ void load4(const __nv_bfloat16* __restrict__ x, int i,
                                      float v[4]) {
  const uint2 raw = *reinterpret_cast<const uint2*>(x + i);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
  const float2 a = __bfloat1622float2(h[0]);
  const float2 b = __bfloat1622float2(h[1]);
  v[0] = a.x; v[1] = a.y; v[2] = b.x; v[3] = b.y;
}

__device__ __forceinline__ float load1(const float* __restrict__ x, int i) { return x[i]; }

__device__ __forceinline__ float load1(const __nv_bfloat16* __restrict__ x, int i) {
  return __bfloat162float(x[i]);
}

// The 4 x 128 DFT table into shared memory, two entries per thread.
__device__ __forceinline__ void load_tables(const float* __restrict__ tab, float* tabs) {
  tabs[threadIdx.x] = tab[threadIdx.x];
  tabs[threadIdx.x + kThreads] = tab[threadIdx.x + kThreads];
}

// Opt the kernel into `smem` bytes of dynamic shared memory and launch one
// kThreads block per frame. Returns the CUDA error code (0 on success).
template <typename... Params, typename... Args>
int launch_frames(void (*kernel)(Params...), size_t smem, int frames,
                  cudaStream_t stream, Args... args) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return int(err);
  kernel<<<frames, kThreads, smem, stream>>>(args...);
  return int(cudaGetLastError());
}

}  // namespace fft128
}  // namespace tpu_sdr
