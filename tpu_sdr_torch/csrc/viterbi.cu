// K3: batched Viterbi decoding of a rate-1/n convolutional code.
//
// Replaces tpu_sdr/kernels/fec.py _viterbi (:221-253), which the JAX package
// runs as a jitted lax.scan of the add-compare-select (ACS) and a reversed
// lax.scan of the traceback (XLA code, no Pallas kernel). In eager PyTorch
// each trellis step would take about eight launches.
//
// Per row b (one CTA a row), per trellis step k, for every state t of the
// 2^(K-1) states, with p0 = t >> 1 and p1 = p0 + S/2 its predecessors:
//
//   bm_e = x[b,k,0]*s_e[t,0] + x[b,k,1]*s_e[t,1] (+ ...)   in index order,
//          s_e = +-1, the branch's output bits; x*(-1) is -x, exactly
//   c0   = pm[p0] + bm_0,   c1 = pm[p1] + bm_1
//   dec  = c1 > c0           (strict: state p0 wins a tie, as in JAX)
//   pm'  = dec ? c1 : c0,    then pm' -= max over all states of pm'
//
// from pm = 0 at state 0 and -1e9 elsewhere. Each thread keeps the raw pm'
// (before the subtraction) in shared memory, double-buffered by step, and
// the step's block maximum m; the next step reads (raw[p] - m) + bm, the
// same two roundings as the reference's (pm' - m)[p] + bm, so the whole
// forward pass takes one barrier a step. The maximum is exact whatever the
// order: a warp shuffle tree, then the warps' maxima in index order.
//
// Decisions are packed by __ballot_sync: lane l of warp w owns state
// 32*w + l (plus blockDim for a second state), so a ballot is one 32-state
// word, written to dec (B, T, W) uint32, W = max(S/32, 1). After the last
// step one thread a row walks back from state 0:
//
//   bit[k] = state & 1;  state = (state >> 1) | (dec[k][state] << (K-2))
//
// What bounds it: not bytes (8 bytes a step a row of input at rate 1/2) and
// not operations (about 12 fp32 operations a state a step), but the latency
// of T dependent steps, each a shared-memory read, two adds, a compare, a
// shuffle tree and a barrier, and then T dependent global reads of the
// traceback. chip_smoke.py measures the floor of one such step with
// tpu_sdr_viterbi_step_probe (a dependent ACS and a barrier, nothing else).
// This design is the simple one; its times are in PERF.md.

#include <cuda_runtime.h>
#include <stdint.h>

#include "error_string.cuh"

namespace {

constexpr int kMaxStates = 2048;
constexpr int kMaxThreads = 1024;
constexpr int kMaxOut = 8;
constexpr int kMaxWarps = kMaxThreads / 32;
constexpr float kNeg = -1e9f;

// The loops run to kMaxOut with a guard, unrolled, so that xs stays in
// registers; the sum is still in index order.
__device__ __forceinline__ float branch_metric(const float (&xs)[kMaxOut], int n, int mask) {
  float bm = (mask & 1) ? -xs[0] : xs[0];
#pragma unroll
  for (int j = 1; j < kMaxOut; ++j) {
    if (j < n) bm = bm + (((mask >> j) & 1) ? -xs[j] : xs[j]);
  }
  return bm;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// out0[t], out1[t]: bit j = output bit j of the p0 -> t and p1 -> t edges.
__global__ void __launch_bounds__(kMaxThreads)
viterbi_kernel(const float* __restrict__ x, const int* __restrict__ out0,
               const int* __restrict__ out1, uint32_t* __restrict__ dec,
               uint8_t* __restrict__ bits, int t_len, int n_out, int k) {
  __shared__ float pm[2][kMaxStates];
  __shared__ float wmax[2][kMaxWarps];
  const int S = 1 << (k - 1);
  const int half = S >> 1;
  const int W = S >= 32 ? S / 32 : 1;
  const int tid = threadIdx.x;
  const int nthreads = blockDim.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int nwarps = nthreads >> 5;
  const int per = S > nthreads ? S / nthreads : 1;  // states a thread: 1 or 2
  const size_t row = blockIdx.x;
  const float* xr = x + row * size_t(t_len) * n_out;
  uint32_t* dr = dec + row * size_t(t_len) * W;

  int m0[2] = {0, 0}, m1[2] = {0, 0};
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (i >= per) break;
    const int t = tid + i * nthreads;
    m0[i] = t < S ? out0[t] : 0;
    m1[i] = t < S ? out1[t] : 0;
    if (t < S) pm[0][t] = t == 0 ? 0.0f : kNeg;
  }
  if (tid < kMaxWarps) wmax[0][tid] = 0.0f;  // step 0 subtracts nothing
  float xs[kMaxOut];
#pragma unroll
  for (int j = 0; j < kMaxOut; ++j) xs[j] = j < n_out ? xr[j] : 0.0f;
  __syncthreads();

  for (int step = 0; step < t_len; ++step) {
    const int cur = step & 1;
    float xn[kMaxOut];
#pragma unroll
    for (int j = 0; j < kMaxOut; ++j) {
      xn[j] = (j < n_out && step + 1 < t_len) ? xr[size_t(step + 1) * n_out + j] : 0.0f;
    }
    float m = wmax[cur][0];
    for (int w = 1; w < (step == 0 ? 1 : nwarps); ++w) m = fmaxf(m, wmax[cur][w]);
    float best = __int_as_float(0xff800000);  // -inf
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      if (i >= per) break;  // uniform across the block
      const int t = tid + i * nthreads;
      bool won1 = false;
      if (t < S) {
        const int p0 = t >> 1;
        const float c0 = (pm[cur][p0] - m) + branch_metric(xs, n_out, m0[i]);
        const float c1 = (pm[cur][p0 + half] - m) + branch_metric(xs, n_out, m1[i]);
        won1 = c1 > c0;
        const float v = won1 ? c1 : c0;
        pm[cur ^ 1][t] = v;
        best = fmaxf(best, v);
      }
      const unsigned word = __ballot_sync(0xffffffffu, won1);
      const int first = tid - lane + i * nthreads;  // the warp's first state
      if (lane == 0 && first < S) dr[size_t(step) * W + (first >> 5)] = word;
    }
    best = warp_max(best);
    if (lane == 0) wmax[cur ^ 1][warp] = best;
#pragma unroll
    for (int j = 0; j < kMaxOut; ++j) xs[j] = xn[j];
    __syncthreads();
  }

  if (tid == 0) {
    uint8_t* br = bits + row * size_t(t_len);
    int state = 0;  // zero-terminated
    for (int step = t_len - 1; step >= 0; --step) {
      br[step] = uint8_t(state & 1);
      const uint32_t word = dr[size_t(step) * W + (state >> 5)];
      const int won1 = (word >> (state & 31)) & 1;
      state = (state >> 1) | (won1 << (k - 2));
    }
  }
}

// The latency floor of one trellis step: each of ``S`` threads reads two
// predecessors' metrics from shared memory, adds, compares, selects and
// writes its state's metric to the other buffer, then the block meets at a
// barrier. Thread 0 writes the clock64 cycles of ``t_len`` steps to
// cycles[0] and the final metric of state 0 to cycles[1] (kept live).
__global__ void viterbi_step_probe_kernel(long long* cycles, int t_len) {
  __shared__ float pm[2][kMaxStates];
  const int S = blockDim.x;
  const int t = threadIdx.x;
  pm[0][t] = float(t);
  __syncthreads();
  const long long t0 = clock64();
  for (int step = 0; step < t_len; ++step) {
    const int cur = step & 1;
    const int p0 = t >> 1;
    const float c0 = pm[cur][p0] + 1.0f;
    const float c1 = pm[cur][p0 + S / 2] - 1.0f;
    pm[cur ^ 1][t] = c1 > c0 ? c1 : c0;
    __syncthreads();
  }
  const long long t1 = clock64();
  if (t == 0) {
    cycles[0] = t1 - t0;
    cycles[1] = (long long)pm[t_len & 1][0];
  }
}

}  // namespace

extern "C" {

// x: (rows, t_len, n_out) f32, the depunctured branch observations; out0,
// out1: (2^(k-1),) int32 edge output bits; dec: (rows, t_len, W) uint32
// scratch, W = max(2^(k-1) / 32, 1); bits: (rows, t_len) uint8. All
// contiguous on the current device; 2 <= k <= 12, 1 <= n_out <= 8. Returns
// the CUDA error code of the launch (0 on success).
int tpu_sdr_viterbi(const float* x, const int* out0, const int* out1, uint32_t* dec,
                    uint8_t* bits, int rows, int t_len, int n_out, int k, void* stream) {
  if (rows <= 0 || t_len <= 0) return 0;
  if (k < 2 || k > 12 || n_out < 1 || n_out > kMaxOut) return int(cudaErrorInvalidValue);
  const int states = 1 << (k - 1);
  int threads = states < 32 ? 32 : states;
  if (threads > kMaxThreads) threads = kMaxThreads;
  viterbi_kernel<<<rows, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      x, out0, out1, dec, bits, t_len, n_out, k);
  return int(cudaGetLastError());
}

// cycles: (2,) int64. states in [64, 1024], a power of two.
int tpu_sdr_viterbi_step_probe(long long* cycles, int states, int t_len, void* stream) {
  if (states < 64 || states > kMaxThreads || (states & (states - 1))) {
    return int(cudaErrorInvalidValue);
  }
  viterbi_step_probe_kernel<<<1, states, 0, static_cast<cudaStream_t>(stream)>>>(cycles, t_len);
  return int(cudaGetLastError());
}

}  // extern "C"
