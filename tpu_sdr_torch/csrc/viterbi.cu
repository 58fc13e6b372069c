// K3: batched Viterbi decoding of a rate-1/n convolutional code.
//
// Replaces tpu_sdr/kernels/fec.py _viterbi (:221-253), which the JAX package
// runs as a jitted lax.scan of the add-compare-select (ACS) and a reversed
// lax.scan of the traceback (XLA code, no Pallas kernel). In eager PyTorch
// each trellis step would take about eight launches.
//
// Per row b, per trellis step k, for every state t of the S = 2^(K-1)
// states, with p0 = t >> 1 and p1 = p0 + S/2 its predecessors:
//
//   bm_e = x[b,k,0]*s_e[t,0] + x[b,k,1]*s_e[t,1] (+ ...)   in index order,
//          s_e = +-1, the branch's output bits; x*(-1) is -x, exactly
//   c0   = pm[p0] + bm_0,   c1 = pm[p1] + bm_1
//   dec  = c1 > c0           (strict: state p0 wins a tie, as in JAX)
//   pm'  = dec ? c1 : c0,    then pm' -= max over all states of pm'
//
// from pm = 0 at state 0 and -1e9 elsewhere. The kernels keep the raw pm'
// (before the subtraction) and the step's maximum m; the next step reads
// (raw[p] - m) + bm, the same two roundings as the reference's
// (pm' - m)[p] + bm. The maximum is exact in any order. Decisions are
// packed 32 states a word (bit t & 31 of word t >> 5), W = max(S/32, 1)
// words a step. After the last step the row walks back from state 0:
//
//   bit[k] = state & 1;  state = (state >> 1) | (dec[k][state] << (K-2))
//
// What bounds it: not bytes (8 bytes a step a row of input at rate 1/2) and
// not operations (about 12 fp32 operations a state a step), but the latency
// of T dependent steps and then T dependent traceback reads. Two routes,
// chosen by K before launch:
//
// The warp route, K <= 7 (S <= 64: the burst path's K = 7 and every code
// the modem builds), viterbi_warp_kernel: one warp a row, up to
// kRowsPerCta rows a CTA, no block barrier anywhere. Lane l holds the raw
// metrics of states l and l + 32 in registers (S < 32: lanes >= S hold
// nothing that is read: they are left out of the maximum and masked out
// of the ballots). State l's predecessors l>>1 and (l>>1) + 32 both sit in
// lane l>>1, state l+32's 16+(l>>1) and 48+(l>>1) in lane 16+(l>>1): four
// independent __shfl_sync a step (two for S <= 32, from lanes l>>1 and
// (l>>1) + S/2). The maximum is one __reduce_max_sync of order-preserving
// integer keys of the lanes' metrics (exact, as any fmaxf order is; a
// 5-level __shfl_xor_sync tree of fmaxf is exact too, but five shuffle
// latencies long: PERF.md has both). A step's dependent chain is that
// reduction with its
// key conversions, a subtraction, an add, a compare and a select; the
// predecessor shuffles run beside it. The observations are loaded 32
// steps a time (lane i holds step base + i, coalesced) and put in shared
// memory a chunk ahead, where each step reads its n values as two 16-byte
// broadcasts off the chain (rate 1/2 has its two terms unrolled, other
// rates their n_out terms guarded). Two ballots a step (one at S <= 32)
// give the decision words; in a 32-step chunk lane u keeps step u's and
// the warp stores the chunk's at its end, so that no store orders a step
// against the next step's reads. They go to shared memory: T x W words a
// row (16.4 KB at T = 2054, K = 7). The traceback runs in the
// whole warp, the state kept alike in every lane as lo | hi << 5: a
// step's words are read at addresses that do not depend on the state, so
// the reads run ahead, and the chain a step is a select of the word by hi,
// a test of bit lo and the next select (the decision bit is the next hi).
// Long rows: where T x W words would not fit in the shared memory of one
// row (kSmemBudget: more than 28,032 steps at K = 7, 56,064 below), the
// decisions go to device memory (the dec scratch) for that call, the same
// kernel otherwise; tpu_sdr_viterbi_needs_scratch tells the wrapper so.
// This is chosen by shape before the launch, never on a failure.
//
// The block route, 8 <= K <= 12 (128-2048 states), viterbi_kernel: one CTA
// a row, a thread per state (two above 1024), the metrics in shared memory
// double-buffered by step, one barrier a step: a warp shuffle tree for the
// maximum, then the warps' maxima in index order. Ballots of 32 states go
// to dec (B, T, W) in device memory, and one thread a row walks back.
//
// chip_smoke.py measures the latency floor of a step of each route with a
// probe that runs that route's dependent chain and nothing else:
// tpu_sdr_viterbi_warp_step_probe (the warp route at K = 7: the maximum's
// reduction with its key conversions, a subtraction, an add, a compare and
// a select) and tpu_sdr_viterbi_step_probe (the block route: a dependent
// ACS and a block barrier). The floors and the kernels' times are in
// PERF.md.

#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

#include "error_string.cuh"

namespace {

constexpr int kMaxStates = 2048;
constexpr int kMaxThreads = 1024;
constexpr int kMaxOut = 8;
constexpr int kMaxWarps = kMaxThreads / 32;
constexpr float kNeg = -1e9f;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kWarpMaxK = 7;     // the warp route: up to 64 states
constexpr int kRowsPerCta = 4;   // warps (rows) a CTA on the warp route
constexpr int kChunk = 32;       // steps an observation load and a traceback chunk
// Shared bytes a CTA may opt into on the H100, less the warp route's
// static observation buffers: what is left for its decisions.
constexpr size_t kSmemBudget = 232448 - kRowsPerCta * 2 * kChunk * kMaxOut * sizeof(float);
constexpr size_t kSmemDefault = 48 * 1024;  // above this a kernel must opt in

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

// The warp route (see the header). K <= 7; kShared: the decisions in
// shared memory (T x W words a warp), else in dec.
template <int K>
struct Trellis {
  static constexpr int S = 1 << (K - 1);
  static constexpr int NS = S > 32 ? 2 : 1;  // states a lane
  static constexpr int W = S > 32 ? 2 : 1;   // decision words a step
  static constexpr int LANES = S < 32 ? S : 32;  // lanes that hold states
};

// The branch metric of an edge: sum of x_j * s_j (s_j = +-1, exact) in
// index order, over N terms (N = 0: n, up to kMaxOut, guarded).
template <int N>
__device__ __forceinline__ float edge_metric(const float (&xk)[kMaxOut], const float (&sg)[kMaxOut],
                                             int n) {
  float bm = xk[0] * sg[0];
#pragma unroll
  for (int j = 1; j < (N ? N : kMaxOut); ++j) {
    if (N || j < n) bm = bm + xk[j] * sg[j];
  }
  return bm;
}

// The exact maximum over the lanes that hold states: one warp reduction of
// order-preserving integer keys (a float's bits, the magnitude bits
// flipped where the sign is set), exact as any fmaxf order would be.
template <int K>
__device__ __forceinline__ float states_max(float v) {
  int key = __float_as_int(v);
  key ^= (key >> 31) & 0x7fffffff;
  if (Trellis<K>::LANES < 32 && int(threadIdx.x & 31) >= Trellis<K>::LANES) key = INT_MIN;
  int m = __reduce_max_sync(kFull, key);
  m ^= (m >> 31) & 0x7fffffff;
  return __int_as_float(m);
}

// The traceback's state, lo | hi << 5: hi picks the step's word (K = 7:
// states 32-63), lo the bit in it. The next hi is the decision bit itself,
// so a step's chain is a select, a test and the next select.
template <int K>
struct Trace {
  int lo = 0;
  bool hi = false;
  __device__ __forceinline__ void back(uint32_t a, uint32_t b) {
    const bool bit = ((hi ? b : a) & (1u << lo)) != 0;
    if (Trellis<K>::W == 2) {
      lo = (lo >> 1) | (hi ? 16 : 0);
      hi = bit;
    } else {
      lo = (lo >> 1) | (bit ? 1 << (K - 2) : 0);
    }
  }
};

template <int K, int N, bool kShared>
__global__ void __launch_bounds__(kRowsPerCta * 32)
viterbi_warp_kernel(const float* __restrict__ x, const int* __restrict__ out0,
                    const int* __restrict__ out1, uint32_t* __restrict__ dec,
                    uint8_t* __restrict__ bits, int rows, int t_len, int n_out) {
  using Tr = Trellis<K>;
  constexpr int S = Tr::S, NS = Tr::NS, W = Tr::W;
  extern __shared__ uint32_t smem_dec[];
  // A chunk's observations, a step's n values zero-padded to kMaxOut.
  __shared__ __align__(16) float obs[kRowsPerCta][2][kChunk][kMaxOut];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int row = blockIdx.x * (blockDim.x >> 5) + warp;
  if (row >= rows) return;  // the whole warp: no barrier follows
  uint32_t* dr = kShared ? smem_dec + size_t(warp) * t_len * W : dec + size_t(row) * t_len * W;
  const float* xr = x + size_t(row) * t_len * n_out;

  // The edges into this lane's states, as signs: sg[slot][edge][j].
  float sg[NS][2][kMaxOut];
  float r[NS];  // raw metrics of states lane + 32 slot
#pragma unroll
  for (int i = 0; i < NS; ++i) {
    const int t = lane + 32 * i;
    const int m0 = t < S ? out0[t] : 0;
    const int m1 = t < S ? out1[t] : 0;
#pragma unroll
    for (int j = 0; j < kMaxOut; ++j) {
      sg[i][0][j] = ((m0 >> j) & 1) ? -1.0f : 1.0f;
      sg[i][1][j] = ((m1 >> j) & 1) ? -1.0f : 1.0f;
    }
    r[i] = t == 0 ? 0.0f : kNeg;
  }
  // Predecessor lanes: S > 32, slot 0 from lane l>>1 (slots 0, 1), slot 1
  // from lane 16 + (l>>1) (slots 0, 1); S <= 32 from lanes l>>1, (l>>1) + S/2.
  const int src_a = lane >> 1;
  const int src_b = S > 32 ? 16 + (lane >> 1) : (lane >> 1) + S / 2;
  const unsigned live = S < 32 ? (1u << (S & 31)) - 1 : kFull;

  // Lane l loads step base + l of a chunk into registers, and puts it into
  // the chunk's buffer later, so that the loads fly while a chunk runs.
  float pre[kMaxOut];
  auto load_obs = [&](int base) {
    const int k = base + lane;
#pragma unroll
    for (int j = 0; j < kMaxOut; ++j) {
      pre[j] = (j < n_out && k < t_len) ? xr[size_t(k) * n_out + j] : 0.0f;
    }
  };
  auto put_obs = [&](int buf) {
    float4* dst = reinterpret_cast<float4*>(obs[warp][buf][lane]);
    dst[0] = make_float4(pre[0], pre[1], pre[2], pre[3]);
    dst[1] = make_float4(pre[4], pre[5], pre[6], pre[7]);
  };
  // One step: the new metrics in r and the step's decision words.
  auto acs = [&](const float* o, unsigned (&word)[2]) {
    const float4 o0 = reinterpret_cast<const float4*>(o)[0];
    const float4 o1 = reinterpret_cast<const float4*>(o)[1];
    const float xk[kMaxOut] = {o0.x, o0.y, o0.z, o0.w, o1.x, o1.y, o1.z, o1.w};
    float m = NS == 2 ? fmaxf(r[0], r[NS - 1]) : r[0];
    m = states_max<K>(m);
    if (NS == 2) {
      const float a0 = __shfl_sync(kFull, r[0], src_a), a1 = __shfl_sync(kFull, r[NS - 1], src_a);
      const float b0 = __shfl_sync(kFull, r[0], src_b), b1 = __shfl_sync(kFull, r[NS - 1], src_b);
      const float c00 = (a0 - m) + edge_metric<N>(xk, sg[0][0], n_out);
      const float c01 = (a1 - m) + edge_metric<N>(xk, sg[0][1], n_out);
      const float c10 = (b0 - m) + edge_metric<N>(xk, sg[NS - 1][0], n_out);
      const float c11 = (b1 - m) + edge_metric<N>(xk, sg[NS - 1][1], n_out);
      const bool d0 = c01 > c00, d1 = c11 > c10;
      r[0] = d0 ? c01 : c00;
      r[NS - 1] = d1 ? c11 : c10;
      word[0] = __ballot_sync(kFull, d0);
      word[1] = __ballot_sync(kFull, d1);
    } else {
      const float a = __shfl_sync(kFull, r[0], src_a), b = __shfl_sync(kFull, r[0], src_b);
      const float c0 = (a - m) + edge_metric<N>(xk, sg[0][0], n_out);
      const float c1 = (b - m) + edge_metric<N>(xk, sg[0][1], n_out);
      const bool d = c1 > c0;
      r[0] = d ? c1 : c0;
      word[0] = __ballot_sync(kFull, d) & live;
      word[1] = 0;
    }
  };
  auto put_words = [&](int step, const unsigned (&word)[2]) {
    if (W == 2) {
      *reinterpret_cast<uint2*>(dr + size_t(step) * 2) = make_uint2(word[0], word[1]);
    } else {
      dr[step] = word[0];
    }
  };

  // The forward pass: whole chunks unrolled, then the last steps one by
  // one. In a chunk, lane u keeps step u's words and the warp stores them
  // at its end, so that no store stands between a step and the next step's
  // reads of the observations.
  load_obs(0);
  put_obs(0);
  __syncwarp();
  int base = 0;
  for (; base + kChunk <= t_len; base += kChunk) {
    const int buf = (base / kChunk) & 1;
    load_obs(base + kChunk);
    unsigned mine[2] = {0, 0};
#pragma unroll
    for (int u = 0; u < kChunk; ++u) {
      unsigned word[2];
      acs(obs[warp][buf][u], word);
      mine[0] = lane == u ? word[0] : mine[0];
      mine[1] = lane == u ? word[1] : mine[1];
    }
    put_words(base + lane, mine);
    put_obs(buf ^ 1);
    __syncwarp();
  }
  for (int step = base; step < t_len; ++step) {
    unsigned word[2];
    acs(obs[warp][(base / kChunk) & 1][step - base], word);
    if (lane == 0) put_words(step, word);
  }
  __syncwarp();

  // The traceback from state 0, the same state in every lane; lane u keeps
  // the bit of step base + u of a chunk and the warp stores the chunk's 32.
  uint8_t* br = bits + size_t(row) * t_len;
  Trace<K> tr;
  base = (t_len - 1) / kChunk * kChunk;
  int mine = 0;
  for (int step = t_len - 1; step >= base; --step) {
    mine = lane == step - base ? (tr.lo & 1) : mine;
    tr.back(dr[size_t(step) * W], dr[size_t(step) * W + W - 1]);
  }
  if (base + lane < t_len) br[base + lane] = uint8_t(mine);
  for (base -= kChunk; base >= 0; base -= kChunk) {
#pragma unroll
    for (int u = kChunk - 1; u >= 0; --u) {
      const int step = base + u;
      mine = lane == u ? (tr.lo & 1) : mine;
      tr.back(dr[size_t(step) * W], dr[size_t(step) * W + W - 1]);
    }
    br[base + lane] = uint8_t(mine);
  }
}

template <int K, int N>
cudaError_t launch_warp(const float* x, const int* out0, const int* out1, uint32_t* dec,
                        uint8_t* bits, int rows, int t_len, int n_out, cudaStream_t stream) {
  const size_t per_row = size_t(t_len) * Trellis<K>::W * sizeof(uint32_t);
  int per_cta = rows < kRowsPerCta ? rows : kRowsPerCta;
  if (per_row > kSmemBudget) {  // long rows: the decisions in dec
    const int blocks = (rows + per_cta - 1) / per_cta;
    viterbi_warp_kernel<K, N, false><<<blocks, per_cta * 32, 0, stream>>>(
        x, out0, out1, dec, bits, rows, t_len, n_out);
    return cudaGetLastError();
  }
  while (per_cta > 1 && per_cta * per_row > kSmemBudget) --per_cta;
  const size_t smem = per_cta * per_row;
  if (smem > kSmemDefault) {
    const cudaError_t err = cudaFuncSetAttribute(viterbi_warp_kernel<K, N, true>,
                                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                                 int(smem));
    if (err != cudaSuccess) return err;
  }
  const int blocks = (rows + per_cta - 1) / per_cta;
  viterbi_warp_kernel<K, N, true><<<blocks, per_cta * 32, smem, stream>>>(
      x, out0, out1, nullptr, bits, rows, t_len, n_out);
  return cudaGetLastError();
}

// Rate 1/2 (the burst path's and the modem's codes) with its two terms
// unrolled; any other rate with n_out's terms guarded.
template <int K>
cudaError_t launch_warp(const float* x, const int* out0, const int* out1, uint32_t* dec,
                        uint8_t* bits, int rows, int t_len, int n_out, cudaStream_t stream) {
  return n_out == 2 ? launch_warp<K, 2>(x, out0, out1, dec, bits, rows, t_len, n_out, stream)
                    : launch_warp<K, 0>(x, out0, out1, dec, bits, rows, t_len, n_out, stream);
}

// Whether a call of these shapes needs the dec scratch in device memory.
bool needs_scratch(int t_len, int k) {
  if (k > kWarpMaxK) return true;
  const size_t words = k == kWarpMaxK ? 2 : 1;
  return size_t(t_len) * words * sizeof(uint32_t) > kSmemBudget;
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

// The latency floor of one step of the warp route at K = 7 (64 states, two
// a lane): one warp runs the step's dependent chain and nothing else. The
// two slots' maximum, its key, the warp reduction and back, and per state
// (raw - m) + bm, the compare and the select; the four predecessor
// shuffles run beside the reduction, as in the kernel. The branch metrics
// are constants, and no observation is read and no decision kept (both
// are off the chain). Lane 0 writes the clock64 cycles of ``t_len`` steps
// to cycles[0] and the final metric of state 0 to cycles[1] (kept live).
__global__ void viterbi_warp_step_probe_kernel(long long* cycles, int t_len) {
  constexpr int K = kWarpMaxK;
  static_assert(Trellis<K>::NS == 2, "the probe takes two states a lane");
  const int lane = threadIdx.x & 31;
  const int src_a = lane >> 1, src_b = 16 + (lane >> 1);
  const float bm = (lane & 1) ? 1.0f : -1.0f;
  float r0 = lane == 0 ? 0.0f : kNeg, r1 = kNeg;
  const long long t0 = clock64();
#pragma unroll 32
  for (int step = 0; step < t_len; ++step) {
    const float m = states_max<K>(fmaxf(r0, r1));
    const float a0 = __shfl_sync(kFull, r0, src_a), a1 = __shfl_sync(kFull, r1, src_a);
    const float b0 = __shfl_sync(kFull, r0, src_b), b1 = __shfl_sync(kFull, r1, src_b);
    const float c00 = (a0 - m) + bm, c01 = (a1 - m) - bm;
    const float c10 = (b0 - m) - bm, c11 = (b1 - m) + bm;
    r0 = c01 > c00 ? c01 : c00;
    r1 = c11 > c10 ? c11 : c10;
  }
  const long long t1 = clock64();
  if (lane == 0) {
    cycles[0] = t1 - t0;
    cycles[1] = (long long)r0;
  }
}

}  // namespace

extern "C" {

// x: (rows, t_len, n_out) f32, the depunctured branch observations; out0,
// out1: (2^(k-1),) int32 edge output bits; dec: (rows, t_len, W) uint32
// scratch, W = max(2^(k-1) / 32, 1), where tpu_sdr_viterbi_needs_scratch
// says so (else it may be null and is not touched); bits: (rows, t_len)
// uint8. All contiguous on the current device; 2 <= k <= 12, 1 <= n_out <=
// 8. K <= 7 takes the warp route, K >= 8 the block route. Returns the CUDA
// error code of the launch (0 on success).
int tpu_sdr_viterbi(const float* x, const int* out0, const int* out1, uint32_t* dec,
                    uint8_t* bits, int rows, int t_len, int n_out, int k, void* stream) {
  if (rows <= 0 || t_len <= 0) return 0;
  if (k < 2 || k > 12 || n_out < 1 || n_out > kMaxOut) return int(cudaErrorInvalidValue);
  if (dec == nullptr && needs_scratch(t_len, k)) return int(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (k) {
    case 2: return int(launch_warp<2>(x, out0, out1, dec, bits, rows, t_len, n_out, st));
    case 3: return int(launch_warp<3>(x, out0, out1, dec, bits, rows, t_len, n_out, st));
    case 4: return int(launch_warp<4>(x, out0, out1, dec, bits, rows, t_len, n_out, st));
    case 5: return int(launch_warp<5>(x, out0, out1, dec, bits, rows, t_len, n_out, st));
    case 6: return int(launch_warp<6>(x, out0, out1, dec, bits, rows, t_len, n_out, st));
    case 7: return int(launch_warp<7>(x, out0, out1, dec, bits, rows, t_len, n_out, st));
    default: break;
  }
  static_assert(kWarpMaxK == 7, "the switch above takes the warp route for k = 2..7");
  const int states = 1 << (k - 1);
  const int threads = states > kMaxThreads ? kMaxThreads : states;
  viterbi_kernel<<<rows, threads, 0, st>>>(x, out0, out1, dec, bits, t_len, n_out, k);
  return int(cudaGetLastError());
}

// 1 if tpu_sdr_viterbi needs the dec scratch for rows of t_len steps of a
// code of constraint length k (the block route, or rows too long for the
// warp route's shared memory), else 0.
int tpu_sdr_viterbi_needs_scratch(int t_len, int k) { return needs_scratch(t_len, k) ? 1 : 0; }

// cycles: (2,) int64. states in [64, 1024], a power of two.
int tpu_sdr_viterbi_step_probe(long long* cycles, int states, int t_len, void* stream) {
  if (states < 64 || states > kMaxThreads || (states & (states - 1))) {
    return int(cudaErrorInvalidValue);
  }
  viterbi_step_probe_kernel<<<1, states, 0, static_cast<cudaStream_t>(stream)>>>(cycles, t_len);
  return int(cudaGetLastError());
}

// cycles: (2,) int64. One warp.
int tpu_sdr_viterbi_warp_step_probe(long long* cycles, int t_len, void* stream) {
  viterbi_warp_step_probe_kernel<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>(cycles, t_len);
  return int(cudaGetLastError());
}

}  // extern "C"
