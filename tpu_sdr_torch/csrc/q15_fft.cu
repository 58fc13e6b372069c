// K1: the Q15 pipeline's device stage: [the RTL window,] the scaled 16-bit
// fixed-point FFT of the reference's xfft core and the magnitude of its
// wire words, on int16 frames.
//
// Replaces the device stage of tpu_sdr/runtime/q15.py (_window_fft,
// :121-153) and tpu_sdr/kernels/fft_q15.py fft_q15 (:149-207), which the
// JAX package runs as jitted XLA code (no Pallas kernel). Per frame of
// n = 2^m samples (n <= 16384):
//
//   window (with a ROM):  p = x * rom[i] (int32);
//                         x' = int16((p >> 15) + ((p >> 14) & 1))
//   m radix-2 DIF ranks:  half = n >> (t + 1); for each pair (a, b) half
//                         apart, j = the pair's offset in its group:
//     sum = sat16((a + b) >> s),  d = sat16((a - b) >> s)      (s = schedule[t])
//     p   = j == 0 ? d : sat16((d * W_n^(j << t)) >> 15)       (complex, Q15)
//   output:               re/im[k] = value[bitrev(k)] (int16), and
//                         |X|[k] = sqrt(re^2 + im^2) in fp32.
//
// Every value is saturated to int16 after every rank, so any grouping of
// the ranks' butterflies gives the same bits: each value goes through the
// butterflies of fft_q15_np and no others. The twiddles are the host's
// plan_q15 table (np round then clip), never recomputed and never formed
// as a product: rank 0's table W_n^e, e < n / 2, holds rank t's entry j at
// e = j << t. In registers a twiddle is int32, and entry 0 (the only e = 0,
// the table's (32767, 0)) becomes (32768, 0), with which the product is d
// exactly: the bypass, without a branch a butterfly. The two products of
// the complex multiply add in int32 before the shift (|d| |w| < 2^15
// sqrt(2) 2^15 < 2^31); right shifts of negative int32 are arithmetic.
// When s >= 1 the clamps of (a +- b) >> s are no-ops (|a +- b| <= 65535),
// so a rank whose shift is not 0 drops them (one uniform branch a rank);
// the clamps after the product always stay. The magnitude is __fmul_rn /
// __fadd_rn / __fsqrt_rn, the plain version's operations, so nvcc
// contracts nothing into an FMA.
//
// What bounds it on an H100: not bytes (2 in and 8 out a sample: 0.049 us
// a frame at 3.35 TB/s) but integer issue and latency: about 9 int32
// operations a sample a rank, 14 ranks, at 64 lanes an SM a cycle, and 14
// dependent butterflies. One block a frame leaves a frame on one SM. So a
// frame of n = 2^14 runs on a cluster of kClusterCtas CTAs (the cluster
// route), and a thread keeps 16 points in registers through up to four
// ranks between two exchanges:
//
//   the frame as 128 x 128, i = 128 r + c: DIF rank t pairs the indices
//   that differ in bit 13 - t, so ranks 0-6 work within a column (over r)
//   and ranks 7-13 within a row (over c).
//   phase A: CTA q of the cluster owns the 128 / C columns from q 128 / C;
//     8 threads a column. A1: thread (g, c) loads r = g + 8k, k < 16,
//     straight from device memory (the window applied), runs ranks 0-3 in
//     registers; the points go through shared memory (Y); A2: the thread
//     takes r = 8h + k', h = g and g + 8, k' < 8, and runs ranks 4-6 on
//     both groups of 8.
//   the X send: phase B runs row r on CTA b / (128 / C) as its local row u
//     = b % (128 / C), b = brev7(r); each point goes there, a thread's
//     points of rows b and b + 1 as one 8-byte store.
//   phase B: 8 threads a row. B1: thread (u, g) takes c = g + 8k from X,
//     runs ranks 7-10; through shared memory (Z); B2: c = 8h + k', h = g
//     and g + 8, ranks 11-13.
//   the W send: output k = brev7(c) 128 + brev7(r), and output row cp =
//     brev7(c) belongs to CTA cp / (128 / C), which stores it whole; each
//     point goes there, at column brev7(r).
//   the store: each thread stores 8 consecutive outputs twice, a warp two
//     whole output rows: re and im as 8 x int16 (16 bytes), |X| as two
//     float4.
//
// The X and W sends are asynchronous stores into the receiving CTA's
// shared memory (st.async ... mbarrier::complete_tx), counted in bytes on
// its mbarrier; a CTA waits on its own mbarrier for the points it is owed,
// and no CTA fences its memory for another. A relaxed cluster barrier
// (no fence) covers the mbarriers' initialisation before the first send,
// and a second one the exit: no CTA leaves while stores to it may be in
// flight. Y and Z are exchanges within a CTA, one __syncthreads each. Each
// layout (y_word, x_word, z_word, w_word) is an XOR swizzle under which
// every warp's accesses, scalar or vector, local or sent, are free of bank
// conflicts (tests/test_torch_q15_fft_schedule.py counts them). The
// twiddles a thread needs: phase A's 22 come from device memory into
// registers at the start, beside the frame's loads; phase B's are the 64
// row twiddles W_128^m (table entry m << 7), staged in shared memory and
// read into registers before each pass. Nothing is loaded from device
// memory inside the ranks.
//
// Smaller frames (n < 2^14) take the block route: a CTA takes
// max(n, kBlockPoints) points (several frames when n is small) in shared
// memory, the same passes of up to four ranks in registers (16 points a
// thread) with a barrier between passes, and the same vector stores.
// tpu_sdr_q15_fft_route says which route, and how many CTAs a frame, a
// launch of a given shape takes: a pure function of (frames, log2n).
//
// chip_smoke.py measures the latency floor of a frame with two probes:
// tpu_sdr_q15_butterfly_probe (cycles of one butterfly's dependent chain,
// a rank after a rank) and tpu_sdr_q15_memory_probe (cycles of one read
// from device memory and of one write with its fence). Times, floors and
// the cluster sizes tried are in PERF.md; scripts/torch_q15_phases.py
// stamps the phases above.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

#include <utility>

#include "error_string.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kMaxLog2 = 14;
constexpr int kClusterLog2 = 14;  // the cluster route's frame, 128 x 128
constexpr int kN = 1 << kClusterLog2;
constexpr int kLine = 128;        // points a column, and a row
constexpr int kPoints = 16;       // points a thread holds
constexpr int kThreadsPerLine = kLine / kPoints;
// CTAs a frame on the cluster route, chosen from the times of C = 1, 2, 4,
// 8 and 16 at F = 1, 8 and 64 (PERF.md; scripts/torch_kernel_ab.py
// --variant c1 ...).
constexpr int kClusterCtas = 8;
// Points a CTA of the block route holds (several frames when n is
// smaller).
constexpr int kBlockPoints = 2048;
constexpr int kZStride = 136;     // words a row of Z

__device__ __forceinline__ int sat16(int v) { return min(max(v, -32768), 32767); }

__device__ __forceinline__ int brev7(int x) { return int(__brev(unsigned(x)) >> 25); }
__host__ __device__ constexpr int brev3(int x) { return ((x & 1) << 2) | (x & 2) | ((x >> 2) & 1); }

// (re, im) int16 in one word, and back.
__device__ __forceinline__ uint32_t pack(int re, int im) {
  return __byte_perm(uint32_t(re), uint32_t(im), 0x5410);
}
__device__ __forceinline__ int lo16(uint32_t v) { return int(int16_t(v & 0xffffu)); }
__device__ __forceinline__ int hi16(uint32_t v) { return int(v) >> 16; }

// The RTL window's product, wrapped to int16 like the RTL's slice.
__device__ __forceinline__ int window(int x, int w) {
  const int p = x * w;
  return int(int16_t((p >> 15) + ((p >> 14) & 1)));
}

// A twiddle in registers: the table's entry e, entry 0 as (32768, 0).
struct Tw {
  int re, im;
};
__device__ __forceinline__ Tw twiddle(short2 w, int e) { return {e == 0 ? 32768 : int(w.x), int(w.y)}; }

// One butterfly in place: a <- sum, b <- rotated difference.
template <bool kScaled>
__device__ __forceinline__ void butterfly(int& ar, int& ai, int& br, int& bi, Tw w, int s) {
  int sr, si, dr, di;
  if (kScaled) {  // s >= 1: (a +- b) >> s already lies in int16
    sr = (ar + br) >> s;
    si = (ai + bi) >> s;
    dr = (ar - br) >> s;
    di = (ai - bi) >> s;
  } else {
    sr = sat16(ar + br);
    si = sat16(ai + bi);
    dr = sat16(ar - br);
    di = sat16(ai - bi);
  }
  br = sat16((dr * w.re - di * w.im) >> 15);
  bi = sat16((dr * w.im + di * w.re) >> 15);
  ar = sr;
  ai = si;
}

// Rank kU of a pass of kQ ranks on kG groups of 2^kQ points of re/im
// (register 2^kQ g + k holds group g's point k): it pairs registers ka and
// ka | span of each group, span = 2^(kQ-1-kU), with the twiddle
// w[ka & (span - 1)] (the groups share their twiddles).
template <int kQ, int kG, int kU, bool kScaled>
__device__ __forceinline__ void rank_pairs(int* re, int* im, const Tw* w, int s) {
  constexpr int kSpan = 1 << (kQ - 1 - kU);
#pragma unroll
  for (int g = 0; g < kG; ++g) {
#pragma unroll
    for (int ka = 0; ka < (1 << kQ); ++ka) {
      if (ka & kSpan) continue;
      const int a = (g << kQ) + ka;
      butterfly<kScaled>(re[a], im[a], re[a | kSpan], im[a | kSpan], w[ka & (kSpan - 1)], s);
    }
  }
}

template <int kQ, int kG, int kU>
__device__ __forceinline__ void rank(int* re, int* im, const Tw* w, int s) {
  if (s != 0) {
    rank_pairs<kQ, kG, kU, true>(re, im, w, s);
  } else {
    rank_pairs<kQ, kG, kU, false>(re, im, w, s);
  }
}

// Rank kU's twiddles start at w + tw_offset<kQ>(kU): 2^(kQ-1-kU) of them.
template <int kQ>
__host__ __device__ constexpr int tw_offset(int u) {
  return (1 << kQ) - (1 << (kQ - u));
}

// The rank of a pass's f-th twiddle.
template <int kQ>
__host__ __device__ constexpr int tw_rank(int f) {
  return f < tw_offset<kQ>(1) ? 0 : f < tw_offset<kQ>(2) ? 1 : f < tw_offset<kQ>(3) ? 2 : 3;
}

template <int kQ, int kG, int... kU>
__device__ __forceinline__ void pass_ranks(int* re, int* im, const Tw* w, const int* s,
                                           std::integer_sequence<int, kU...>) {
  (rank<kQ, kG, kU>(re, im, w + tw_offset<kQ>(kU), s[kU]), ...);
}

// kQ ranks in registers on kG groups of 2^kQ points, a rank of every group
// before the next rank; w: the pass's 2^kQ - 1 twiddles; s: its kQ shifts.
template <int kQ, int kG = 1>
__device__ __forceinline__ void pass(int* re, int* im, const Tw* w, const int* s) {
  pass_ranks<kQ, kG>(re, im, w, s, std::make_integer_sequence<int, kQ>{});
}

// ------------------------------------------------------------------ the cluster route (n = 2^14)

template <int kC>
struct Cluster {
  static constexpr int kCols = kLine / kC;  // columns a CTA owns in phase A, rows in phase B
  static constexpr int kThreads = kThreadsPerLine * kCols;
  static constexpr int kRowMask = kCols < 32 ? 32 / kCols - 1 : 0;
  static constexpr int kYZ = kLine * kCols > kCols * kZStride ? kLine * kCols : kCols * kZStride;
  static constexpr int kX = kLine * kCols;  // words a CTA receives in X, and in W
  static constexpr int kW = kLine * kCols;
  static constexpr int kSmemBytes = (kYZ + kX + kW + 64) * 4 + 2 * 8;  // + two mbarriers
  static_assert(kC >= 1 && kC <= 16 && kCols >= 8, "1 to 16 CTAs a frame");
};

// Y: point (r, cl) of phase A between A1 and A2.
template <int kC>
__device__ __forceinline__ int y_word(int r, int cl) {
  using S = Cluster<kC>;
  return (r * S::kCols + cl) ^ (((r >> 3) & S::kRowMask) * S::kCols);
}

// X: point (local row u, c) of phase B as its CTA receives it: rows u and
// u ^ 1 interleaved, so that a sender's two points of a column for the two
// rows are one 8-byte vector; c permuted by bit 1 of u (rows 2 apart in a
// reading warp fall in distinct banks).
__device__ __forceinline__ int x_word(int u, int c) {
  return (u >> 1) * 2 * kLine + 2 * (c ^ (((u >> 1) & 1) << 3)) + (u & 1);
}

// Z: point (u, c) of phase B between B1 and B2.
__device__ __forceinline__ int z_word(int u, int c) { return u * kZStride + (c ^ (((c >> 5) & 1) << 2)); }

// W: output point (row rl of the CTA's rows, column col < 128), in 4-word
// chunks, chunk col / 4 permuted within its row by its own bit 3 and by
// bits 1-3 of rl.
__device__ __forceinline__ int w_word(int rl, int col) {
  const int ch = col >> 2;
  return rl * kLine + (((ch ^ ((ch >> 3) & 1) ^ ((rl >> 1) & 7))) << 2) + (col & 3);
}

// 4 aligned words of shared memory as one 16-byte load.
__device__ __forceinline__ void load4(uint32_t* v, const uint32_t* p) {
  const uint4 t = *reinterpret_cast<const uint4*>(p);
  v[0] = t.x, v[1] = t.y, v[2] = t.z, v[3] = t.w;
}

// The exchanges between the CTAs of a cluster: each point goes to the CTA
// that needs it by an asynchronous store into that CTA's shared memory,
// which counts the bytes on its mbarrier (st.async ... complete_tx), so
// no CTA waits on another's fence. A CTA expects its bytes on the
// mbarrier, which completes its phase 0 once they have all landed. The
// cluster barrier (relaxed: no memory fence) is used twice: after the
// mbarriers' initialisation, before the first store into another CTA,
// and before exit, so that no CTA leaves while stores to it are in flight.
__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return uint32_t(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void mbar_init_expect(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(smem_addr(bar)) : "memory");
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(smem_addr(bar)),
               "r"(bytes) : "memory");
}
// Waits for the mbarrier's phase 0; traps after about 2^34 cycles (some
// seconds) rather than hang if its bytes never come.
__device__ __forceinline__ void mbar_wait(uint64_t* bar) {
  const long long t0 = clock64();
  for (;;) {
    uint32_t done;
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], 0;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(smem_addr(bar))
        : "memory");
    if (done) return;
    if (clock64() - t0 > (1ll << 34)) __trap();
  }
}
// The shared::cluster address of CTA rank's copy of a (a shared::cta
// address of this CTA).
__device__ __forceinline__ uint32_t map_rank(uint32_t a, int rank) {
  uint32_t d;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;" : "=r"(d) : "r"(a), "r"(rank));
  return d;
}
__device__ __forceinline__ void st_async(uint32_t addr, uint32_t v, uint32_t bar) {
  asm volatile("st.async.shared::cluster.mbarrier::complete_tx::bytes.b32 [%0], %1, [%2];"
               ::"r"(addr), "r"(v), "r"(bar) : "memory");
}
__device__ __forceinline__ void st_async2(uint32_t addr, uint32_t v0, uint32_t v1, uint32_t bar) {
  asm volatile("st.async.shared::cluster.mbarrier::complete_tx::bytes.v2.b32 [%0], {%1, %2}, [%3];"
               ::"r"(addr), "r"(v0), "r"(v1), "r"(bar) : "memory");
}
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.aligned;" ::: "memory");
}

// 8 points of an output row (words v[0..8), (re, im) each) to re, im and
// |X| at offset o.
__device__ __forceinline__ void store8(const uint32_t* v, int16_t* out_re, int16_t* out_im,
                                       float* mag, size_t o) {
  uint4 re, im;
  re.x = __byte_perm(v[0], v[1], 0x5410), im.x = __byte_perm(v[0], v[1], 0x7632);
  re.y = __byte_perm(v[2], v[3], 0x5410), im.y = __byte_perm(v[2], v[3], 0x7632);
  re.z = __byte_perm(v[4], v[5], 0x5410), im.z = __byte_perm(v[4], v[5], 0x7632);
  re.w = __byte_perm(v[6], v[7], 0x5410), im.w = __byte_perm(v[6], v[7], 0x7632);
  *reinterpret_cast<uint4*>(out_re + o) = re;
  *reinterpret_cast<uint4*>(out_im + o) = im;
  if (mag != nullptr) {
    float m[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const float fr = float(lo16(v[i]));
      const float fi = float(hi16(v[i]));
      m[i] = __fsqrt_rn(__fadd_rn(__fmul_rn(fr, fr), __fmul_rn(fi, fi)));
    }
    *reinterpret_cast<float4*>(mag + o) = make_float4(m[0], m[1], m[2], m[3]);
    *reinterpret_cast<float4*>(mag + o + 4) = make_float4(m[4], m[5], m[6], m[7]);
  }
}

template <int kC>
__global__ void __launch_bounds__(Cluster<kC>::kThreads)
q15_fft_cluster_kernel(const int16_t* __restrict__ x_re, const int16_t* __restrict__ x_im,
                       const int16_t* __restrict__ rom, const short2* __restrict__ tw,
                       const int* __restrict__ sched, int16_t* __restrict__ out_re,
                       int16_t* __restrict__ out_im, float* __restrict__ mag) {
  using S = Cluster<kC>;
  extern __shared__ __align__(16) uint32_t smem[];
  uint32_t* yz = smem;          // Y, then Z (apart by a barrier)
  uint32_t* xs = yz + S::kYZ;   // X, as this CTA receives it
  uint32_t* ws = xs + S::kX;    // W, as this CTA receives it
  short2* rt = reinterpret_cast<short2*>(ws + S::kW);  // W_128^m, m < 64
  uint64_t* bars = reinterpret_cast<uint64_t*>(rt + 64);  // X's and W's mbarriers
  const int tid = int(threadIdx.x);
  const int q = kC > 1 ? int(cg::this_cluster().block_rank()) : 0;
  const size_t base = size_t(blockIdx.x / kC) * kN;
  // Words `word` and `word` + 1 (word even) of X of CTA dest get v0 and
  // v1, one vector.
  const auto send_x = [&](int dest, int word, uint32_t v0, uint32_t v1) {
    if constexpr (kC > 1) {
      st_async2(map_rank(smem_addr(xs), dest) + 4 * word, v0, v1, map_rank(smem_addr(bars), dest));
    } else {
      xs[word] = v0;
      xs[word + 1] = v1;
    }
  };
  // Word `word` of W of CTA dest gets v.
  const auto send_w = [&](int dest, int word, uint32_t v) {
    if constexpr (kC > 1) {
      st_async(map_rank(smem_addr(ws), dest) + 4 * word, v, map_rank(smem_addr(bars + 1), dest));
    } else {
      ws[word] = v;
    }
  };
  if constexpr (kC > 1) {
    if (tid == 0) {
      mbar_init_expect(bars, S::kX * 4);
      mbar_init_expect(bars + 1, S::kW * 4);
    }
    cluster_arrive();  // waited for before the first send
  }

  int s[kMaxLog2];
#pragma unroll
  for (int t = 0; t < kMaxLog2; ++t) s[t] = __ldg(sched + t);

  // Phase A: columns. The twiddles of ranks 0-6, from device memory into
  // registers, beside the frame's loads.
  const int g = tid / S::kCols, cl = tid % S::kCols, c = q * S::kCols + cl;
  Tw wa1[15], wa2[7];
#pragma unroll
  for (int f = 0; f < 15; ++f) {
    const int u = tw_rank<4>(f), jj = f - tw_offset<4>(u);
    const int e = (kLine * g + c + (jj << 10)) << u;
    wa1[f] = twiddle(__ldg(tw + e), e);
  }
#pragma unroll
  for (int f = 0; f < 7; ++f) {
    const int u = tw_rank<3>(f), jj = f - tw_offset<3>(u);
    const int e = (c + (jj << 7)) << (4 + u);
    wa2[f] = twiddle(__ldg(tw + e), e);
  }
  if (tid < 64) rt[tid] = __ldg(tw + (tid << 7));

  int re[kPoints], im[kPoints];
#pragma unroll
  for (int k = 0; k < kPoints; ++k) {
    const int i = kLine * (g + kThreadsPerLine * k) + c;
    int vr = x_re[base + i];
    int vi = x_im != nullptr ? int(x_im[base + i]) : 0;
    if (rom != nullptr) {
      const int w = rom[i];
      vr = window(vr, w);
      vi = window(vi, w);
    }
    re[k] = vr;
    im[k] = vi;
  }
  pass<4>(re, im, wa1, s);  // A1: ranks 0-3
#pragma unroll
  for (int k = 0; k < kPoints; ++k) yz[y_word<kC>(g + kThreadsPerLine * k, cl)] = pack(re[k], im[k]);
  __syncthreads();
#pragma unroll
  for (int k = 0; k < kPoints; ++k) {
    const uint32_t v = yz[y_word<kC>(8 * (g + 8 * (k >> 3)) + (k & 7), cl)];
    re[k] = lo16(v);
    im[k] = hi16(v);
  }
  pass<3, 2>(re, im, wa2, s + 4);  // A2: ranks 4-6, two groups of 8
  // The X send: register k holds r = 64 (k >> 3) + 8 g + (k & 7), and
  // phase B runs row r on CTA b / kCols as its row b % kCols, b = brev7(r)
  // = brev3(k & 7) 16 + brev3(g) 2 + (k >> 3): registers k and k + 8 go to
  // rows b and b + 1 of one CTA, one vector. (Paired, the sends took half
  // the time; W's sends paired gained nothing, and stay single.)
  if constexpr (kC > 1) cluster_wait();  // every CTA's mbarriers are ready
  const int ga = brev7(g) >> 4;  // brev3(g)
#pragma unroll
  for (int k = 0; k < kPoints / 2; ++k) {
    const int b = (brev3(k) << 4) | (ga << 1);
    send_x(b / S::kCols, x_word(b % S::kCols, c), pack(re[k], im[k]), pack(re[k + 8], im[k + 8]));
  }
  if constexpr (kC > 1) {
    mbar_wait(bars);
  } else {
    __syncthreads();
  }

  // Phase B: rows. Row twiddles from shared memory into registers.
  const int u = tid / kThreadsPerLine, gb = tid % kThreadsPerLine;
  const int r = brev7(q * S::kCols + u);
  Tw wb1[15], wb2[7];
#pragma unroll
  for (int f = 0; f < 15; ++f) {
    const int uu = tw_rank<4>(f), jj = f - tw_offset<4>(uu);
    const int m = (gb + (jj << 3)) << uu;
    wb1[f] = twiddle(rt[m], m);
  }
#pragma unroll
  for (int f = 0; f < 7; ++f) {
    const int uu = tw_rank<3>(f), jj = f - tw_offset<3>(uu);
    const int m = jj << (4 + uu);
    wb2[f] = twiddle(rt[m], m);
  }
  // B1: register kk holds c = gb + 8 kk.
#pragma unroll
  for (int kk = 0; kk < kPoints; ++kk) {
    const uint32_t v = xs[x_word(u, gb + 8 * kk)];
    re[kk] = lo16(v);
    im[kk] = hi16(v);
  }
  pass<4>(re, im, wb1, s + 7);  // B1: ranks 7-10
#pragma unroll
  for (int k = 0; k < kPoints; ++k) yz[z_word(u, gb + kThreadsPerLine * k)] = pack(re[k], im[k]);
  __syncthreads();
#pragma unroll
  for (int k = 0; k < kPoints; k += 4) {
    uint32_t v[4];
    load4(v, yz + z_word(u, 8 * (gb + 8 * (k >> 3)) + (k & 7)));
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      re[k + i] = lo16(v[i]);
      im[k + i] = hi16(v[i]);
    }
  }
  pass<3, 2>(re, im, wb2, s + 11);  // B2: ranks 11-13, two groups of 8
  // The W send: register k holds c = 8 gb' + (k & 7), gb' = gb + 8 (k >> 3),
  // so its output row cp = brev7(c) = brev3(k & 7) 16 + brev3(gb) 2 +
  // (k >> 3), column q kCols + u; CTA cp / kCols owns output row cp.
  const int gr = brev7(gb) >> 4;  // brev3(gb)
#pragma unroll
  for (int k = 0; k < kPoints; ++k) {
    const int cp = (brev3(k & 7) << 4) | (gr << 1) | (k >> 3);
    send_w(cp / S::kCols, w_word(cp % S::kCols, q * S::kCols + u), pack(re[k], im[k]));
  }
  if constexpr (kC > 1) {
    mbar_wait(bars + 1);
    cluster_arrive();  // every store into this CTA has landed
  } else {
    __syncthreads();
  }

  // The store: unit v = tid + T w is outputs 8 (v % 16) .. + 8 of output
  // row q kCols + v / 16, so a warp stores two whole rows.
#pragma unroll
  for (int w = 0; w < 2; ++w) {
    const int v = tid + S::kThreads * w;
    const int rl = v >> 4, j = v & 15;
    uint32_t pts[8];
    load4(pts, ws + w_word(rl, 8 * j));
    load4(pts + 4, ws + w_word(rl, 8 * j + 4));
    store8(pts, out_re, out_im, mag, base + size_t(q * S::kCols + rl) * kLine + 8 * j);
  }
  if constexpr (kC > 1) cluster_wait();  // no store into any CTA of the cluster is in flight
}

// ------------------------------------------------------------------ the block route (n < 2^14)

__device__ __forceinline__ int block_slot(int p) { return p ^ ((p >> 5) & 31); }

// One pass of kQ ranks (t0 .. t0 + kQ - 1, over the index bits lo .. lo +
// kQ - 1) on the CTA's frames in shared memory: 16 / 2^kQ groups a thread.
template <int kQ>
__device__ __forceinline__ void block_pass(uint32_t* buf, const short2* tws, const int* sh,
                                           int log2n, int lo, int t0, int tid, int threads) {
  const int n = 1 << log2n;
#pragma unroll
  for (int v = 0; v < (kPoints >> kQ); ++v) {
    const int gi = tid + threads * v;
    const int fl = gi >> (log2n - kQ), gl = gi & ((n >> kQ) - 1);
    const int jbase = gl & ((1 << lo) - 1);
    const int p0 = (fl << log2n) + ((gl >> lo) << (lo + kQ)) + jbase;
    int re[1 << kQ], im[1 << kQ];
#pragma unroll
    for (int k = 0; k < (1 << kQ); ++k) {
      const uint32_t w = buf[block_slot(p0 + (k << lo))];
      re[k] = lo16(w);
      im[k] = hi16(w);
    }
    Tw w[(1 << kQ) - 1];
    int s[kQ];
#pragma unroll
    for (int u = 0; u < kQ; ++u) {
      s[u] = sh[t0 + u];
#pragma unroll
      for (int jj = 0; jj < (1 << (kQ - 1 - u)); ++jj) {
        const int e = (jbase + (jj << lo)) << (t0 + u);
        w[tw_offset<kQ>(u) + jj] = twiddle(tws[e], e);
      }
    }
    pass<kQ>(re, im, w, s);
#pragma unroll
    for (int k = 0; k < (1 << kQ); ++k) buf[block_slot(p0 + (k << lo))] = pack(re[k], im[k]);
  }
}

__global__ void __launch_bounds__(kN / 2 / kPoints)
q15_fft_block_kernel(const int16_t* __restrict__ x_re, const int16_t* __restrict__ x_im,
                     const int16_t* __restrict__ rom, const short2* __restrict__ tw,
                     const int* __restrict__ sched, int16_t* __restrict__ out_re,
                     int16_t* __restrict__ out_im, float* __restrict__ mag, int frames,
                     int log2n) {
  extern __shared__ __align__(16) uint32_t smem[];
  const int n = 1 << log2n;
  const int points = n > kBlockPoints ? n : kBlockPoints;
  uint32_t* buf = smem;
  short2* tws = reinterpret_cast<short2*>(buf + points);
  int* sh = reinterpret_cast<int*>(tws + n / 2);
  const int tid = int(threadIdx.x), threads = int(blockDim.x);
  const size_t cta0 = size_t(blockIdx.x) * size_t(points);
  const size_t total = size_t(frames) << log2n;
  for (int e = tid; e < n / 2; e += threads) tws[e] = __ldg(tw + e);
  if (tid < log2n) sh[tid] = __ldg(sched + tid);
#pragma unroll
  for (int k = 0; k < kPoints; ++k) {
    const int p = tid + threads * k;
    int vr = 0, vi = 0;
    if (cta0 + p < total) {
      vr = x_re[cta0 + p];
      vi = x_im != nullptr ? int(x_im[cta0 + p]) : 0;
      if (rom != nullptr) {
        const int w = rom[p & (n - 1)];
        vr = window(vr, w);
        vi = window(vi, w);
      }
    }
    buf[block_slot(p)] = pack(vr, vi);
  }
  __syncthreads();
  for (int done = 0; done < log2n;) {
    const int q = log2n - done < 4 ? log2n - done : 4;
    const int lo = log2n - done - q;
    switch (q) {
      case 4: block_pass<4>(buf, tws, sh, log2n, lo, done, tid, threads); break;
      case 3: block_pass<3>(buf, tws, sh, log2n, lo, done, tid, threads); break;
      case 2: block_pass<2>(buf, tws, sh, log2n, lo, done, tid, threads); break;
      default: block_pass<1>(buf, tws, sh, log2n, lo, done, tid, threads); break;
    }
    done += q;
    __syncthreads();
  }
#pragma unroll
  for (int w = 0; w < 2; ++w) {
    const int p0 = 8 * (tid + threads * w);
    uint32_t pts[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int p = p0 + i;
      const int k = p & (n - 1);
      pts[i] = buf[block_slot((p - k) + int(__brev(unsigned(k)) >> (32 - log2n)))];
    }
    if (cta0 + p0 + 8 <= total) {
      store8(pts, out_re, out_im, mag, cta0 + p0);
    } else {
      for (int i = 0; i < 8 && cta0 + p0 + i < total; ++i) {
        out_re[cta0 + p0 + i] = int16_t(lo16(pts[i]));
        out_im[cta0 + p0 + i] = int16_t(hi16(pts[i]));
        if (mag != nullptr) {
          const float fr = float(lo16(pts[i]));
          const float fi = float(hi16(pts[i]));
          mag[cta0 + p0 + i] = __fsqrt_rn(__fadd_rn(__fmul_rn(fr, fr), __fmul_rn(fi, fi)));
        }
      }
    }
  }
}

// ------------------------------------------------------------------ the latency floor's probes

// One warp runs ``steps`` butterflies, each on the last one's outputs,
// the rotated difference taken as the next a (the longer path): the
// dependent chain of one rank of the main path's schedule (s = 1).
// Lane 0 writes the clock64 cycles to cycles[0] and a sum of the values
// to cycles[1] (kept live).
__global__ void q15_butterfly_probe_kernel(long long* cycles, int steps, int s, Tw w) {
  int ar = 1000 + int(threadIdx.x), ai = -700, br = 300, bi = 20 * int(threadIdx.x);
  const long long t0 = clock64();
#pragma unroll 16
  for (int i = 0; i < steps; ++i) {
    butterfly<true>(ar, ai, br, bi, w, s);
    const int tr = ar, ti = ai;
    ar = br, ai = bi;
    br = tr, bi = ti;
  }
  const long long t1 = clock64();
  if (threadIdx.x == 0) {
    cycles[0] = t1 - t0;
    cycles[1] = ar + ai + br + bi;
  }
}

// The chase: line j of ``lines`` (128 bytes each) points to line j + stride.
__global__ void q15_memory_probe_init_kernel(unsigned* buf, unsigned lines, unsigned stride) {
  for (unsigned j = blockIdx.x * blockDim.x + threadIdx.x; j < lines; j += gridDim.x * blockDim.x) {
    buf[size_t(j) * 32] = (j + stride) % lines;
  }
}

// One thread: ``steps`` dependent reads of lines not in L2 (cycles[0]),
// then ``steps`` writes to other such lines, each followed by a fence that
// waits for it (cycles[1]); cycles[2] keeps the chase live.
__global__ void q15_memory_probe_kernel(unsigned* buf, unsigned lines, int steps,
                                        long long* cycles) {
  unsigned j = 0;
  long long t0 = clock64();
  for (int i = 0; i < steps; ++i) j = __ldcg(buf + size_t(j) * 32);
  long long t1 = clock64();
  cycles[0] = t1 - t0;
  t0 = clock64();
  for (int i = 0; i < steps; ++i) {
    __stcg(buf + (size_t(i) * 4099 + 7) % lines * 32, j + unsigned(i));
    __threadfence();
  }
  t1 = clock64();
  cycles[1] = t1 - t0;
  cycles[2] = j;
}

// ------------------------------------------------------------------ launch

// CTAs a frame on the cluster route, or 0 for the block route.
int route_ctas(int frames, int log2n) {
  (void)frames;
  return log2n == kClusterLog2 ? kClusterCtas : 0;
}

template <int kC>
cudaError_t launch_cluster(const int16_t* x_re, const int16_t* x_im, const int16_t* rom,
                           const short2* tw, const int* sched, int16_t* out_re, int16_t* out_im,
                           float* mag, int frames, cudaStream_t stream) {
  using S = Cluster<kC>;
  if (frames > INT_MAX / kC) return cudaErrorInvalidValue;
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  static bool configured[64] = {};  // per device, once
  if (device >= 64) return cudaErrorInvalidDevice;
  if (!configured[device]) {
    err = cudaFuncSetAttribute(q15_fft_cluster_kernel<kC>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, S::kSmemBytes);
    if (err != cudaSuccess) return err;
    if (kC > 8) {
      err = cudaFuncSetAttribute(q15_fft_cluster_kernel<kC>,
                                 cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
      if (err != cudaSuccess) return err;
    }
    configured[device] = true;
  }
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = kC;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(unsigned(frames) * kC);
  cfg.blockDim = dim3(S::kThreads);
  cfg.dynamicSmemBytes = S::kSmemBytes;
  cfg.stream = stream;
  cfg.attrs = &attr;
  cfg.numAttrs = kC > 1 ? 1 : 0;
  err = cudaLaunchKernelEx(&cfg, q15_fft_cluster_kernel<kC>, x_re, x_im, rom, tw, sched, out_re,
                           out_im, mag);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

cudaError_t launch_block(const int16_t* x_re, const int16_t* x_im, const int16_t* rom,
                         const short2* tw, const int* sched, int16_t* out_re, int16_t* out_im,
                         float* mag, int frames, int log2n, cudaStream_t stream) {
  const int n = 1 << log2n;
  const int points = n > kBlockPoints ? n : kBlockPoints;
  const long long blocks = ((long long)frames * n + points - 1) / points;
  const int smem = (points + n / 2 + kMaxLog2) * 4;
  cudaError_t err = cudaFuncSetAttribute(q15_fft_block_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  q15_fft_block_kernel<<<unsigned(blocks), points / kPoints, smem, stream>>>(
      x_re, x_im, rom, tw, sched, out_re, out_im, mag, frames, log2n);
  return cudaGetLastError();
}

bool aligned16(const void* p) { return p == nullptr || (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

}  // namespace

extern "C" {

// x_re, x_im (optional): (frames, 2^log2n) int16; rom (optional): (2^log2n,)
// int16, the window ROM; tw: (2^(log2n - 1), 2) int16, rank 0's Q15
// twiddles; sched: (log2n,) int32 shifts; out_re, out_im: (frames,
// 2^log2n) int16; mag (optional): (frames, 2^log2n) fp32. All contiguous,
// on the current device, the outputs 16-byte aligned; 1 <= log2n <= 14.
// The route is tpu_sdr_q15_fft_route's. Returns the CUDA error code of the
// launch (0 on success).
int tpu_sdr_q15_fft(const int16_t* x_re, const int16_t* x_im, const int16_t* rom,
                    const void* tw, const int* sched, int16_t* out_re, int16_t* out_im,
                    float* mag, int frames, int log2n, void* stream) {
  if (frames <= 0) return 0;
  if (log2n < 1 || log2n > kMaxLog2) return int(cudaErrorInvalidValue);
  if (!aligned16(out_re) || !aligned16(out_im) || !aligned16(mag)) {
    return int(cudaErrorMisalignedAddress);
  }
  const short2* t = static_cast<const short2*>(tw);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int ctas = route_ctas(frames, log2n);
  static_assert(kClusterCtas == 1 || kClusterCtas == 2 || kClusterCtas == 4 ||
                    kClusterCtas == 8 || kClusterCtas == 16,
                "the cluster route takes 1, 2, 4, 8 or 16 CTAs a frame");
  if (ctas == 0) {
    return int(launch_block(x_re, x_im, rom, t, sched, out_re, out_im, mag, frames, log2n, st));
  }
  return int(launch_cluster<kClusterCtas>(x_re, x_im, rom, t, sched, out_re, out_im, mag, frames,
                                          st));
}

// CTAs a frame that tpu_sdr_q15_fft's launch of this shape runs on: the
// cluster route's C (n = 2^14), or 0 for the block route.
int tpu_sdr_q15_fft_route(int frames, int log2n) { return route_ctas(frames, log2n); }

// cycles: (2,) int64. One warp, ``steps`` dependent butterflies at shift s
// with the twiddle (w_re, w_im).
int tpu_sdr_q15_butterfly_probe(long long* cycles, int steps, int s, int w_re, int w_im,
                                void* stream) {
  q15_butterfly_probe_kernel<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>(cycles, steps, s,
                                                                              Tw{w_re, w_im});
  return int(cudaGetLastError());
}

// buf: ``bytes`` of device memory, at least 256 MB: the first half holds
// the chase, the second is written to push it out of L2. cycles: (3,)
// int64.
int tpu_sdr_q15_memory_probe(void* buf, long long bytes, long long* cycles, int steps,
                             void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const long long half = bytes / 2;
  if (half < (128ll << 20) || steps < 1 || steps > 4096) return int(cudaErrorInvalidValue);
  unsigned* chase = static_cast<unsigned*>(buf);
  const unsigned lines = unsigned(half / 128);
  q15_memory_probe_init_kernel<<<1024, 256, 0, st>>>(chase, lines, 12289u);
  cudaError_t err = cudaMemsetAsync(static_cast<char*>(buf) + half, 0, size_t(half), st);
  if (err != cudaSuccess) return int(err);
  q15_memory_probe_kernel<<<1, 1, 0, st>>>(chase, lines, steps, cycles);
  return int(cudaGetLastError());
}

}  // extern "C"
