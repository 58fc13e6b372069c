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
// 2^23 = 2^24 and |acc| <= 2^22 + 2^24 < 2^25, far inside 2^31, so the
// sums may be taken in any order.
//
// The design: a wavefront, one section a lane. The chain is sequential by
// nature (the clip is not linear), so the kernel is bound by the latency
// of its dependent integer operations, not by bytes or issue. A row is
// walked by S lanes of a warp (a group of G = S rounded up to a power of
// two lanes; 32 / G rows a warp). Lane s owns section s: its coefficients
// and state stay in registers. At step j lane s filters sample
// j - kChunk * s, so a row takes T + kChunk (S - 1) steps, not T * S. Lane
// 0 takes the windowed sample; lane s > 0 the output of lane s - 1 for the
// same sample, made a chunk (kChunk steps) before. The hand-over goes
// through shared memory a chunk at a time: each lane writes its chunk of
// outputs to a row of its own (16-byte stores), the warp meets at one
// __syncwarp a chunk, and the next lane reads the chunk back (16-byte
// reads) before it starts, so no read waits inside the chunk. (A shuffle a
// step was slower: the compiler issues it next to its consumer, and an
// in-order warp then waits out its latency on the chain.) The critical
// path is one section's own recurrence:
//
//   acc[n] = (b0 v[n] + b1 v[n-1] + z1[n-1]) - a1 y[n-1]
//
// The bracket does not depend on y[n-1] (z1[n-1] = b2 v[n-2] - a2 y[n-2]),
// so from y[n-1] to y[n] it is one IMAD (acc and acc + 32 side by side),
// the add of acc's sign, the shift and the clip's min and max: five
// dependent integer operations a step. The state carried a lane is
// (R = b1 v[n-1] + z1[n-1], z1[n], y[n-1]), z0[n] = R - a1 y[n-1]; zi
// enters as R = z0, y = 0.
//
// At the edges (a lane whose sample index is below 0, or at T or above) a
// predicate keeps the lane's state: the chunks that hold such a lane take
// the predicated form, the rest (all but S - 1 chunks at the start and one
// at the end) the plain one. The input: the warp loads 1024 samples ahead
// (R rows x L samples, coalesced 16-byte vectors, four a lane), applies the
// window on the load, writes the windowed vectors out, and keeps them as
// int32 in a double-buffered shared tile, from which lane 0 reads its
// chunks. The output: lane S - 1 collects its samples in a ring of 8
// registers and stores each full ring as one 16-byte vector. Its times on
// the card are in PERF.md.

#include <cuda_runtime.h>
#include <stdint.h>

#include "error_string.cuh"

namespace {

constexpr int kVec = 8;  // int16 samples a 16-byte access
constexpr int kMaxSections = 8;
constexpr int kChunk = 32;    // steps between a section and the next, a hand-over
constexpr int kTileVecs = 4;  // 16-byte vectors a lane loads a tile

// Lanes a row, rows a warp, samples a row a tile.
template <int S>
struct Shape {
  static constexpr int G = S <= 1 ? 1 : S <= 2 ? 2 : S <= 4 ? 4 : 8;
  static constexpr int R = 32 / G;
  static constexpr int L = 32 * kTileVecs * kVec / R;  // R * L = 1024
  static constexpr int LAG = kChunk * (S - 1);        // lane S - 1's delay in steps
  static constexpr int PAD = 4;                       // ints after each tile row
  static_assert(L % kChunk == 0, "a tile holds whole chunks");
};

union Vec8 {
  uint4 u;
  int16_t s[kVec];
};

__device__ __forceinline__ int window_q15(int x, int w) {
  const int p = x * w;
  return int16_t((p >> 15) + ((p >> 14) & 1));  // wraps like the RTL's slice
}

// One section's step: y from the bracket Q = b0 v + R and the previous y.
// acc and acc + 32 come from two multiply-adds side by side (the second
// as PTX, so that the compiler does not fold it into an add after the
// first): the rounding is then one add of acc's sign, and from y_prev to y
// the chain is an IMAD, that add, the shift and the clip's min and max.
__device__ __forceinline__ int section_out(int q_bracket, int neg_a1, int y_prev) {
  const int acc = q_bracket + neg_a1 * y_prev;
  int acc32;
  asm("mad.lo.s32 %0, %1, %2, %3;" : "=r"(acc32) : "r"(neg_a1), "r"(y_prev), "r"(q_bracket + 32));
  return min(max((acc32 + (acc >> 31)) >> 6, -32768), 32767);
}

struct Lane {
  int b0, b1, b2, na1, na2;  // coefficients (-a1, -a2); zero on idle lanes
  int r, z1, y;              // the carried state (see above)
  int ring[kVec];            // lane S - 1's outputs, sample i at i mod 8
};

// One chunk of kChunk steps from j0: input i of the chunk at in[i], this
// lane's outputs to out[i] (both 16-byte aligned). All the inputs are read
// first, 16 bytes a read, so that no read waits behind a write. kEdge: some
// lane of the warp is off its row's samples in this chunk (its state must
// not move there).
template <int S, bool kEdge>
__device__ __forceinline__ void chunk(Lane& ln, int j0, int sec, int t_len, const int* in,
                                      int* out, int16_t* y_row, bool store_lane, uint4* sink) {
  using Sh = Shape<S>;
  int vin[kChunk];
#pragma unroll
  for (int q = 0; q < kChunk / 4; ++q) {
    const int4 w = reinterpret_cast<const int4*>(in)[q];
    vin[4 * q + 0] = w.x;
    vin[4 * q + 1] = w.y;
    vin[4 * q + 2] = w.z;
    vin[4 * q + 3] = w.w;
  }
  int yq[4];
#pragma unroll
  for (int u = 0; u < kChunk; ++u) {
    const int v = vin[u];
    const int q = ln.b0 * v + ln.r;
    const int y = section_out(q, ln.na1, ln.y);
    const int r = ln.b1 * v + ln.z1;
    const int z1 = ln.b2 * v + ln.na2 * y;
    if (kEdge) {
      const int i = j0 + u - kChunk * sec;
      const bool on = i >= 0 && i < t_len;
      ln.r = on ? r : ln.r;
      ln.z1 = on ? z1 : ln.z1;
      ln.y = on ? y : ln.y;
    } else {
      ln.r = r;
      ln.z1 = z1;
      ln.y = y;
    }
    yq[u % 4] = y;
    if (u % 4 == 3) reinterpret_cast<int4*>(out)[u / 4] = make_int4(yq[0], yq[1], yq[2], yq[3]);
    ln.ring[u % kVec] = y;
    if (u % kVec == kVec - 1) {
      const int i = j0 + u - Sh::LAG;  // lane S - 1's sample at this step
      const bool put = store_lane && i >= kVec - 1 && i < t_len;
      uint4 w;
      w.x = (uint32_t(ln.ring[0]) & 0xffffu) | (uint32_t(ln.ring[1]) << 16);
      w.y = (uint32_t(ln.ring[2]) & 0xffffu) | (uint32_t(ln.ring[3]) << 16);
      w.z = (uint32_t(ln.ring[4]) & 0xffffu) | (uint32_t(ln.ring[5]) << 16);
      w.w = (uint32_t(ln.ring[6]) & 0xffffu) | (uint32_t(ln.ring[7]) << 16);
      // every lane stores (no branch): the others into a shared sink
      *(put ? reinterpret_cast<uint4*>(y_row) + (i - (kVec - 1)) / kVec : sink) = w;
    }
  }
}

template <int S>
__global__ void __launch_bounds__(32)
sosfilt_q15_kernel(const int* __restrict__ sos, const int16_t* __restrict__ x, int rows,
                   int t_len, const int16_t* __restrict__ rom, int n_rom,
                   const int* __restrict__ zi, int16_t* __restrict__ xw,
                   int16_t* __restrict__ y, int* __restrict__ zf) {
  using Sh = Shape<S>;
  constexpr int kRowInts = Sh::L + Sh::PAD;
  // The windowed input, double-buffered by tile; each lane's outputs,
  // double-buffered by chunk (a row a lane, padded so that 16-byte accesses
  // of 8 lanes fall in distinct banks).
  __shared__ __align__(16) int tile[2][Sh::R][kRowInts];
  __shared__ __align__(16) int xfer[2][32][kChunk + 4];
  __shared__ uint4 sink[32];

  const int lane = threadIdx.x;
  const int sec = lane % Sh::G;
  const int grp = lane / Sh::G;
  const int row = blockIdx.x * Sh::R + grp;
  const bool row_ok = row < rows;
  const bool mine = row_ok && sec < S;  // a lane that owns a section of a row

  Lane ln;
  ln.b0 = ln.b1 = ln.b2 = ln.na1 = ln.na2 = 0;
  ln.r = ln.z1 = ln.y = 0;
#pragma unroll
  for (int k = 0; k < kVec; ++k) ln.ring[k] = 0;
  if (sec < S) {
    ln.b0 = sos[6 * sec + 0];
    ln.b1 = sos[6 * sec + 1];
    ln.b2 = sos[6 * sec + 2];
    ln.na1 = -sos[6 * sec + 4];
    ln.na2 = -sos[6 * sec + 5];
  }
  if (mine) {
    ln.r = zi[(size_t(row) * S + sec) * 2 + 0];
    ln.z1 = zi[(size_t(row) * S + sec) * 2 + 1];
  }

  // The tile's loads: lane, vector k -> warp vector lane + 32 k -> (tile
  // row, vector in the row).
  constexpr int kRowVecs = Sh::L / kVec;
  const int first_row = blockIdx.x * Sh::R;
  const int t_vecs = t_len / kVec;
  const int rom_vecs = n_rom / kVec;
  uint4 stage[kTileVecs], stage_rom[kTileVecs];
  auto load_tile = [&](int t) {
#pragma unroll
    for (int k = 0; k < kTileVecs; ++k) {
      const int v = lane + 32 * k;
      const int r = first_row + v / kRowVecs;
      const int c = t * kRowVecs + v % kRowVecs;
      const bool in = r < rows && c < t_vecs;
      stage[k] = in ? reinterpret_cast<const uint4*>(x + size_t(r) * t_len)[c]
                    : make_uint4(0, 0, 0, 0);
      if (rom != nullptr) {
        stage_rom[k] = in ? reinterpret_cast<const uint4*>(rom)[c % rom_vecs]
                          : make_uint4(0, 0, 0, 0);
      }
    }
  };
  auto put_tile = [&](int t, int buf) {
#pragma unroll
    for (int k = 0; k < kTileVecs; ++k) {
      const int v = lane + 32 * k;
      const int tr = v / kRowVecs;
      const int r = first_row + tr;
      const int c = t * kRowVecs + v % kRowVecs;
      Vec8 in;
      in.u = stage[k];
      if (rom != nullptr) {
        Vec8 w;
        w.u = stage_rom[k];
#pragma unroll
        for (int e = 0; e < kVec; ++e) in.s[e] = int16_t(window_q15(in.s[e], w.s[e]));
        if (xw != nullptr && r < rows && c < t_vecs) {
          reinterpret_cast<uint4*>(xw + size_t(r) * t_len)[c] = in.u;
        }
      }
      int* dst = &tile[buf][tr][(v % kRowVecs) * kVec];
      reinterpret_cast<int4*>(dst)[0] = make_int4(in.s[0], in.s[1], in.s[2], in.s[3]);
      reinterpret_cast<int4*>(dst)[1] = make_int4(in.s[4], in.s[5], in.s[6], in.s[7]);
    }
  };

  const int steps = t_len + Sh::LAG;
  const int tiles = (steps + Sh::L - 1) / Sh::L;
  load_tile(0);
  put_tile(0, 0);
  __syncwarp();
  int16_t* y_row = row_ok ? y + size_t(row) * t_len : y;
  const bool store_lane = row_ok && sec == S - 1;
  int k = 0;  // the chunk
  for (int t = 0; t < tiles; ++t) {
    const int buf = t & 1;
    const bool more = (t + 1) * Sh::L < t_len;
    if (more) load_tile(t + 1);
    for (int c = 0; c < Sh::L; c += kChunk, ++k) {
      const int j0 = t * Sh::L + c;
      if (j0 >= steps) break;
      // lane 0 reads the tile, lane s the chunk lane s - 1 wrote before
      const int* in = sec == 0 ? &tile[buf][grp][c] : &xfer[(k + 1) & 1][lane - 1][0];
      int* out = &xfer[k & 1][lane][0];
      if (j0 >= Sh::LAG && j0 + kChunk <= t_len) {
        chunk<S, false>(ln, j0, sec, t_len, in, out, y_row, store_lane, &sink[lane]);
      } else {
        chunk<S, true>(ln, j0, sec, t_len, in, out, y_row, store_lane, &sink[lane]);
      }
      __syncwarp();
    }
    if (more) put_tile(t + 1, buf ^ 1);
    __syncwarp();
  }
  if (mine) {
    zf[(size_t(row) * S + sec) * 2 + 0] = ln.r + ln.na1 * ln.y;
    zf[(size_t(row) * S + sec) * 2 + 1] = ln.z1;
  }
}

template <int S>
cudaError_t launch_sections(const int* sos, const int16_t* x, int rows, int t_len,
                            const int16_t* rom, int n_rom, const int* zi, int16_t* xw,
                            int16_t* y, int* zf, cudaStream_t stream) {
  const int blocks = (rows + Shape<S>::R - 1) / Shape<S>::R;
  sosfilt_q15_kernel<S><<<blocks, 32, 0, stream>>>(sos, x, rows, t_len, rom, n_rom, zi, xw, y,
                                                    zf);
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

// The steps between a section's output and the next section's use of it
// (kChunk): a row takes t_len + delay * (sections - 1) steps.
int tpu_sdr_sosfilt_q15_section_delay() { return kChunk; }

}  // extern "C"
