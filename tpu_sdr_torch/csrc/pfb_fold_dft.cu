// PFB channelizer core: the weighted overlap-fold of `taps` shifted rows and
// the two 128 x 128 real DFT products of the folded rows, the products on
// the tensor cores with fp32 operands split into three bf16 pieces.
//
// Replaces the TPU kernel tpu_sdr/kernels/pallas/pfb_kernel.py pfb_fold_dft
// (body _pfb_kernel). For batch row b and output step s of a (batch, R, 128)
// row array, R = steps + taps - 1:
//
//   fold[s][p] = sum_t rows[b][s + t][p] * h2[t][p]       (t = 0 .. taps-1)
//   A[b][s][k] = sum_p fold[s][p] * cos[p][k]
//   B[b][s][k] = sum_p fold[s][p] * sin[p][k]             (negated if neg_b)
//
// cos and sin are arguments, as in the TPU kernel, which multiplies by them
// at precision="highest" (six bf16 passes on the TPU): whatever their values,
// the kernel computes these two dense products. It assumes no DFT structure,
// so a radix FFT, which would compute another function for other planes, is
// not an option.
//
// Precision (csrc/split_bf16.cuh): the fold is IEEE fp32 (__fmul_rn /
// __fadd_rn, t ascending: the plain version's order, so the folded rows
// equal pfb_kernel.fold_rows bit for bit); each folded value and each plane
// value is split into three bf16 pieces, and a product takes the six piece
// products with i + j <= 2 as mma.sync m16n8k16 bf16 with fp32
// accumulation, each k-step of 16 in a fresh accumulator joined to the
// running sum by one IEEE add. tests/test_torch_pfb_split.py is the NumPy
// model of this arithmetic. Every `precision` the wrapper accepts runs it.
//
// Design (persistent: one 384-thread block per SM, blocks in pairs; warp
// specialised):
//
// - Block 2i computes A (the cos plane), block 2i + 1 computes B (sin), over
//   the same tiles of 64 steps (tile i, i + pairs, ...), so the second of a
//   pair reads a tile's rows from L2.
// - Four producer warps stage a tile's rows and taps - 1 halo rows in shared
//   memory by cp.async (rows past the end of the array zero-filled; the row
//   stride padded to 136 floats, so the fold's 8-byte loads do not
//   conflict) and fold them, warp r the 16 rows of m-tile r, each lane the
//   two column pairs of its A fragment slots, taps in blocks of 8 whose 23
//   rows it holds in registers; then split them and store the three pieces
//   in fragment order, 16 bytes a lane a piece, into one of two buffers,
//   and stage the next tile's rows. Where the rows and halo do not fit
//   beside the two buffers (taps > 183), the fold reads them through L1.
// - Eight consumer warps take the products: warp w owns columns [16w, 16w +
//   16) of its plane, whose three pieces, split once a block, stay in
//   registers as B fragments (8 k-steps x 2 n-tiles x 3 pieces x 2 words: 96
//   registers); it walks a tile's four m-tiles two at a time, 8 k-steps of 2
//   x 2 (m-tile, n-tile) accumulators, six MMAs each, the A pieces from
//   shared memory; then stores its 16 columns of the tile's steps (negated
//   for B with neg_b), masking steps past the end. Nothing is padded in
//   device memory.
// - Named barriers hand the two buffers over (full: producers to consumers;
//   empty: back), so one tile's fold runs under the previous tile's products.
//   The first tile is folded by four consumer warps before the roles split.
//
// A step's result depends only on its own rows and the fixed order of the
// operations on them, so it does not depend on the tile it falls in, on the
// number of steps, or on the batch.
//
// What bounds it on an H100: the function reads 4 bytes and writes 8 per
// input sample (100.8 MB, 0.030 ms at 8 x 2^20 samples); an FFT's count of
// operations (0.28 GFLOP) is less. For arbitrary planes the kernel's floor
// is its dense work, 512 operations a sample (4.295 GFLOP) times six bf16
// passes at 989 TFLOP/s: 0.026 ms, below the bytes bound. Shared memory
// (dynamic): 96 KiB of pieces and (64 + taps - 1) x 544 bytes of rows, at
// most 232,128 bytes (taps = 183). Its times on the card are in PERF.md.

#include <cuda_runtime.h>
#include <stdint.h>

#include "error_string.cuh"
#include "split_bf16.cuh"

namespace {

using split_bf16::add4;
using split_bf16::kPieces;
using split_bf16::mma6;
using split_bf16::split_frag;
using split_bf16::split_pair;

constexpr int kM = 128;                   // channels (the DFT size, K and N)
constexpr int kTile = 64;                 // output steps per tile
constexpr int kMTiles = kTile / 16;       // m-tiles of a tile
constexpr int kMGroup = 2;                // m-tiles the products walk at once
constexpr int kKSteps = kM / 16;          // k-steps of a product
constexpr int kConsumers = 256;           // 8 warps x 16 columns = one plane
constexpr int kProducers = 32 * kMTiles;  // 4 warps, an m-tile each: rows, fold, split
constexpr int kThreads = kConsumers + kProducers;
constexpr int kStride = kM + 8;           // row stride (floats) of the staged rows
constexpr int kASlots = kPieces * kMTiles * kKSteps * 32;  // uint4 slots of a tile's A pieces
constexpr size_t kPieceBytes = size_t(2) * kASlots * 16;    // two tiles' A pieces: 96 KiB
constexpr size_t kMaxSmem = 232448;       // a block's shared memory on an H100

// Named barriers (0 is __syncthreads): a buffer's A pieces are full (the
// producers arrive, the consumers wait) or empty (the reverse); the
// producers among themselves.
constexpr int kFull = 1;   // + buffer
constexpr int kEmpty = 3;  // + buffer
constexpr int kProd = 5;

__host__ __device__ constexpr size_t rows_bytes(int taps) {
  return size_t(kTile + taps - 1) * kStride * sizeof(float);
}

// Whether a tile's rows and halo fit in shared memory beside the pieces.
__host__ __device__ constexpr bool staged(int taps) {
  return kPieceBytes + rows_bytes(taps) <= kMaxSmem;
}

__device__ __forceinline__ void bar_sync(int id, int count) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}

__device__ __forceinline__ void bar_arrive(int id, int count) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}

// 16 bytes from device to shared memory by cp.async; src_bytes 0 zero-fills.
__device__ __forceinline__ void copy16_async(void* dst, const void* src, int src_bytes) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src),
               "r"(src_bytes)
               : "memory");
}

// This thread's cp.async copies are complete and visible to it.
__device__ __forceinline__ void wait_async() { asm volatile("cp.async.wait_all;\n" ::: "memory"); }

// Producer p stages rows [s0, s0 + kTile + taps - 1) of batch row b into xs
// (zero past r_rows: only masked steps read them).
__device__ __forceinline__ void stage_rows(const float* __restrict__ rows, float* xs, int b,
                                           int s0, int r_rows, int taps, int p) {
  const int n = kTile + taps - 1;
  const int live = min(n, r_rows - s0);
  const float* src = rows + (size_t(b) * r_rows + s0) * kM;
  for (int i = p; i < n * (kM / 4); i += kProducers) {
    const int r = i / (kM / 4), c = 4 * (i % (kM / 4));
    copy16_async(xs + r * kStride + c, r < live ? src + size_t(r) * kM + c : rows,
                 r < live ? 16 : 0);
  }
}

// The fold of m-tile r of the tile of steps [s0, s0 + 64) of batch row b
// for this lane's A fragment columns c0 = 16s + 2tig and c0 + 8 (s = lane /
// 4, tig = lane % 4), all 16 rows: acc = -0 + x[row] h[0] + x[row + 1] h[1]
// + ..., t ascending (adding to -0 changes no bit, so this is the plain
// version's fold). Taps go in blocks of 8, for which the 23 rows they need
// are loaded once into registers (from the staged rows xs, or through L1).
// Then the eight slots' three pieces, stored in fragment order to ap.
template <bool kStaged>
__device__ __forceinline__ void fold_mtile(const float* __restrict__ rows,
                                           const float* __restrict__ h2, const float* xs,
                                           uint4* ap, int b, int s0, int r_rows, int taps, int r,
                                           int lane) {
  const int s = lane >> 2;
  const int c0 = 16 * s + 2 * (lane & 3);
  const int last = kStaged ? kTile + taps - 2 : r_rows - 1 - s0;  // the last row to read
  float2 v[2][16];  // [column pair][row of the m-tile]
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    const int c = c0 + 8 * e;
#pragma unroll
    for (int j = 0; j < 16; ++j) v[e][j] = make_float2(-0.f, -0.f);
    for (int t0 = 0; t0 < taps; t0 += 8) {
      float2 win[16 + 7];
#pragma unroll
      for (int i = 0; i < 16 + 7; ++i) {
        const int row = min(16 * r + t0 + i, last);
        win[i] = kStaged ? *reinterpret_cast<const float2*>(xs + row * kStride + c)
                         : __ldg(reinterpret_cast<const float2*>(
                               rows + (size_t(b) * r_rows + s0 + row) * kM + c));
      }
      float2 h[8];  // the block's prototype values (the last tap's past the end)
#pragma unroll
      for (int dt = 0; dt < 8; ++dt)
        h[dt] = __ldg(reinterpret_cast<const float2*>(h2 + min(t0 + dt, taps - 1) * kM + c));
#pragma unroll
      for (int dt = 0; dt < 8; ++dt) {
        if (t0 + dt < taps) {
#pragma unroll
          for (int j = 0; j < 16; ++j) {
            v[e][j].x = __fadd_rn(v[e][j].x, __fmul_rn(win[j + dt].x, h[dt].x));
            v[e][j].y = __fadd_rn(v[e][j].y, __fmul_rn(win[j + dt].y, h[dt].y));
          }
        }
      }
    }
  }
#pragma unroll
  for (int gid = 0; gid < 8; ++gid) {  // slot (r, s, 4 gid + tig): a0 .. a3
    const float2 q[4] = {v[0][gid], v[0][gid + 8], v[1][gid], v[1][gid + 8]};
    uint32_t a[kPieces][4];
    split_frag(q, a);
#pragma unroll
    for (int k = 0; k < kPieces; ++k)
      ap[((k * kMTiles + r) * kKSteps + s) * 32 + 4 * gid + (lane & 3)] =
          make_uint4(a[k][0], a[k][1], a[k][2], a[k][3]);
  }
}

// Consumer warp w's 16 columns of a tile from its A pieces ap and its B
// fragments bf: m-tiles two at a time, 8 k-steps of 2 x 2 (m-tile, n-tile)
// accumulators, six MMAs each; then the stores of the steps below `steps`
// (negated with `negate`).
__device__ __forceinline__ void products_tile(const uint4* ap,
                                              const uint32_t (&bf)[kKSteps][2][2][kPieces],
                                              float* __restrict__ out, int b, int s0, int steps,
                                              bool negate, int w, int lane) {
#pragma unroll 1
  for (int m0 = 0; m0 < kMTiles; m0 += kMGroup) {
    float acc[kMGroup][2][4];
#pragma unroll
    for (int g = 0; g < kMGroup; ++g)
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[g][h][c] = 0.f;
#pragma unroll
    for (int s = 0; s < kKSteps; ++s) {
      uint32_t a[kMGroup][kPieces][4];
#pragma unroll
      for (int g = 0; g < kMGroup; ++g)
#pragma unroll
        for (int k = 0; k < kPieces; ++k) {
          const uint4 u = ap[((k * kMTiles + m0 + g) * kKSteps + s) * 32 + lane];
          a[g][k][0] = u.x; a[g][k][1] = u.y; a[g][k][2] = u.z; a[g][k][3] = u.w;
        }
#pragma unroll
      for (int g = 0; g < kMGroup; ++g)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          float d[4] = {0.f, 0.f, 0.f, 0.f};
          mma6(d, a[g], bf[s][h][0], bf[s][h][1]);
          add4(acc[g][h], d);
        }
    }
#pragma unroll
    for (int g = 0; g < kMGroup; ++g)
#pragma unroll
      for (int e = 0; e < 2; ++e) {  // rows gid, gid + 8 of m-tile m0 + g
        const int step = s0 + 16 * (m0 + g) + (lane >> 2) + 8 * e;
        if (step >= steps) continue;
        float* o = out + (size_t(b) * steps + step) * kM + 16 * w + 2 * (lane & 3);
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const float x = acc[g][h][2 * e], y = acc[g][h][2 * e + 1];
          *reinterpret_cast<float2*>(o + 8 * h) = negate ? make_float2(-x, -y) : make_float2(x, y);
        }
      }
  }
}

template <bool kStaged>
__global__ void __launch_bounds__(kThreads, 1)
pfb_fold_dft_kernel(const float* __restrict__ rows, const float* __restrict__ h2,
                    const float* __restrict__ cos, const float* __restrict__ sin,
                    float* __restrict__ a_out, float* __restrict__ b_out, int batch,
                    int r_rows, int taps, int neg_b) {
  extern __shared__ __align__(16) uint4 smem[];
  // A pieces of two tiles [2][piece][m-tile][k-step][lane], then the rows
  // [kTile + taps - 1][kStride] (kStaged)
  float* xs = reinterpret_cast<float*>(smem + 2 * kASlots);
  const int steps = r_rows - taps + 1;
  const int row_tiles = (steps + kTile - 1) / kTile;
  const int tiles = batch * row_tiles;
  const int pairs = gridDim.x >> 1;
  const int lane = threadIdx.x & 31;
  const int first = blockIdx.x >> 1;
  if (first >= tiles) return;

  // The first tile's rows, then its fold by four consumer warps (an m-tile
  // a warp) while the producers wait: the producers' pipeline starts with
  // the second tile.
  const bool producer = threadIdx.x >= kConsumers;
  const int p = threadIdx.x - kConsumers;
  if (kStaged && producer) {
    stage_rows(rows, xs, first / row_tiles, first % row_tiles * kTile, r_rows, taps, p);
    wait_async();
  }
  __syncthreads();  // the first tile's rows are staged
  if (threadIdx.x < 32 * kMTiles) {
    fold_mtile<kStaged>(rows, h2, xs, smem, first / row_tiles, first % row_tiles * kTile, r_rows,
                        taps, threadIdx.x >> 5, lane);
  }
  __syncthreads();  // the first tile's pieces are stored and its rows are free

  if (producer) {
    int i = 1;
    int t = first + pairs;
    if (kStaged && t < tiles) stage_rows(rows, xs, t / row_tiles, t % row_tiles * kTile, r_rows, taps, p);
    for (; t < tiles; t += pairs, ++i) {
      const int b = t / row_tiles, s0 = t % row_tiles * kTile;
      if (kStaged) {
        wait_async();
        bar_sync(kProd, kProducers);  // every producer's rows have landed
      }
      if (i >= 2) bar_sync(kEmpty + (i & 1), kThreads);  // the consumers are done with tile i - 2
      fold_mtile<kStaged>(rows, h2, xs, smem + (i & 1) * kASlots, b, s0, r_rows, taps, p >> 5,
                          lane);
      if (kStaged && t + pairs < tiles) {
        bar_sync(kProd, kProducers);  // every producer is done with the rows
        const int tn = t + pairs;
        stage_rows(rows, xs, tn / row_tiles, tn % row_tiles * kTile, r_rows, taps, p);
      }
      bar_arrive(kFull + (i & 1), kThreads);
    }
    for (int j = max(i - 2, 0); j < i; ++j) bar_sync(kEmpty + (j & 1), kThreads);
    return;
  }

  // The consumers. Columns [16w, 16w + 16) of the plane as B fragments,
  // split once: bf[k-step][n-tile][b0, b1][piece]; b0 holds rows 16s + 2tig
  // + {0, 1}, b1 rows + 8, of column 16w + 8h + gid.
  const int plane = blockIdx.x & 1;
  const float* bm = plane ? sin : cos;
  float* out = plane ? b_out : a_out;
  const bool negate = plane && neg_b;
  const int w = threadIdx.x >> 5;
  uint32_t bf[kKSteps][2][2][kPieces];
#pragma unroll
  for (int s = 0; s < kKSteps; ++s)
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        const int k0 = 16 * s + 2 * (lane & 3) + 8 * q;
        const int n = 16 * w + 8 * h + (lane >> 2);
        split_pair(__ldg(bm + k0 * kM + n), __ldg(bm + (k0 + 1) * kM + n), bf[s][h][q]);
      }
  int i = 0;
  for (int t = first; t < tiles; t += pairs, ++i) {
    if (i > 0) bar_sync(kFull + (i & 1), kThreads);  // the producers have stored tile i's pieces
    products_tile(smem + (i & 1) * kASlots, bf, out, t / row_tiles, t % row_tiles * kTile, steps,
                  negate, w, lane);
    bar_arrive(kEmpty + (i & 1), kThreads);
  }
}

}  // namespace

extern "C" {

// rows: (batch, r_rows, 128) fp32; h2: (taps, 128) fp32; cos, sin: (128, 128)
// fp32; a, b: (batch, r_rows - taps + 1, 128) fp32. All contiguous and
// 16-byte aligned, on the current device; 1 <= taps <= min(r_rows, 256).
// Returns the CUDA error code of the launch (0 on success).
int tpu_sdr_pfb_fold_dft(const float* rows, const float* h2, const float* cos,
                         const float* sin, float* a, float* b, int batch,
                         int r_rows, int taps, int neg_b, void* stream) {
  const int steps = r_rows - taps + 1;
  if (batch <= 0 || steps <= 0) return 0;
  const bool stage = staged(taps);
  const auto kernel = stage ? pfb_fold_dft_kernel<true> : pfb_fold_dft_kernel<false>;
  const size_t smem = kPieceBytes + (stage ? rows_bytes(taps) : 0);
  int device = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return int(err);
  const long long tiles = (long long)batch * ((steps + kTile - 1) / kTile);
  const int pairs = int(tiles < sms / 2 ? tiles : sms / 2);
  kernel<<<2 * pairs, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      rows, h2, cos, sin, a, b, batch, r_rows, taps, neg_b);
  return int(cudaGetLastError());
}

}  // extern "C"
