// Per-frame zero-state IIR summaries: the state that the composite 12th-order
// cascade reaches at the end of each windowed frame when it enters the frame
// at rest, as one direct product a frame.
//
// Replaces the TPU kernel tpu_sdr/kernels/pallas/iir_fft.py iir_summaries
// (body _summaries_kernel: window, forcing xw @ PT, masked doubling scan,
// frame-end gather through V). The function is linear in the frame:
//
//   w_f = sum_j AL^(127-j) P (x_f[128j : 128j + 128] * win_j) = K_w x_f
//
// with K_w (12 x 16384) the plan's summary_matrix: the window folded in,
// computed in float64 from the plan's fp32 AL, P and window and rounded
// once. So the kernel is a skinny product, frames (F x 16384) times K_w^T,
// with no block chain: its error does not grow as the poles near the unit
// circle, where a 128-step fp32 chain loses digits.
//
// What bounds it on an H100: the frames' 64 KB each, read once; the 12
// FMAs a sample (0.4 MFLOP a frame) take a third of that time at the fp32
// peak, so the floor is the read. The design streams the frames and keeps
// the arithmetic out of the way:
//
// - A cluster of kRanks = 8 CTAs shares each frame: CTA rank r owns the
//   samples [2048 r, 2048 r + 2048), thread t the eight samples 2048 r + 4t
//   + 1024 j + q (j < 2, q < 4), and holds their 96 coefficients of K_w in
//   registers for the whole launch (K_w is read once a CTA, from L2).
// - Each thread copies its samples of a frame into a ring of kStages
//   frames in shared memory with two 16-byte cp.async (a warp reads 512
//   contiguous bytes), kStages = 12 frames ahead of the one it sums, so an
//   SM keeps 96 KB of reads in flight without registers to hold them; each
//   thread reads back only what it copied, so a wait on its own copies is
//   the only synchronisation. 12 FMAs a sample.
// - Each frame is reduced in a fixed order: a thread's eight samples by a
//   chain of FMAs (j, then q, ascending); the warp's 32 lanes by a butterfly
//   over lane bits 4, 3, 2, 1, 0 (the first two levels transposed: a lane
//   keeps half of its sums and sends the other half, 18 shuffles a frame);
//   the CTA's 8 warps in ascending order, the sum stored into the shared
//   memory of the rank that writes the frame (distributed shared memory);
//   after one cluster barrier, that rank adds the 8 ranks' sums in
//   ascending order. No atomics, no second launch: a frame's 12 floats
//   depend only on that frame.
// - The grid is persistent: cluster c takes the frames c, c + C, c + 2C,
//   ... (C clusters, no more than fit on the card at once: 15 of 8 CTAs on
//   an H100 SXM, so every cluster gets within one frame of F / C) and
//   reduces them in batches of kBatch frames, one cluster barrier a batch;
//   the empty slots of its last batch are skipped.
//
// One CTA an SM (256 threads, 164 registers); shared memory 96 KiB of ring
// and 18.75 KiB of sums. The coefficients' loads go out before the first
// frames' copies. IEEE fp32 throughout.

#include <cooperative_groups.h>

#include "frame.cuh"

namespace {

namespace cg = cooperative_groups;
using tpu_sdr::kN;

constexpr int kM = 12;            // composite state size (6 sections)
constexpr int kRanks = 8;         // CTAs a cluster, each a slice of the frame
constexpr int kSlice = kN / kRanks;  // 2048 samples
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kHalf = kSlice / 2;   // j: the two 16-byte loads of a thread
// Frames a cluster reduces together: the main path's 512 frames over 15
// clusters are 35 a cluster, one batch.
constexpr int kBatch = 40;
constexpr int kMine = kBatch / kRanks;  // frames of a batch each rank writes
constexpr int kStages = 12;       // frames in flight: the ring's slots
constexpr size_t kRingBytes = size_t(kStages) * kSlice * sizeof(float);
static_assert(4 * kThreads * 2 == kSlice, "eight samples a thread");
static_assert(kBatch % kRanks == 0, "each rank writes kMine frames of a batch");

__device__ __forceinline__ void copy16_async(float* dst, const float* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src) : "memory");
}

// The thread's samples of frame f (if it exists) into its places in ring
// slot `slot`, as one commit group (empty for no frame, to keep the count).
__device__ __forceinline__ void copy_frame_part(const float* __restrict__ x, int f, int n0,
                                                float* slot) {
  if (f >= 0) {
    const float* src = x + size_t(f) * kN + n0;
    copy16_async(slot + n0 % kSlice, src);
    copy16_async(slot + n0 % kSlice + kHalf, src + kHalf);
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// The cluster barrier in two halves: every CTA of the cluster has started
// (arrived) before any writes another's shared memory (waits).
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
}

// All but the newest kStages - 1 of this thread's copy groups are complete
// and visible to it.
__device__ __forceinline__ void wait_oldest() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kStages - 1) : "memory");
}

// The s-th frame of cluster c (of C), c + s C, or -1 past the last.
__device__ __forceinline__ int stream_frame(int s, int c, int clusters, int frames) {
  const int f = c + s * clusters;
  return f < frames ? f : -1;
}

// This warp's 12 sums of one frame into sums[12]: each lane's eight samples
// by a chain of FMAs (j, then q, ascending), then a butterfly over lane bits
// 4, 3 (transposed: a lane keeps sums 6h .. 6h + 5 of the pair, h = bit 4,
// then 3 of those, by bit 3), 2, 1, 0. Lanes 0, 8, 16 and 24 store 3 each.
__device__ __forceinline__ void frame_sums(const float (&k)[2][4][kM], const float (&xv)[2][4],
                                           int lane, float* sums) {
  float acc[kM];
#pragma unroll
  for (int a = 0; a < kM; ++a) {
    acc[a] = 0.f;
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[a] = fmaf(k[j][q][a], xv[j][q], acc[a]);
  }
  const bool hi = lane & 16;
  const bool mid = lane & 8;
  float r6[6], r3[3];
#pragma unroll
  for (int a = 0; a < 6; ++a) {
    const float send = hi ? acc[a] : acc[a + 6];
    const float keep = hi ? acc[a + 6] : acc[a];
    r6[a] = keep + __shfl_xor_sync(0xffffffffu, send, 16);
  }
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    const float send = mid ? r6[a] : r6[a + 3];
    const float keep = mid ? r6[a + 3] : r6[a];
    r3[a] = keep + __shfl_xor_sync(0xffffffffu, send, 8);
  }
#pragma unroll
  for (int d = 4; d > 0; d >>= 1)
#pragma unroll
    for (int a = 0; a < 3; ++a) r3[a] += __shfl_xor_sync(0xffffffffu, r3[a], d);
  if ((lane & 7) == 0) {
#pragma unroll
    for (int a = 0; a < 3; ++a) sums[6 * hi + 3 * mid + a] = r3[a];
  }
}

__global__ void __launch_bounds__(kThreads, 1)
iir_summaries_kernel(const float* __restrict__ x, const float* __restrict__ kw,
                     float* __restrict__ out, int frames) {
  extern __shared__ __align__(16) float ring[];  // [kStages][kSlice] frame slices
  __shared__ float red[kBatch][kWarps][kM];  // each warp's sums of a frame
  // The sums of this rank's frames from every rank, two batches in turn.
  __shared__ float gather[2][kMine][kRanks][kM];

  cg::cluster_group cluster = cg::this_cluster();
  const int rank = int(cluster.block_rank());
  const int c = blockIdx.x / kRanks;
  const int clusters = gridDim.x / kRanks;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int p0 = 4 * tid;                  // samples p0 + kHalf j + q of the slice
  const int n0 = rank * kSlice + p0;       // in the frame

  float k[2][4][kM];  // K_w[a][n0 + kHalf j + q]
#pragma unroll
  for (int a = 0; a < kM; ++a)
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const float4 v = __ldg(reinterpret_cast<const float4*>(kw + size_t(a) * kN + n0 + kHalf * j));
      k[j][0][a] = v.x;
      k[j][1][a] = v.y;
      k[j][2][a] = v.z;
      k[j][3][a] = v.w;
    }

#pragma unroll 1
  for (int s = 0; s < kStages; ++s)
    copy_frame_part(x, stream_frame(s, c, clusters, frames), n0, ring + s * kSlice);
  cluster_arrive();

  const int batches = ((frames - c + clusters - 1) / clusters + kBatch - 1) / kBatch;
  for (int b = 0; b < batches; ++b) {
    for (int i = 0; i < kBatch; ++i) {
      const int s = b * kBatch + i;
      const int f = stream_frame(s, c, clusters, frames);
      float* slot = ring + (s % kStages) * kSlice;
      wait_oldest();  // frame s's copies
      if (f >= 0) {  // the same for the whole cluster
        const float4 v0 = *reinterpret_cast<const float4*>(slot + p0);
        const float4 v1 = *reinterpret_cast<const float4*>(slot + p0 + kHalf);
        const float xv[2][4] = {{v0.x, v0.y, v0.z, v0.w}, {v1.x, v1.y, v1.z, v1.w}};
        frame_sums(k, xv, lane, red[i][warp]);
      }
      // The slot's values are in registers and summed: refill it, kStages
      // frames ahead.
      copy_frame_part(x, stream_frame(s + kStages, c, clusters, frames), n0, slot);
    }
    __syncthreads();
    if (b == 0) cluster_wait();  // every CTA of the cluster has started
    const int buf = b & 1;
    for (int t = tid; t < kBatch * kM; t += kThreads) {
      const int i = t / kM, a = t % kM;
      float sum = red[i][0][a];
#pragma unroll
      for (int w = 1; w < kWarps; ++w) sum += red[i][w][a];
      *cluster.map_shared_rank(&gather[buf][i % kMine][rank][a], i / kMine) = sum;
    }
    // Every rank's sums of this batch have arrived; the other buffer's
    // readers (the previous batch) are done, so the next batch may fill it.
    // After the last batch no CTA touches another's shared memory.
    cluster.sync();
    if (tid < kMine * kM) {
      const int li = tid / kM, a = tid % kM;
      const int f = stream_frame(b * kBatch + rank * kMine + li, c, clusters, frames);
      float sum = gather[buf][li][0][a];
#pragma unroll
      for (int r = 1; r < kRanks; ++r) sum += gather[buf][li][r][a];
      if (f >= 0) out[size_t(f) * kM + a] = sum;
    }
  }
}

}  // namespace

extern "C" {

// x: (frames, 16384) fp32, 16-byte aligned; kw: (12, 16384) fp32, the
// plan's summary_matrix (window included), 16-byte aligned; out: (frames,
// 12) fp32. All contiguous, on the current device. Launches clusters of 8
// CTAs, as many as the device holds at once (at most one a frame).
// Returns the CUDA error code of the occupancy query or the launch (0 on
// success).
int tpu_sdr_iir_summaries(const float* x, const float* kw, float* out, int frames,
                          void* stream) {
  if (frames <= 0) return 0;
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return int(err);
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = kRanks;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(kRanks);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = kRingBytes;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  static int max_clusters[64] = {};  // per device, queried once
  if (device >= 64) return int(cudaErrorInvalidDevice);
  if (max_clusters[device] == 0) {
    err = cudaFuncSetAttribute(iir_summaries_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, int(kRingBytes));
    if (err != cudaSuccess) return int(err);
    int n = 0;
    err = cudaOccupancyMaxActiveClusters(&n, iir_summaries_kernel, &cfg);
    if (err != cudaSuccess) return int(err);
    if (n < 1) return int(cudaErrorInvalidConfiguration);
    max_clusters[device] = n;
  }
  cfg.gridDim = dim3((frames < max_clusters[device] ? frames : max_clusters[device]) * kRanks);
  err = cudaLaunchKernelEx(&cfg, iir_summaries_kernel, x, kw, out, frames);
  if (err != cudaSuccess) return int(err);
  return int(cudaGetLastError());
}

}  // extern "C"
