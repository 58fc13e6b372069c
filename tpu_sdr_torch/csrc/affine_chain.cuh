// The sequential chain of affine maps y <- A[g] y + B[g], g = 0, 1, ..., in
// order, walked at its latency floor: one dependent multiply and add a map.
//
// kernels/demod.py carries its one-pole states (FM de-emphasis, the AM DC
// block, AGC, the stereo EMAs) from one 128-sample block to the next as
// such a chain. Kept sequential, with every multiply and add as __fmul_rn /
// __fadd_rn (no contraction into an FMA), its results equal the plain
// version's loop (demod._chain_blocks) bit for bit, and a stream cut into
// chunks gives the same bits as one call.
//
// walk_chain runs in one block of kThreads per chain. Warps 1 .. 7 (the
// helpers) load the chain's maps (8 bytes a map) from device memory into a
// double-buffered stage in shared memory and store the entry states of the
// previous stage, coalesced; lane 0 of warp 0 walks the current stage with
// the next kAhead maps already in registers, so that it waits on arithmetic
// only (about 8 cycles a map on an H100: an FMUL and an FADD in sequence),
// and writes each map's entry state to shared memory. One barrier a stage
// of kChunk maps. The caller's hooks make the helpers wait for maps that
// other blocks of the same launch are still computing (hooks.wait_maps(lo,
// hi), called by every helper before it loads maps [lo, hi)), and publish
// how far the entry states are stored (hooks.stored(count), called by every
// helper once every helper has stored its share of [0, count)).

#pragma once

#include <cuda_runtime.h>

namespace affine_chain {

constexpr int kThreads = 256;            // a walking block: the walker's warp + 7 helper warps
constexpr int kHelpers = kThreads - 32;
constexpr int kChunk = 1024;             // maps a stage
constexpr int kAhead = 8;                // maps the walker holds in registers
constexpr int kLoads = (kChunk + kHelpers - 1) / kHelpers;  // maps a helper loads a stage

// Shared memory of walk_chain: two stages of maps (each padded by kAhead,
// which the walker reads past its end) and of entry states.
struct Stages {
  float2 maps[2][kChunk + kAhead];
  float ys[2][kChunk];
};

// Walk the n <= kChunk maps m[0 .. n) from y: ys[g] = the state entering map
// g. Returns the state after map n - 1. m must be readable to m[kChunk +
// kAhead); the maps past n are loaded and never used. Whole groups of
// kAhead maps run without a condition a map; the tail with one.
__device__ __forceinline__ float walk_stage(const float2* __restrict__ m, float* __restrict__ ys,
                                            int n, float y) {
  float2 cur[kAhead];
#pragma unroll
  for (int i = 0; i < kAhead; ++i) cur[i] = m[i];
  int g0 = 0;
  for (; g0 + kAhead <= n; g0 += kAhead) {
    float2 nxt[kAhead];
#pragma unroll
    for (int i = 0; i < kAhead; ++i) nxt[i] = m[g0 + kAhead + i];
#pragma unroll
    for (int i = 0; i < kAhead; ++i) {
      ys[g0 + i] = y;
      y = __fadd_rn(__fmul_rn(cur[i].x, y), cur[i].y);
    }
#pragma unroll
    for (int i = 0; i < kAhead; ++i) cur[i] = nxt[i];
  }
#pragma unroll
  for (int i = 0; i < kAhead; ++i) {
    if (g0 + i < n) {
      ys[g0 + i] = y;
      y = __fadd_rn(__fmul_rn(cur[i].x, y), cur[i].y);
    }
  }
  return y;
}

// Helper h loads maps [g, g + min(kChunk, n - g)) into dst, through L2 (a
// map may have been written by another block of the launch).
__device__ __forceinline__ void load_stage(const float2* __restrict__ maps, float2* dst, int g,
                                           int n, int h) {
  const int cnt = min(kChunk, n - g);
  float2 v[kLoads];
#pragma unroll
  for (int r = 0; r < kLoads; ++r) {
    const int i = h + r * kHelpers;
    if (i < cnt) v[r] = __ldcg(maps + g + i);
  }
#pragma unroll
  for (int r = 0; r < kLoads; ++r) {
    const int i = h + r * kHelpers;
    if (i < cnt) dst[i] = v[r];
  }
}

// The helpers (warps 1 ..) wait for each other (named barrier 1).
__device__ __forceinline__ void helpers_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(kHelpers) : "memory");
}

// Helper h stores the entry states [g, g + cnt) from ys, then publishes
// them once every helper has stored its share.
template <class Hooks>
__device__ __forceinline__ void store_stage(const float* ys, float* __restrict__ y_in, int g,
                                            int cnt, int h, const Hooks& hooks) {
  for (int i = h; i < cnt; i += kHelpers) y_in[g + i] = ys[i];
  helpers_sync();
  hooks.stored(g + cnt);
}

// The chain of maps[0 .. n) = (A, B) from y0, in a block of kThreads
// threads, all of which call it: y_in[g] = the state entering map g.
// Returns the final state in thread 0 (other threads: y0).
template <class Hooks>
__device__ __forceinline__ float walk_chain(const float2* __restrict__ maps,
                                            float* __restrict__ y_in, int n, float y0,
                                            Stages& st, const Hooks& hooks) {
  const int tid = threadIdx.x;
  const int h = tid - 32;  // helper index
  const int stages = (n + kChunk - 1) / kChunk;
  if (h >= 0) {
    hooks.wait_maps(0, min(n, kChunk));
    load_stage(maps, st.maps[0], 0, n, h);
  }
  __syncthreads();
  float y = y0;
  for (int k = 0; k < stages; ++k) {
    const int g0 = k * kChunk;
    if (tid == 0) {
      y = walk_stage(st.maps[k & 1], st.ys[k & 1], min(kChunk, n - g0), y);
    } else if (h >= 0) {
      if (k > 0) store_stage(st.ys[(k - 1) & 1], y_in, g0 - kChunk, kChunk, h, hooks);
      const int g1 = g0 + kChunk;  // the next stage's maps
      if (g1 < n) {
        hooks.wait_maps(g1, min(n, g1 + kChunk));
        load_stage(maps, st.maps[(k + 1) & 1], g1, n, h);
      }
    }
    __syncthreads();
  }
  const int g0 = (stages - 1) * kChunk;
  if (h >= 0) store_stage(st.ys[(stages - 1) & 1], y_in, g0, n - g0, h, hooks);
  return y;
}

}  // namespace affine_chain
