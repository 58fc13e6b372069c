// fp32 products on the tensor cores with each operand split into three
// bf16 pieces: the helpers shared by csrc/fft_mag_fused.cu (kernel row 6)
// and csrc/pfb_fold_dft.cu (kernel row 8).
//
// Each fp32 operand a is split in registers into bf16 pieces a = a0 + a1 +
// a2 (a0 = bf16(a), a1 = bf16(a - a0), a2 = bf16(a - a0 - a1); the
// subtractions are exact), 24 significant bits. A product a.b takes the six
// piece products with i + j <= 2 (the TPU's precision="highest"), each exact
// in fp32, as mma.sync m16n8k16 bf16 with fp32 accumulation, smallest first:
// a2b0, a1b1, a0b2, a1b0, a0b1, a0b0. A kernel sums each k-step of 16 into a
// fresh accumulator and adds it to its running fp32 sum with one IEEE add
// (add4), so the tensor cores' own rounding inside an MMA acts on one
// k-step's partial sum only. tests/test_torch_split_precision.py and
// tests/test_torch_pfb_split.py are NumPy models of this arithmetic.
//
// Fragment layouts (PTX ISA, mma.m16n8k16 with .bf16): gid = lane >> 2,
// tig = lane & 3; A (row-major 16 x 16) a0 = rows gid, columns 2 tig + {0,
// 1}; a1 = rows gid + 8; a2 = columns + 8; a3 = both; B (column-major 16 x
// 8) b0 = rows 2 tig + {0, 1}, column gid; b1 = rows + 8; C (16 x 8) c0, c1 =
// row gid, columns 2 tig + {0, 1}; c2, c3 = row gid + 8.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace split_bf16 {

constexpr int kPieces = 3;

// Three bf16x2 words of a pair of floats (lo in the low half): word k holds
// piece k of both.
__device__ __forceinline__ void split_pair(float lo, float hi, uint32_t (&w)[kPieces]) {
#pragma unroll
  for (int k = 0; k < kPieces; ++k) {
    const __nv_bfloat162 p = __floats2bfloat162_rn(lo, hi);
    w[k] = *reinterpret_cast<const uint32_t*>(&p);
    const float2 back = __bfloat1622float2(p);
    lo = __fsub_rn(lo, back.x);
    hi = __fsub_rn(hi, back.y);
  }
}

// d += A B, m16n8k16, bf16 operands, fp32 accumulation.
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                    uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// The six piece products (A piece i, B piece j) with i + j <= 2 of one
// k-step into acc, smallest first: A pieces a[i], B pieces (b0[j], b1[j]).
__device__ __forceinline__ void mma6(float (&acc)[4], const uint32_t (&a)[kPieces][4],
                                     const uint32_t (&b0)[kPieces],
                                     const uint32_t (&b1)[kPieces]) {
  mma(acc, a[2], b0[0], b1[0]);
  mma(acc, a[1], b0[1], b1[1]);
  mma(acc, a[0], b0[2], b1[2]);
  mma(acc, a[1], b0[0], b1[0]);
  mma(acc, a[0], b0[1], b1[1]);
  mma(acc, a[0], b0[0], b1[0]);
}

__device__ __forceinline__ void add4(float (&s)[4], const float (&t)[4]) {
#pragma unroll
  for (int c = 0; c < 4; ++c) s[c] = __fadd_rn(s[c], t[c]);
}

// The pieces of an A fragment held as four fp32 pairs (a0 .. a3 in order).
__device__ __forceinline__ void split_frag(const float2 (&v)[4], uint32_t (&a)[kPieces][4]) {
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    uint32_t w[kPieces];
    split_pair(v[q].x, v[q].y, w);
#pragma unroll
    for (int k = 0; k < kPieces; ++k) a[k][q] = w[k];
  }
}

}  // namespace split_bf16
