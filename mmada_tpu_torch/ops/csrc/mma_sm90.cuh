// Warp-level building blocks of the port's kernels: bf16 packing (every
// attention kernel), and for the mma.sync kernels (B3-bias in
// flash_attention_bwd.cu and flash_attention_dkv.cuh; B6 in int4_matmul.cu)
// the mma.sync m16n8k16 product, ldmatrix fragment loads, cp.async copies,
// and the two warp-tile products B3-bias is made of.
//
// Fragment layout of mma.sync m16n8k16 (g = lane / 4, t = lane % 4):
//   accumulator c[0..1] -> row g, columns 2t, 2t+1; c[2..3] -> row g+8.
//   A (16x16, row-major): a[0] rows 0-7 / cols 0-7, a[1] rows 8-15 / cols
//   0-7, a[2] rows 0-7 / cols 8-15, a[3] rows 8-15 / cols 8-15.
// Shared-memory tiles are row-major with a row stride of D + 8 elements, so
// the eight rows an ldmatrix reads fall in different banks.

#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // .x (low half) = lo
  return *reinterpret_cast<uint32_t*>(&v);
}

// The low half of the split x = hi + lo of two fp32 values whose bf16
// roundings `hi` holds (pack_bf16): lo = bf16(x - hi). x - hi is exact in
// fp32, so hi + lo carries about 16 significant bits of x where hi alone
// carries 8.
__device__ __forceinline__ uint32_t pack_bf16_rest(float x0, float x1, uint32_t hi) {
  const float2 h = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&hi));
  return pack_bf16(x0 - h.x, x1 - h.y);
}

// D(16x8, f32) += A(16x16, bf16, row) * B(16x8, bf16, col)
__device__ __forceinline__ void mma_bf16(float c[4], const uint32_t a[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Four 8x8 bf16 matrices from shared memory; lane i gives the address of
// row i % 8 of matrix i / 8. TRANS delivers each matrix transposed.
template <bool TRANS>
__device__ __forceinline__ void ldmatrix_x4(uint32_t r[4], const bf16* row) {
  const uint32_t addr = static_cast<uint32_t>(__cvta_generic_to_shared(row));
  if (TRANS)
    asm volatile(
        "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
        : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(addr));
  else
    asm volatile(
        "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
        : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(addr));
}

// 16-byte asynchronous copy global -> shared; with `valid` false the 16
// bytes are zero-filled and nothing is read.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  const uint32_t addr = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(addr), "l"(src), "r"(valid ? 16 : 0));
}

// 4-byte asynchronous copy global -> shared, zero-filled when not `valid`.
__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool valid) {
  const uint32_t addr = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(addr), "l"(src), "r"(valid ? 4 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N));
}

// Start copying rows [row0, row0 + ROWS) of a (L, D) bf16 matrix with row
// stride `row_stride` into shared memory (row stride D + 8), rows at or past
// `n_rows` zero-filled. THREADS threads of the block take part.
template <int D, int ROWS, int THREADS = 128>
__device__ __forceinline__ void load_rows_async(bf16* dst, const bf16* src,
                                                long long row_stride, int row0,
                                                int n_rows) {
  constexpr int STRIDE = D + 8;
  constexpr int VECS = D / 8;  // 16-byte vectors per row
  static_assert(ROWS * VECS % THREADS == 0, "whole vectors per thread");
#pragma unroll
  for (int it = 0; it < ROWS * VECS / THREADS; ++it) {
    const int i = threadIdx.x + it * THREADS;
    const int r = i / VECS, c = (i % VECS) * 8;
    const bool valid = row0 + r < n_rows;
    cp_async16(dst + r * STRIDE + c,
               src + (long long)(valid ? row0 + r : 0) * row_stride + c, valid);
  }
}

// s (16 x NB*8, fp32, accumulator layout; overwritten) = A . B^T, where A is
// this warp's 16 rows and B NB*8 rows, both row-major over D in shared
// memory: the score-shaped product (q.k^T, dO.v^T, k.q^T, v.dO^T). The d
// loop is outermost so consecutive products go to different accumulators.
template <int D, int NB>
__device__ __forceinline__ void mma_abt(float s[NB][4], const bf16* a,
                                        const bf16* b, int lane) {
  constexpr int STRIDE = D + 8;
#pragma unroll
  for (int n = 0; n < NB; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
  // A: lane's row lane % 16, columns (lane / 16) * 8 of each 16-wide slice
  const bf16* arow = a + (lane & 15) * STRIDE + (lane >> 4) * 8;
  // B: row n*8 + lane % 8, columns (lane / 8) * 8 of each 32-wide slice
  const bf16* brow = b + (lane & 7) * STRIDE + (lane >> 3) * 8;
#pragma unroll
  for (int kk = 0; kk < D / 16; kk += 2) {
    uint32_t a0[4], a1[4];
    ldmatrix_x4<false>(a0, arow + kk * 16);
    ldmatrix_x4<false>(a1, arow + (kk + 1) * 16);
    uint32_t bf[NB][4];  // B fragments of d slices kk and kk + 1
#pragma unroll
    for (int n = 0; n < NB; ++n) ldmatrix_x4<false>(bf[n], brow + n * 8 * STRIDE + kk * 16);
#pragma unroll
    for (int n = 0; n < NB; ++n) mma_bf16(s[n], a0, bf[n][0], bf[n][1]);
#pragma unroll
    for (int n = 0; n < NB; ++n) mma_bf16(s[n], a1, bf[n][2], bf[n][3]);
  }
}

// acc (16 x D, fp32) += bf16(P) . B, where P (16 x NB*8) is in accumulator
// layout in registers (rounded to bf16 here) and B is NB*8 rows x D,
// row-major in shared memory (read transposed by ldmatrix): the
// probability-shaped product (ds.k, p^T.dO, ds^T.q).
template <int D, int NB>
__device__ __forceinline__ void mma_pb(float acc[D / 8][4], const float p[NB][4],
                                       const bf16* b, int lane) {
  constexpr int STRIDE = D + 8;
  static_assert(NB % 2 == 0, "whole 16-wide k slices");
#pragma unroll
  for (int kb = 0; kb < NB / 2; ++kb) {
    // the two 16x8 fragments of columns [16 kb, 16 kb + 16) form the
    // 16x16 A fragment
    const float* p0 = p[2 * kb];
    const float* p1 = p[2 * kb + 1];
    const uint32_t pa[4] = {pack_bf16(p0[0], p0[1]), pack_bf16(p0[2], p0[3]),
                            pack_bf16(p1[0], p1[1]), pack_bf16(p1[2], p1[3])};
    // ldmatrix.trans rows: kb*16 + lane % 16, columns (lane / 16) * 8
    const bf16* brow = b + (kb * 16 + (lane & 15)) * STRIDE + (lane >> 4) * 8;
#pragma unroll
    for (int dn = 0; dn < D / 8; dn += 2) {
      uint32_t bf[4];  // B fragments of columns dn*8.. and (dn+1)*8..
      ldmatrix_x4<true>(bf, brow + dn * 8);
      mma_bf16(acc[dn], pa, bf[0], bf[1]);
      mma_bf16(acc[dn + 1], pa, bf[2], bf[3]);
    }
  }
}

}  // namespace
