// Hopper building blocks shared by the port's kernels, every one of them on
// wgmma (B1 and B2 in flash_attention_fwd.cu; B3 and B3-bias in
// flash_attention_bwd.cu; B4, B4-bias, B5-dq and B5-dkv, unbiased and
// biased, in flash_attention_long.cu; the backward bodies of B3 and B5 in
// flash_attention_bwd_wgmma.cuh; B6 in int4_matmul.cu): bf16 packing, TMA
// tile loads and stores through tensor maps, mbarrier waits, warpgroup
// register rebalancing, the wgmma shared-memory matrix descriptor, the
// m64nNk16 bf16 wgmma products (fp32 accumulate) these kernels take, 1-D
// bulk copies, and the reads of an fp32 bias tile.
//
// Tiles live in shared memory as TMA writes them with the 128-byte swizzle:
// a box is `rows` rows of 64 bf16 (128 bytes), 1024-byte aligned, the 16-byte
// chunk c of row r stored at chunk c ^ (r % 8). A D = 128 tile is two such
// boxes, columns 0-63 then 64-127. The wgmma descriptors name the same
// swizzle (layout type 1), so map and descriptor agree by construction; a
// mismatch would run and return wrong numbers, which the card test
// `test_wgmma_tile_loaded_by_tma_matches_torch_matmul` pins.
//
// An fp32 bias tile (B2, B5-dq-bias, B5-dkv-bias) arrives the same way, in
// boxes of 32 fp32 columns (128 bytes) and `rows` rows with the 128-byte
// swizzle: element (r, c) of a box at r * 128 + (((c / 4) ^ (r % 8)) << 4) +
// (c % 4) * 4. The swizzle makes both reads the consumers make free of bank
// conflicts: a warp reading its accumulator elements row-wise (B2, B5-dq:
// rows 16w + g, keys 8j + 2q, +1, as float2) hits each 16-byte chunk of a
// row from two rows of the eight, and one reading them transposed (B5-dkv:
// bias[query][key] with the key as its accumulator row, queries 8j + 2q +
// (i & 1) as columns) hits 32 distinct banks. Unswizzled, the rows of 128
// bytes would put the eight rows of a warp on the same banks.
//
// Accumulator layout of m64nNk16 (fp32), thread t of the warpgroup, warp w =
// t / 32, g = (t % 32) / 4, q = t % 4: d[4j + 0..1] -> row 16w + g, columns
// 8j + 2q, +1; d[4j + 2..3] -> row 16w + g + 8. The register-A fragment of
// one k16 step (a[0..3]) is the m16n8k16 A fragment's layout: a[0] row
// 16w + g, k 2q..2q+1; a[1] row + 8; a[2] k + 8; a[3] row + 8, k + 8. So
// the accumulator of keys [16kb, 16kb + 16) packs into the A fragment of
// the next product without moving between threads.

#pragma once

#include <cuda.h>  // CUtensorMap and its enums; the driver entry is looked up, not linked
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <float.h>
#include <math.h>
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

constexpr float NEG_F32 = -FLT_MAX;  // finite min: a running max's start
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

// ---------------------------------------------------------------- device

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" :: "r"(smem_u32(bar)), "r"(count)
               : "memory");
}

// Make the barriers' initialisation visible to the async proxy (TMA).
__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// Arrive once and expect `bytes` of TMA traffic before the phase completes.
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(smem_u32(bar)), "r"(bytes) : "memory");
}

// Wait until the phase of parity `parity` has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(addr), "r"(parity) : "memory");
  } while (!done);
}

// One box of a 4-D tensor map (columns, rows, heads, batches) into shared
// memory; completion is counted in bytes on `bar`. Rows past the tensor's
// edge arrive as zeros.
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map, uint64_t* bar,
                                         int col, int row, int head, int batch) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5, %6}], [%2];\n"
      :: "r"(smem_u32(dst)), "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)),
         "r"(col), "r"(row), "r"(head), "r"(batch)
      : "memory");
}

// The same box into shared memory at the same offset in every block of the
// cluster that `mask` names (bit r: rank r), counted on each one's `bar`.
__device__ __forceinline__ void tma_load_multicast(void* dst, const CUtensorMap* map,
                                                   uint64_t* bar, uint16_t mask, int col,
                                                   int row, int head, int batch) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
      ".multicast::cluster [%0], [%1, {%4, %5, %6, %7}], [%2], %3;\n"
      :: "r"(smem_u32(dst)), "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)),
         "h"(mask), "r"(col), "r"(row), "r"(head), "r"(batch)
      : "memory");
}

// `bytes` contiguous bytes (a multiple of 16, both addresses 16-byte
// aligned) from global into shared memory, counted in bytes on `bar`.
__device__ __forceinline__ void bulk_load(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      :: "r"(smem_u32(dst)), "l"(src), "r"(bytes), "r"(smem_u32(bar)) : "memory");
}

// Arrive once on this block's barrier `bar`.
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" :: "r"(smem_u32(bar)) : "memory");
}

// Arrive on the barrier at the same offset as `bar` in block `rank` of the
// cluster (this block's own included).
__device__ __forceinline__ void mbar_arrive_cluster(uint64_t* bar, uint32_t rank) {
  asm volatile(
      "{\n.reg .b32 remote;\n"
      "mapa.shared::cluster.u32 remote, %0, %1;\n"
      "mbarrier.arrive.release.cluster.shared::cluster.b64 _, [remote];\n}\n"
      :: "r"(smem_u32(bar)), "r"(rank) : "memory");
}

__device__ __forceinline__ uint32_t cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}

// Every thread of every block of the cluster: arrive, then wait for all.
__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.release;\nbarrier.cluster.wait.acquire;\n" ::: "memory");
}

// One box from shared memory to the tensor; rows past the edge are not written.
__device__ __forceinline__ void tma_store(const CUtensorMap* map, const void* src, int col,
                                          int row, int head, int batch) {
  asm volatile(
      "cp.async.bulk.tensor.4d.global.shared::cta.bulk_group"
      " [%0, {%2, %3, %4, %5}], [%1];\n"
      :: "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(src)), "r"(col), "r"(row),
         "r"(head), "r"(batch)
      : "memory");
}

// Wait until this thread's TMA stores have read their shared memory.
__device__ __forceinline__ void tma_store_wait() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}

// Order this thread's generic-proxy writes to shared memory before the
// async proxy's (TMA) reads of it.
__device__ __forceinline__ void fence_async_shared() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void named_barrier_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" :: "r"(id), "r"(threads) : "memory");
}

__device__ __forceinline__ void named_barrier_arrive(int id, int threads) {
  asm volatile("bar.arrive %0, %1;\n" :: "r"(id), "r"(threads) : "memory");
}

template <int REGS>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" :: "n"(REGS));
}

template <int REGS>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" :: "n"(REGS));
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(N) : "memory");
}

// Keep the compiler from moving reads or writes of registers that an
// asynchronous wgmma owns across the wait for it.
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i]) :: "memory");
}

template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(r[i][j]) :: "memory");
}

// The wgmma shared-memory matrix descriptor of a 128-byte-swizzled operand
// starting at `p`: start address, leading and stride byte offsets (16-byte
// units), layout type 1 (128-byte swizzle), base offset 0 (atoms are
// 1024-byte aligned). K-major: `sbo` is the distance between 8-row groups
// (1024 bytes) and `lbo` is unused. MN-major: `lbo` is the distance between
// 64-column blocks (boxes) and `sbo` between groups of 8 k rows (1024).
__device__ __forceinline__ uint64_t desc_sw128(const void* p, uint32_t lbo, uint32_t sbo) {
  uint64_t desc = (smem_u32(p) & 0x3FFFF) >> 4;
  desc |= (uint64_t)((lbo >> 4) & 0x3FFF) << 16;
  desc |= (uint64_t)((sbo >> 4) & 0x3FFF) << 32;
  desc |= 1ull << 62;
  return desc;
}

__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t desc_a,
                                             uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d));
}

// d = a . b + (scale_d ? d : 0) (m64n128k16, both from shared memory: a
// K-major, b MN-major, as B6 reads x and its expanded W tile)
__device__ __forceinline__ void wgmma_ss_n128_mn(float (&d)[64], uint64_t desc_a,
                                                uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d));
}

// d += a . b (m64n64k16, both from shared memory)
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t desc_a, uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(desc_a), "l"(desc_b), "r"(1));
}

// d = a . b, d's earlier values neither read nor kept: the registers of a
// product that starts a sum are free up to this instruction, where a "+f"
// operand (wgmma_ss_n64, with scale-d 0) would keep the previous values
// live, in a loop from one iteration to the next
__device__ __forceinline__ void wgmma_ss_n64_first(float (&d)[32], uint64_t desc_a,
                                                  uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3]), "=f"(d[4]), "=f"(d[5]), "=f"(d[6]), "=f"(d[7]),
        "=f"(d[8]), "=f"(d[9]), "=f"(d[10]), "=f"(d[11]), "=f"(d[12]), "=f"(d[13]), "=f"(d[14]), "=f"(d[15]),
        "=f"(d[16]), "=f"(d[17]), "=f"(d[18]), "=f"(d[19]), "=f"(d[20]), "=f"(d[21]), "=f"(d[22]), "=f"(d[23]),
        "=f"(d[24]), "=f"(d[25]), "=f"(d[26]), "=f"(d[27]), "=f"(d[28]), "=f"(d[29]), "=f"(d[30]), "=f"(d[31])
      : "l"(desc_a), "l"(desc_b), "r"(0));
}

__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64], const uint32_t (&a)[4],
                                             uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32], const uint32_t (&a)[4],
                                             uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(scale_d));
}

// Store this warpgroup's 64 x D accumulator rows (rows 16w + g and + 8 of
// column slab n), each divided by its row's `div[r]` and then multiplied by
// `mul`, as bf16 into 128-byte-swizzled boxes: box c (columns 64c..) at
// tile + c * box_stride, the layout a TMA store with a box of 64 rows reads.
template <int D>
__device__ __forceinline__ void acc_to_swizzled(unsigned char* tile, int box_stride,
                                                const float (&o)[D / 2], const float div[2],
                                                int t, float mul = 1.f) {
  const int warp = t / 32, g = (t % 32) / 4, q = t % 4;
#pragma unroll
  for (int n = 0; n < D / 8; ++n) {
    unsigned char* box = tile + (n / 8) * box_stride;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = warp * 16 + g + 8 * r;
      const uint32_t v =
          pack_bf16(o[4 * n + 2 * r] / div[r] * mul, o[4 * n + 2 * r + 1] / div[r] * mul);
      *reinterpret_cast<uint32_t*>(box + row * 128 + (((n & 7) ^ g) << 4) + q * 4) = v;
    }
  }
}

// ------------------------------------------------- the attention skeleton
//
// B1 and B4 take it as it is; B2, B3, B4-bias and B5 take it with tiles of
// 64 rows (STEP_N) streamed past the resident 128-row ones. One block per (128-row query tile, head, batch) with
// three warpgroups: warpgroup 0 is the producer (one thread issues every
// TMA load, after lowering the warpgroup's registers to 40), warpgroups 1
// and 2 consume 64 query rows each (raised to 232 registers). The Q tile is
// loaded once and stays as the A operand of q . k^T; K and V tiles of 128
// keys stream through a ring of STAGES slots: full[s] completes when the
// slot's bytes have landed, empty[s] when the consumer warps are done with
// it. The consumers compute S = Q . K^T with wgmma from shared memory (K
// read K-major, no transposed copy), form p in registers in the A-fragment
// layout, and accumulate O += P . V with V read through an MN-major
// descriptor.
//
// The blocks of two neighbouring query tiles of one (head, batch) form a
// cluster and read every K and V tile once for both: each block's producer
// loads half of a tile's boxes and multicasts them into both blocks' slots,
// and a slot is refilled only when the consumer warps of both blocks have
// released it (16 arrivals). That halves the tiles' traffic from L2, which
// at 128 query rows a block is about 128 flops (B1's first pass: 64) per byte
// of K and V read.

constexpr int ATT_M = 128;        // query rows a block
constexpr int ATT_N = 128;        // keys a K / V tile
constexpr int ATT_THREADS = 384;  // producer + two consumer warpgroups
constexpr int ATT_BOX = 128 * 128;  // bytes of one 64-column box of a 128-row tile
constexpr int ATT_PAIR = 2;  // blocks of a cluster, sharing each K / V tile

template <int D, int STAGES>
struct AttnSmem {
  static constexpr int TILE = 128 * D * 2;  // bytes of a Q, K or V tile
  static constexpr int BYTES = (1 + 2 * STAGES) * TILE + 8 * (1 + 2 * STAGES) + 1024;
  unsigned char* q;
  unsigned char* k[STAGES];
  unsigned char* v[STAGES];
  uint64_t* q_full;
  uint64_t* full;
  uint64_t* empty;

  __device__ explicit AttnSmem(unsigned char* raw) {
    // the 128-byte swizzle repeats every 1024 bytes: tiles start on it
    unsigned char* base = reinterpret_cast<unsigned char*>(
        (reinterpret_cast<uintptr_t>(raw) + 1023) & ~static_cast<uintptr_t>(1023));
    q = base;
    for (int s = 0; s < STAGES; ++s) {
      k[s] = base + (1 + s) * TILE;
      v[s] = base + (1 + STAGES + s) * TILE;
    }
    q_full = reinterpret_cast<uint64_t*>(base + (1 + 2 * STAGES) * TILE);
    full = q_full + 1;
    empty = full + STAGES;
  }

  __device__ void init_barriers() const {
    mbar_init(q_full, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 8 * ATT_PAIR);  // one arrival per consumer warp of the pair
    }
    mbar_init_fence();
  }
};

// The producer thread: the Q tile, then `k_only` K tiles (B1's first pass
// over the keys), then n_tiles K and V tiles. Load i goes to slot i %
// STAGES once the consumers of both blocks have released that slot's
// previous use; of its boxes (K's, then V's) this block issues those of
// index `rank` modulo the pair, to both blocks.
template <int D, int STAGES>
__device__ __forceinline__ void attn_produce(const AttnSmem<D, STAGES>& sm,
                                             const CUtensorMap* tm_q, const CUtensorMap* tm_k,
                                             const CUtensorMap* tm_v, int q0, int h, int kvh,
                                             int b, int n_tiles, int k_only, int rank) {
  constexpr int BOXES = D / 64;
  constexpr int TILE = AttnSmem<D, STAGES>::TILE;
  constexpr uint16_t BOTH = (1 << ATT_PAIR) - 1;
  mbar_expect_tx(sm.q_full, TILE);
  for (int c = 0; c < BOXES; ++c) tma_load(sm.q + c * ATT_BOX, tm_q, sm.q_full, 64 * c, q0, h, b);
  for (int i = 0; i < k_only + n_tiles; ++i) {
    const int s = i % STAGES;
    const bool with_v = i >= k_only;
    const int key0 = (with_v ? i - k_only : i) * ATT_N;
    mbar_wait(&sm.empty[s], ((i / STAGES) & 1) ^ 1);
    mbar_expect_tx(&sm.full[s], with_v ? 2 * TILE : TILE);
    for (int box = rank; box < (with_v ? 2 : 1) * BOXES; box += ATT_PAIR) {
      const bool is_v = box >= BOXES;
      const int c = box % BOXES;
      tma_load_multicast((is_v ? sm.v[s] : sm.k[s]) + c * ATT_BOX, is_v ? tm_v : tm_k,
                         &sm.full[s], BOTH, 64 * c, key0, kvh, b);
    }
  }
}

// Issue s (64 x 128 keys, fp32) = this warpgroup's query rows (starting at
// `q` inside the Q tile) . the K tile^T: D / 16 wgmma steps, each advancing
// both descriptors by 32 bytes inside a box or to the next box.
template <int D>
__device__ __forceinline__ void attn_scores_issue(float (&s)[64], const unsigned char* q,
                                                  const unsigned char* k) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const int off = (kk / 4) * ATT_BOX + (kk % 4) * 32;
    wgmma_ss_n128(s, desc_sw128(q + off, 16, 1024), desc_sw128(k + off, 16, 1024), kk > 0);
  }
}

// Issue o += p . V for the 128 keys of the V tile: 8 steps of 16 keys, p
// from registers, V MN-major (its 64-column boxes ATT_BOX bytes apart).
template <int D>
__device__ __forceinline__ void attn_pv_issue(float (&o)[D / 2], uint32_t (&p)[8][4],
                                              const unsigned char* v) {
#pragma unroll
  for (int kb = 0; kb < 8; ++kb) {
    const uint64_t desc = desc_sw128(v + kb * 16 * 128, ATT_BOX, 1024);
    if constexpr (D == 128)
      wgmma_rs_n128(o, p[kb], desc, 1);
    else
      wgmma_rs_n64(o, p[kb], desc, 1);
  }
}

// Tiles of 64 rows (B2's K and V tiles, B5-dq's K and V, B5-dkv's q and
// dO): STEP_N rows, boxes of STEP_BOX bytes. Such a tile is read both ways:
// K-major as the B operand of a score product, MN-major as the B operand of
// an accumulation whose A operand comes from registers.
constexpr int STEP_N = 64;
constexpr int STEP_BOX = 64 * 128;  // bytes of one 64-column box of such a tile

// s (64 x 64, fp32) = a . b^T for this warpgroup's 64 rows of a 128-row tile
// (`a`, its boxes ATT_BOX apart) and a 64-row tile `b`, both K-major: D / 16
// wgmma steps, the first of which does not read s.
template <int D>
__device__ __forceinline__ void step_scores_issue(float (&s)[32], const unsigned char* a,
                                                  const unsigned char* b) {
  wgmma_ss_n64_first(s, desc_sw128(a, 16, 1024), desc_sw128(b, 16, 1024));
#pragma unroll
  for (int kk = 1; kk < D / 16; ++kk) {
    const int col = (kk % 4) * 32;
    wgmma_ss_n64(s, desc_sw128(a + (kk / 4) * ATT_BOX + col, 16, 1024),
                 desc_sw128(b + (kk / 4) * STEP_BOX + col, 16, 1024));
  }
}

// acc (64 x D) += x . b over the 64 rows of the tile `b` (MN-major, its
// 64-column boxes STEP_BOX apart), x from registers in four k16 steps.
template <int D>
__device__ __forceinline__ void step_acc_issue(float (&acc)[D / 2], const uint32_t (&x)[4][4],
                                               const unsigned char* b) {
#pragma unroll
  for (int kb = 0; kb < 4; ++kb) {
    const uint64_t desc = desc_sw128(b + kb * 16 * 128, STEP_BOX, 1024);
    if constexpr (D == 128)
      wgmma_rs_n128(acc, x[kb], desc, 1);
    else
      wgmma_rs_n64(acc, x[kb], desc, 1);
  }
}

// Ping-pong between the two consumer warpgroups: each issues its products
// only in its turn (named barrier 3 + cw, 256 threads: its own 128 wait,
// the other's 128 arrive) and hands the turn over once they are issued, so
// that one warpgroup's fp32 work runs beside the other's wgmma instead of
// both contending for the tensor cores at once. Warpgroup 1 gives
// warpgroup 0 the first turn (turns_start) and keeps its own last turn
// (turn_end with `last`), so every arrival is waited for.
__device__ __forceinline__ void turns_start(int cw) {
  if (cw == 1) named_barrier_arrive(3, 256);
}

__device__ __forceinline__ void turn_begin(int cw) { named_barrier_sync(3 + cw, 256); }

__device__ __forceinline__ void turn_end(int cw, bool last) {
  if (!(last && cw == 1)) named_barrier_arrive(3 + (cw ^ 1), 256);
}

// The (tile, head) this block takes. The grid is (tiles, H, B) with the
// tile fastest, or, with `heads_fastest`, (tiles * H, 1, B) with the head
// fastest: each cluster (ATT_PAIR neighbouring blocks of x) is one head's
// neighbouring tiles, and the H heads' clusters of the same tiles follow one
// another, so that blocks that read the same rows of a bias broadcast over
// the heads run side by side.
__device__ __forceinline__ int2 tile_and_head(bool heads_fastest, int H) {
  if (!heads_fastest) return make_int2(blockIdx.x, blockIdx.y);
  const int pair = blockIdx.x / ATT_PAIR;
  return make_int2((pair / H) * ATT_PAIR + blockIdx.x % ATT_PAIR, pair % H);
}

// The (tile, head, batch) of work item `item` of a kernel whose clusters
// walk items (B3's dq on its persistent grid): item = (batch, then pair of
// 128-row tiles and head), a pair of tiles a cluster (this block the tile of
// its rank), in tile_and_head's orders: the tiles fastest, or with
// `heads_fastest` the H heads of one pair one after another.
__device__ __forceinline__ int3 work_item(int item, int pairs, int H, bool heads_fastest) {
  const int per_batch = pairs * H, r = item % per_batch;
  const int pair = heads_fastest ? r / H : r % pairs;
  return make_int3(pair * ATT_PAIR + (int)cluster_rank(), heads_fastest ? r % H : r / pairs,
                   item / per_batch);
}

// This warp's part in releasing a ring slot: every consumer warp of the
// pair arrives on the slot's empty barrier in both blocks.
__device__ __forceinline__ void release_slot(uint64_t* empty, int lane) {
  if (lane < ATT_PAIR) mbar_arrive_cluster(empty, lane);
}

// Score columns at or past Lk take no part: -inf, so p = 0 there. s holds
// this thread's N values of a tile of 2 N keys (128 or 64) from key0.
template <int N>
__device__ __forceinline__ void mask_keys(float (&s)[N], int key0, int Lk, int tq) {
  if (key0 + 2 * N <= Lk) return;
#pragma unroll
  for (int j = 0; j < N / 4; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i)
      if (key0 + 8 * j + 2 * tq + (i & 1) >= Lk) s[4 * j + i] = -INFINITY;
}

constexpr int BIAS_COLS = 32;  // fp32 columns of one bias box: 128 bytes

// The byte offset of element (row, col) in an fp32 bias tile held as
// 128-byte-swizzled boxes of BIAS_COLS columns, `box_bytes` apart.
__device__ __forceinline__ int bias_offset(int box_bytes, int row, int col) {
  const int c = col % BIAS_COLS;
  return (col / BIAS_COLS) * box_bytes + row * 128 + (((c >> 2) ^ (row & 7)) << 4) + (c & 3) * 4;
}

// Element (row, col) of such a tile; an even col starts a float2.
__device__ __forceinline__ const float* bias_at(const unsigned char* tile, int box_bytes,
                                                int row, int col) {
  return reinterpret_cast<const float*>(tile + bias_offset(box_bytes, row, col));
}

// Where a thread's accumulator values of its 64 x 64 scores (B2,
// B5-dq-bias: rows `row` and row + 8, columns col0 + 8j + 2tq, +1) are in
// an fp32 bias tile: the float2 of row row + 8r, columns 8j + 2tq, +1.
__device__ __forceinline__ const float2* bias_row_pair(const unsigned char* tile, int box_bytes,
                                                       int row, int col0, int tq, int j, int r) {
  return reinterpret_cast<const float2*>(
      bias_at(tile, box_bytes, row + 8 * r, col0 + 8 * j + 2 * tq));
}

// The same, transposed, for the scores k . q^T of B5-dkv-bias, whose rows
// are keys (`key` and key + 8) and columns queries while the tile is
// bias[query][key]: accumulator value 4j + i is element (8j + 2tq + (i & 1),
// key + 8 (i >> 1)), bias_col_offset(..., i) + 1024 j bytes into the tile
// (eight more rows keep the swizzle's row % 8).
__device__ __forceinline__ int bias_col_offset(int box_bytes, int key, int tq, int i) {
  return bias_offset(box_bytes, 2 * tq + (i & 1), key + 8 * (i >> 1));
}

__device__ __forceinline__ const float* bias_col_at(const unsigned char* tile, int box_bytes,
                                                    int key, int tq, int j, int i) {
  return reinterpret_cast<const float*>(tile + bias_col_offset(box_bytes, key, tq, i) +
                                        1024 * j);
}

// threadIdx.x, read where it is used: the compiler may not hoist it (and
// what is computed from it) out of a loop and hold it there.
__device__ __forceinline__ int thread_index() {
  int t;
  asm volatile("mov.u32 %0, %%tid.x;\n" : "=r"(t));
  return t;
}

// The fp32 at shared-memory address `addr` (ld.shared: the compiler may not
// move it across the barrier waits and arrivals around it).
__device__ __forceinline__ float ld_shared_f32(uint32_t addr) {
  float x;
  asm volatile("ld.shared.f32 %0, [%1];\n" : "=f"(x) : "r"(addr) : "memory");
  return x;
}

// A thread's 32 accumulator values read through bias_row_pair
// (`transposed` false) or bias_col_at: the card test's view of both reads.
__device__ __forceinline__ void bias_values(float (&bv)[32], const unsigned char* tile,
                                            int box_bytes, int first, int tq, bool transposed) {
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      if (transposed) {
        bv[4 * j + 2 * r] = *bias_col_at(tile, box_bytes, first, tq, j, 2 * r);
        bv[4 * j + 2 * r + 1] = *bias_col_at(tile, box_bytes, first, tq, j, 2 * r + 1);
      } else {
        const float2 x = *bias_row_pair(tile, box_bytes, first, 0, tq, j, r);
        bv[4 * j + 2 * r] = x.x;
        bv[4 * j + 2 * r + 1] = x.y;
      }
    }
}

// The largest score of row r (g or g + 8) over the quad's columns.
template <int N>
__device__ __forceinline__ float row_max(const float (&s)[N], int r) {
  float mx = -INFINITY;
#pragma unroll
  for (int j = 0; j < N / 4; ++j) mx = fmaxf(mx, fmaxf(s[4 * j + 2 * r], s[4 * j + 2 * r + 1]));
  mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
  return fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// The consumer warpgroup's epilogue: its 64 x D output rows, each divided
// by `div[r]` and multiplied by `mul`, as bf16 into its own rows of a
// 128-row tile (the Q tile: no longer read), then one TMA store per box;
// rows past Lq are not written.
template <int D>
__device__ __forceinline__ void attn_store(unsigned char* q_rows, const CUtensorMap* tm_o,
                                           const float (&o)[D / 2], const float div[2], int t,
                                           int cw, int row0, int Lq, int h, int b,
                                           float mul = 1.f) {
  acc_to_swizzled<D>(q_rows, ATT_BOX, o, div, t, mul);
  fence_async_shared();
  named_barrier_sync(1 + cw, 128);
  if (t == 0 && row0 < Lq) {
    for (int c = 0; c < D / 64; ++c) tma_store(tm_o, q_rows + c * ATT_BOX, 64 * c, row0, h, b);
    tma_store_wait();
  }
}

// ------------------------------------------------------------------ host

typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                  const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                  CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled, looked up through the runtime: the libraries link
// no -lcuda.
inline EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault,
                                     &found);
#else
    cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (found == cudaDriverEntryPointSuccess) fn = reinterpret_cast<EncodeTiledFn>(p);
  }
  return fn;
}

// Values per operand in a wrapper's description (ops/tensor_maps.py):
// dims (columns D, rows, heads, batches), the byte strides of rows, heads
// and batches, the box (columns, rows, 1, 1).
constexpr int MAP_SPEC = 11;

// The tensor map of a bf16 (B, H, L, D) operand (or, with `type` FLOAT32,
// an fp32 bias (B|1, H|1, Lq, Lk); B6's 2-D operands as (columns, rows, 1,
// 1)) at `base` from its description `spec`: the 128-byte swizzle unless
// `swizzle` says otherwise, zero fill past the edges.
inline cudaError_t encode_tensor_map(
    CUtensorMap* map, const void* base, const long long* spec,
    CUtensorMapDataType type = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
    CUtensorMapSwizzle swizzle = CU_TENSOR_MAP_SWIZZLE_128B) {
  const EncodeTiledFn encode = encode_tiled();
  if (encode == nullptr) return cudaErrorNotSupported;
  cuuint64_t dims[4], strides[3];
  cuuint32_t box[4];
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  for (int i = 0; i < 4; ++i) dims[i] = (cuuint64_t)spec[i];
  for (int i = 0; i < 3; ++i) strides[i] = (cuuint64_t)spec[4 + i];
  for (int i = 0; i < 4; ++i) box[i] = (cuuint32_t)spec[7 + i];
  const CUresult r = encode(map, type, 4, const_cast<void*>(base),
                            dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
                            swizzle, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// Encode `n` tensor maps from the descriptions at `maps` (MAP_SPEC values
// each) of the bf16 operands at `bases`.
inline cudaError_t encode_maps(CUtensorMap* tm, const void* const* bases, const long long* maps,
                               int n) {
  for (int i = 0; i < n; ++i) {
    const cudaError_t err = encode_tensor_map(&tm[i], bases[i], maps + i * MAP_SPEC);
    if (err != cudaSuccess) return err;
  }
  return cudaSuccess;
}

// Whether `spec` describes a (batches, heads, rows, d) operand with boxes
// of `box_rows` rows, as a kernel's tiles expect.
inline bool spec_is(const long long* spec, int d, int rows, int heads, int batches,
                    int box_rows) {
  return spec[0] == d && spec[1] == rows && spec[2] == heads && spec[3] == batches &&
         spec[7] == (d < 64 ? d : 64) && spec[8] == box_rows && spec[9] == 1 && spec[10] == 1;
}

// Whether `spec` describes an fp32 bias of `cols` keys and `rows` queries
// over heads and batches each either broadcast (a dimension of 1, indexed at
// 0) or full, read in boxes of BIAS_COLS columns and `box_rows` rows.
inline bool bias_spec_is(const long long* spec, int cols, int rows, int heads, int batches,
                         int box_rows) {
  return spec[0] == cols && spec[1] == rows && (spec[2] == 1 || spec[2] == heads) &&
         (spec[3] == 1 || spec[3] == batches) && spec[7] == BIAS_COLS &&
         spec[8] == box_rows && spec[9] == 1 && spec[10] == 1;
}

// Values per fp32 row-statistics operand (lse, delta: contiguous (B, H, L))
// in a wrapper's description (ops/tensor_maps.py, `describe_rows`): rows,
// heads, batches, and the bytes of one span a kernel reads at a time.
constexpr int ROWS_SPEC = 4;

inline bool rows_spec_is(const long long* spec, int rows, int heads, int batches,
                         int span_rows) {
  return spec[0] == rows && spec[1] == heads && spec[2] == batches &&
         spec[3] == 4LL * span_rows;
}

// Shapes every attention entry refuses.
inline bool bad_shape(int B, int H, int KVH, int Lq, int Lk) {
  return B < 1 || H < 1 || KVH < 1 || H % KVH || Lq < 1 || Lk < 1;
}

}  // namespace
