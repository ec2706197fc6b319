// Grouped int4 weight matmul for Hopper (sm_90a): kernel B6.
//
// B6 replaces the TPU kernel `int4_matmul` -> `_int4_kernel` in
// mmada_tpu/ops/int4_matmul.py (:91, called at :149). It computes
//
//   out (M, N) = bf16( x (M, K) . W (K, N), accumulated in fp32 )
//   W[k, n]    = bf16_rn( float(nibble(k, n)) * scales[k / 128, n] )
//
// x is bf16; `packed` is int8 (K/2, N); `scales` fp32 (K/128, N). Within each
// 128-row group along K, packed byte row i (of 64) holds w[i] in bits 0-3 and
// w[i + 64] in bits 4-7, both sign-extended nibbles in [-8, 7]: the group is
// the two halves in order, not interleaved even/odd. Dequantisation is an
// fp32 multiply and one round-to-nearest-even to bf16, so W is bit for bit
// the weight the plain version (`x @ unpack_int4(packed, scales, bf16)`)
// multiplies; only the order of the fp32 sums differs. The output is cast to
// bf16 once.
//
// Bound: int4 moves 0.5 bytes per weight and does 2*M flops on it, so at
// 989 TFLOP/s bf16 and 3.35 TB/s the kernel is bound by bytes below about
// M = 74 rows and by operations above. The serving shapes (M = 96 to 4,620)
// are mostly above: the products must run in the tensor cores at the wgmma
// rate, the expansion of the nibbles must overlap them, and the weight must
// never be written back to device memory dequantised (that would move 2
// bytes per weight, four times the packed stream).
//
// Design (the warp-specialised shape of hopper_sm90.cuh). A block of three
// warpgroups owns an output tile of BM = 128 or 256 rows by 128 columns at a
// time, on a persistent grid (as many blocks as the card holds at once,
// each walking tiles; neighbouring tiles in bands of 8 row tiles, so that
// the blocks running together share x rows and W columns through L2):
//  * warpgroup 0 is the producer: one thread keeps the x tiles (BM x 128
//    bf16 of one K group, two boxes of 64 columns, 128-byte swizzle) in a
//    ring of XS slots, another the packed bytes (64 x 128) and the group's
//    128 scales in a ring of PS slots, all by TMA on mbarriers, running on
//    from one tile into the next;
//  * warpgroups 1 and 2 are the consumers, BM / 2 rows each (one or two
//    m64 blocks, fp32 accumulators in registers). For each K group they
//    issue the group's wgmma products (x K-major from its slot, W MN-major
//    from one of two expanded tiles) and, while the tensor cores run them,
//    expand the next group's packed bytes into the other W tile
//    (`consume_step`): each of
//    the 256 threads turns 4 x 8 bytes (two nibbles each) into 4 x 2 rows of
//    8 bf16 in the swizzled layout the wgmma B descriptor reads (the layout
//    of V in the attention kernels: k rows, 64-column boxes), so the
//    expansion overlaps the products and every weight is expanded once per
//    block tile for both warpgroups. After the products' wait the two
//    warpgroups meet at a barrier (W tile complete, the old one free).
//  * the epilogue (after a tile's last group): each consumer writes its
//    rows of out as bf16 into the x slot its products just read (the slot
//    is exactly the tile's size), and stores them by TMA (rows past M
//    dropped) before the slot is freed.
// Why W goes through shared memory as the B operand, not into registers as
// the A operand of out^T = W^T . x^T: a thread's register-A fragment needs
// bytes of four packed rows and eight columns that no wide load brings
// together (byte-wise reads), where the shared tile takes 8-byte reads and
// 16-byte writes without bank conflicts, and one expansion serves both
// consumer warpgroups. Tiles of 256 rows halve the expansions and the
// packed bytes read per output but halve the tiles; the wrapper takes them
// where the waves they save outweigh a wave's fixed cost, as measured on an
// H100 (`int4_matmul.block_rows`: the t2i shapes and the text ff_proj).
//
// A nibble becomes a float without a conversion instruction: (nibble ^ 8)
// is v + 8 in [0, 15], placed in the low byte of 0x4B000000 (2^23) by a
// byte permute; minus 2^23 + 8 that is v exactly.

#include "hopper_sm90.cuh"

namespace {

constexpr int GROUP = 128;          // K rows per scale group
constexpr int PACK = GROUP / 2;     // packed byte rows per group
constexpr int BN = 128;             // output columns per tile
constexpr int GROUP_M = 8;          // row tiles per band of the tile order
constexpr int THREADS = 384;        // producer + two consumer warpgroups
constexpr int W_BOX = GROUP * 128;  // bytes of a 64-column box of the W tile
constexpr int W_BYTES = 2 * W_BOX;  // the expanded W tile: 128 k rows x 128 bf16
constexpr int P_BYTES = PACK * BN;  // a group's packed bytes
constexpr int S_BYTES = BN * 4;     // a group's scales
constexpr int PS = 3;               // slots of the packed-byte ring
constexpr int X_RING = 128 * 1024;  // bytes of the x ring

// The shared memory of a block whose tiles are BM = 128 MB rows: the x ring
// (XS slots of BM x 128 bf16, each two 128-byte-swizzled boxes of BM rows),
// two expanded W tiles, the ring of packed bytes and scales, then the
// barriers (full and empty of each ring).
template <int MB>
struct Int4Smem {
  static constexpr int BM = 128 * MB;
  static constexpr int X_BOX = BM * 128;  // one 64-column box of an x tile
  static constexpr int X_BYTES = 2 * X_BOX;
  static constexpr int XS = X_RING / X_BYTES;
  static constexpr int BYTES =
      XS * X_BYTES + 2 * W_BYTES + PS * (P_BYTES + S_BYTES) + 16 * (XS + PS) + 1024;
  unsigned char* base;

  __device__ explicit Int4Smem(unsigned char* raw)
      : base(reinterpret_cast<unsigned char*>(
            (reinterpret_cast<uintptr_t>(raw) + 1023) & ~static_cast<uintptr_t>(1023))) {}

  __device__ unsigned char* x(int s) const { return base + s * X_BYTES; }
  __device__ unsigned char* w(int b) const { return base + XS * X_BYTES + b * W_BYTES; }
  __device__ const int8_t* packed(int s) const {
    return reinterpret_cast<const int8_t*>(w(2) + s * P_BYTES);
  }
  __device__ const float* scales(int s) const {
    return reinterpret_cast<const float*>(w(2) + PS * P_BYTES + s * S_BYTES);
  }
  __device__ uint64_t* x_full(int s) const {
    return reinterpret_cast<uint64_t*>(w(2) + PS * (P_BYTES + S_BYTES)) + s;
  }
  __device__ uint64_t* x_empty(int s) const { return x_full(XS + s); }
  __device__ uint64_t* p_full(int s) const { return x_full(2 * XS + s); }
  __device__ uint64_t* p_empty(int s) const { return x_full(2 * XS + PS + s); }

  __device__ void init_barriers() const {
    for (int s = 0; s < XS; ++s) {
      mbar_init(x_full(s), 1);
      mbar_init(x_empty(s), 1);  // consumer thread 0, after both warpgroups' barrier
    }
    for (int s = 0; s < PS; ++s) {
      mbar_init(p_full(s), 1);
      mbar_init(p_empty(s), 1);
    }
    mbar_init_fence();
  }
};

// The (row tile, column tile) of tile t: bands of GROUP_M row tiles, the
// column tiles of a band in turn, its row tiles fastest.
__device__ __forceinline__ int2 tile_of(int t, int tiles_m, int tiles_n) {
  const int band = t / (GROUP_M * tiles_n), first = band * GROUP_M;
  const int rows = min(GROUP_M, tiles_m - first);
  const int r = t - band * GROUP_M * tiles_n;
  return make_int2(first + r % rows, r / rows);
}

// Byte `i` of `biased` (a nibble v + 8 in [0, 15]) as the float v.
__device__ __forceinline__ float nibble_value(uint32_t biased, int i) {
  return __uint_as_float(__byte_perm(biased, 0x4B000000u, 0x7540 + i)) - 8388616.f;
}

// Eight weights of one W row as bf16: the nibbles at `shift` (0: rows i,
// 4: rows i + 64) of the packed bytes `pk` (columns 0-7), each times its
// column's scale in fp32, rounded once.
__device__ __forceinline__ uint4 expand8(uint2 pk, int shift, const float (&sc)[8]) {
  const uint32_t a = ((pk.x >> shift) & 0x0F0F0F0Fu) ^ 0x08080808u;
  const uint32_t b = ((pk.y >> shift) & 0x0F0F0F0Fu) ^ 0x08080808u;
  return make_uint4(pack_bf16(nibble_value(a, 0) * sc[0], nibble_value(a, 1) * sc[1]),
                    pack_bf16(nibble_value(a, 2) * sc[2], nibble_value(a, 3) * sc[3]),
                    pack_bf16(nibble_value(b, 0) * sc[4], nibble_value(b, 1) * sc[5]),
                    pack_bf16(nibble_value(b, 2) * sc[6], nibble_value(b, 3) * sc[7]));
}

// Consumer thread c's part (c in [0, 256)) of one group's expansion into
// the W tile `w`: columns 8 jj.. (jj = c % 16) of packed rows c / 16 + 16 i,
// written as W rows r and r + 64 into the 128-byte swizzle (chunk jj % 8 of
// box jj / 8 at chunk (jj % 8) ^ (r % 8)). Then the writes (and the reads of
// the packed slot) are ordered before the async proxy's use of both.
__device__ __forceinline__ void expand_group(unsigned char* w, const int8_t* packed,
                                             const float* scales, int c) {
  const int jj = c % 16;
  const float4 s0 = reinterpret_cast<const float4*>(scales)[2 * jj];
  const float4 s1 = reinterpret_cast<const float4*>(scales)[2 * jj + 1];
  const float sc[8] = {s0.x, s0.y, s0.z, s0.w, s1.x, s1.y, s1.z, s1.w};
  unsigned char* box = w + (jj / 8) * W_BOX;
#pragma unroll
  for (int i = 0; i < PACK / 16; ++i) {
    const int r = c / 16 + 16 * i;
    const uint2 pk = *reinterpret_cast<const uint2*>(packed + r * BN + 8 * jj);
    const int chunk = ((jj % 8) ^ (r % 8)) << 4;
    *reinterpret_cast<uint4*>(box + r * 128 + chunk) = expand8(pk, 0, sc);
    *reinterpret_cast<uint4*>(box + (r + PACK) * 128 + chunk) = expand8(pk, 4, sc);
  }
  fence_async_shared();
}

// Consumer step s, K group g of the block's tile `tile`: the group's
// products into acc (its first group starts the sums: scale-d 0) and, while
// they run, the expansion of the next step's packed bytes into the other W
// tile (the last step expands its own bytes again into that tile, which
// nothing reads any more: the region between the products' commit and wait
// holds no branch and no barrier wait, since ptxas crashed on B6 with a
// wait loop there); with LAST (the tile's last group) the epilogue; then
// both warpgroups' barrier and the slots' release. Thread t of consumer
// warpgroup cw, c = 128 cw + t.
template <int MB, bool LAST>
__device__ __forceinline__ void consume_step(const Int4Smem<MB>& sm, const CUtensorMap* tm_o,
                                             float (&acc)[MB][64], int s, int g, int steps,
                                             int2 tile, int M, int cw, int t, int c) {
  using S = Int4Smem<MB>;
  const int slot = s % S::XS;
  const bool next = s + 1 < steps;
  if (next) mbar_wait(sm.p_full((s + 1) % PS), ((s + 1) / PS) & 1);
  mbar_wait(sm.x_full(slot), (s / S::XS) & 1);
  unsigned char* x = sm.x(slot);
  const unsigned char* rows = x + cw * MB * 64 * 128;  // this warpgroup's rows
  const unsigned char* w = sm.w(s % 2);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < GROUP / 16; ++kk) {
    const uint64_t desc_w = desc_sw128(w + kk * 16 * 128, W_BOX, 1024);
#pragma unroll
    for (int b = 0; b < MB; ++b)
      wgmma_ss_n128_mn(
          acc[b], desc_sw128(rows + (kk / 4) * S::X_BOX + b * 64 * 128 + (kk % 4) * 32, 16, 1024),
          desc_w, kk > 0 || g > 0);
  }
  wgmma_commit();
  const int p = (next ? s + 1 : s) % PS;
  expand_group(sm.w((s + 1) % 2), sm.packed(p), sm.scales(p), c);
  wgmma_wait<0>();
#pragma unroll
  for (int b = 0; b < MB; ++b) fence_regs(acc[b]);
  if constexpr (LAST) {
    // out rows as bf16 over this warpgroup's rows of the x slot, then by TMA
    const float one[2] = {1.f, 1.f};
#pragma unroll
    for (int b = 0; b < MB; ++b)
      acc_to_swizzled<BN>(x + (cw * MB + b) * 64 * 128, S::X_BOX, acc[b], one, t);
    fence_async_shared();
    named_barrier_sync(2 + cw, 128);
    if (t == 0) {
      for (int b = 0; b < MB; ++b) {
        const int row = tile.x * S::BM + (cw * MB + b) * 64;
        if (row < M)
          for (int cc = 0; cc < 2; ++cc)
            tma_store(tm_o, x + cc * S::X_BOX + (cw * MB + b) * 64 * 128, tile.y * BN + 64 * cc,
                      row, 0, 0);
      }
      tma_store_wait();
    }
  }
  named_barrier_sync(1, 256);  // W tile s % 2 read, W tile (s + 1) % 2 written
  if (c == 0) {
    mbar_arrive(sm.x_empty(slot));
    if (next) mbar_arrive(sm.p_empty((s + 1) % PS));
  }
}

// Kernel B6. The producer threads and the consumers walk the same steps:
// step s of this block is K group s % G of its tile s / G (tiles blockIdx.x,
// + gridDim.x, ...). Step s's x tile is the x ring's load s, its packed
// bytes the packed ring's load s, its W tile w(s % 2).
template <int MB>
__global__ void __launch_bounds__(THREADS, 1)
int4_matmul_wgmma_kernel(const __grid_constant__ CUtensorMap tm_x,
                         const __grid_constant__ CUtensorMap tm_p,
                         const __grid_constant__ CUtensorMap tm_s,
                         const __grid_constant__ CUtensorMap tm_o, int M, int N, int K) {
  using S = Int4Smem<MB>;
  constexpr int BM = S::BM, XS = S::XS;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const S sm(smem_raw);
  const int tiles_m = (M + BM - 1) / BM, tiles_n = N / BN;
  const int G = K / GROUP;
  const int tiles = (tiles_m * tiles_n - blockIdx.x + gridDim.x - 1) / gridDim.x;
  const int steps = tiles * G;
  if (threadIdx.x == 0) sm.init_barriers();
  __syncthreads();
  const int wg = threadIdx.x / 128;
  if (wg == 0) {
    setmaxnreg_dec<40>();
    if (threadIdx.x == 0) {  // the x ring
      for (int s = 0; s < steps; ++s) {
        const int2 tile = tile_of(blockIdx.x + s / G * gridDim.x, tiles_m, tiles_n);
        const int slot = s % XS;
        mbar_wait(sm.x_empty(slot), ((s / XS) & 1) ^ 1);
        mbar_expect_tx(sm.x_full(slot), S::X_BYTES);
        for (int c = 0; c < 2; ++c)
          tma_load(sm.x(slot) + c * S::X_BOX, &tm_x, sm.x_full(slot), (s % G) * GROUP + 64 * c,
                   tile.x * BM, 0, 0);
      }
    } else if (threadIdx.x == 32) {  // the packed bytes and scales
      for (int s = 0; s < steps; ++s) {
        const int2 tile = tile_of(blockIdx.x + s / G * gridDim.x, tiles_m, tiles_n);
        const int slot = s % PS;
        mbar_wait(sm.p_empty(slot), ((s / PS) & 1) ^ 1);
        mbar_expect_tx(sm.p_full(slot), P_BYTES + S_BYTES);
        tma_load(sm.w(2) + slot * P_BYTES, &tm_p, sm.p_full(slot), tile.y * BN,
                 (s % G) * PACK, 0, 0);
        tma_load(sm.w(2) + PS * P_BYTES + slot * S_BYTES, &tm_s, sm.p_full(slot), tile.y * BN,
                 s % G, 0, 0);
      }
    }
  } else {
    setmaxnreg_inc<232>();
    const int cw = wg - 1, t = threadIdx.x % 128, c = threadIdx.x - 128;
    float acc[MB][64];  // each tile's first products do not read it
#pragma unroll
    for (int b = 0; b < MB; ++b)
#pragma unroll
      for (int i = 0; i < 64; ++i) acc[b][i] = 0.f;
    mbar_wait(sm.p_full(0), 0);  // step 0's W tile
    expand_group(sm.w(0), sm.packed(0), sm.scales(0), c);
    named_barrier_sync(1, 256);
    if (c == 0) mbar_arrive(sm.p_empty(0));
    for (int i = 0; i < tiles; ++i) {
      const int2 tile = tile_of(blockIdx.x + i * gridDim.x, tiles_m, tiles_n);
      for (int g = 0; g + 1 < G; ++g)
        consume_step<MB, false>(sm, &tm_o, acc, i * G + g, g, steps, tile, M, cw, t, c);
      consume_step<MB, true>(sm, &tm_o, acc, i * G + G - 1, G - 1, steps, tile, M, cw, t, c);
    }
  }
}

// Whether `spec` describes a 2-D operand of `cols` columns and `rows` rows
// (as (cols, rows, 1, 1)) read or written in boxes of box_cols x box_rows.
inline bool matrix_spec_is(const long long* spec, long long cols, long long rows, int box_cols,
                           int box_rows) {
  return spec[0] == cols && spec[1] == rows && spec[2] == 1 && spec[3] == 1 &&
         spec[7] == box_cols && spec[8] == box_rows && spec[9] == 1 && spec[10] == 1;
}

template <int MB>
cudaError_t launch(const void* const bases[4], const long long* maps, int M, int K, int N,
                   cudaStream_t stream) {
  CUtensorMap tm[4];
  cudaError_t err = encode_tensor_map(&tm[0], bases[0], maps);
  if (err == cudaSuccess)
    err = encode_tensor_map(&tm[1], bases[1], maps + MAP_SPEC, CU_TENSOR_MAP_DATA_TYPE_UINT8,
                            CU_TENSOR_MAP_SWIZZLE_NONE);
  if (err == cudaSuccess)
    err = encode_tensor_map(&tm[2], bases[2], maps + 2 * MAP_SPEC,
                            CU_TENSOR_MAP_DATA_TYPE_FLOAT32, CU_TENSOR_MAP_SWIZZLE_NONE);
  if (err == cudaSuccess) err = encode_tensor_map(&tm[3], bases[3], maps + 3 * MAP_SPEC);
  if (err != cudaSuccess) return err;
  auto kernel = int4_matmul_wgmma_kernel<MB>;
  const int smem = Int4Smem<MB>::BYTES;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  int device = 0, sms = 0, per_sm = 0;
  if (err == cudaSuccess) err = cudaGetDevice(&device);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, THREADS, smem);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  const int tiles = (M + 128 * MB - 1) / (128 * MB) * (N / BN);
  const int grid = tiles < sms * per_sm ? tiles : sms * per_sm;
  kernel<<<grid, THREADS, smem, stream>>>(tm[0], tm[1], tm[2], tm[3], M, N, K);
  return cudaGetLastError();
}

}  // namespace

// C entry, bound with ctypes. x (M, K) bf16, packed (K/2, N) int8, scales
// (K/128, N) fp32, out (M, N) bf16; K and N multiples of 128. `maps`: the
// wrapper's descriptions (ops/tensor_maps.py, `describe_matrix`; MAP_SPEC
// values each, every row 16-byte aligned) of x (boxes of 64 columns and the
// tile's 128 or 256 rows, which choose the kernel), packed (128 x 64),
// scales (128 x 1) and out (64 x 64). Returns a cudaError_t; 0 is success.
extern "C" int mmada_int4_matmul_bf16(const void* x, const void* packed, const void* scales,
                                      void* out, int M, int K, int N, const long long* maps,
                                      void* stream) {
  const long long* x_map = maps;
  const int bm = (int)x_map[8];
  if (M < 1 || K < GROUP || K % GROUP || N < BN || N % BN || (bm != 128 && bm != 256) ||
      !matrix_spec_is(x_map, K, M, 64, bm) ||
      !matrix_spec_is(maps + MAP_SPEC, N, K / 2, BN, PACK) ||
      !matrix_spec_is(maps + 2 * MAP_SPEC, N, K / GROUP, BN, 1) ||
      !matrix_spec_is(maps + 3 * MAP_SPEC, N, M, 64, 64))
    return (int)cudaErrorInvalidValue;
  const void* bases[4] = {x, packed, scales, out};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return bm == 256 ? (int)launch<2>(bases, maps, M, K, N, s)
                   : (int)launch<1>(bases, maps, M, K, N, s);
}
