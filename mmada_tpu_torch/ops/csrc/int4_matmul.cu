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
// are mostly above: the products must run in the tensor cores, and the
// weight must never be written back to device memory dequantised (that
// would move 2 bytes per weight, four times the packed stream).
//
// Design (right and simple first; speed is later work). One block of 256
// threads (8 warps: 4 along M by 2 along N) owns a 128 x 128 output tile and
// walks K one 128-row group at a time:
//  1. cp.async brings the x tile (128 x 128 bf16), the 64 x 128 packed bytes
//     and the group's 128 fp32 scales into shared memory, double-buffered:
//     group g + 1's copies are in flight while group g is expanded and
//     multiplied;
//  2. the threads expand the packed bytes into a bf16 128 x 128 W tile in
//     shared memory (row stride 136: the eight rows an ldmatrix reads fall in
//     different banks), each thread 4 columns of a byte row at a time;
//  3. ldmatrix (x as A, W transposed as B) and mma.sync m16n8k16 (bf16 in,
//     fp32 accumulate) run over the tile.
// Rows past M are masked (zero-filled loads, no stores), not padded. The
// wrapper hands the row strides of x, packed and scales, so a column window
// of a wide head or one layer of a stacked weight is read in place. Every
// block re-expands its W tile, so a weight is expanded once per M tile: at
// large M that is wasted work that a later design (a wgmma producer/consumer
// split, or expanding once into registers per warp) would remove. Blocks of
// 64 rows (two resident per SM) were tried too and were slower at the serving
// shapes than these of 128 (one per SM, 168 registers a thread).

#include "mma_sm90.cuh"

namespace {

constexpr int GROUP = 128;          // K rows per scale group
constexpr int PACK = GROUP / 2;     // packed byte rows per group
constexpr int BM = 128;             // output rows per block
constexpr int BN = 128;             // output columns per block
constexpr int NUM_THREADS = 256;    // 8 warps: 4 along M x 2 along N
constexpr int STRIDE = GROUP + 8;   // bf16 row stride of the x and W tiles

struct Smem {
  bf16 x[2][BM * STRIDE];           // x tile, K-major rows
  int8_t packed[2][PACK * BN];      // the group's packed bytes
  float scales[2][BN];              // the group's scales
  bf16 w[GROUP * STRIDE];           // the dequantised W tile (K rows x N)
};

// One nibble of a byte as a signed value in [-8, 7].
__device__ __forceinline__ float nibble(unsigned int u) {
  return static_cast<float>(static_cast<int>((u & 15u) ^ 8u) - 8);
}

__global__ void __launch_bounds__(NUM_THREADS)
int4_matmul_kernel(const bf16* __restrict__ x, const int8_t* __restrict__ packed,
                   const float* __restrict__ scales, bf16* __restrict__ out, int M,
                   int n_groups, long long x_stride, long long p_stride,
                   long long s_stride, long long o_stride) {
  constexpr int WM = BM / 4;        // rows per warp
  constexpr int MFRAG = WM / 16;    // m16 fragments per warp
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Smem& sm = *reinterpret_cast<Smem*>(smem_raw);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int warp_m = warp >> 1, warp_n = warp & 1;
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN;

  auto load_group = [&](int g, int buf) {
#pragma unroll
    for (int it = 0; it < BM * 16 / NUM_THREADS; ++it) {  // 16-byte vectors
      const int i = tid + it * NUM_THREADS;
      const int r = i >> 4, c = (i & 15) * 8;
      const bool valid = m0 + r < M;
      cp_async16(&sm.x[buf][r * STRIDE + c],
                 x + (long long)(valid ? m0 + r : 0) * x_stride + (long long)g * GROUP + c,
                 valid);
    }
#pragma unroll
    for (int it = 0; it < PACK * BN / 16 / NUM_THREADS; ++it) {
      const int i = tid + it * NUM_THREADS;
      const int r = i >> 3, c = (i & 7) * 16;
      cp_async16(&sm.packed[buf][r * BN + c],
                 packed + ((long long)g * PACK + r) * p_stride + n0 + c, true);
    }
    if (tid < BN / 4)
      cp_async16(&sm.scales[buf][tid * 4], scales + (long long)g * s_stride + n0 + tid * 4,
                 true);
    cp_async_commit();
  };

  float acc[MFRAG][8][4];
#pragma unroll
  for (int mf = 0; mf < MFRAG; ++mf)
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) acc[mf][nt][0] = acc[mf][nt][1] = acc[mf][nt][2] = acc[mf][nt][3] = 0.f;

  load_group(0, 0);
  for (int g = 0; g < n_groups; ++g) {
    const int buf = g & 1;
    // group g's copies have landed, and every warp is done with group g - 1's
    // products (so W and the other buffers are free)
    cp_async_wait<0>();
    __syncthreads();

    // expand: each thread 4 columns of a packed row per step, low nibbles to
    // row r of W and high nibbles to row r + 64
#pragma unroll
    for (int it = 0; it < PACK * BN / 4 / NUM_THREADS; ++it) {
      const int i = tid + it * NUM_THREADS;
      const int r = i >> 5, c = (i & 31) * 4;
      const unsigned int word = *reinterpret_cast<const unsigned int*>(&sm.packed[buf][r * BN + c]);
      const float4 s = *reinterpret_cast<const float4*>(&sm.scales[buf][c]);
      const float sc[4] = {s.x, s.y, s.z, s.w};
      float lo[4], hi[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const unsigned int byte = (word >> (8 * j)) & 0xffu;
        lo[j] = nibble(byte) * sc[j];
        hi[j] = nibble(byte >> 4) * sc[j];
      }
      *reinterpret_cast<uint2*>(&sm.w[r * STRIDE + c]) =
          make_uint2(pack_bf16(lo[0], lo[1]), pack_bf16(lo[2], lo[3]));
      *reinterpret_cast<uint2*>(&sm.w[(r + PACK) * STRIDE + c]) =
          make_uint2(pack_bf16(hi[0], hi[1]), pack_bf16(hi[2], hi[3]));
    }
    if (g + 1 < n_groups) load_group(g + 1, buf ^ 1);
    __syncthreads();  // W is complete

    const bf16* xa = &sm.x[buf][(warp_m * WM + (lane & 15)) * STRIDE + (lane >> 4) * 8];
    const bf16* wb = &sm.w[(lane & 15) * STRIDE + warp_n * 64 + (lane >> 4) * 8];
#pragma unroll
    for (int ks = 0; ks < GROUP / 16; ++ks) {
      uint32_t a[MFRAG][4];
#pragma unroll
      for (int mf = 0; mf < MFRAG; ++mf)
        ldmatrix_x4<false>(a[mf], xa + mf * 16 * STRIDE + ks * 16);
#pragma unroll
      for (int np = 0; np < 4; ++np) {
        uint32_t b[4];  // B fragments of n tiles 2 np and 2 np + 1
        ldmatrix_x4<true>(b, wb + ks * 16 * STRIDE + np * 16);
#pragma unroll
        for (int mf = 0; mf < MFRAG; ++mf) {
          mma_bf16(acc[mf][2 * np], a[mf], b[0], b[1]);
          mma_bf16(acc[mf][2 * np + 1], a[mf], b[2], b[3]);
        }
      }
    }
  }

  // epilogue: accumulator rows lane / 4 and lane / 4 + 8, columns 2 (lane % 4)
#pragma unroll
  for (int mf = 0; mf < MFRAG; ++mf) {
    const int row = m0 + warp_m * WM + mf * 16 + (lane >> 2);
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      const int col = n0 + warp_n * 64 + nt * 8 + (lane & 3) * 2;
      if (row < M)
        *reinterpret_cast<uint32_t*>(out + (long long)row * o_stride + col) =
            pack_bf16(acc[mf][nt][0], acc[mf][nt][1]);
      if (row + 8 < M)
        *reinterpret_cast<uint32_t*>(out + (long long)(row + 8) * o_stride + col) =
            pack_bf16(acc[mf][nt][2], acc[mf][nt][3]);
    }
  }
}

cudaError_t launch(const void* x, const void* packed, const void* scales, void* out, int M,
                   int K, int N, long long x_stride, long long p_stride, long long s_stride,
                   cudaStream_t stream) {
  const size_t smem = sizeof(Smem);
  cudaError_t err = cudaFuncSetAttribute(
      int4_matmul_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((M + BM - 1) / BM, N / BN);
  int4_matmul_kernel<<<grid, NUM_THREADS, smem, stream>>>(
      static_cast<const bf16*>(x), static_cast<const int8_t*>(packed),
      static_cast<const float*>(scales), static_cast<bf16*>(out), M, K / GROUP, x_stride,
      p_stride, s_stride, N);
  return cudaGetLastError();
}

}  // namespace

// C entry, bound with ctypes. x (M, K) bf16 with row stride x_stride
// elements; packed (K/2, N) int8 with row stride p_stride bytes; scales
// (K/128, N) fp32 with row stride s_stride elements; out (M, N) bf16,
// contiguous. K and N multiples of 128; every row 16-byte aligned. Returns
// a cudaError_t; 0 is success.
extern "C" int mmada_int4_matmul_bf16(const void* x, const void* packed, const void* scales,
                                      void* out, int M, int K, int N, long long x_stride,
                                      long long p_stride, long long s_stride, void* stream) {
  if (M < 1 || K < GROUP || K % GROUP || N < BN || N % BN)
    return (int)cudaErrorInvalidValue;
  return (int)launch(x, packed, scales, out, M, K, N, x_stride, p_stride, s_stride,
                     static_cast<cudaStream_t>(stream));
}
