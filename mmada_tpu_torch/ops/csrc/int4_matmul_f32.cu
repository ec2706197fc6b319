// Grouped int4 weight matmul with fp32 x, for Hopper (sm_90a): kernel
// B6-f32, on the CUDA cores.
//
// B6-f32 stands for the TPU kernel `int4_matmul` -> `_int4_kernel` in
// mmada_tpu/ops/int4_matmul.py (:91-107, called at :149) when x is fp32 (B6,
// int4_matmul.cu, keeps bf16 x). It computes, in JAX's layout and rounding:
//
//   W[k, n]  = float(nibble(k, n)) * scales[k / 128, n]     (one fp32 rounding)
//   out      = x (M, K) . W (K, N), fp32 products summed in fp32, out fp32
//
// `packed` is int8 (K/2, N): within each 128-row group along K, byte row i
// (of 64) holds w[i] in bits 0-3 and w[i + 64] in bits 4-7, sign-extended
// nibbles in [-8, 7]; `scales` fp32 (K/128, N). K and N are multiples of 128,
// M any.
//
// Arithmetic: fp32 FFMA on the CUDA cores, no tensor core and no TF32 (TF32
// keeps a 10-bit mantissa: the fp32 bar is 1e-5 of the output's largest
// entry; a split-TF32 product leaves about 2^-22 of each product, several
// fp32 ulps, against the float64 bar). W is dequantised into shared memory,
// never written back to device memory.
//
// Design: a block of 256 threads (16 x 16: ty, tx) owns a 128 x 128 output
// tile and walks its K range in stages of 64 K rows: the 32 packed byte rows
// j..j+31 of a group give K rows j..j+31 (low nibbles) and j+64..j+95 (high
// nibbles), so each packed byte is read once. Each stage's raw operands (x's
// 128 rows at those 64 columns, the 32 x 128 packed bytes, the group's 128
// scales) arrive by cp.async in 16-byte pieces into a ring of RING slots,
// two stages ahead of the one computed; rows past M arrive as zeros. One
// stage ahead of the product, the block expands the next stage's packed
// bytes into an fp32 W tile (64 x 128) in shared memory, double-buffered, so
// that a step needs one barrier. Thread (ty, tx) accumulates the outputs of
// rows 8 ty + i (i < 8) and columns 4 tx + e, 64 + 4 tx + e (e < 4): per 4 K
// rows, 8 float4 reads of x along K (one address per quarter-warp: a
// broadcast) and 8 float4 reads of W along N (128 contiguous bytes per
// quarter-warp: no bank conflict) feed 256 FFMAs, one 128-bit read per 16.
// Each group's products are summed apart and then added to the total (a
// sum in blocks of 128 K rows): at 477 rows a single chain of fp32 sums
// over K = 12,288 lay further from float64 than cuBLAS's product, past the
// bar of 1.25 times its distance (`chip_smoke.py` 14a). That takes 64 more
// registers, so one block fills an SM (255 registers a thread, 183,808
// bytes of shared memory); on the H100, two blocks an SM (128 registers,
// the single chain) spilled and ran no faster, and 32-row stages ran
// slower than 64.
//
// Small M: where the output tiles do not fill two waves of the card's block
// slots, the wrapper splits K across blocks (`int4_matmul.f32_splits`, a
// function of M, K, N and the SM count); split z writes its fp32 partial to
// the workspace, and a second kernel sums the splits in the fixed order 0,
// 1, ..., so the result does not depend on the schedule's timing (no
// atomics).
//
// Bound: 2 M K N flops at 67 TFLOP/s (fp32, CUDA cores) against x (4 M K
// bytes) + packed (K N / 2) + scales + out (4 M N) at 3.35 TB/s: at the
// 8B's shapes (M ~ 4.6k, and 477) the flops bound it.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int BM = 128, BN = 128, GROUP = 128;
constexpr int PACK_ROWS = 32;             // packed byte rows a stage
constexpr int BK = 2 * PACK_ROWS;         // K rows a stage: the low and the high nibbles
constexpr int STAGES_PER_GROUP = GROUP / BK;
constexpr int RING = 3;                   // raw stages in shared memory
constexpr int XS = BK + 4;                // padded row of a stage's x tile (floats)
constexpr int X_BYTES = BM * XS * 4;
constexpr int P_BYTES = PACK_ROWS * BN;
constexpr int SLOT = X_BYTES + P_BYTES + BN * 4;  // x, packed bytes, scales
constexpr int W_BYTES = BK * BN * 4;
constexpr int SMEM = RING * SLOT + 2 * W_BYTES;   // 183,808: one block an SM

// 16 bytes from global (src) into shared memory (dst), or 16 zero bytes
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(s), "l"(src), "r"(valid ? 16 : 0) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

struct Operands {
  const float* x;
  long long sx;
  const int8_t* packed;
  long long sp;
  const float* scales;
  long long ss;
  int M;
};

// Queue stage `st` of the block's K range (group g0 + st / 2) into `slot`:
// x's 128 rows at the stage's 64 columns (16 pieces a row: the low nibbles'
// 32 columns, then the high nibbles'), the 32 packed byte rows, the scales.
__device__ __forceinline__ void issue_stage(unsigned char* slot, const Operands& op, int m0,
                                            int n0, int g0, int st, int tid) {
  const int g = g0 + st / STAGES_PER_GROUP, j = (st % STAGES_PER_GROUP) * PACK_ROWS;
  float* xs = reinterpret_cast<float*>(slot);
#pragma unroll
  for (int e = 0; e < BM * 16 / THREADS; ++e) {
    const int p = e * THREADS + tid, r = p >> 4, c = p & 15;
    const int k = g * GROUP + (c < 8 ? j + 4 * c : GROUP / 2 + j + 4 * (c - 8));
    const bool ok = m0 + r < op.M;
    cp_async16(xs + r * XS + 4 * c, ok ? op.x + (long long)(m0 + r) * op.sx + k : op.x, ok);
  }
  {
    const int r = tid >> 3, c = tid & 7;
    cp_async16(slot + X_BYTES + r * BN + 16 * c,
               op.packed + (long long)(g * (GROUP / 2) + j + r) * op.sp + n0 + 16 * c, true);
  }
  if (tid < BN / 4) {
    const int c = tid;
    cp_async16(slot + X_BYTES + P_BYTES + 16 * c, op.scales + (long long)g * op.ss + n0 + 4 * c,
               true);
  }
}

// The stage in `slot` expanded into the fp32 W tile `w` (64 x 128): row r <
// 32 the low nibbles of byte row r, row 32 + r the high ones, each nibble
// times its column's scale (one fp32 rounding). Thread t takes byte rows t /
// 32 + 8 h (h < 4) at columns 4 (t % 32)..+3.
__device__ __forceinline__ void expand_stage(const unsigned char* slot, float* w, int tid) {
  const int c = 4 * (tid & 31);
  const float4 sc = *reinterpret_cast<const float4*>(slot + X_BYTES + P_BYTES + 4 * c);
  const float s[4] = {sc.x, sc.y, sc.z, sc.w};
#pragma unroll
  for (int h = 0; h < 4; ++h) {
    const int r = (tid >> 5) + 8 * h;
    const uint32_t bytes = *reinterpret_cast<const uint32_t*>(slot + X_BYTES + r * BN + c);
    float lo[4], hi[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      lo[e] = __fmul_rn((float)((int)(bytes << (28 - 8 * e)) >> 28), s[e]);  // arithmetic
      hi[e] = __fmul_rn((float)((int)(bytes << (24 - 8 * e)) >> 28), s[e]);
    }
    *reinterpret_cast<float4*>(w + r * BN + c) = make_float4(lo[0], lo[1], lo[2], lo[3]);
    *reinterpret_cast<float4*>(w + (PACK_ROWS + r) * BN + c) =
        make_float4(hi[0], hi[1], hi[2], hi[3]);
  }
}

// part += this thread's products over one stage: x rows 8 ty + i of the
// stage's x tile `xs`, W columns 4 tx.. and 64 + 4 tx.. of `w`.
__device__ __forceinline__ void stage_product(float (&part)[8][8], const float* xs,
                                              const float* w, int ty, int tx) {
#pragma unroll
  for (int kq = 0; kq < BK / 4; ++kq) {
    float4 a[8];
#pragma unroll
    for (int i = 0; i < 8; ++i)
      a[i] = *reinterpret_cast<const float4*>(xs + (8 * ty + i) * XS + 4 * kq);
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const float* wr = w + (4 * kq + u) * BN + 4 * tx;
      const float4 b0 = *reinterpret_cast<const float4*>(wr);
      const float4 b1 = *reinterpret_cast<const float4*>(wr + 64);
      const float b[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const float x = u == 0 ? a[i].x : u == 1 ? a[i].y : u == 2 ? a[i].z : a[i].w;
#pragma unroll
        for (int n = 0; n < 8; ++n) part[i][n] = fmaf(x, b[n], part[i][n]);
      }
    }
  }
}

// Kernel B6-f32: grid (N / 128, ceil(M / 128), splits); block z walks the
// groups [z G, (z + 1) G) of K (G = K / 128 / splits) and writes its tile to
// out (one split) or to its plane of the workspace.
__global__ void __launch_bounds__(THREADS, 1)
int4_matmul_f32_kernel(Operands op, float* __restrict__ out, int N, int groups_per_split) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* w_tiles = reinterpret_cast<float*>(smem + RING * SLOT);
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN, g0 = blockIdx.z * groups_per_split;
  const int stages = groups_per_split * STAGES_PER_GROUP;
  float acc[8][8], part[8][8];  // the sum so far; the current group's
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int n = 0; n < 8; ++n) acc[i][n] = part[i][n] = 0.f;

  issue_stage(smem, op, m0, n0, g0, 0, tid);
  cp_async_commit();
  if (stages > 1) issue_stage(smem + SLOT, op, m0, n0, g0, 1, tid);
  cp_async_commit();
  cp_async_wait<1>();
  __syncthreads();
  expand_stage(smem, w_tiles, tid);
  for (int st = 0; st < stages; ++st) {
    // stage st + 1 has landed, W tile st is complete, and every thread is
    // done with step st - 1 (its slot and W tile are free)
    cp_async_wait<0>();
    __syncthreads();
    if (st + 2 < stages) {
      issue_stage(smem + ((st + 2) % RING) * SLOT, op, m0, n0, g0, st + 2, tid);
      cp_async_commit();
    }
    if (st + 1 < stages)
      expand_stage(smem + ((st + 1) % RING) * SLOT, w_tiles + ((st + 1) & 1) * (BK * BN), tid);
    stage_product(part, reinterpret_cast<const float*>(smem + (st % RING) * SLOT),
                  w_tiles + (st & 1) * (BK * BN), ty, tx);
    if (st % STAGES_PER_GROUP == STAGES_PER_GROUP - 1) {  // a group's sum joins the total
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int n = 0; n < 8; ++n) {
          acc[i][n] += part[i][n];
          part[i][n] = 0.f;
        }
    }
  }

  float* plane = out + (long long)blockIdx.z * op.M * N;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int r = m0 + 8 * ty + i;
    if (r >= op.M) continue;
    float* row = plane + (long long)r * N + n0 + 4 * tx;
    *reinterpret_cast<float4*>(row) = make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
    *reinterpret_cast<float4*>(row + 64) =
        make_float4(acc[i][4], acc[i][5], acc[i][6], acc[i][7]);
  }
}

// out = the sum of the `splits` planes of the workspace (each n4 float4s),
// in the order 0, 1, ...
__global__ void __launch_bounds__(THREADS)
int4_sum_splits_kernel(const float4* __restrict__ ws, float4* __restrict__ out, long long n4,
                       int splits) {
  for (long long i = blockIdx.x * (long long)THREADS + threadIdx.x; i < n4;
       i += (long long)gridDim.x * THREADS) {
    float4 v = ws[i];
    for (int z = 1; z < splits; ++z) {
      const float4 u = ws[z * n4 + i];
      v.x += u.x;
      v.y += u.y;
      v.z += u.z;
      v.w += u.w;
    }
    out[i] = v;
  }
}

}  // namespace

// C entry, bound with ctypes: x fp32 (M, K) with row stride sx (elements,
// last dim contiguous, rows 16-byte aligned), packed int8 (K/2, N) and
// scales fp32 (K/128, N) with row strides sp and ss (16-byte aligned rows),
// out fp32 (M, N) contiguous. `splits` divides K / 128; with more than one,
// `workspace` is fp32 (splits, M, N), else unused. Returns a cudaError_t; 0
// is success.
extern "C" int mmada_int4_matmul_f32(const void* x, long long sx, const void* packed,
                                     long long sp, const void* scales, long long ss, void* out,
                                     void* workspace, int M, int K, int N, int splits,
                                     void* stream) {
  const int groups = K / GROUP;
  if (M < 1 || K < GROUP || N < BN || K % GROUP || N % BN || (M + BM - 1) / BM > 65535 ||
      splits < 1 || splits > 65535 || groups % splits || (splits > 1 && workspace == nullptr) ||
      sx % 4 || sp % 16 || ss % 4 || reinterpret_cast<uintptr_t>(x) % 16 ||
      reinterpret_cast<uintptr_t>(packed) % 16 || reinterpret_cast<uintptr_t>(scales) % 16)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(int4_matmul_f32_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Operands op{static_cast<const float*>(x), sx, static_cast<const int8_t*>(packed), sp,
                    static_cast<const float*>(scales), ss, M};
  float* dst = static_cast<float*>(splits > 1 ? workspace : out);
  const dim3 grid(N / BN, (M + BM - 1) / BM, splits);
  int4_matmul_f32_kernel<<<grid, THREADS, SMEM, s>>>(op, dst, N, groups / splits);
  err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return (int)err;
  const long long n4 = (long long)M * N / 4;
  const int blocks = (int)((n4 + THREADS - 1) / THREADS < 1024 ? (n4 + THREADS - 1) / THREADS
                                                                : 1024);
  int4_sum_splits_kernel<<<blocks, THREADS, 0, s>>>(static_cast<const float4*>(workspace),
                                                    static_cast<float4*>(out), n4, splits);
  return (int)cudaGetLastError();
}
