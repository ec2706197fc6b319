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
// entry). W is dequantised into shared memory, never written back to device
// memory.
//
// Design (simple first): a block of 256 threads (16 x 16) owns a 128 x 128
// output tile and walks K 16 rows at a time: x's 128 x 16 slice goes to
// shared memory transposed (k-major), the 16 x 128 slice of W is expanded
// from its packed bytes and scales into shared memory, and each thread
// accumulates 8 x 8 outputs (rows ty + 16 i, columns tx + 16 j): 64 FFMAs for
// 16 shared-memory reads.
//
// Bound: 2 M K N flops at 67 TFLOP/s (fp32, CUDA cores) against x (4 M K
// bytes) + packed (K N / 2) + scales + out (4 M N) at 3.35 TB/s: at the
// 8B's shapes (M ~ 4.6k) the flops bound it.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int BM = 128, BN = 128, BK = 16, GROUP = 128;
constexpr int XS = BM + 4;  // padded k-major row of the x slice
constexpr int WS = BN + 4;  // padded row of the W slice

__global__ void __launch_bounds__(THREADS)
int4_matmul_f32_kernel(const float* __restrict__ x, long long sx,
                       const int8_t* __restrict__ packed, long long sp,
                       const float* __restrict__ scales, long long ss,
                       float* __restrict__ out, int M, int K, int N) {
  __shared__ float xs[BK * XS];
  __shared__ float ws[BK * WS];
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
  for (int k0 = 0; k0 < K; k0 += BK) {
    // x: 128 rows x 16 columns, stored k-major; rows past M read as 0
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      const int r = e * 16 + ty;
      xs[tx * XS + r] = m0 + r < M ? x[(long long)(m0 + r) * sx + k0 + tx] : 0.f;
    }
    // W: 16 rows x 128 columns of this K slice, from the packed bytes: row k
    // of group g is byte row g * 64 + (k % 64), low nibble below 64, high above
    const int g = k0 / GROUP, kw = k0 % GROUP, hi = kw >= GROUP / 2;
    const int8_t* prow = packed + (long long)(g * (GROUP / 2) + (kw % (GROUP / 2))) * sp + n0;
    const float* srow = scales + (long long)g * ss + n0;
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      const int kk = e * 2 + (tid >> 7), c = tid & 127;
      const int byte = prow[(long long)kk * sp + c];            // sign-extended
      const int nib = hi ? (byte >> 4) : ((int)((unsigned)byte << 28) >> 28);  // arithmetic
      ws[kk * WS + c] = (float)nib * srow[c];
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      float a[8], b[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) a[i] = xs[kk * XS + ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 8; ++j) b[j] = ws[kk * WS + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int r = m0 + ty + 16 * i;
    if (r >= M) continue;
#pragma unroll
    for (int j = 0; j < 8; ++j) out[(long long)r * N + n0 + tx + 16 * j] = acc[i][j];
  }
}

}  // namespace

// C entry, bound with ctypes: x fp32 (M, K) with row stride sx (elements,
// last dim contiguous), packed int8 (K/2, N) and scales fp32 (K/128, N) with
// row strides sp and ss, out fp32 (M, N) contiguous. Returns a cudaError_t;
// 0 is success.
extern "C" int mmada_int4_matmul_f32(const void* x, long long sx, const void* packed,
                                     long long sp, const void* scales, long long ss, void* out,
                                     int M, int K, int N, void* stream) {
  if (M < 1 || K < GROUP || N < BN || K % GROUP || N % BN || (M + BM - 1) / BM > 65535)
    return (int)cudaErrorInvalidValue;
  const dim3 grid(N / BN, (M + BM - 1) / BM);
  int4_matmul_f32_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), sx, static_cast<const int8_t*>(packed), sp,
      static_cast<const float*>(scales), ss, static_cast<float*>(out), M, K, N);
  return (int)cudaGetLastError();
}
