// Backward of one-pass bidirectional attention, for Hopper (sm_90a): the dq
// kernel and the dk/dv kernel, without a bias (kernels B3) and with one
// (B3-bias).
//
// Replaces the TPU kernels of `flash_attention_bwd` in
// mmada_tpu/ops/flash_attention.py: `_attn_bwd_dq_kernel` (:719) and
// `_attn_bwd_dq_bias_kernel` (:746), called at :895, and
// `_attn_bwd_dkv_kernel` (:753) and `_attn_bwd_dkv_bias_kernel` (:799),
// called at :963. All take q and k already rotated (RoPE and its pullback
// run outside, as in the JAX package), bf16 q / k / v / dO with element
// strides, and delta = rowsum(dO * O) in fp32, computed outside. With
// s = (q . k^T) * scale in fp32, plus the fp32 bias (B|1, H|1, Lq, Lk) in the
// biased kernels (round(round(s * scale) + bias), as the forward), and key
// columns past Lk at -inf (p = 0 there):
//
//   dq kernel:  m, l = row max and row sum of exp(s - m)       (pass 1)
//               p = exp(s - m) / l; dp = dO . v^T; ds = p (dp - delta)
//               dq = bf16((ds . k) * scale); lse = m + log(l)  (pass 2)
//   dkv kernel: p = exp(s - lse); dv = p^T . dO; dp = dO . v^T;
//               ds = p (dp - delta); dk = (ds^T . q) * scale;
//               summed over the query heads that share the kv head
//
// Design. Every product is mma.sync m16n8k16 (bf16 operands, fp32
// accumulators) fed by ldmatrix from shared memory; tiles stream in with
// cp.async, double-buffered, so the next tile's copy overlaps this tile's
// products. Blocks have four warps of 16 rows.
//  * dq: one block per (64-row query tile, head, batch). Its q and dO tiles
//    stay in shared memory; it walks the K/V tiles twice, as the forward
//    kernel does, because p is normalised by the full row sum before use.
//    GQA maps head h to kv head h / (H / KVH).
//  * dkv: one block per (64-row key tile, kv head, batch) walks every query
//    tile of every query head of its group, the GQA sum in registers. Its
//    kernel is in flash_attention_dkv.cuh, shared with the staged backward
//    (B5), which differs from it only in how p and ds enter the tensor cores.
//  * Ragged edges are masked in the kernels: rows past Lq / Lk are
//    zero-filled on load and never stored, key columns past Lk get -inf
//    (dq), query columns past Lq get p = 0 (dkv).
//  * The bias is read per accumulator fragment from global memory, as in
//    the forward kernel (its rows need not be 16-byte aligned), before the
//    products it is added to; dkv reads it transposed, bias[query][key] for
//    its k . q^T tile.
//
// Query rows whose every key is masked (the padding of a masked frame): each
// score rounds to the finite min, so dq's p is 1/Lk on such a row and its lse
// is the finite min (min + log Lk rounds back to it), which makes dkv's
// p = exp(s - lse) = 1 for each of its keys, as the TPU's dkv kernel has it.
// The model gives those rows a zero cotangent (no real row attends to a pad
// key, and no loss reads a pad row), so dO = delta = 0 there and they add
// nothing; with a nonzero cotangent every output stays finite.
//
// Rounding. q.k^T and dO.v^T multiply bf16 inputs exactly and sum in fp32,
// as the TPU kernel's fp32 dots do. p and ds are fp32 and are rounded to
// bf16 (round to nearest even) to enter the tensor cores for ds.k, p^T.dO
// and ds^T.q, the usual choice of flash-attention backward kernels: each
// term then carries a relative error of at most 2^-9, against the TPU
// kernel's fp32 products, and the outputs a further bf16 rounding.
//
// Bound (on an H100 SXM: 989 TFLOP/s bf16 dense, 3.35 TB/s): dq needs
// 6*B*H*Lq*Lk*D flops (the kernel does 8, pass 1 recomputes q.k^T) against
// q + k + v + dO + dq (+ delta, lse) bytes; dkv 8*B*H*Lq*Lk*D flops against
// q + k + v + dO + dk + dv (+ lse, delta). At the stage-1 training shape
// (B 15, H 32, L 388, D 128) both are bound by bytes by a small margin; at
// longer L by operations. mma.sync without warp specialisation keeps the
// kernels short of either bound; wgmma and TMA are the next steps.

#include "flash_attention_dkv.cuh"

namespace {

template <int D, bool BIAS>
__global__ void __launch_bounds__(NUM_THREADS)
attn_bwd_dq_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                   const bf16* __restrict__ v, const bf16* __restrict__ dout,
                   const float* __restrict__ delta, const float* __restrict__ bias,
                   bf16* __restrict__ dq, float* __restrict__ lse, int rep,
                   int H, int Lq, int Lk, Strides st, float scale) {
  // strides: q 0-2, k 3-5, v 6-8, dO 9-11, dq 12-14, bias 15-17
  constexpr int STRIDE = D + 8;
  constexpr int TILE = BLOCK * STRIDE;
  constexpr int NB = BLOCK / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* qs = reinterpret_cast<bf16*>(smem_raw);
  bf16* dos = qs + TILE;
  bf16* ks = dos + TILE;  // two K tiles
  bf16* vs = ks + 2 * TILE;  // two V tiles

  const int q0 = blockIdx.x * BLOCK;
  const int h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / rep;
  const bf16* qp = q + b * st.s[0] + h * st.s[1];
  const bf16* kp = k + b * st.s[3] + kvh * st.s[4];
  const bf16* vp = v + b * st.s[6] + kvh * st.s[7];
  const bf16* dop = dout + b * st.s[9] + h * st.s[10];
  bf16* dqp = dq + b * st.s[12] + h * st.s[13];
  const long long stat0 = ((long long)b * H + h) * Lq;  // delta / lse rows

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
  const int n_tiles = (Lk + BLOCK - 1) / BLOCK;
  const bf16* qw = qs + warp * 16 * STRIDE;   // this warp's 16 query rows
  const bf16* dow = dos + warp * 16 * STRIDE;
  const int row_a = q0 + warp * 16 + g;
  const int row_b = row_a + 8;
  // this thread's two bias rows; rows past Lq (never stored) read row Lq - 1
  const float* brow[2] = {nullptr, nullptr};
  if (BIAS) {
    const float* bp = bias + b * st.s[15] + h * st.s[16];
    brow[0] = bp + (long long)min(row_a, Lq - 1) * st.s[17];
    brow[1] = bp + (long long)min(row_b, Lq - 1) * st.s[17];
  }

  load_rows_async<D, BLOCK>(qs, qp, st.s[2], q0, Lq);
  load_rows_async<D, BLOCK>(dos, dop, st.s[11], q0, Lq);
  load_rows_async<D, BLOCK>(ks, kp, st.s[5], 0, Lk);
  cp_async_commit();

  float s[NB][4];

  // pass 1: row max m and row sum l (rows g and g + 8 of this warp)
  float m[2] = {NEG_F32, NEG_F32};
  float l[2] = {0.f, 0.f};
  float bv[NB][4];
  for (int tile = 0; tile < n_tiles; ++tile) {
    load_bias_rows<BIAS, NB>(bv, brow, tile * BLOCK, Lk, t);
    if (tile + 1 < n_tiles) {
      load_rows_async<D, BLOCK>(ks + ((tile + 1) & 1) * TILE, kp, st.s[5],
                                (tile + 1) * BLOCK, Lk);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    mma_abt<D, NB>(s, qw, ks + (tile & 1) * TILE, lane);
#pragma unroll
    for (int n = 0; n < NB; ++n)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = tile * BLOCK + n * 8 + t * 2 + (j & 1);
        s[n][j] = col < Lk ? scaled<BIAS>(s[n][j], scale, bv[n][j]) : EDGE;
      }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float mx = NEG_F32;
#pragma unroll
      for (int n = 0; n < NB; ++n) mx = fmaxf(mx, fmaxf(s[n][2 * r], s[n][2 * r + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m[r], mx);
      float sum = 0.f;
#pragma unroll
      for (int n = 0; n < NB; ++n)
        sum += expf(s[n][2 * r] - m_new) + expf(s[n][2 * r + 1] - m_new);
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      l[r] = l[r] * expf(m[r] - m_new) + sum;
      m[r] = m_new;
    }
    __syncthreads();  // every warp is done with this buffer before its refill
  }

  const float delta_r[2] = {row_a < Lq ? delta[stat0 + row_a] : 0.f,
                            row_b < Lq ? delta[stat0 + row_b] : 0.f};

  // pass 2: p, dp, ds; dq += ds . k
  float acc[D / 8][4];
#pragma unroll
  for (int dn = 0; dn < D / 8; ++dn) acc[dn][0] = acc[dn][1] = acc[dn][2] = acc[dn][3] = 0.f;
  constexpr int HALF = BLOCK / 2;
  float sh[NB / 2][4], dp[NB / 2][4];

  load_rows_async<D, BLOCK>(ks, kp, st.s[5], 0, Lk);
  load_rows_async<D, BLOCK>(vs, vp, st.s[8], 0, Lk);
  cp_async_commit();
  for (int tile = 0; tile < n_tiles; ++tile) {
    if (tile + 1 < n_tiles) {
      const int next = (tile + 1) & 1;
      load_rows_async<D, BLOCK>(ks + next * TILE, kp, st.s[5], (tile + 1) * BLOCK, Lk);
      load_rows_async<D, BLOCK>(vs + next * TILE, vp, st.s[8], (tile + 1) * BLOCK, Lk);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    // the tile in two halves of 32 keys, which keeps s, dp, the dq
    // accumulators and the B fragments within the register file
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const bf16* kt = ks + (tile & 1) * TILE + half * HALF * STRIDE;
      float bh[NB / 2][4];
      load_bias_rows<BIAS, NB / 2>(bh, brow, tile * BLOCK + half * HALF, Lk, t);
      mma_abt<D, NB / 2>(sh, qw, kt, lane);
      mma_abt<D, NB / 2>(dp, dow, vs + (tile & 1) * TILE + half * HALF * STRIDE, lane);
#pragma unroll
      for (int n = 0; n < NB / 2; ++n)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int r = j >> 1;
          const int col = tile * BLOCK + half * HALF + n * 8 + t * 2 + (j & 1);
          const float sc = col < Lk ? scaled<BIAS>(sh[n][j], scale, bh[n][j]) : EDGE;
          const float p = expf(sc - m[r]) / l[r];  // normalised, as :735-738
          sh[n][j] = p * (dp[n][j] - delta_r[r]);  // ds
        }
      mma_pb<D, NB / 2>(acc, sh, kt, lane);
    }
    __syncthreads();
  }

#pragma unroll
  for (int dn = 0; dn < D / 8; ++dn) {
    const int col = dn * 8 + t * 2;
    if (row_a < Lq)
      *reinterpret_cast<uint32_t*>(dqp + row_a * st.s[14] + col) =
          pack_bf16(acc[dn][0] * scale, acc[dn][1] * scale);
    if (row_b < Lq)
      *reinterpret_cast<uint32_t*>(dqp + row_b * st.s[14] + col) =
          pack_bf16(acc[dn][2] * scale, acc[dn][3] * scale);
  }
  if (t == 0) {
    if (row_a < Lq) lse[stat0 + row_a] = m[0] + logf(l[0]);
    if (row_b < Lq) lse[stat0 + row_b] = m[1] + logf(l[1]);
  }
}

template <int D, bool BIAS>
cudaError_t launch_dq(const void* q, const void* k, const void* v,
                      const void* dout, const void* delta, const void* bias,
                      void* dq, void* lse, int B, int H, int KVH, int Lq, int Lk,
                      const long long* strides, float scale, cudaStream_t stream) {
  const size_t smem = (size_t)6 * BLOCK * (D + 8) * sizeof(bf16);
  cudaError_t err = cudaFuncSetAttribute(
      attn_bwd_dq_kernel<D, BIAS>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((Lq + BLOCK - 1) / BLOCK, H, B);
  attn_bwd_dq_kernel<D, BIAS><<<grid, NUM_THREADS, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const bf16*>(dout),
      static_cast<const float*>(delta), static_cast<const float*>(bias),
      static_cast<bf16*>(dq), static_cast<float*>(lse), H / KVH, H, Lq, Lk,
      copy_strides(strides, BIAS ? 18 : 15), scale);
  return cudaGetLastError();
}

template <bool BIAS>
int dispatch_dq(const void* q, const void* k, const void* v, const void* dout,
                const void* delta, const void* bias, void* dq, void* lse, int B,
                int H, int KVH, int Lq, int Lk, int D, const long long* strides,
                float scale, void* stream) {
  if (bad_shape(B, H, KVH, Lq, Lk) || (BIAS && bias == nullptr))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D == 128)
    return (int)launch_dq<128, BIAS>(q, k, v, dout, delta, bias, dq, lse, B, H,
                                     KVH, Lq, Lk, strides, scale, s);
  if (D == 64)
    return (int)launch_dq<64, BIAS>(q, k, v, dout, delta, bias, dq, lse, B, H,
                                    KVH, Lq, Lk, strides, scale, s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// C entries, bound with ctypes. q, dO (B, H, Lq, D) and k, v (B, KVH, Lk, D):
// bf16, last dim contiguous, rows 16-byte aligned; `strides` holds the
// element strides (batch, head, row) of each operand in argument order.
// delta and lse: contiguous fp32 (B, H, Lq). Each returns a cudaError_t; 0 is
// success.

// dq (B, H, Lq, D) bf16 and lse; strides = [q, k, v, dO, dq] x 3.
extern "C" int mmada_flash_attention_bwd_dq_bf16(
    const void* q, const void* k, const void* v, const void* dout,
    const void* delta, void* dq, void* lse, int B, int H, int KVH, int Lq,
    int Lk, int D, const long long* strides, float scale, void* stream) {
  return dispatch_dq<false>(q, k, v, dout, delta, nullptr, dq, lse, B, H, KVH,
                            Lq, Lk, D, strides, scale, stream);
}

// dk, dv (B, KVH, Lk, D) bf16; strides = [q, k, v, dO, dk, dv] x 3.
extern "C" int mmada_flash_attention_bwd_dkv_bf16(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* delta, void* dk, void* dv, int B, int H,
    int KVH, int Lq, int Lk, int D, const long long* strides, float scale,
    void* stream) {
  return dispatch_dkv<false, false>(q, k, v, dout, lse, delta, nullptr, dk, dv, B,
                                    H, KVH, Lq, Lk, D, strides, scale, stream);
}

// The biased entries take the fp32 bias (B|1, H|1, Lq, Lk), last dim
// contiguous, after delta (dq) or lse and delta (dkv), and its element
// strides (batch, head, row; 0 on a broadcast axis) after the others.

// dq-bias: strides = [q, k, v, dO, dq, bias] x 3.
extern "C" int mmada_flash_attention_bwd_dq_bias_bf16(
    const void* q, const void* k, const void* v, const void* dout,
    const void* delta, const void* bias, void* dq, void* lse, int B, int H,
    int KVH, int Lq, int Lk, int D, const long long* strides, float scale,
    void* stream) {
  return dispatch_dq<true>(q, k, v, dout, delta, bias, dq, lse, B, H, KVH, Lq,
                           Lk, D, strides, scale, stream);
}

// dkv-bias: strides = [q, k, v, dO, dk, dv, bias] x 3.
extern "C" int mmada_flash_attention_bwd_dkv_bias_bf16(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* delta, const void* bias, void* dk, void* dv,
    int B, int H, int KVH, int Lq, int Lk, int D, const long long* strides,
    float scale, void* stream) {
  return dispatch_dkv<true, false>(q, k, v, dout, lse, delta, bias, dk, dv, B, H,
                                   KVH, Lq, Lk, D, strides, scale, stream);
}
