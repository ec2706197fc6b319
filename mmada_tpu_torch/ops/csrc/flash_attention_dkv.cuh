// The dk/dv kernel of bidirectional attention and what the backward kernels
// share, for Hopper (sm_90a): included by flash_attention_bwd.cu (the
// one-pass backward, B3) and flash_attention_long.cu (the staged backward,
// B5), which differ here only in how p and ds enter the tensor cores.
//
// attn_bwd_dkv_kernel replaces `_attn_bwd_dkv_kernel` (:753) and
// `_attn_bwd_dkv_bias_kernel` (:799) of mmada_tpu/ops/flash_attention.py,
// called at :963 (B3), and `_attn_bwd_dkv_staged_kernel` (:1070) and its
// `_bias` (:1110), called at :1240 (B5). All four compute, with q and k
// rotated, s = (q . k^T) * scale in fp32 (+ the fp32 bias (B|1, H|1, Lq, Lk),
// added as round(round(s * scale) + bias)) and lse / delta from the dq pass:
//
//   p = exp(s - lse); dv = p^T . dO; dp = dO . v^T; ds = p (dp - delta);
//   dk = (ds^T . q) * scale; summed over the query heads of the kv head
//
// One block per (64-row key tile, kv head, batch). Each warp keeps its 16
// key rows' dk and dv in fp32 registers and the block walks every (query
// head of the group, 32-row query tile) pair in one loop, so the GQA sum
// happens in registers: no atomics and no second pass. This is the TPU
// kernels' sequential group axis with fp32 outputs. It computes the
// transposed scores k . q^T directly, so p^T and ds^T come out in the
// accumulator layout the next products take as their A operand. Q, dO, lse
// and delta tiles stream in with cp.async, double-buffered. Rows past Lk are
// zero-filled on load and never stored; query columns past Lq get p = 0. The
// bias is read per accumulator fragment from global memory (its rows need not
// be 16-byte aligned), transposed (bias[query][key]), before the wait for
// the step's copy, so the loads overlap it and the products.
//
// Rounding. k.q^T and v.dO^T multiply bf16 inputs exactly and sum in fp32,
// as the TPU kernels' fp32 dots do. p^T and ds^T are fp32; SPLIT decides how
// they enter the tensor cores for p^T.dO and ds^T.q:
//  * false (B3): rounded to bf16, a relative error of at most 2^-9 per term,
//    the usual choice of flash-attention backward kernels;
//  * true (B5): as hi + lo, two bf16 products each (mma_pb), about 16
//    significant bits, so dk and dv stay within fp32-like error of the TPU
//    staged kernel's fp32 products before their bf16 rounding.
//
// Bound (on an H100 SXM: 989 TFLOP/s bf16 dense, 3.35 TB/s): 8*B*H*Lq*Lk*D
// flops against q + k + v + dO + dk + dv (+ lse, delta, bias) bytes; bound
// by bytes at the stage-1 training frame (L 387) by a small margin, by
// operations at longer L. With SPLIT the tensor cores do 12 of those 8 units
// (two products each for p^T.dO and ds^T.q).

#pragma once

#include <float.h>
#include <math.h>

#include "mma_sm90.cuh"

namespace {

constexpr int BLOCK = 64;   // query rows per dq block, key rows per dkv block
constexpr int DKV_QT = 32;  // query rows per step of the dkv loop
constexpr int NUM_THREADS = 128;
constexpr float NEG_F32 = -FLT_MAX;  // finite min: the running max's start
constexpr float EDGE = -INFINITY;    // key columns past Lk: p = exp(-inf) = 0

// Element strides (batch, head, row) of the operands, in call order.
struct Strides {
  long long s[21];
};

// round(s * scale) + bias, with no fused multiply-add (as the forward)
template <bool BIAS>
__device__ __forceinline__ float scaled(float s, float scale, float b) {
  return BIAS ? __fadd_rn(__fmul_rn(s, scale), b) : s * scale;
}

// The bias values of NB score fragments whose rows are brow[0] (row g) and
// brow[1] (row g + 8), keys from k0 (0 past Lk); loaded before the products
// they are added to, so the loads overlap them.
template <bool BIAS, int NB>
__device__ __forceinline__ void load_bias_rows(float bv[NB][4], const float* const brow[2],
                                               int k0, int Lk, int t) {
  if (!BIAS) return;
#pragma unroll
  for (int n = 0; n < NB; ++n)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = k0 + n * 8 + t * 2 + (j & 1);
      bv[n][j] = col < Lk ? __ldg(brow[j >> 1] + col) : 0.f;
    }
}

template <int D, bool BIAS, bool SPLIT>
__global__ void __launch_bounds__(NUM_THREADS)
attn_bwd_dkv_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                    const bf16* __restrict__ v, const bf16* __restrict__ dout,
                    const float* __restrict__ lse, const float* __restrict__ delta,
                    const float* __restrict__ bias, bf16* __restrict__ dk,
                    bf16* __restrict__ dv, int group, int H, int Lq, int Lk,
                    Strides st, float scale) {
  // strides: q 0-2, k 3-5, v 6-8, dO 9-11, dk 12-14, dv 15-17, bias 18-20
  constexpr int STRIDE = D + 8;
  constexpr int QTILE = DKV_QT * STRIDE;
  constexpr int NB = DKV_QT / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* ks = reinterpret_cast<bf16*>(smem_raw);
  bf16* vs = ks + BLOCK * STRIDE;
  bf16* qs = vs + BLOCK * STRIDE;  // two Q tiles
  bf16* dos = qs + 2 * QTILE;      // two dO tiles
  float* lses = reinterpret_cast<float*>(dos + 2 * QTILE);  // two x DKV_QT
  float* dels = lses + 2 * DKV_QT;                          // two x DKV_QT

  const int k0 = blockIdx.x * BLOCK;
  const int kvh = blockIdx.y, b = blockIdx.z;
  const int n_qt = (Lq + DKV_QT - 1) / DKV_QT;
  const int n_steps = group * n_qt;

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
  const bf16* kw = ks + warp * 16 * STRIDE;  // this warp's 16 key rows
  const bf16* vw = vs + warp * 16 * STRIDE;
  // this thread's two key columns of the bias; keys past Lk (never stored)
  // read key Lk - 1
  const int key[2] = {min(k0 + warp * 16 + g, Lk - 1), min(k0 + warp * 16 + g + 8, Lk - 1)};

  // step i: query head kvh * group + i / n_qt, query tile i % n_qt
  auto issue = [&](int step, int buf) {
    const int h = kvh * group + step / n_qt;
    const int row0 = (step % n_qt) * DKV_QT;
    load_rows_async<D, DKV_QT>(qs + buf * QTILE, q + b * st.s[0] + h * st.s[1],
                               st.s[2], row0, Lq);
    load_rows_async<D, DKV_QT>(dos + buf * QTILE, dout + b * st.s[9] + h * st.s[10],
                               st.s[11], row0, Lq);
    if (threadIdx.x < 2 * DKV_QT) {
      const int i = threadIdx.x % DKV_QT;
      const bool valid = row0 + i < Lq;
      const long long at = ((long long)b * H + h) * Lq + (valid ? row0 + i : 0);
      if (threadIdx.x < DKV_QT)
        cp_async4(lses + buf * DKV_QT + i, lse + at, valid);
      else
        cp_async4(dels + buf * DKV_QT + i, delta + at, valid);
    }
  };

  load_rows_async<D, BLOCK>(ks, k + b * st.s[3] + kvh * st.s[4], st.s[5], k0, Lk);
  load_rows_async<D, BLOCK>(vs, v + b * st.s[6] + kvh * st.s[7], st.s[8], k0, Lk);
  issue(0, 0);
  cp_async_commit();

  float acc_dk[D / 8][4], acc_dv[D / 8][4];
#pragma unroll
  for (int dn = 0; dn < D / 8; ++dn)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc_dk[dn][j] = acc_dv[dn][j] = 0.f;
  float s[NB][4], dp[NB][4];

  for (int step = 0; step < n_steps; ++step) {
    // this step's bias values, bias[query][key] for the k . q^T fragments
    // (query head kvh * group + step / n_qt, query rows from row0); loaded
    // before the wait so they overlap it and the products
    const int row0 = (step % n_qt) * DKV_QT;
    float bv[NB][4];
    if (BIAS) {
      const float* bstep = bias + b * st.s[18] + (kvh * group + step / n_qt) * st.s[19];
#pragma unroll
      for (int n = 0; n < NB; ++n)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int qrow = min(row0 + n * 8 + t * 2 + (j & 1), Lq - 1);
          bv[n][j] = __ldg(bstep + qrow * st.s[20] + key[j >> 1]);
        }
    }
    if (step + 1 < n_steps) {
      issue(step + 1, (step + 1) & 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const int buf = step & 1;
    const bf16* qt = qs + buf * QTILE;
    const bf16* dot = dos + buf * QTILE;
    const float* lt = lses + buf * DKV_QT;
    const float* dt = dels + buf * DKV_QT;

    // s^T (this warp's 16 keys x DKV_QT queries) -> p^T
    mma_abt<D, NB>(s, kw, qt, lane);
#pragma unroll
    for (int n = 0; n < NB; ++n)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = n * 8 + t * 2 + (j & 1);  // query within the tile
        const float sc = scaled<BIAS>(s[n][j], scale, bv[n][j]);
        s[n][j] = row0 + c < Lq ? expf(sc - lt[c]) : 0.f;  // :769
      }
    mma_pb<D, NB, SPLIT>(acc_dv, s, dot, lane);  // dv += p^T . dO
    mma_abt<D, NB>(dp, vw, dot, lane);           // dp^T = v . dO^T
#pragma unroll
    for (int n = 0; n < NB; ++n)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = n * 8 + t * 2 + (j & 1);
        s[n][j] = s[n][j] * (dp[n][j] - dt[c]);  // ds^T
      }
    mma_pb<D, NB, SPLIT>(acc_dk, s, qt, lane);   // dk += ds^T . q
    __syncthreads();  // every warp is done with this buffer before its refill
  }

  const int row_a = k0 + warp * 16 + g;
  const int row_b = row_a + 8;
  bf16* dkp = dk + b * st.s[12] + kvh * st.s[13];
  bf16* dvp = dv + b * st.s[15] + kvh * st.s[16];
#pragma unroll
  for (int dn = 0; dn < D / 8; ++dn) {
    const int col = dn * 8 + t * 2;
    if (row_a < Lk) {
      *reinterpret_cast<uint32_t*>(dkp + row_a * st.s[14] + col) =
          pack_bf16(acc_dk[dn][0] * scale, acc_dk[dn][1] * scale);
      *reinterpret_cast<uint32_t*>(dvp + row_a * st.s[17] + col) =
          pack_bf16(acc_dv[dn][0], acc_dv[dn][1]);
    }
    if (row_b < Lk) {
      *reinterpret_cast<uint32_t*>(dkp + row_b * st.s[14] + col) =
          pack_bf16(acc_dk[dn][2] * scale, acc_dk[dn][3] * scale);
      *reinterpret_cast<uint32_t*>(dvp + row_b * st.s[17] + col) =
          pack_bf16(acc_dv[dn][2], acc_dv[dn][3]);
    }
  }
}

Strides copy_strides(const long long* strides, int n) {
  Strides st;
  for (int i = 0; i < 21; ++i) st.s[i] = i < n ? strides[i] : 0;
  return st;
}

template <int D, bool BIAS, bool SPLIT>
cudaError_t launch_dkv(const void* q, const void* k, const void* v,
                       const void* dout, const void* lse, const void* delta,
                       const void* bias, void* dk, void* dv, int B, int H,
                       int KVH, int Lq, int Lk, const long long* strides,
                       float scale, cudaStream_t stream) {
  const size_t smem = (size_t)(2 * BLOCK + 4 * DKV_QT) * (D + 8) * sizeof(bf16) +
                      (size_t)4 * DKV_QT * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      attn_bwd_dkv_kernel<D, BIAS, SPLIT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((Lk + BLOCK - 1) / BLOCK, KVH, B);
  attn_bwd_dkv_kernel<D, BIAS, SPLIT><<<grid, NUM_THREADS, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const bf16*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<const float*>(bias), static_cast<bf16*>(dk),
      static_cast<bf16*>(dv), H / KVH, H, Lq, Lk,
      copy_strides(strides, BIAS ? 21 : 18), scale);
  return cudaGetLastError();
}

bool bad_shape(int B, int H, int KVH, int Lq, int Lk) {
  return B < 1 || H < 1 || KVH < 1 || H % KVH || Lq < 1 || Lk < 1;
}

template <bool BIAS, bool SPLIT>
int dispatch_dkv(const void* q, const void* k, const void* v, const void* dout,
                 const void* lse, const void* delta, const void* bias, void* dk,
                 void* dv, int B, int H, int KVH, int Lq, int Lk, int D,
                 const long long* strides, float scale, void* stream) {
  if (bad_shape(B, H, KVH, Lq, Lk) || (BIAS && bias == nullptr))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D == 128)
    return (int)launch_dkv<128, BIAS, SPLIT>(q, k, v, dout, lse, delta, bias, dk, dv,
                                             B, H, KVH, Lq, Lk, strides, scale, s);
  if (D == 64)
    return (int)launch_dkv<64, BIAS, SPLIT>(q, k, v, dout, lse, delta, bias, dk, dv, B,
                                            H, KVH, Lq, Lk, strides, scale, s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace
