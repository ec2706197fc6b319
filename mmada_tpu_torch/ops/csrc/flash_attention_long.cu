// Bidirectional attention past the one-pass range, for Hopper (sm_90a): the
// long-L forward (kernel B4) and the staged backward (kernels B5-dq and
// B5-dkv), each without a bias and with one.
//
// B4 replaces the four forward bodies of mmada_tpu/ops/flash_attention.py's
// long tiers, which compute one function: `_attn_online_kernel` (:224,
// called at :471) and `_attn_online_bias_kernel` (:259, :497) of
// `flash_attention_online`, `_attn_staged_kernel` (:291, :392) and
// `_attn_staged_bias_kernel` (:333, :418) of `flash_attention_staged`. The
// TPU splits them by VMEM (K/V whole in VMEM up to 8192 and unbiased, else
// streamed); here there is one kernel. B5-dq replaces
// `_attn_bwd_dq_staged_kernel` (:1018) and its `_bias` (:1062), called at
// :1185; B5-dkv, `_attn_bwd_dkv_staged_kernel` (:1070) and its `_bias`
// (:1110), called at :1240 (its kernel is in flash_attention_dkv.cuh, shared
// with B3). q and k arrive rotated (RoPE runs outside in fp32, as the TPU
// tier does), bf16 with element strides; Lq and Lk are multiples of 128, as
// the TPU tiers require. With s = (q . k^T) * scale in fp32 (+ the fp32 bias
// (B|1, H|1, Lq, Lk), added as round(round(s * scale) + bias)), walking the K
// tiles once with a running max m and sum l per query row:
//
//   B4:    m' = max(m, rowmax(s)); a = exp(m - m'); p = exp(s - m')
//          l = l a + rowsum(p); acc = acc a + p . v
//          out = bf16(acc / max(l, 1e-30))
//   B5-dq: the same carry with dp = dO . v^T, t = p (dp - delta) and
//          acc = acc a + t . k; dq = bf16(acc / max(l, 1e-30) * scale),
//          lse = m + log(max(l, 1e-30)) (fp32, (B, H, Lq))
//
// This is not the one-pass tier's function (B1, B3): p stays fp32 and
// unnormalised, and the division comes last. So the products whose left
// operand is fp32 (p . v, t . k, and in B5-dkv p^T . dO, ds^T . q) take it as
// hi + lo, two bf16 values (mma_pb with SPLIT): about 16 significant bits of
// p instead of the 8 a bf16 p would keep, where a bf16 p would compute a
// third function. q . k^T and dO . v^T multiply bf16 inputs exactly and sum in
// fp32; the scale multiplies the fp32 product (the TPU scales q first: the
// two differ by fp32 rounding).
//
// m starts at the finite fp32 min, not -inf, so a - m' never computes
// (-inf) - (-inf): a score of -inf gives p = 0, and a row whose every score
// is the finite min (a query row a mask shuts out entirely) gets p = 1 per
// key and averages v over its Lk keys, as the TPU tiers do on aligned L.
//
// Design, as B1 and B3: one block per (64-row query tile, head, batch), four
// warps of 16 rows, q (and dO) tiles in shared memory, K/V tiles of 64 keys
// double-buffered with cp.async so the next tile's copy overlaps this tile's
// products, fragments from ldmatrix, products from mma.sync m16n8k16 (bf16
// in, fp32 accumulate). GQA maps head h to kv head h / (H / KVH). The bias is
// read per accumulator fragment from global memory before the products it
// joins (its offsets in 64 bits: a (B, 1, 8192, 8192) bias passes 2^31
// elements at B = 32). B5-dq works on two 32-key halves of each tile, which
// keeps its carry, accumulators and fragments in registers but for a few
// (ptxas -v at D = 128: 48 bytes spilled, 104 with the bias).
//
// Bound (on an H100 SXM: 989 TFLOP/s bf16 dense, 3.35 TB/s): B4 needs
// 4*B*H*Lq*Lk*D flops and B5-dq 6, against a few bytes per row (q, k, v, o;
// dO, dq, delta, lse), so at L >= 4096 both are bound by operations. The
// split products make the tensor cores do 6 and 10 of those units; mma.sync
// without warp specialisation keeps them well short of the bound; wgmma, TMA
// and a cheaper split are the next steps.

#include "flash_attention_dkv.cuh"

namespace {

constexpr int ALIGN = 128;  // Lq, Lk multiples of this, as the TPU tiers

// One query row's online-softmax step over this thread's NB score fragments
// of row r (s[n][2r], s[n][2r + 1], already scaled): the new max over the
// quad's columns, p = exp(s - m') in place, the carry rescaled by a; returns
// a. l is this thread's partial row sum (the quad's partial sums are added
// at the end: a is the same on the four threads of a row).
template <int NB>
__device__ __forceinline__ float online_step(float s[NB][4], int r, float& m, float& l) {
  float mx = NEG_F32;
#pragma unroll
  for (int n = 0; n < NB; ++n) mx = fmaxf(mx, fmaxf(s[n][2 * r], s[n][2 * r + 1]));
  mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
  mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
  const float m_new = fmaxf(m, mx);
  const float a = expf(m - m_new);
  float sum = 0.f;
#pragma unroll
  for (int n = 0; n < NB; ++n) {
    s[n][2 * r] = expf(s[n][2 * r] - m_new);
    s[n][2 * r + 1] = expf(s[n][2 * r + 1] - m_new);
    sum += s[n][2 * r] + s[n][2 * r + 1];
  }
  l = l * a + sum;
  m = m_new;
  return a;
}

// The row sum of the quad's partial sums, at least 1e-30 (the TPU's guard).
__device__ __forceinline__ float row_sum(float l) {
  l += __shfl_xor_sync(0xffffffffu, l, 1);
  l += __shfl_xor_sync(0xffffffffu, l, 2);
  return fmaxf(l, 1e-30f);
}

template <int D>
__device__ __forceinline__ void rescale_rows(float acc[D / 8][4], const float a[2]) {
#pragma unroll
  for (int dn = 0; dn < D / 8; ++dn) {
    acc[dn][0] *= a[0];
    acc[dn][1] *= a[0];
    acc[dn][2] *= a[1];
    acc[dn][3] *= a[1];
  }
}

template <int D, bool BIAS>
__global__ void __launch_bounds__(NUM_THREADS)
attn_long_fwd_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                     const bf16* __restrict__ v, bf16* __restrict__ o,
                     const float* __restrict__ bias, int rep, int Lk, Strides st,
                     float scale) {
  // strides: q 0-2, k 3-5, v 6-8, o 9-11, bias 12-14
  constexpr int STRIDE = D + 8;
  constexpr int TILE = BLOCK * STRIDE;
  constexpr int NB = BLOCK / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* qs = reinterpret_cast<bf16*>(smem_raw);
  bf16* ks = qs + TILE;      // two K tiles
  bf16* vs = ks + 2 * TILE;  // two V tiles

  const int q0 = blockIdx.x * BLOCK;
  const int h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / rep;
  const bf16* kp = k + b * st.s[3] + kvh * st.s[4];
  const bf16* vp = v + b * st.s[6] + kvh * st.s[7];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
  const int n_tiles = Lk / BLOCK;
  const bf16* qw = qs + warp * 16 * STRIDE;  // this warp's 16 query rows
  const int row_a = q0 + warp * 16 + g;      // and row_a + 8; Lq is aligned
  const float* brow[2] = {nullptr, nullptr};
  if (BIAS) {
    const float* bp = bias + b * st.s[12] + h * st.s[13];
    brow[0] = bp + (long long)row_a * st.s[14];
    brow[1] = bp + (long long)(row_a + 8) * st.s[14];
  }

  // every row of the query tile exists: Lq is a multiple of BLOCK
  load_rows_async<D, BLOCK>(qs, q + b * st.s[0] + h * st.s[1], st.s[2], q0, q0 + BLOCK);
  load_rows_async<D, BLOCK>(ks, kp, st.s[5], 0, Lk);
  load_rows_async<D, BLOCK>(vs, vp, st.s[8], 0, Lk);
  cp_async_commit();

  float acc[D / 8][4];
#pragma unroll
  for (int dn = 0; dn < D / 8; ++dn) acc[dn][0] = acc[dn][1] = acc[dn][2] = acc[dn][3] = 0.f;
  float m[2] = {NEG_F32, NEG_F32};
  float l[2] = {0.f, 0.f};
  float s[NB][4], bv[NB][4];
  for (int tile = 0; tile < n_tiles; ++tile) {
    load_bias_rows<BIAS, NB>(bv, brow, tile * BLOCK, Lk, t);
    if (tile + 1 < n_tiles) {
      const int next = (tile + 1) & 1;
      load_rows_async<D, BLOCK>(ks + next * TILE, kp, st.s[5], (tile + 1) * BLOCK, Lk);
      load_rows_async<D, BLOCK>(vs + next * TILE, vp, st.s[8], (tile + 1) * BLOCK, Lk);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // this tile's copy is visible to every warp
    mma_abt<D, NB>(s, qw, ks + (tile & 1) * TILE, lane);
#pragma unroll
    for (int n = 0; n < NB; ++n)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[n][j] = scaled<BIAS>(s[n][j], scale, bv[n][j]);
    const float a[2] = {online_step<NB>(s, 0, m[0], l[0]), online_step<NB>(s, 1, m[1], l[1])};
    rescale_rows<D>(acc, a);
    mma_pb<D, NB, true>(acc, s, vs + (tile & 1) * TILE, lane);  // acc += p . v
    __syncthreads();  // every warp is done with this buffer before its refill
  }

  const float lsum[2] = {row_sum(l[0]), row_sum(l[1])};
  bf16* op = o + b * st.s[9] + h * st.s[10];
#pragma unroll
  for (int dn = 0; dn < D / 8; ++dn) {
    const int col = dn * 8 + t * 2;
    *reinterpret_cast<uint32_t*>(op + row_a * st.s[11] + col) =
        pack_bf16(acc[dn][0] / lsum[0], acc[dn][1] / lsum[0]);
    *reinterpret_cast<uint32_t*>(op + (row_a + 8) * st.s[11] + col) =
        pack_bf16(acc[dn][2] / lsum[1], acc[dn][3] / lsum[1]);
  }
}

template <int D, bool BIAS>
__global__ void __launch_bounds__(NUM_THREADS)
attn_long_bwd_dq_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                        const bf16* __restrict__ v, const bf16* __restrict__ dout,
                        const float* __restrict__ delta, const float* __restrict__ bias,
                        bf16* __restrict__ dq, float* __restrict__ lse, int rep, int H,
                        int Lq, int Lk, Strides st, float scale) {
  // strides: q 0-2, k 3-5, v 6-8, dO 9-11, dq 12-14, bias 15-17
  constexpr int STRIDE = D + 8;
  constexpr int TILE = BLOCK * STRIDE;
  constexpr int HALF = BLOCK / 2;
  constexpr int NH = HALF / 8;  // score fragments of a half tile
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* qs = reinterpret_cast<bf16*>(smem_raw);
  bf16* dos = qs + TILE;
  bf16* ks = dos + TILE;     // two K tiles
  bf16* vs = ks + 2 * TILE;  // two V tiles

  const int q0 = blockIdx.x * BLOCK;
  const int h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / rep;
  const bf16* kp = k + b * st.s[3] + kvh * st.s[4];
  const bf16* vp = v + b * st.s[6] + kvh * st.s[7];
  const long long stat0 = ((long long)b * H + h) * Lq;  // delta / lse rows
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
  const int n_tiles = Lk / BLOCK;
  const bf16* qw = qs + warp * 16 * STRIDE;  // this warp's 16 query rows
  const bf16* dow = dos + warp * 16 * STRIDE;
  const int row_a = q0 + warp * 16 + g;      // and row_a + 8; Lq is aligned
  const float* brow[2] = {nullptr, nullptr};
  if (BIAS) {
    const float* bp = bias + b * st.s[15] + h * st.s[16];
    brow[0] = bp + (long long)row_a * st.s[17];
    brow[1] = bp + (long long)(row_a + 8) * st.s[17];
  }

  load_rows_async<D, BLOCK>(qs, q + b * st.s[0] + h * st.s[1], st.s[2], q0, Lq);
  load_rows_async<D, BLOCK>(dos, dout + b * st.s[9] + h * st.s[10], st.s[11], q0, Lq);
  load_rows_async<D, BLOCK>(ks, kp, st.s[5], 0, Lk);
  load_rows_async<D, BLOCK>(vs, vp, st.s[8], 0, Lk);
  cp_async_commit();

  const float delta_r[2] = {delta[stat0 + row_a], delta[stat0 + row_a + 8]};
  float acc[D / 8][4];
#pragma unroll
  for (int dn = 0; dn < D / 8; ++dn) acc[dn][0] = acc[dn][1] = acc[dn][2] = acc[dn][3] = 0.f;
  float m[2] = {NEG_F32, NEG_F32};
  float l[2] = {0.f, 0.f};
  float s[NH][4], dp[NH][4], bv[NH][4];
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
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int k0 = tile * BLOCK + half * HALF;
      const bf16* kt = ks + (tile & 1) * TILE + half * HALF * STRIDE;
      load_bias_rows<BIAS, NH>(bv, brow, k0, Lk, t);
      mma_abt<D, NH>(s, qw, kt, lane);
      mma_abt<D, NH>(dp, dow, vs + (tile & 1) * TILE + half * HALF * STRIDE, lane);
#pragma unroll
      for (int n = 0; n < NH; ++n)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[n][j] = scaled<BIAS>(s[n][j], scale, bv[n][j]);
      const float a[2] = {online_step<NH>(s, 0, m[0], l[0]), online_step<NH>(s, 1, m[1], l[1])};
      rescale_rows<D>(acc, a);
#pragma unroll
      for (int n = 0; n < NH; ++n)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[n][j] *= dp[n][j] - delta_r[j >> 1];  // t
      mma_pb<D, NH, true>(acc, s, kt, lane);  // acc += t . k
    }
    __syncthreads();  // every warp is done with this buffer before its refill
  }

  const float lsum[2] = {row_sum(l[0]), row_sum(l[1])};
  bf16* dqp = dq + b * st.s[12] + h * st.s[13];
#pragma unroll
  for (int dn = 0; dn < D / 8; ++dn) {
    const int col = dn * 8 + t * 2;
    *reinterpret_cast<uint32_t*>(dqp + row_a * st.s[14] + col) =
        pack_bf16(acc[dn][0] / lsum[0] * scale, acc[dn][1] / lsum[0] * scale);
    *reinterpret_cast<uint32_t*>(dqp + (row_a + 8) * st.s[14] + col) =
        pack_bf16(acc[dn][2] / lsum[1] * scale, acc[dn][3] / lsum[1] * scale);
  }
  if (t == 0) {
    lse[stat0 + row_a] = m[0] + logf(lsum[0]);
    lse[stat0 + row_a + 8] = m[1] + logf(lsum[1]);
  }
}

template <int D, bool BIAS>
cudaError_t launch_fwd(const void* q, const void* k, const void* v, void* o,
                       const void* bias, int B, int H, int KVH, int Lq, int Lk,
                       const long long* strides, float scale, cudaStream_t stream) {
  const size_t smem = (size_t)5 * BLOCK * (D + 8) * sizeof(bf16);
  cudaError_t err = cudaFuncSetAttribute(
      attn_long_fwd_kernel<D, BIAS>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(Lq / BLOCK, H, B);
  attn_long_fwd_kernel<D, BIAS><<<grid, NUM_THREADS, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<bf16*>(o),
      static_cast<const float*>(bias), H / KVH, Lk,
      copy_strides(strides, BIAS ? 15 : 12), scale);
  return cudaGetLastError();
}

template <int D, bool BIAS>
cudaError_t launch_dq(const void* q, const void* k, const void* v,
                      const void* dout, const void* delta, const void* bias,
                      void* dq, void* lse, int B, int H, int KVH, int Lq, int Lk,
                      const long long* strides, float scale, cudaStream_t stream) {
  const size_t smem = (size_t)6 * BLOCK * (D + 8) * sizeof(bf16);
  cudaError_t err = cudaFuncSetAttribute(
      attn_long_bwd_dq_kernel<D, BIAS>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(Lq / BLOCK, H, B);
  attn_long_bwd_dq_kernel<D, BIAS><<<grid, NUM_THREADS, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const bf16*>(dout),
      static_cast<const float*>(delta), static_cast<const float*>(bias),
      static_cast<bf16*>(dq), static_cast<float*>(lse), H / KVH, H, Lq, Lk,
      copy_strides(strides, BIAS ? 18 : 15), scale);
  return cudaGetLastError();
}

bool bad_long_shape(int B, int H, int KVH, int Lq, int Lk, int D, bool bias,
                    const void* bias_ptr) {
  return bad_shape(B, H, KVH, Lq, Lk) || Lq % ALIGN || Lk % ALIGN ||
         (D != 64 && D != 128) || (bias && bias_ptr == nullptr);
}

template <bool BIAS>
int dispatch_fwd(const void* q, const void* k, const void* v, void* o,
                 const void* bias, int B, int H, int KVH, int Lq, int Lk, int D,
                 const long long* strides, float scale, void* stream) {
  if (bad_long_shape(B, H, KVH, Lq, Lk, D, BIAS, bias)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return D == 128 ? (int)launch_fwd<128, BIAS>(q, k, v, o, bias, B, H, KVH, Lq, Lk,
                                               strides, scale, s)
                  : (int)launch_fwd<64, BIAS>(q, k, v, o, bias, B, H, KVH, Lq, Lk,
                                              strides, scale, s);
}

template <bool BIAS>
int dispatch_dq(const void* q, const void* k, const void* v, const void* dout,
                const void* delta, const void* bias, void* dq, void* lse, int B,
                int H, int KVH, int Lq, int Lk, int D, const long long* strides,
                float scale, void* stream) {
  if (bad_long_shape(B, H, KVH, Lq, Lk, D, BIAS, bias)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return D == 128 ? (int)launch_dq<128, BIAS>(q, k, v, dout, delta, bias, dq, lse, B, H,
                                              KVH, Lq, Lk, strides, scale, s)
                  : (int)launch_dq<64, BIAS>(q, k, v, dout, delta, bias, dq, lse, B, H,
                                             KVH, Lq, Lk, strides, scale, s);
}

template <bool BIAS>
int dispatch_long_dkv(const void* q, const void* k, const void* v, const void* dout,
                      const void* lse, const void* delta, const void* bias, void* dk,
                      void* dv, int B, int H, int KVH, int Lq, int Lk, int D,
                      const long long* strides, float scale, void* stream) {
  if (bad_long_shape(B, H, KVH, Lq, Lk, D, BIAS, bias)) return (int)cudaErrorInvalidValue;
  return dispatch_dkv<BIAS, true>(q, k, v, dout, lse, delta, bias, dk, dv, B, H, KVH,
                                  Lq, Lk, D, strides, scale, stream);
}

}  // namespace

// C entries, bound with ctypes, with the signatures of the one-pass tier's
// (flash_attention_fwd.cu without the rope arguments, flash_attention_bwd.cu
// as they are): q, dO (B, H, Lq, D) and k, v (B, KVH, Lk, D) bf16, last dim
// contiguous, rows 16-byte aligned, Lq and Lk multiples of 128, D 64 or 128;
// `strides` holds the element strides (batch, head, row) of each operand in
// argument order, the bias's last (0 on a broadcast axis). delta and lse:
// contiguous fp32 (B, H, Lq). The bias: fp32 (B|1, H|1, Lq, Lk), last dim
// contiguous. Each returns a cudaError_t; 0 is success.

// B4: o (B, H, Lq, D) bf16; strides = [q, k, v, o] x 3.
extern "C" int mmada_flash_attention_long_fwd_bf16(
    const void* q, const void* k, const void* v, void* o, int B, int H, int KVH,
    int Lq, int Lk, int D, const long long* strides, float scale, void* stream) {
  return dispatch_fwd<false>(q, k, v, o, nullptr, B, H, KVH, Lq, Lk, D, strides,
                             scale, stream);
}

// B4-bias: strides = [q, k, v, o, bias] x 3.
extern "C" int mmada_flash_attention_long_fwd_bias_bf16(
    const void* q, const void* k, const void* v, void* o, const void* bias, int B,
    int H, int KVH, int Lq, int Lk, int D, const long long* strides, float scale,
    void* stream) {
  return dispatch_fwd<true>(q, k, v, o, bias, B, H, KVH, Lq, Lk, D, strides, scale,
                            stream);
}

// B5-dq: dq (B, H, Lq, D) bf16 and lse; strides = [q, k, v, dO, dq] x 3.
extern "C" int mmada_flash_attention_long_bwd_dq_bf16(
    const void* q, const void* k, const void* v, const void* dout,
    const void* delta, void* dq, void* lse, int B, int H, int KVH, int Lq,
    int Lk, int D, const long long* strides, float scale, void* stream) {
  return dispatch_dq<false>(q, k, v, dout, delta, nullptr, dq, lse, B, H, KVH, Lq,
                            Lk, D, strides, scale, stream);
}

// B5-dq-bias: strides = [q, k, v, dO, dq, bias] x 3.
extern "C" int mmada_flash_attention_long_bwd_dq_bias_bf16(
    const void* q, const void* k, const void* v, const void* dout,
    const void* delta, const void* bias, void* dq, void* lse, int B, int H,
    int KVH, int Lq, int Lk, int D, const long long* strides, float scale,
    void* stream) {
  return dispatch_dq<true>(q, k, v, dout, delta, bias, dq, lse, B, H, KVH, Lq, Lk, D,
                           strides, scale, stream);
}

// B5-dkv: dk, dv (B, KVH, Lk, D) bf16; strides = [q, k, v, dO, dk, dv] x 3.
extern "C" int mmada_flash_attention_long_bwd_dkv_bf16(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* delta, void* dk, void* dv, int B, int H,
    int KVH, int Lq, int Lk, int D, const long long* strides, float scale,
    void* stream) {
  return dispatch_long_dkv<false>(q, k, v, dout, lse, delta, nullptr, dk, dv, B, H,
                                  KVH, Lq, Lk, D, strides, scale, stream);
}

// B5-dkv-bias: strides = [q, k, v, dO, dk, dv, bias] x 3.
extern "C" int mmada_flash_attention_long_bwd_dkv_bias_bf16(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* delta, const void* bias, void* dk, void* dv,
    int B, int H, int KVH, int Lq, int Lk, int D, const long long* strides,
    float scale, void* stream) {
  return dispatch_long_dkv<true>(q, k, v, dout, lse, delta, bias, dk, dv, B, H, KVH,
                                 Lq, Lk, D, strides, scale, stream);
}
