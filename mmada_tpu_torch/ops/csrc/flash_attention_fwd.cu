// One-pass bidirectional attention with neox RoPE, for Hopper (sm_90a),
// without a bias (kernel B1) and with one (kernel B2).
//
// B1 replaces the TPU kernel `flash_attention` -> `_attn_kernel` /
// `_attn_rope_kernel` in mmada_tpu/ops/flash_attention.py (:59-92, called at
// :650); B2 replaces `_attn_bias_kernel` / `_attn_rope_bias_kernel` (:148,
// :172, called at :686). They compute, per (batch, head):
//
//   q, k  <- RoPE(q, k) in fp32 (rotate-half), cast back to bf16
//   s     =  (q . k^T accumulated in fp32) * scale  [+ bias, fp32, B2]
//   p     =  exp(s - rowmax(s)) / rowsum(...)     in fp32, BEFORE the cast
//   out   =  bf16( bf16(p) . v accumulated in fp32 )
//
// Key columns >= Lk take no part: their score is -inf, so p = 0 there. (The
// TPU kernel pads K to the 128 tile and gives the padded columns the finite
// fp32 min; on a row whose every real score is the finite min, as a query
// row that a mask shuts out entirely, that averages v over the padded tile.
// Here such a row averages v over its Lk real keys, which is what the XLA
// tier computes. Rows with an allowed key get the same p either way.)
//
// Normalising p before its bf16 cast is the point of the design: an online
// softmax that divides at the end is another function in bf16 (about half the
// outputs differ). So each query tile walks K twice: pass 1 finds the row max
// and row sum, pass 2 recomputes the scores, forms the normalised p, casts it
// to bf16 and accumulates p . v. The tensor cores therefore do 6 B H Lq Lk D
// flops where the function's bound counts 4: B1 can reach at most 2/3 of it.
//
// rope_kernel rotates q and k once into contiguous bf16 scratch, which TMA
// then reads (the TPU kernel fuses the rotation into its tile loads because
// it reads K once per query tile; here every query tile reads K twice).
//
// B1 (attn_fwd_wgmma_kernel) is the attention skeleton of hopper_sm90.cuh:
// one block per (128-row query tile, head, batch), pairs of blocks in a
// cluster sharing each K/V tile by TMA multicast, a TMA producer warpgroup
// and two consumer warpgroups of 64 rows that issue their wgmma products in
// turns, K/V tiles of 128 keys in a ring of three slots, q . k^T and p . v
// on wgmma (p from registers), the output stored by TMA. Pass 1 streams K
// alone. Pass 2 is pipelined by one tile: a turn issues p_{j-1} . V_{j-1}
// and q . K_j^T together, and p_j is formed while the other warpgroup's
// products run. The fp32 work per score is one FFMA and one ex2 per pass
// (exp through exp2 of the score pre-scaled by log2 e: p moves by a few fp32
// ulps), and in pass 2 the division as a multiply by the row's correctly
// rounded reciprocal plus one FMA correction step, q1 = q0 + r (e - q0 l):
// no SFU division, no slow path. GQA maps head h to kv head h
// / (H / KVH) in the tensor maps' coordinates; TMA zero-fills rows past Lq
// and Lk, and the store drops rows past Lq.
//
// B2 (attn_fwd_bias_kernel) keeps the earlier design: one block per (64-row
// query tile, head, batch), four warps of 16 query rows, K/V tiles of 64
// keys double-buffered with cp.async, fragments from ldmatrix, products from
// mma.sync m16n8k16. The bias is (B|1, H|1, Lq, Lk) fp32 with its own element
// strides, 0 on a broadcast axis; it is added as round(round(s * scale) +
// bias), with no fused multiply-add. Each thread reads the bias values of
// its accumulator fragments straight from global memory (two rows, 2
// columns of each 8-key slice), for a tile before the wait for its K copy,
// so the loads overlap the barrier and the products: the rows of a mask
// bias of odd Lk are not 16-byte aligned, which rules out cp.async vectors
// without a padded copy, and a (B, 1, L, L) mask bias is read by all H heads
// of a batch row, so after the first head it comes from L2.
//
// Bound: 4*B*H*Lq*Lk*D flops against q + k + v + o bytes (+ the fp32 rope
// tables, + the bias). At the serving shapes (L ~ 1.2k, D = 128) the flops
// dominate: the kernels are compute-bound.

#include <float.h>
#include <math.h>

#include "hopper_sm90.cuh"

namespace {

constexpr int BLOCK_Q = 64;
constexpr int BLOCK_K = 64;
constexpr int NUM_WARPS = BLOCK_Q / 16;
constexpr int NUM_THREADS = NUM_WARPS * 32;
constexpr int ROPE_THREADS = 256;
constexpr int STAGES = 3;            // B1's K/V ring
constexpr float NEG_F32 = -FLT_MAX;  // finite min: the running max's start
constexpr float EDGE = -INFINITY;    // key columns past Lk: p = exp(-inf) = 0
constexpr float LOG2E = 1.4426950408889634f;

// RoPE of every row of x (B, H, L, D; element strides sb, sh, sl) into the
// contiguous out (B, H, L, D): out = x * cos + rotate_half(x) * sin in fp32,
// rotate_half(x) = [-x2, x1], rounded to bf16 as `_rope_tile` does. A thread
// takes 8 columns c.. of the first half and the 8 columns c + D/2.. they pair
// with. Plain multiplies and adds (no fused multiply-add) keep the rounding
// of the unfused reference.
template <int D>
__global__ void __launch_bounds__(ROPE_THREADS)
rope_kernel(const bf16* __restrict__ x, bf16* __restrict__ out,
            const float* __restrict__ sin_t, const float* __restrict__ cos_t,
            long long n_chunks, int H, int L, long long sb, long long sh,
            long long sl) {
  constexpr int HALF = D / 2;
  constexpr int CHUNKS = HALF / 8;  // 8-column chunks per half row
  const long long i = (long long)blockIdx.x * ROPE_THREADS + threadIdx.x;
  if (i >= n_chunks) return;
  const long long row = i / CHUNKS;
  const int c = (int)(i % CHUNKS) * 8;
  const int pos = (int)(row % L);
  const long long bh = row / L;
  const bf16* src = x + (bh / H) * sb + (bh % H) * sh + pos * sl;
  const uint4 x1v = *reinterpret_cast<const uint4*>(src + c);
  const uint4 x2v = *reinterpret_cast<const uint4*>(src + c + HALF);
  const float4* sn = reinterpret_cast<const float4*>(sin_t + (long long)pos * D + c);
  const float4* cs = reinterpret_cast<const float4*>(cos_t + (long long)pos * D + c);
  // [0, 8): columns c.., [8, 16): columns c + D/2..
  const float4 s4[4] = {sn[0], sn[1], sn[HALF / 4], sn[HALF / 4 + 1]};
  const float4 c4[4] = {cs[0], cs[1], cs[HALF / 4], cs[HALF / 4 + 1]};
  const float* sv = reinterpret_cast<const float*>(s4);
  const float* cv = reinterpret_cast<const float*>(c4);
  const bf16* x1 = reinterpret_cast<const bf16*>(&x1v);
  const bf16* x2 = reinterpret_cast<const bf16*>(&x2v);
  uint4 lo, hi;
  bf16* out_lo = reinterpret_cast<bf16*>(&lo);
  bf16* out_hi = reinterpret_cast<bf16*>(&hi);
#pragma unroll
  for (int e = 0; e < 8; ++e) {
    const float a = __bfloat162float(x1[e]), b = __bfloat162float(x2[e]);
    out_lo[e] = __float2bfloat16_rn(
        __fadd_rn(__fmul_rn(a, cv[e]), __fmul_rn(-b, sv[e])));
    out_hi[e] = __float2bfloat16_rn(
        __fadd_rn(__fmul_rn(b, cv[8 + e]), __fmul_rn(a, sv[8 + e])));
  }
  bf16* dst = out + row * D + c;
  *reinterpret_cast<uint4*>(dst) = lo;
  *reinterpret_cast<uint4*>(dst + HALF) = hi;
}

// This thread's bias values for the tile of keys from k0, in the score
// fragments' layout (bv[n][0..1] from row bias_a, bv[n][2..3] from bias_b);
// 0 past Lk. Issued before the tile's copy is waited for, so the loads
// overlap the barrier and the products.
__device__ __forceinline__ void load_bias(float bv[BLOCK_K / 8][4],
                                          const float* bias_a,
                                          const float* bias_b, int k0, int Lk,
                                          int t) {
#pragma unroll
  for (int n = 0; n < BLOCK_K / 8; ++n)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = k0 + n * 8 + t * 2 + (j & 1);
      bv[n][j] = col < Lk ? __ldg(((j & 2) ? bias_b : bias_a) + col) : 0.f;
    }
}

// Scores of this warp's 16 query rows against the 64 keys in `ks`:
// s[n][0..1] -> row g, keys n*8 + 2t + {0,1}; s[n][2..3] -> row g + 8.
// Scaled, plus the bias values bv (load_bias), and masked past Lk.
// The d loop is outermost so that consecutive products go to different
// accumulators; each accumulator still sums its d slices in order.
template <int D>
__device__ __forceinline__ void tile_scores(float s[BLOCK_K / 8][4],
                                            const uint32_t qa[D / 16][4],
                                            const bf16* ks, int k0, int Lk,
                                            float scale, int lane,
                                            const float bv[BLOCK_K / 8][4]) {
  constexpr int STRIDE = D + 8;
  const int t = lane & 3;
#pragma unroll
  for (int n = 0; n < BLOCK_K / 8; ++n)
    s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
  // lane's row for ldmatrix: key n*8 + lane%8, d columns (lane/8)*8 of 32
  const bf16* krow = ks + (lane & 7) * STRIDE + (lane >> 3) * 8;
#pragma unroll
  for (int kk = 0; kk < D / 16; kk += 2) {
    uint32_t b[BLOCK_K / 8][4];  // B fragments of d slices kk and kk + 1
#pragma unroll
    for (int n = 0; n < BLOCK_K / 8; ++n)
      ldmatrix_x4<false>(b[n], krow + n * 8 * STRIDE + kk * 16);
#pragma unroll
    for (int n = 0; n < BLOCK_K / 8; ++n) mma_bf16(s[n], qa[kk], b[n][0], b[n][1]);
#pragma unroll
    for (int n = 0; n < BLOCK_K / 8; ++n)
      mma_bf16(s[n], qa[kk + 1], b[n][2], b[n][3]);
  }
#pragma unroll
  for (int n = 0; n < BLOCK_K / 8; ++n) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = k0 + n * 8 + t * 2 + (j & 1);
      s[n][j] = col < Lk ? __fadd_rn(__fmul_rn(s[n][j], scale), bv[n][j]) : EDGE;
    }
  }
}

template <int D>
__global__ void __launch_bounds__(NUM_THREADS)
attn_fwd_bias_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                const bf16* __restrict__ v, bf16* __restrict__ o,
                const float* __restrict__ bias, int rep,
                int Lq, int Lk, long long q_sb, long long q_sh, long long q_sl,
                long long k_sb, long long k_sh, long long k_sl,
                long long v_sb, long long v_sh, long long v_sl,
                long long o_sb, long long o_sh, long long o_sl,
                long long b_sb, long long b_sh, long long b_sl, float scale) {
  constexpr int STRIDE = D + 8;
  constexpr int TILE = BLOCK_K * STRIDE;  // elements of one K or V tile
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* qs = reinterpret_cast<bf16*>(smem_raw);
  bf16* ks = qs + BLOCK_Q * STRIDE;  // two K tiles
  bf16* vs = ks + 2 * TILE;          // two V tiles

  const int q0 = blockIdx.x * BLOCK_Q;
  const int h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / rep;
  const bf16* qp = q + b * q_sb + h * q_sh;
  const bf16* kp = k + b * k_sb + kvh * k_sh;
  const bf16* vp = v + b * v_sb + kvh * v_sh;
  bf16* op = o + b * o_sb + h * o_sh;

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
  const int n_tiles = (Lk + BLOCK_K - 1) / BLOCK_K;
  const int row_a = q0 + warp * 16 + g;
  const int row_b = row_a + 8;
  // this thread's two bias rows; rows past Lq (never stored) read row Lq - 1
  const float* bp = bias + b * b_sb + h * b_sh;
  const float* bias_a = bp + (long long)min(row_a, Lq - 1) * b_sl;
  const float* bias_b = bp + (long long)min(row_b, Lq - 1) * b_sl;

  load_rows_async<D, BLOCK_Q>(qs, qp, q_sl, q0, Lq);
  load_rows_async<D, BLOCK_K>(ks, kp, k_sl, 0, Lk);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();

  // this warp's 16 query rows as mma A fragments, one per 16-wide d slice
  uint32_t qa[D / 16][4];
  {
    const bf16* qw = qs + warp * 16 * STRIDE;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const int c = kk * 16 + t * 2;
      qa[kk][0] = *reinterpret_cast<const uint32_t*>(qw + g * STRIDE + c);
      qa[kk][1] = *reinterpret_cast<const uint32_t*>(qw + (g + 8) * STRIDE + c);
      qa[kk][2] = *reinterpret_cast<const uint32_t*>(qw + g * STRIDE + c + 8);
      qa[kk][3] =
          *reinterpret_cast<const uint32_t*>(qw + (g + 8) * STRIDE + c + 8);
    }
  }

  float s[BLOCK_K / 8][4];

  // pass 1: row max and row sum (rows g and g + 8 of this warp). Tile 0 is
  // in the first K buffer; each step starts copying the next tile into the
  // other one.
  float m[2] = {NEG_F32, NEG_F32};
  float l[2] = {0.f, 0.f};
  float bv[BLOCK_K / 8][4];
  for (int tile = 0; tile < n_tiles; ++tile) {
    load_bias(bv, bias_a, bias_b, tile * BLOCK_K, Lk, t);
    if (tile + 1 < n_tiles) {
      load_rows_async<D, BLOCK_K>(ks + ((tile + 1) & 1) * TILE, kp, k_sl,
                                  (tile + 1) * BLOCK_K, Lk);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // this tile's copy is visible to every warp
    tile_scores<D>(s, qa, ks + (tile & 1) * TILE, tile * BLOCK_K, Lk,
                         scale, lane, bv);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float mx = NEG_F32;
#pragma unroll
      for (int n = 0; n < BLOCK_K / 8; ++n)
        mx = fmaxf(mx, fmaxf(s[n][2 * r], s[n][2 * r + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m[r], mx);
      float sum = 0.f;
#pragma unroll
      for (int n = 0; n < BLOCK_K / 8; ++n)
        sum += expf(s[n][2 * r] - m_new) + expf(s[n][2 * r + 1] - m_new);
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      l[r] = l[r] * expf(m[r] - m_new) + sum;
      m[r] = m_new;
    }
    __syncthreads();  // every warp is done with this buffer before its refill
  }

  // pass 2: p = exp(s - m) / l in fp32, cast to bf16, accumulate p . v
  float acc[D / 8][4];
#pragma unroll
  for (int dn = 0; dn < D / 8; ++dn)
    acc[dn][0] = acc[dn][1] = acc[dn][2] = acc[dn][3] = 0.f;

  load_rows_async<D, BLOCK_K>(ks, kp, k_sl, 0, Lk);
  load_rows_async<D, BLOCK_K>(vs, vp, v_sl, 0, Lk);
  cp_async_commit();
  for (int tile = 0; tile < n_tiles; ++tile) {
    load_bias(bv, bias_a, bias_b, tile * BLOCK_K, Lk, t);
    if (tile + 1 < n_tiles) {
      const int next = (tile + 1) & 1;
      load_rows_async<D, BLOCK_K>(ks + next * TILE, kp, k_sl, (tile + 1) * BLOCK_K, Lk);
      load_rows_async<D, BLOCK_K>(vs + next * TILE, vp, v_sl, (tile + 1) * BLOCK_K, Lk);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    tile_scores<D>(s, qa, ks + (tile & 1) * TILE, tile * BLOCK_K, Lk,
                         scale, lane, bv);
    const bf16* vt = vs + (tile & 1) * TILE;
#pragma unroll
    for (int kb = 0; kb < BLOCK_K / 16; ++kb) {
      // the two 16x8 score fragments of keys [16 kb, 16 kb + 16) form the
      // 16x16 A fragment of p
      uint32_t pa[4];
      const float* s0 = s[2 * kb];
      const float* s1 = s[2 * kb + 1];
      pa[0] = pack_bf16(expf(s0[0] - m[0]) / l[0], expf(s0[1] - m[0]) / l[0]);
      pa[1] = pack_bf16(expf(s0[2] - m[1]) / l[1], expf(s0[3] - m[1]) / l[1]);
      pa[2] = pack_bf16(expf(s1[0] - m[0]) / l[0], expf(s1[1] - m[0]) / l[0]);
      pa[3] = pack_bf16(expf(s1[2] - m[1]) / l[1], expf(s1[3] - m[1]) / l[1]);
      // ldmatrix.trans rows: key kb*16 + lane%16, d columns (lane/16)*8
      const bf16* vrow = vt + (kb * 16 + (lane & 15)) * STRIDE + (lane >> 4) * 8;
#pragma unroll
      for (int dn = 0; dn < D / 8; dn += 2) {
        uint32_t vf[4];  // B fragments of d columns dn*8.. and (dn+1)*8..
        ldmatrix_x4<true>(vf, vrow + dn * 8);
        mma_bf16(acc[dn], pa, vf[0], vf[1]);
        mma_bf16(acc[dn + 1], pa, vf[2], vf[3]);
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int dn = 0; dn < D / 8; ++dn) {
    const int col = dn * 8 + t * 2;
    if (row_a < Lq)
      *reinterpret_cast<uint32_t*>(op + row_a * o_sl + col) =
          pack_bf16(acc[dn][0], acc[dn][1]);
    if (row_b < Lq)
      *reinterpret_cast<uint32_t*>(op + row_b * o_sl + col) =
          pack_bf16(acc[dn][2], acc[dn][3]);
  }
}


// B1's probabilities of one tile, as register-A fragments: p = exp(s - m) / l
// in fp32 (exp through exp2 of the log2-scaled score, the division as a
// multiply by the row's correctly rounded reciprocal `inv` and one FMA
// correction step), then cast to bf16. Keys past Lk get p = 0.
__device__ __forceinline__ void normalised_probs(uint32_t (&p)[8][4], float (&s)[64], int key0,
                                                 int Lk, int tq, float c, const float m[2],
                                                 const float l[2], const float inv[2]) {
  mask_keys(s, key0, Lk, tq);
#pragma unroll
  for (int kb = 0; kb < 8; ++kb)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = e & 1;
      float x[2];
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const float ex = exp2f(fmaf(s[8 * kb + 2 * e + u], c, -m[r]));
        const float y = ex * inv[r];
        x[u] = fmaf(inv[r], fmaf(-y, l[r], ex), y);
      }
      p[kb][e] = pack_bf16(x[0], x[1]);
    }
}

// Kernel B1. q_rows: this consumer warpgroup's 64 rows of the Q tile.
template <int D>
__global__ void __cluster_dims__(ATT_PAIR, 1, 1) __launch_bounds__(ATT_THREADS, 1)
attn_fwd_wgmma_kernel(const __grid_constant__ CUtensorMap tm_q,
                      const __grid_constant__ CUtensorMap tm_k,
                      const __grid_constant__ CUtensorMap tm_v,
                      const __grid_constant__ CUtensorMap tm_o, int rep, int Lq, int Lk,
                      float scale_log2) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const AttnSmem<D, STAGES> sm(smem_raw);
  const int q0 = blockIdx.x * ATT_M, h = blockIdx.y, b = blockIdx.z;
  const int n_tiles = (Lk + ATT_N - 1) / ATT_N;
  if (threadIdx.x == 0) sm.init_barriers();
  cluster_sync();  // the pair's barriers are ready before any multicast or remote arrival
  const int wg = threadIdx.x / 128;
  if (wg == 0) {
    setmaxnreg_dec<40>();
    if (threadIdx.x == 0)
      attn_produce(sm, &tm_q, &tm_k, &tm_v, q0, h, h / rep, b, n_tiles, n_tiles, cluster_rank());
    cluster_sync();  // the pair's last multicasts and arrivals are done
  } else {
    setmaxnreg_inc<232>();
    const int cw = wg - 1, t = threadIdx.x % 128, lane = t % 32, tq = lane % 4;
    unsigned char* q_rows = sm.q + cw * 64 * 128;
    const float c = scale_log2;  // scores in log2 units: exp(s * scale) = exp2(s * c)
    turns_start(cw);
    mbar_wait(sm.q_full, 0);

    // pass 1: the row max m (log2 units) and this thread's part of the row
    // sum l, rows g and g + 8 of its warp; one turn per K tile
    float s[64];
    float m[2] = {NEG_F32, NEG_F32}, l[2] = {0.f, 0.f};
    for (int j = 0; j < n_tiles; ++j) {
      const int st = j % STAGES;
      mbar_wait(&sm.full[st], (j / STAGES) & 1);
      turn_begin(cw);
      wgmma_fence();
      attn_scores_issue<D>(s, q_rows, sm.k[st]);
      wgmma_commit();
      turn_end(cw, false);
      wgmma_wait<0>();
      fence_regs(s);
      release_slot(&sm.empty[st], lane);
      mask_keys(s, j * ATT_N, Lk, tq);
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const float m_new = fmaxf(m[r], row_max(s, r) * c);
        float sum = 0.f;
#pragma unroll
        for (int n = 0; n < 16; ++n)
          sum += exp2f(fmaf(s[4 * n + 2 * r], c, -m_new)) +
                 exp2f(fmaf(s[4 * n + 2 * r + 1], c, -m_new));
        l[r] = l[r] * exp2f(m[r] - m_new) + sum;
        m[r] = m_new;
      }
    }
    float inv[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l[r] = quad_sum(l[r]);
      inv[r] = __frcp_rn(l[r]);
    }

    // pass 2: p = exp(s - m) / l in fp32, cast to bf16, o += p . v. Software
    // pipelined by one tile: the turn of tile j issues o += p_{j-1} . V_{j-1}
    // and s_j = q . K_j^T together, then forms p_j while the other warpgroup's
    // products run; a first turn issues s_0 alone, a last one p_{n-1} . V_{n-1}.
    // (No wgmma sits under a runtime condition: ptxas would serialise them.)
    float o[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
    uint32_t p[8][4];
    {
      const int st = n_tiles % STAGES;
      mbar_wait(&sm.full[st], (n_tiles / STAGES) & 1);
      turn_begin(cw);
      wgmma_fence();
      attn_scores_issue<D>(s, q_rows, sm.k[st]);
      wgmma_commit();
      turn_end(cw, false);
      wgmma_wait<0>();
      fence_regs(s);
    }
    normalised_probs(p, s, 0, Lk, tq, c, m, l, inv);
    for (int j = 1; j < n_tiles; ++j) {
      const int i = n_tiles + j, st = i % STAGES, prev = (i - 1) % STAGES;
      mbar_wait(&sm.full[st], (i / STAGES) & 1);
      turn_begin(cw);
      wgmma_fence();
      attn_pv_issue<D>(o, p, sm.v[prev]);
      attn_scores_issue<D>(s, q_rows, sm.k[st]);
      wgmma_commit();
      turn_end(cw, false);
      wgmma_wait<0>();
      fence_regs(o);
      fence_regs(s);
      fence_regs(p);
      release_slot(&sm.empty[prev], lane);
      normalised_probs(p, s, j * ATT_N, Lk, tq, c, m, l, inv);
    }
    {
      const int last = (2 * n_tiles - 1) % STAGES;
      turn_begin(cw);
      wgmma_fence();
      attn_pv_issue<D>(o, p, sm.v[last]);
      wgmma_commit();
      turn_end(cw, true);
      wgmma_wait<0>();
      fence_regs(o);
      fence_regs(p);
      release_slot(&sm.empty[last], lane);
    }
    const float one[2] = {1.f, 1.f};
    attn_store<D>(q_rows, &tm_o, o, one, t, cw, q0 + 64 * cw, Lq, h, b);
    cluster_sync();
  }
}

// One 64 x 128 by 128 x 128 tile product through the kernels' TMA and wgmma
// path, for the card test that pins the descriptors and the swizzle: s = a
// . b^T (a and b K-major, as q and k), o = bf16(s) . v (v MN-major, as V,
// with B1's descriptor). One warpgroup; a is two boxes of 64 rows, b and v
// two boxes of 128 rows.
__global__ void __launch_bounds__(128)
wgmma_tile_kernel(const __grid_constant__ CUtensorMap tm_a,
                  const __grid_constant__ CUtensorMap tm_b,
                  const __grid_constant__ CUtensorMap tm_v, float* s_out, float* o_out) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* a = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  unsigned char* bt = a + 2 * 64 * 128;
  unsigned char* v = bt + 2 * ATT_BOX;
  uint64_t* bar = reinterpret_cast<uint64_t*>(v + 2 * ATT_BOX);
  const int t = threadIdx.x;
  if (t == 0) {
    mbar_init(bar, 1);
    mbar_init_fence();
  }
  __syncthreads();
  if (t == 0) {
    mbar_expect_tx(bar, 2 * 64 * 128 + 4 * ATT_BOX);
    for (int c = 0; c < 2; ++c) {
      tma_load(a + c * 64 * 128, &tm_a, bar, 64 * c, 0, 0, 0);
      tma_load(bt + c * ATT_BOX, &tm_b, bar, 64 * c, 0, 0, 0);
      tma_load(v + c * ATT_BOX, &tm_v, bar, 64 * c, 0, 0, 0);
    }
  }
  mbar_wait(bar, 0);
  float s[64];
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < 8; ++kk)
    wgmma_ss_n128(s, desc_sw128(a + (kk / 4) * 64 * 128 + (kk % 4) * 32, 16, 1024),
                  desc_sw128(bt + (kk / 4) * ATT_BOX + (kk % 4) * 32, 16, 1024), kk > 0);
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs(s);
  uint32_t p[8][4];
#pragma unroll
  for (int kb = 0; kb < 8; ++kb)
#pragma unroll
    for (int e = 0; e < 4; ++e) p[kb][e] = pack_bf16(s[8 * kb + 2 * e], s[8 * kb + 2 * e + 1]);
  float o[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) o[i] = 0.f;
  wgmma_fence();
#pragma unroll
  attn_pv_issue<128>(o, p, v);
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs(o);
  fence_regs(p);
  const int warp = t / 32, g = (t % 32) / 4, q = t % 4;
#pragma unroll
  for (int j = 0; j < 16; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int idx = (warp * 16 + g + 8 * (i >> 1)) * 128 + 8 * j + 2 * q + (i & 1);
      s_out[idx] = s[4 * j + i];
      o_out[idx] = o[4 * j + i];
    }
}

// Rotate x (B, H, L, D; element strides st[0..2]) into the contiguous out.
template <int D>
cudaError_t rope(const void* x, void* out, const void* sin_t, const void* cos_t,
                 int B, int H, int L, const long long* st, cudaStream_t stream) {
  const long long n_chunks = (long long)B * H * L * (D / 16);
  const unsigned blocks = (unsigned)((n_chunks + ROPE_THREADS - 1) / ROPE_THREADS);
  rope_kernel<D><<<blocks, ROPE_THREADS, 0, stream>>>(
      static_cast<const bf16*>(x), static_cast<bf16*>(out),
      static_cast<const float*>(sin_t), static_cast<const float*>(cos_t),
      n_chunks, H, L, st[0], st[1], st[2]);
  return cudaGetLastError();
}

// RoPE (when the tables are given) of q and k into q_rot and k_rot, with
// their element strides in st[0..2] and st[3..5].
template <int D>
cudaError_t rope_qk(const void* q, const void* k, const void* rope_sin, const void* rope_cos,
                    void* q_rot, void* k_rot, int B, int H, int KVH, int Lq, int Lk,
                    const long long* st, cudaStream_t stream) {
  if (rope_sin == nullptr) return cudaSuccess;
  const cudaError_t err = rope<D>(q, q_rot, rope_sin, rope_cos, B, H, Lq, st, stream);
  if (err != cudaSuccess) return err;
  return rope<D>(k, k_rot, rope_sin, rope_cos, B, KVH, Lk, st + 3, stream);
}

// B1 on the operands that `maps` describes (q or q_rot, k or k_rot, v, o).
template <int D>
cudaError_t launch_wgmma(const void* const bases[4], const long long* maps, int B, int H,
                         int KVH, int Lq, int Lk, float scale, cudaStream_t stream) {
  if (!spec_is(maps, D, Lq, H, B, ATT_M) || !spec_is(maps + MAP_SPEC, D, Lk, KVH, B, ATT_N) ||
      !spec_is(maps + 2 * MAP_SPEC, D, Lk, KVH, B, ATT_N) ||
      !spec_is(maps + 3 * MAP_SPEC, D, Lq, H, B, 64))
    return cudaErrorInvalidValue;
  CUtensorMap tm[4];
  for (int i = 0; i < 4; ++i) {
    const cudaError_t err = encode_tensor_map(&tm[i], bases[i], maps + i * MAP_SPEC);
    if (err != cudaSuccess) return err;
  }
  const int smem = AttnSmem<D, STAGES>::BYTES;
  cudaError_t err = cudaFuncSetAttribute(
      attn_fwd_wgmma_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  // whole pairs of query tiles (a tile past Lq computes and stores nothing)
  const int tiles = (Lq + ATT_M - 1) / ATT_M;
  const dim3 grid((tiles + ATT_PAIR - 1) / ATT_PAIR * ATT_PAIR, H, B);
  attn_fwd_wgmma_kernel<D><<<grid, ATT_THREADS, smem, stream>>>(
      tm[0], tm[1], tm[2], tm[3], H / KVH, Lq, Lk, scale * LOG2E);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_bias(const void* q, const void* k, const void* v, void* o,
                        const void* bias, const void* rope_sin, const void* rope_cos,
                        void* q_rot, void* k_rot, int B, int H, int KVH, int Lq,
                        int Lk, const long long* strides, float scale,
                        cudaStream_t stream) {
  long long st[15];
  for (int i = 0; i < 15; ++i) st[i] = strides[i];
  cudaError_t err = rope_qk<D>(q, k, rope_sin, rope_cos, q_rot, k_rot, B, H, KVH, Lq, Lk, st,
                               stream);
  if (err != cudaSuccess) return err;
  if (rope_sin != nullptr) {
    q = q_rot;
    k = k_rot;
    st[0] = (long long)H * Lq * D, st[1] = (long long)Lq * D, st[2] = D;
    st[3] = (long long)KVH * Lk * D, st[4] = (long long)Lk * D, st[5] = D;
  }
  const size_t smem = (size_t)(BLOCK_Q + 4 * BLOCK_K) * (D + 8) * sizeof(bf16);
  err = cudaFuncSetAttribute(attn_fwd_bias_kernel<D>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((Lq + BLOCK_Q - 1) / BLOCK_Q, H, B);
  attn_fwd_bias_kernel<D><<<grid, NUM_THREADS, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<bf16*>(o),
      static_cast<const float*>(bias), H / KVH, Lq, Lk, st[0], st[1], st[2],
      st[3], st[4], st[5], st[6], st[7], st[8], st[9], st[10], st[11], st[12],
      st[13], st[14], scale);
  return cudaGetLastError();
}

bool bad_args(int B, int H, int KVH, int Lq, int Lk, const void* rope_sin,
              const void* rope_cos, const void* q_rot, const void* k_rot) {
  if (B < 1 || H < 1 || KVH < 1 || H % KVH || Lq < 1 || Lk < 1) return true;
  return (rope_sin == nullptr) != (rope_cos == nullptr) ||
         (rope_sin != nullptr && (Lq != Lk || q_rot == nullptr || k_rot == nullptr));
}

}  // namespace

// C entries, bound with ctypes. q (B, H, Lq, D), k and v (B, KVH, Lk, D), o
// (B, H, Lq, D): bf16, last dim contiguous. rope_sin / rope_cos: fp32 (L, D)
// contiguous, or both null for no RoPE (RoPE needs Lq == Lk); with RoPE,
// q_rot (B*H*Lq*D) and k_rot (B*KVH*Lk*D) are bf16 scratch for the rotated q
// and k. Each returns a cudaError_t; 0 is success.

// Kernel B1: no bias. `strides`: the element strides (batch, head, row) of
// q and k, which the rotation reads; `maps`: the wrapper's descriptions
// (ops/tensor_maps.py, MAP_SPEC values each) of the operands the attention
// kernel reads through TMA, in order q (q_rot with RoPE; boxes of 128
// rows), k (k_rot with RoPE; 128), v (128), o (64): rows 16-byte aligned,
// every stride a multiple of 16 bytes.
extern "C" int mmada_flash_attention_fwd_bf16(
    const void* q, const void* k, const void* v, void* o,
    const void* rope_sin, const void* rope_cos, void* q_rot, void* k_rot,
    int B, int H, int KVH, int Lq, int Lk, int D, const long long* strides,
    const long long* maps, float scale, void* stream) {
  if (bad_args(B, H, KVH, Lq, Lk, rope_sin, rope_cos, q_rot, k_rot) || (D != 64 && D != 128))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool roped = rope_sin != nullptr;
  const void* bases[4] = {roped ? q_rot : q, roped ? k_rot : k, v, o};
  cudaError_t err = D == 128 ? rope_qk<128>(q, k, rope_sin, rope_cos, q_rot, k_rot, B, H, KVH,
                                            Lq, Lk, strides, s)
                             : rope_qk<64>(q, k, rope_sin, rope_cos, q_rot, k_rot, B, H, KVH,
                                           Lq, Lk, strides, s);
  if (err != cudaSuccess) return (int)err;
  err = D == 128 ? launch_wgmma<128>(bases, maps, B, H, KVH, Lq, Lk, scale, s)
                 : launch_wgmma<64>(bases, maps, B, H, KVH, Lq, Lk, scale, s);
  return (int)err;
}

// Kernel B2: plus the fp32 bias (B|1, H|1, Lq, Lk), last dim contiguous.
// `strides` holds the element strides (batch, head, row) of q, k, v, o and
// the bias (0 on a broadcast axis); rows 16-byte aligned.
extern "C" int mmada_flash_attention_fwd_bias_bf16(
    const void* q, const void* k, const void* v, void* o, const void* bias,
    const void* rope_sin, const void* rope_cos, void* q_rot, void* k_rot,
    int B, int H, int KVH, int Lq, int Lk, int D, const long long* strides,
    float scale, void* stream) {
  if (bad_args(B, H, KVH, Lq, Lk, rope_sin, rope_cos, q_rot, k_rot) || bias == nullptr)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D == 128)
    return (int)launch_bias<128>(q, k, v, o, bias, rope_sin, rope_cos, q_rot, k_rot, B, H,
                                 KVH, Lq, Lk, strides, scale, s);
  if (D == 64)
    return (int)launch_bias<64>(q, k, v, o, bias, rope_sin, rope_cos, q_rot, k_rot, B, H,
                                KVH, Lq, Lk, strides, scale, s);
  return (int)cudaErrorInvalidValue;
}

// The tile product of wgmma_tile_kernel, for the card test: a (64 x 128), b
// and v (128 x 128) described by `maps` (boxes of 64, 128 and 128 rows);
// s_out and o_out fp32 (64 x 128) row-major.
extern "C" int mmada_wgmma_tile_bf16(const void* a, const void* b, const void* v,
                                     void* s_out, void* o_out, const long long* maps,
                                     void* stream) {
  if (!spec_is(maps, 128, 64, 1, 1, 64) || !spec_is(maps + MAP_SPEC, 128, 128, 1, 1, 128) ||
      !spec_is(maps + 2 * MAP_SPEC, 128, 128, 1, 1, 128))
    return (int)cudaErrorInvalidValue;
  CUtensorMap tm[3];
  const void* bases[3] = {a, b, v};
  for (int i = 0; i < 3; ++i) {
    const cudaError_t err = encode_tensor_map(&tm[i], bases[i], maps + i * MAP_SPEC);
    if (err != cudaSuccess) return (int)err;
  }
  const int smem = 2 * 64 * 128 + 4 * ATT_BOX + 8 + 1024;
  cudaError_t err = cudaFuncSetAttribute(wgmma_tile_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  wgmma_tile_kernel<<<1, 128, smem, static_cast<cudaStream_t>(stream)>>>(
      tm[0], tm[1], tm[2], static_cast<float*>(s_out), static_cast<float*>(o_out));
  return (int)cudaGetLastError();
}
