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
// B4 (attn_long_fwd_wgmma_kernel) is the attention skeleton of
// hopper_sm90.cuh with one online pass: one block per (128-row query tile,
// head, batch), pairs of blocks in a cluster sharing each K/V tile by TMA
// multicast, a TMA producer warpgroup and two consumer warpgroups of 64
// rows that issue their wgmma products in turns, K/V tiles of 128 keys in a
// ring of three slots, q . k^T on wgmma from shared memory, p . v on wgmma
// with p from registers: p is split into its hi and lo bf16 halves, two
// register-A operands, and O takes two products per tile, P_hi . V then
// P_lo . V. The loop is pipelined by one tile: a turn issues tile j-1's two
// products and tile j's scores together, and tile j's online step (o
// rescaled, p formed and split) runs while the other warpgroup's products
// run. exp goes through exp2 of the score pre-scaled by log2 e (p
// moves by a few fp32 ulps, far inside the bar of one bf16 ulp); the output
// is stored by TMA. Lq and Lk are multiples of 128, so there are no ragged
// edges.
//
// B4-bias (attn_long_fwd_bias_kernel) and B5-dq keep the earlier design, as
// B2 and B3: one block per (64-row query tile, head, batch), four warps of
// 16 rows, q (and dO) tiles in shared memory, K/V tiles of 64 keys
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
// split products make the tensor cores do 6 and 10 of those units: even a B4
// at the tensor cores' peak takes 1.5 times the bound.

#include "flash_attention_dkv.cuh"
#include "hopper_sm90.cuh"

namespace {

constexpr int ALIGN = 128;  // Lq, Lk multiples of this, as the TPU tiers
constexpr int LONG_STAGES = 3;  // B4's K/V ring
constexpr float LOG2E = 1.4426950408889634f;

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

// Kernel B4-bias.
template <int D>
__global__ void __launch_bounds__(NUM_THREADS)
attn_long_fwd_bias_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
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
  const float* bp = bias + b * st.s[12] + h * st.s[13];
  const float* const brow[2] = {bp + (long long)row_a * st.s[14],
                                bp + (long long)(row_a + 8) * st.s[14]};

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
    load_bias_rows<true, NB>(bv, brow, tile * BLOCK, Lk, t);
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
      for (int j = 0; j < 4; ++j) s[n][j] = scaled<true>(s[n][j], scale, bv[n][j]);
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

// B4's online step for one tile of scores s (fp32, unscaled): the new row
// max m (log2 units), p = exp(s - m) in place, l = l a + rowsum(p) (this
// thread's part), o rescaled by a, and p as two register-A operands, its
// bf16 rounding hi and the rest lo.
template <int D>
__device__ __forceinline__ void online_step(float (&o)[D / 2], float (&s)[64], float m[2],
                                            float l[2], uint32_t (&hi)[8][4],
                                            uint32_t (&lo)[8][4], float c) {
  float a[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float m_new = fmaxf(m[r], row_max(s, r) * c);
    a[r] = exp2f(m[r] - m_new);
    m[r] = m_new;
    float sum = 0.f;
#pragma unroll
    for (int n = 0; n < 16; ++n)
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        float& x = s[4 * n + 2 * r + u];
        x = exp2f(fmaf(x, c, -m_new));
        sum += x;
      }
    l[r] = l[r] * a[r] + sum;
  }
#pragma unroll
  for (int n = 0; n < D / 8; ++n) {
    o[4 * n] *= a[0];
    o[4 * n + 1] *= a[0];
    o[4 * n + 2] *= a[1];
    o[4 * n + 3] *= a[1];
  }
#pragma unroll
  for (int kb = 0; kb < 8; ++kb)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float x0 = s[8 * kb + 2 * e], x1 = s[8 * kb + 2 * e + 1];
      hi[kb][e] = pack_bf16(x0, x1);
      lo[kb][e] = pack_bf16_rest(x0, x1, hi[kb][e]);
    }
}

// Kernel B4. q_rows: this consumer warpgroup's 64 rows of the Q tile.
template <int D>
__global__ void __cluster_dims__(ATT_PAIR, 1, 1) __launch_bounds__(ATT_THREADS, 1)
attn_long_fwd_wgmma_kernel(const __grid_constant__ CUtensorMap tm_q,
                           const __grid_constant__ CUtensorMap tm_k,
                           const __grid_constant__ CUtensorMap tm_v,
                           const __grid_constant__ CUtensorMap tm_o, int rep, int Lq, int Lk,
                           float scale_log2) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const AttnSmem<D, LONG_STAGES> sm(smem_raw);
  const int q0 = blockIdx.x * ATT_M, h = blockIdx.y, b = blockIdx.z;
  const int n_tiles = Lk / ATT_N;
  if (threadIdx.x == 0) sm.init_barriers();
  cluster_sync();  // the pair's barriers are ready before any multicast or remote arrival
  const int wg = threadIdx.x / 128;
  if (wg == 0) {
    setmaxnreg_dec<40>();
    if (threadIdx.x == 0)
      attn_produce(sm, &tm_q, &tm_k, &tm_v, q0, h, h / rep, b, n_tiles, 0, cluster_rank());
    cluster_sync();  // the pair's last multicasts and arrivals are done
  } else {
    setmaxnreg_inc<232>();
    const int cw = wg - 1, t = threadIdx.x % 128, lane = t % 32;
    unsigned char* q_rows = sm.q + cw * 64 * 128;
    const float c = scale_log2;  // scores in log2 units: exp(s * scale) = exp2(s * c)
    mbar_wait(sm.q_full, 0);

    // software pipelined by one tile, as B1's second pass: the turn of tile
    // j issues o += p_{j-1} . V_{j-1} (hi, then lo) and s_j = q . K_j^T
    // together, then takes the online step of tile j (o rescaled once
    // p_{j-1} . V_{j-1} is in) while the other warpgroup's products run
    float o[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
    float m[2] = {NEG_F32, NEG_F32}, l[2] = {0.f, 0.f};  // l: this thread's part
    float s[64];
    uint32_t hi[8][4], lo[8][4];
    turns_start(cw);
    mbar_wait(&sm.full[0], 0);
    turn_begin(cw);
    wgmma_fence();
    attn_scores_issue<D>(s, q_rows, sm.k[0]);
    wgmma_commit();
    turn_end(cw, false);
    wgmma_wait<0>();
    fence_regs(s);
    online_step<D>(o, s, m, l, hi, lo, c);
    for (int j = 1; j < n_tiles; ++j) {
      const int st = j % LONG_STAGES, prev = (j - 1) % LONG_STAGES;
      mbar_wait(&sm.full[st], (j / LONG_STAGES) & 1);
      turn_begin(cw);
      wgmma_fence();
      attn_pv_issue<D>(o, hi, sm.v[prev]);
      attn_pv_issue<D>(o, lo, sm.v[prev]);
      attn_scores_issue<D>(s, q_rows, sm.k[st]);
      wgmma_commit();
      turn_end(cw, false);
      wgmma_wait<0>();
      fence_regs(o);
      fence_regs(s);
      fence_regs(hi);
      fence_regs(lo);
      release_slot(&sm.empty[prev], lane);
      online_step<D>(o, s, m, l, hi, lo, c);
    }
    const int last = (n_tiles - 1) % LONG_STAGES;
    turn_begin(cw);
    wgmma_fence();
    attn_pv_issue<D>(o, hi, sm.v[last]);
    attn_pv_issue<D>(o, lo, sm.v[last]);
    wgmma_commit();
    turn_end(cw, true);
    wgmma_wait<0>();
    fence_regs(o);
    fence_regs(hi);
    fence_regs(lo);
    release_slot(&sm.empty[last], lane);
    const float div[2] = {fmaxf(quad_sum(l[0]), 1e-30f), fmaxf(quad_sum(l[1]), 1e-30f)};
    attn_store<D>(q_rows, &tm_o, o, div, t, cw, q0 + 64 * cw, Lq, h, b);
    cluster_sync();
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

// B4 on the operands at `bases` that `maps` describes (q, k, v, o).
template <int D>
cudaError_t launch_fwd(const void* const bases[4], const long long* maps, int B, int H, int KVH,
                       int Lq, int Lk, float scale, cudaStream_t stream) {
  if (!spec_is(maps, D, Lq, H, B, ATT_M) || !spec_is(maps + MAP_SPEC, D, Lk, KVH, B, ATT_N) ||
      !spec_is(maps + 2 * MAP_SPEC, D, Lk, KVH, B, ATT_N) ||
      !spec_is(maps + 3 * MAP_SPEC, D, Lq, H, B, 64))
    return cudaErrorInvalidValue;
  CUtensorMap tm[4];
  for (int i = 0; i < 4; ++i) {
    const cudaError_t err = encode_tensor_map(&tm[i], bases[i], maps + i * MAP_SPEC);
    if (err != cudaSuccess) return err;
  }
  const int smem = AttnSmem<D, LONG_STAGES>::BYTES;
  cudaError_t err = cudaFuncSetAttribute(
      attn_long_fwd_wgmma_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  // whole pairs of query tiles (a tile past Lq computes and stores nothing)
  const int tiles = Lq / ATT_M;
  const dim3 grid((tiles + ATT_PAIR - 1) / ATT_PAIR * ATT_PAIR, H, B);
  attn_long_fwd_wgmma_kernel<D><<<grid, ATT_THREADS, smem, stream>>>(
      tm[0], tm[1], tm[2], tm[3], H / KVH, Lq, Lk, scale * LOG2E);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_fwd_bias(const void* q, const void* k, const void* v, void* o,
                            const void* bias, int B, int H, int KVH, int Lq, int Lk,
                            const long long* strides, float scale, cudaStream_t stream) {
  const size_t smem = (size_t)5 * BLOCK * (D + 8) * sizeof(bf16);
  cudaError_t err = cudaFuncSetAttribute(
      attn_long_fwd_bias_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(Lq / BLOCK, H, B);
  attn_long_fwd_bias_kernel<D><<<grid, NUM_THREADS, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<bf16*>(o),
      static_cast<const float*>(bias), H / KVH, Lk, copy_strides(strides, 15), scale);
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
// contiguous, Lq and Lk multiples of 128, D 64 or 128; `strides` holds the
// element strides (batch, head, row) of each operand in argument order, the
// bias's last (0 on a broadcast axis). delta and lse:
// contiguous fp32 (B, H, Lq). The bias: fp32 (B|1, H|1, Lq, Lk), last dim
// contiguous. Each returns a cudaError_t; 0 is success.

// B4: o (B, H, Lq, D) bf16. `maps`: the wrapper's descriptions
// (ops/tensor_maps.py, MAP_SPEC values each) of q, k, v (boxes of 128 rows)
// and o (64 rows); every stride a multiple of 16 bytes.
extern "C" int mmada_flash_attention_long_fwd_bf16(
    const void* q, const void* k, const void* v, void* o, int B, int H, int KVH,
    int Lq, int Lk, int D, const long long* maps, float scale, void* stream) {
  if (bad_long_shape(B, H, KVH, Lq, Lk, D, false, nullptr)) return (int)cudaErrorInvalidValue;
  const void* bases[4] = {q, k, v, o};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return D == 128 ? (int)launch_fwd<128>(bases, maps, B, H, KVH, Lq, Lk, scale, s)
                  : (int)launch_fwd<64>(bases, maps, B, H, KVH, Lq, Lk, scale, s);
}

// B4-bias: strides = [q, k, v, o, bias] x 3 (element strides, rows 16-byte
// aligned).
extern "C" int mmada_flash_attention_long_fwd_bias_bf16(
    const void* q, const void* k, const void* v, void* o, const void* bias, int B,
    int H, int KVH, int Lq, int Lk, int D, const long long* strides, float scale,
    void* stream) {
  if (bad_long_shape(B, H, KVH, Lq, Lk, D, true, bias)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return D == 128 ? (int)launch_fwd_bias<128>(q, k, v, o, bias, B, H, KVH, Lq, Lk, strides,
                                              scale, s)
                  : (int)launch_fwd_bias<64>(q, k, v, o, bias, B, H, KVH, Lq, Lk, strides,
                                             scale, s);
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
