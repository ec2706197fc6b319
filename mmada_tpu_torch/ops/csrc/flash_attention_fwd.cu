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
// B2 (attn_fwd_bias_wgmma_kernel) is B1 with the fp32 bias (B|1, H|1, Lq,
// Lk) added to the scores. Its K/V tiles are 64 keys (STEP_N), so that a
// ring slot holds the K and V tiles and the block's 128 x 64 fp32 bias tile
// (two 128-byte-swizzled boxes of 32 keys, by TMA, this block's own: the
// pair shares K and V, not its query rows' bias): Q (32 KB) and three slots
// of 64 KB fill 224 KB at D = 128. The products are m64n64 (scores) and
// m64nDk16 over 64 keys (p . v). A broadcast axis of the bias is a
// dimension of 1 in its tensor map, read at index 0. The rows of a mask
// bias of odd L are not 16-byte aligned, which TMA needs:
// `prepare_attention_bias` gives the model's bias rows padded to 4 floats,
// and the wrapper copies any other bias once.
//
// The scores stay in B1's log2 units: with b' = max(bias * log2 e,
// -FLT_MAX), pass 1 takes m = max(fma(s, c, b')) and e = exp2(fma(s, c, -m)
// + b'), pass 2 the same e. For a zero bias b' = 0 and e + 0.0f is e, so B2
// computes B1's every value, bit for bit, provided its pass 1 sums a row's
// exps over B1's 128-key groups: it takes its 64-key tiles in pairs (the
// second of a last pair, past Lk, is zero-filled and masked). The
// saturation is what keeps a row that a mask shuts out entirely (every
// bias the finite min, whose log2 form would be -inf) finite: there m =
// -FLT_MAX and fma(s, c, FLT_MAX) - FLT_MAX = 0, so e = 1 on each of the Lk
// keys and the row averages v, the XLA tier's function; on a row with an
// allowed key a masked key's e is exp2(-FLT_MAX) = 0. Against the plain
// version's round(round(s * scale) + bias), p moves by a few fp32 ulps, as
// B1's does.
//
// Bound: 4*B*H*Lq*Lk*D flops against q + k + v + o bytes (+ the fp32 rope
// tables, + the bias). At the serving shapes (L ~ 1.2k, D = 128) the flops
// dominate: the kernels are compute-bound.

#include "hopper_sm90.cuh"

namespace {

constexpr int ROPE_THREADS = 256;
constexpr int STAGES = 3;  // B1's and B2's K/V rings

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

// ------------------------------------------------------------------ B2

constexpr int B2_BIAS_BOX = ATT_M * 128;  // bytes of one bias box: 128 rows of 32 fp32

// B2's shared memory: the Q tile, then STAGES ring slots, each a K and a V
// tile of STEP_N keys and the block's 128 x STEP_N fp32 bias tile (two boxes
// of BIAS_COLS keys); every tile 1024-byte aligned, as the swizzle needs.
template <int D, int STAGES_>
struct BiasAttnSmem {
  static constexpr int Q_TILE = ATT_M * D * 2;
  static constexpr int KV = STEP_N * D * 2;      // a K or V tile
  static constexpr int BIAS_BOX = B2_BIAS_BOX;
  static constexpr int BIAS = ATT_M * STEP_N * 4;
  static constexpr int STAGE = 2 * KV + BIAS;
  static constexpr int BYTES = Q_TILE + STAGES_ * STAGE + 8 * (1 + 2 * STAGES_) + 1024;
  unsigned char* q;
  uint64_t* q_full;
  uint64_t* full;
  uint64_t* empty;

  __device__ explicit BiasAttnSmem(unsigned char* raw) {
    q = reinterpret_cast<unsigned char*>(
        (reinterpret_cast<uintptr_t>(raw) + 1023) & ~static_cast<uintptr_t>(1023));
    q_full = reinterpret_cast<uint64_t*>(q + Q_TILE + STAGES_ * STAGE);
    full = q_full + 1;
    empty = full + STAGES_;
  }

  // slot s's tiles (computed: a runtime index into an array of pointers
  // would put the array in local memory)
  __device__ unsigned char* k(int s) const { return q + Q_TILE + s * STAGE; }
  __device__ unsigned char* v(int s) const { return k(s) + KV; }
  __device__ unsigned char* bias(int s) const { return k(s) + 2 * KV; }

  __device__ void init_barriers() const {
    mbar_init(q_full, 1);
    for (int s = 0; s < STAGES_; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 8 * ATT_PAIR);
    }
    mbar_init_fence();
  }
};

// B2's producer thread: the Q tile, then n1 slots of a K tile and the bias
// tile (pass 1), then n2 slots of K, V and bias (pass 2), each slot i of
// keys from STEP_N * (i or i - n1). K and V boxes are shared with the pair
// as attn_produce's; the bias boxes (query rows q0.., head hb, batch bb) are
// this block's own.
template <int D, int S>
__device__ __forceinline__ void bias_produce(const BiasAttnSmem<D, S>& sm,
                                             const CUtensorMap* tm_q, const CUtensorMap* tm_k,
                                             const CUtensorMap* tm_v, const CUtensorMap* tm_b,
                                             int q0, int h, int kvh, int b, int hb, int bb,
                                             int n1, int n2, int rank) {
  constexpr int BOXES = D / 64;
  constexpr uint16_t BOTH = (1 << ATT_PAIR) - 1;
  using M = BiasAttnSmem<D, S>;
  mbar_expect_tx(sm.q_full, M::Q_TILE);
  for (int c = 0; c < BOXES; ++c) tma_load(sm.q + c * ATT_BOX, tm_q, sm.q_full, 64 * c, q0, h, b);
  for (int i = 0; i < n1 + n2; ++i) {
    const int s = i % S;
    const bool with_v = i >= n1;
    const int key0 = (with_v ? i - n1 : i) * STEP_N;
    mbar_wait(&sm.empty[s], ((i / S) & 1) ^ 1);
    mbar_expect_tx(&sm.full[s], (with_v ? 2 : 1) * M::KV + M::BIAS);
    for (int box = rank; box < (with_v ? 2 : 1) * BOXES; box += ATT_PAIR) {
      const bool is_v = box >= BOXES;
      const int c = box % BOXES;
      tma_load_multicast((is_v ? sm.v(s) : sm.k(s)) + c * STEP_BOX, is_v ? tm_v : tm_k,
                         &sm.full[s], BOTH, 64 * c, key0, kvh, b);
    }
    for (int c = 0; c < STEP_N / BIAS_COLS; ++c)
      tma_load(sm.bias(s) + c * M::BIAS_BOX, tm_b, &sm.full[s], key0 + BIAS_COLS * c, q0, hb, bb);
  }
}

// A bias value in B1's log2 units, saturated at the finite min (a mask's
// -FLT_MAX times log2 e would be -inf).
__device__ __forceinline__ float bias_log2(float x) { return fmaxf(x * LOG2E, NEG_F32); }

// This thread's 32 bias values of a 64-key tile in log2 units, in the
// accumulator layout of its scores (rows `row` and row + 8 of the block's
// 128).
__device__ __forceinline__ void load_bias_log2(float (&bl)[32], const unsigned char* tile,
                                               int row, int tq) {
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float2 x = *bias_row_pair(tile, B2_BIAS_BOX, row, 0, tq, j, r);
      bl[4 * j + 2 * r] = bias_log2(x.x);
      bl[4 * j + 2 * r + 1] = bias_log2(x.y);
    }
}

// B2's probabilities of one 64-key tile as register-A fragments: B1's
// normalised_probs with the tile's bias (log2 units, load_bias_log2) added
// to each exponent.
__device__ __forceinline__ void normalised_probs_bias(uint32_t (&p)[4][4], float (&s)[32],
                                                      const float (&bl)[32], int key0, int Lk,
                                                      int tq, float c, const float m[2],
                                                      const float l[2], const float inv[2]) {
  mask_keys(s, key0, Lk, tq);
#pragma unroll
  for (int kb = 0; kb < 4; ++kb)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = e & 1;
      float x[2];
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const int i = 8 * kb + 2 * e + u;
        const float ex = exp2f(__fadd_rn(fmaf(s[i], c, -m[r]), bl[i]));
        const float y = ex * inv[r];
        x[u] = fmaf(inv[r], fmaf(-y, l[r], ex), y);
      }
      p[kb][e] = pack_bf16(x[0], x[1]);
    }
}

// Kernel B2. `bias_heads` / `bias_batches`: the bias map's extents of those
// axes (1: broadcast, read at index 0).
template <int D>
__global__ void __cluster_dims__(ATT_PAIR, 1, 1) __launch_bounds__(ATT_THREADS, 1)
attn_fwd_bias_wgmma_kernel(const __grid_constant__ CUtensorMap tm_q,
                           const __grid_constant__ CUtensorMap tm_k,
                           const __grid_constant__ CUtensorMap tm_v,
                           const __grid_constant__ CUtensorMap tm_o,
                           const __grid_constant__ CUtensorMap tm_b, int rep, int Lq, int Lk,
                           int bias_heads, int bias_batches, float scale_log2) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const BiasAttnSmem<D, STAGES> sm(smem_raw);
  const int q0 = blockIdx.x * ATT_M, h = blockIdx.y, b = blockIdx.z;
  // pass 1 walks pairs of 64-key tiles (B1's 128-key tiles), pass 2 tiles
  const int n_pairs = (Lk + 2 * STEP_N - 1) / (2 * STEP_N);
  const int n1 = 2 * n_pairs, n2 = (Lk + STEP_N - 1) / STEP_N;
  if (threadIdx.x == 0) sm.init_barriers();
  cluster_sync();  // the pair's barriers are ready before any multicast or remote arrival
  const int wg = threadIdx.x / 128;
  if (wg == 0) {
    setmaxnreg_dec<40>();
    if (threadIdx.x == 0)
      bias_produce(sm, &tm_q, &tm_k, &tm_v, &tm_b, q0, h, h / rep, b,
                   bias_heads > 1 ? h : 0, bias_batches > 1 ? b : 0, n1, n2, cluster_rank());
    cluster_sync();  // the pair's last multicasts and arrivals are done
  } else {
    setmaxnreg_inc<232>();
    const int cw = wg - 1, t = threadIdx.x % 128, lane = t % 32, tq = lane % 4;
    unsigned char* q_rows = sm.q + cw * 64 * 128;
    const int row = 64 * cw + (t / 32) * 16 + lane / 4;  // this thread's first tile row
    const float c = scale_log2;
    turns_start(cw);
    mbar_wait(sm.q_full, 0);

    // pass 1: B1's, on the pair of 64-key tiles of each 128-key group: the
    // row max of fma(s, c, b') and the sum of exp2(fma(s, c, -m) + b'), its
    // terms in B1's order
    float m[2] = {NEG_F32, NEG_F32}, l[2] = {0.f, 0.f};
    for (int j = 0; j < n_pairs; ++j) {
      const int i0 = 2 * j, s0 = i0 % STAGES, s1 = (i0 + 1) % STAGES;
      mbar_wait(&sm.full[s0], (i0 / STAGES) & 1);
      mbar_wait(&sm.full[s1], ((i0 + 1) / STAGES) & 1);
      float sa[32], sb[32];
      turn_begin(cw);
      wgmma_fence();
      step_scores_issue<D>(sa, q_rows, sm.k(s0));
      step_scores_issue<D>(sb, q_rows, sm.k(s1));
      wgmma_commit();
      turn_end(cw, false);
      float ba[32], bb[32];  // read while the products run
      load_bias_log2(ba, sm.bias(s0), row, tq);
      load_bias_log2(bb, sm.bias(s1), row, tq);
      wgmma_wait<0>();
      fence_regs(sa);
      fence_regs(sb);
      mask_keys(sa, j * 2 * STEP_N, Lk, tq);
      mask_keys(sb, j * 2 * STEP_N + STEP_N, Lk, tq);
      // the bias reads (generic proxy) before the slots' next TMA loads
      fence_async_shared();
      release_slot(&sm.empty[s0], lane);
      release_slot(&sm.empty[s1], lane);
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        float mx = -INFINITY;
#pragma unroll
        for (int n = 0; n < 8; ++n)
#pragma unroll
          for (int u = 0; u < 2; ++u) {
            const int i = 4 * n + 2 * r + u;
            mx = fmaxf(mx, fmaxf(fmaf(sa[i], c, ba[i]), fmaf(sb[i], c, bb[i])));
          }
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        const float m_new = fmaxf(m[r], mx);
        float sum = 0.f;
#pragma unroll
        for (int n = 0; n < 8; ++n) {
          const int i = 4 * n + 2 * r;
          sum += exp2f(__fadd_rn(fmaf(sa[i], c, -m_new), ba[i])) +
                 exp2f(__fadd_rn(fmaf(sa[i + 1], c, -m_new), ba[i + 1]));
        }
#pragma unroll
        for (int n = 0; n < 8; ++n) {
          const int i = 4 * n + 2 * r;
          sum += exp2f(__fadd_rn(fmaf(sb[i], c, -m_new), bb[i])) +
                 exp2f(__fadd_rn(fmaf(sb[i + 1], c, -m_new), bb[i + 1]));
        }
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

    // pass 2: B1's, over 64-key tiles, pipelined by one tile
    float o[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
    float s[32], bl[32];
    uint32_t p[4][4];
    {
      const int st = n1 % STAGES;
      mbar_wait(&sm.full[st], (n1 / STAGES) & 1);
      turn_begin(cw);
      wgmma_fence();
      step_scores_issue<D>(s, q_rows, sm.k(st));
      wgmma_commit();
      turn_end(cw, false);
      load_bias_log2(bl, sm.bias(st), row, tq);
      wgmma_wait<0>();
      fence_regs(s);
      normalised_probs_bias(p, s, bl, 0, Lk, tq, c, m, l, inv);
    }
    for (int j = 1; j < n2; ++j) {
      const int i = n1 + j, st = i % STAGES, prev = (i - 1) % STAGES;
      mbar_wait(&sm.full[st], (i / STAGES) & 1);
      turn_begin(cw);
      wgmma_fence();
      step_acc_issue<D>(o, p, sm.v(prev));
      step_scores_issue<D>(s, q_rows, sm.k(st));
      wgmma_commit();
      turn_end(cw, false);
      load_bias_log2(bl, sm.bias(st), row, tq);
      wgmma_wait<0>();
      fence_regs(o);
      fence_regs(s);
      fence_regs(p);
      fence_async_shared();
      release_slot(&sm.empty[prev], lane);
      normalised_probs_bias(p, s, bl, j * STEP_N, Lk, tq, c, m, l, inv);
    }
    {
      const int last = (n1 + n2 - 1) % STAGES;
      turn_begin(cw);
      wgmma_fence();
      step_acc_issue<D>(o, p, sm.v(last));
      wgmma_commit();
      turn_end(cw, true);
      wgmma_wait<0>();
      fence_regs(o);
      fence_regs(p);
      fence_async_shared();
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

// B2 on the operands that `maps` describes (q or q_rot, k or k_rot, v, o,
// then the fp32 bias).
template <int D>
cudaError_t launch_bias_wgmma(const void* const bases[5], const long long* maps, int B, int H,
                              int KVH, int Lq, int Lk, float scale, cudaStream_t stream) {
  const long long* bias = maps + 4 * MAP_SPEC;
  if (!spec_is(maps, D, Lq, H, B, ATT_M) || !spec_is(maps + MAP_SPEC, D, Lk, KVH, B, STEP_N) ||
      !spec_is(maps + 2 * MAP_SPEC, D, Lk, KVH, B, STEP_N) ||
      !spec_is(maps + 3 * MAP_SPEC, D, Lq, H, B, 64) ||
      !bias_spec_is(bias, Lk, Lq, H, B, ATT_M))
    return cudaErrorInvalidValue;
  CUtensorMap tm[5];
  for (int i = 0; i < 5; ++i) {
    const cudaError_t err =
        encode_tensor_map(&tm[i], bases[i], maps + i * MAP_SPEC,
                          i == 4 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32
                                 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16);
    if (err != cudaSuccess) return err;
  }
  const int smem = BiasAttnSmem<D, STAGES>::BYTES;
  cudaError_t err = cudaFuncSetAttribute(
      attn_fwd_bias_wgmma_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const int tiles = (Lq + ATT_M - 1) / ATT_M;
  const dim3 grid((tiles + ATT_PAIR - 1) / ATT_PAIR * ATT_PAIR, H, B);
  attn_fwd_bias_wgmma_kernel<D><<<grid, ATT_THREADS, smem, stream>>>(
      tm[0], tm[1], tm[2], tm[3], tm[4], H / KVH, Lq, Lk, (int)bias[2], (int)bias[3],
      scale * LOG2E);
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

// Kernel B2: plus the fp32 bias (B|1, H|1, Lq, Lk). As B1's entry, with
// the bias after o in `maps` (q and k in boxes of 128 and 64 rows, v 64, o
// 64; the bias in boxes of 32 fp32 columns and 128 rows, its broadcast axes
// of extent 1, its rows' stride a multiple of 16 bytes).
extern "C" int mmada_flash_attention_fwd_bias_bf16(
    const void* q, const void* k, const void* v, void* o, const void* bias,
    const void* rope_sin, const void* rope_cos, void* q_rot, void* k_rot,
    int B, int H, int KVH, int Lq, int Lk, int D, const long long* strides,
    const long long* maps, float scale, void* stream) {
  if (bad_args(B, H, KVH, Lq, Lk, rope_sin, rope_cos, q_rot, k_rot) || bias == nullptr ||
      (D != 64 && D != 128))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool roped = rope_sin != nullptr;
  const void* bases[5] = {roped ? q_rot : q, roped ? k_rot : k, v, o, bias};
  cudaError_t err = D == 128 ? rope_qk<128>(q, k, rope_sin, rope_cos, q_rot, k_rot, B, H, KVH,
                                            Lq, Lk, strides, s)
                             : rope_qk<64>(q, k, rope_sin, rope_cos, q_rot, k_rot, B, H, KVH,
                                           Lq, Lk, strides, s);
  if (err != cudaSuccess) return (int)err;
  err = D == 128 ? launch_bias_wgmma<128>(bases, maps, B, H, KVH, Lq, Lk, scale, s)
                 : launch_bias_wgmma<64>(bases, maps, B, H, KVH, Lq, Lk, scale, s);
  return (int)err;
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
