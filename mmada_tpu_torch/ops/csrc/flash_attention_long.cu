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
// (:1110), called at :1240 (the biased kernel is flash_attention_dkv.cuh's,
// shared with B3). q and k arrive rotated (RoPE runs outside in fp32, as the TPU
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
//   B5-dkv: p = exp(s - lse); dv = p^T . dO; ds = p (dO . v^T - delta);
//          dk = ds^T . q * scale, summed over the GQA group's query heads
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
// B5-dq (attn_long_bwd_dq_wgmma_kernel) and B5-dkv
// (attn_long_bwd_dkv_wgmma_kernel) take the same skeleton; see their section
// below. B5-dq walks K/V
// tiles of 64 keys (its dp accumulator and t's halves would not fit beside
// 128-key tiles in 232 registers) and is pipelined by one tile as B4;
// B5-dkv keeps dk and dv (64 keys x D each, fp32) in registers and walks
// (query head, 64-row query tile) steps in two turns each.
//
// B4-bias and the biased B5-dq keep the earlier design, as B2 and B3: one
// block per (64-row query tile, head, batch), four warps of 16 rows, q (and
// dO) tiles in shared memory, K/V tiles of 64 keys double-buffered with
// cp.async so the next tile's copy overlaps this tile's products, fragments
// from ldmatrix, products from mma.sync m16n8k16 (bf16 in, fp32 accumulate).
// GQA maps head h to kv head h / (H / KVH). The bias is read per accumulator
// fragment from global memory before the products it joins (its offsets in
// 64 bits: a (B, 1, 8192, 8192) bias passes 2^31 elements at B = 32). The
// biased B5-dq works on two 32-key halves of each tile, which keeps its
// carry, accumulators and fragments in registers but for a few (ptxas -v at
// D = 128: 104 bytes spilled). The biased B5-dkv is flash_attention_dkv.cuh's
// kernel with SPLIT.
//
// Bound (on an H100 SXM: 989 TFLOP/s bf16 dense, 3.35 TB/s): B4 needs
// 4*B*H*Lq*Lk*D flops, B5-dq 6 and B5-dkv 8, against a few bytes per row
// (q, k, v, o; dO, dq, delta, lse; dk, dv), so at L >= 4096 all are bound by
// operations. The split products make the tensor cores do 6, 8 and 12 of
// those units: even at the tensor cores' peak B4 and B5-dkv take 1.5 times
// the bound, B5-dq 1.33 times.

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

// ------------------------------------------------ B5-dq and B5-dkv on wgmma
//
// Both follow B4's skeleton (hopper_sm90.cuh): pairs of blocks in a cluster,
// a TMA producer warpgroup and two consumer warpgroups of 64 rows that issue
// their products in turns, a ring of slots on mbarriers, every product a
// wgmma. Each streamed tile is 64 rows (BWD_N): B5-dq streams K and
// V tiles of 64 keys past a resident 128-row q and dO tile, B5-dkv streams q
// and dO tiles of 64 queries (with their 64 lse and delta values, by bulk
// copy) past a resident 128-row k and v tile. The pair shares the stream:
// each block's producer loads half of a slot's boxes and multicasts them into
// both blocks. A streamed tile is read both ways: K-major as the B operand of
// a score product (q . k^T, dO . v^T; k . q^T, v . dO^T) and MN-major as the
// B operand of an accumulation (t . k; p^T . dO, ds^T . q), whose A operand
// (t, p^T, ds^T: fp32) comes from registers as hi + lo bf16 halves.
//
// Registers bound the shapes (232 a consumer thread after setmaxnreg). B5-dq
// holds acc (64 x D), s and dp (64 x 64) and t's halves: 160 at D = 128, so
// it can pipeline by one tile as B4. B5-dkv holds dk and dv (128 at D = 128)
// beside s^T and dp^T or their four halves, so a step takes two turns and
// waits for its own products; the other warpgroup's products fill the gap.
// A score product that starts a sum does not read its accumulator
// (wgmma_ss_n64_first): with "+f" operands the old s and dp stayed live
// through the next products, and ptxas serialised B5-dkv's wgmma (C7512).

constexpr int BWD_N = 64;            // rows of a streamed tile
constexpr int BWD_BOX = 64 * 128;    // bytes of one 64-column box of such a tile
constexpr int DQ_STAGES = 4;         // B5-dq's ring: K and V tiles (5: no faster)
constexpr int DKV_STAGES = 4;        // B5-dkv's ring: q, dO, lse and delta (5 would not fit)
constexpr float LN2 = 0.6931471805599453f;

// 2^x by the hardware's approximation (MUFU.EX2, a relative error of about
// 2^-22; results below 2^-126 flush to 0): exp2f's range handling costs more
// than the instruction (on an H100, B5-dq at (2, 32, 32, 8192, 8192) took
// about 5% less time without it). p and t move by a few fp32 ulps, far
// inside the gradients' bar.
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// s (64 x 64, fp32) = a . b^T for this warpgroup's 64 rows of a 128-row tile
// (`a`, its boxes ATT_BOX apart) and a 64-row streamed tile `b`, both
// K-major: D / 16 wgmma steps, the first of which does not read s.
template <int D>
__device__ __forceinline__ void bwd_scores_issue(float (&s)[32], const unsigned char* a,
                                                 const unsigned char* b) {
  wgmma_ss_n64_first(s, desc_sw128(a, 16, 1024), desc_sw128(b, 16, 1024));
#pragma unroll
  for (int kk = 1; kk < D / 16; ++kk) {
    const int col = (kk % 4) * 32;
    wgmma_ss_n64(s, desc_sw128(a + (kk / 4) * ATT_BOX + col, 16, 1024),
                 desc_sw128(b + (kk / 4) * BWD_BOX + col, 16, 1024));
  }
}

// acc (64 x D) += x . b over the 64 rows of the streamed tile `b` (MN-major,
// its 64-column boxes BWD_BOX apart), x from registers in four k16 steps.
template <int D>
__device__ __forceinline__ void bwd_acc_issue(float (&acc)[D / 2], const uint32_t (&x)[4][4],
                                              const unsigned char* b) {
#pragma unroll
  for (int kb = 0; kb < 4; ++kb) {
    const uint64_t desc = desc_sw128(b + kb * 16 * 128, BWD_BOX, 1024);
    if constexpr (D == 128)
      wgmma_rs_n128(acc, x[kb], desc, 1);
    else
      wgmma_rs_n64(acc, x[kb], desc, 1);
  }
}

// x (64 x 64 fp32, accumulator layout) as the register-A operand of four k16
// steps: hi its bf16 rounding, lo the rest.
__device__ __forceinline__ void split_hi_lo(const float (&x)[32], uint32_t (&hi)[4][4],
                                            uint32_t (&lo)[4][4]) {
#pragma unroll
  for (int kb = 0; kb < 4; ++kb)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float x0 = x[8 * kb + 2 * e], x1 = x[8 * kb + 2 * e + 1];
      hi[kb][e] = pack_bf16(x0, x1);
      lo[kb][e] = pack_bf16_rest(x0, x1, hi[kb][e]);
    }
}

template <int D, int STAGES>
struct DqSmem {
  static constexpr int TILE = 128 * D * 2;    // the resident q or dO tile
  static constexpr int STEP = BWD_N * D * 2;  // a K or V tile
  static constexpr int BYTES = 2 * TILE + 2 * STAGES * STEP + 8 * (1 + 2 * STAGES) + 1024;
  unsigned char* q;
  unsigned char* dout;
  uint64_t* q_full;
  uint64_t* full;
  uint64_t* empty;

  __device__ explicit DqSmem(unsigned char* raw) {
    q = reinterpret_cast<unsigned char*>(
        (reinterpret_cast<uintptr_t>(raw) + 1023) & ~static_cast<uintptr_t>(1023));
    dout = q + TILE;
    q_full = reinterpret_cast<uint64_t*>(q + 2 * TILE + 2 * STAGES * STEP);
    full = q_full + 1;
    empty = full + STAGES;
  }

  // slot s's K and V tiles (computed, not looked up: a runtime index into
  // an array of pointers would put the array in local memory)
  __device__ unsigned char* k(int s) const { return q + 2 * TILE + s * STEP; }
  __device__ unsigned char* v(int s) const { return q + 2 * TILE + (STAGES + s) * STEP; }

  __device__ void init_barriers() const {
    mbar_init(q_full, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 8 * ATT_PAIR);
    }
    mbar_init_fence();
  }
};

// B5-dq's producer thread: the q and dO tiles (this block's own), then
// n_tiles K and V tiles of 64 keys, each into slot i % STAGES once both
// blocks' consumers released it; of a slot's boxes (K's, then V's) this
// block issues those of index `rank` modulo the pair, to both blocks.
template <int D, int STAGES>
__device__ __forceinline__ void dq_produce(const DqSmem<D, STAGES>& sm, const CUtensorMap* tm_q,
                                           const CUtensorMap* tm_do, const CUtensorMap* tm_k,
                                           const CUtensorMap* tm_v, int q0, int h, int kvh,
                                           int b, int n_tiles, int rank) {
  constexpr int BOXES = D / 64;
  constexpr uint16_t BOTH = (1 << ATT_PAIR) - 1;
  using S = DqSmem<D, STAGES>;
  mbar_expect_tx(sm.q_full, 2 * S::TILE);
  for (int c = 0; c < BOXES; ++c) {
    tma_load(sm.q + c * ATT_BOX, tm_q, sm.q_full, 64 * c, q0, h, b);
    tma_load(sm.dout + c * ATT_BOX, tm_do, sm.q_full, 64 * c, q0, h, b);
  }
  for (int i = 0; i < n_tiles; ++i) {
    const int s = i % STAGES;
    mbar_wait(&sm.empty[s], ((i / STAGES) & 1) ^ 1);
    mbar_expect_tx(&sm.full[s], 2 * S::STEP);
    for (int box = rank; box < 2 * BOXES; box += ATT_PAIR) {
      const bool is_v = box >= BOXES;
      const int c = box % BOXES;
      tma_load_multicast((is_v ? sm.v(s) : sm.k(s)) + c * BWD_BOX, is_v ? tm_v : tm_k,
                         &sm.full[s], BOTH, 64 * c, i * BWD_N, kvh, b);
    }
  }
}

// B5-dq's online step for one tile of 64 keys: s and dp (fp32, unscaled
// scores and dO . v^T) in, the new row max m (log2 units), p = exp(s - m),
// l = l a + rowsum(p) (this thread's part), acc rescaled by a, and t = p (dp
// - delta) as two register-A operands, hi and lo.
template <int D>
__device__ __forceinline__ void dq_step(float (&acc)[D / 2], float (&s)[32],
                                        const float (&dp)[32], float m[2], float l[2],
                                        const float delta[2], uint32_t (&hi)[4][4],
                                        uint32_t (&lo)[4][4], float c) {
  float a[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float m_new = fmaxf(m[r], row_max(s, r) * c);
    a[r] = exp2f(m[r] - m_new);
    m[r] = m_new;
    float sum = 0.f;
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const int i = 4 * n + 2 * r + u;
        const float p = exp2_approx(fmaf(s[i], c, -m_new));
        sum += p;
        s[i] = p * (dp[i] - delta[r]);
      }
    l[r] = l[r] * a[r] + sum;
  }
#pragma unroll
  for (int n = 0; n < D / 8; ++n) {
    acc[4 * n] *= a[0];
    acc[4 * n + 1] *= a[0];
    acc[4 * n + 2] *= a[1];
    acc[4 * n + 3] *= a[1];
  }
  split_hi_lo(s, hi, lo);
}

// Kernel B5-dq.
template <int D>
__global__ void __cluster_dims__(ATT_PAIR, 1, 1) __launch_bounds__(ATT_THREADS, 1)
attn_long_bwd_dq_wgmma_kernel(const __grid_constant__ CUtensorMap tm_q,
                              const __grid_constant__ CUtensorMap tm_k,
                              const __grid_constant__ CUtensorMap tm_v,
                              const __grid_constant__ CUtensorMap tm_do,
                              const __grid_constant__ CUtensorMap tm_dq,
                              const float* __restrict__ delta, float* __restrict__ lse, int rep,
                              int H, int Lq, int Lk, float scale) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const DqSmem<D, DQ_STAGES> sm(smem_raw);
  const int q0 = blockIdx.x * ATT_M, h = blockIdx.y, b = blockIdx.z;
  const int n_tiles = Lk / BWD_N;
  if (threadIdx.x == 0) sm.init_barriers();
  cluster_sync();  // the pair's barriers are ready before any multicast or remote arrival
  const int wg = threadIdx.x / 128;
  if (wg == 0) {
    setmaxnreg_dec<40>();
    if (threadIdx.x == 0)
      dq_produce(sm, &tm_q, &tm_do, &tm_k, &tm_v, q0, h, h / rep, b, n_tiles, cluster_rank());
    cluster_sync();
  } else {
    setmaxnreg_inc<232>();
    const int cw = wg - 1, t = threadIdx.x % 128, lane = t % 32;
    const int row0 = q0 + 64 * cw;
    unsigned char* q_rows = sm.q + cw * 64 * 128;
    const unsigned char* do_rows = sm.dout + cw * 64 * 128;
    const float c = scale * LOG2E;  // scores in log2 units
    // this thread's rows: row0 + 16 w + g and + 8 (a tile past Lq, the
    // pair's padding, reads no delta and stores nothing)
    const long long stat0 = ((long long)b * H + h) * Lq;
    int rows[2];
    float dl[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      rows[r] = row0 + (t / 32) * 16 + (t % 32) / 4 + 8 * r;
      dl[r] = rows[r] < Lq ? delta[stat0 + rows[r]] : 0.f;
    }
    mbar_wait(sm.q_full, 0);

    // pipelined by one tile, as B4: the turn of tile j issues acc += t_{j-1}
    // . K_{j-1} (hi, then lo) and s_j, dp_j together, then takes tile j's
    // online step while the other warpgroup's products run
    float acc[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
    float m[2] = {NEG_F32, NEG_F32}, l[2] = {0.f, 0.f};
    float s[32], dp[32];
    uint32_t hi[4][4], lo[4][4];
    turns_start(cw);
    mbar_wait(&sm.full[0], 0);
    turn_begin(cw);
    wgmma_fence();
    bwd_scores_issue<D>(s, q_rows, sm.k(0));
    bwd_scores_issue<D>(dp, do_rows, sm.v(0));
    wgmma_commit();
    turn_end(cw, false);
    wgmma_wait<0>();
    fence_regs(s);
    fence_regs(dp);
    dq_step<D>(acc, s, dp, m, l, dl, hi, lo, c);
    for (int j = 1; j < n_tiles; ++j) {
      const int st = j % DQ_STAGES, prev = (j - 1) % DQ_STAGES;
      mbar_wait(&sm.full[st], (j / DQ_STAGES) & 1);
      turn_begin(cw);
      wgmma_fence();
      bwd_acc_issue<D>(acc, hi, sm.k(prev));
      bwd_acc_issue<D>(acc, lo, sm.k(prev));
      bwd_scores_issue<D>(s, q_rows, sm.k(st));
      bwd_scores_issue<D>(dp, do_rows, sm.v(st));
      wgmma_commit();
      turn_end(cw, false);
      wgmma_wait<0>();
      fence_regs(acc);
      fence_regs(s);
      fence_regs(dp);
      fence_regs(hi);
      fence_regs(lo);
      release_slot(&sm.empty[prev], lane);
      dq_step<D>(acc, s, dp, m, l, dl, hi, lo, c);
    }
    const int last = (n_tiles - 1) % DQ_STAGES;
    turn_begin(cw);
    wgmma_fence();
    bwd_acc_issue<D>(acc, hi, sm.k(last));
    bwd_acc_issue<D>(acc, lo, sm.k(last));
    wgmma_commit();
    turn_end(cw, true);
    wgmma_wait<0>();
    fence_regs(acc);
    fence_regs(hi);
    fence_regs(lo);
    release_slot(&sm.empty[last], lane);
    const float div[2] = {fmaxf(quad_sum(l[0]), 1e-30f), fmaxf(quad_sum(l[1]), 1e-30f)};
    attn_store<D>(q_rows, &tm_dq, acc, div, t, cw, row0, Lq, h, b, scale);
    if (t % 4 == 0) {
#pragma unroll
      for (int r = 0; r < 2; ++r)
        if (rows[r] < Lq) lse[stat0 + rows[r]] = m[r] * LN2 + logf(div[r]);
    }
    cluster_sync();
  }
}

template <int D, int STAGES>
struct DkvSmem {
  static constexpr int TILE = 128 * D * 2;    // the resident k or v tile
  static constexpr int STEP = BWD_N * D * 2;  // a q or dO tile
  static constexpr int STATS = BWD_N * 4;     // a span of lse or delta
  static constexpr int BYTES =
      2 * TILE + 2 * STAGES * (STEP + STATS) + 8 * (1 + 2 * STAGES) + 1024;
  unsigned char* k;
  unsigned char* v;
  uint64_t* kv_full;
  uint64_t* full;
  uint64_t* empty;

  __device__ explicit DkvSmem(unsigned char* raw) {
    k = reinterpret_cast<unsigned char*>(
        (reinterpret_cast<uintptr_t>(raw) + 1023) & ~static_cast<uintptr_t>(1023));
    v = k + TILE;
    kv_full = reinterpret_cast<uint64_t*>(k + 2 * TILE + 2 * STAGES * (STEP + STATS));
    full = kv_full + 1;
    empty = full + STAGES;
  }

  // slot s's q and dO tiles and lse and delta spans (computed, as DqSmem's)
  __device__ unsigned char* q(int s) const { return k + 2 * TILE + s * STEP; }
  __device__ unsigned char* dout(int s) const { return k + 2 * TILE + (STAGES + s) * STEP; }
  __device__ float* lse(int s) const {
    return reinterpret_cast<float*>(k + 2 * TILE + 2 * STAGES * STEP + s * STATS);
  }
  __device__ float* delta(int s) const {
    return reinterpret_cast<float*>(k + 2 * TILE + 2 * STAGES * STEP + (STAGES + s) * STATS);
  }

  __device__ void init_barriers() const {
    mbar_init(kv_full, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 8 * ATT_PAIR);
    }
    mbar_init_fence();
  }
};

// B5-dkv's producer thread: the k and v tiles (this block's own), then one
// step per (query head of the GQA group, 64-row query tile): q and dO boxes
// shared with the pair as dq_produce's K and V, and this block's own copy
// of the step's 64 lse and delta values.
template <int D, int STAGES>
__device__ __forceinline__ void dkv_produce(const DkvSmem<D, STAGES>& sm,
                                            const CUtensorMap* tm_q, const CUtensorMap* tm_do,
                                            const CUtensorMap* tm_k, const CUtensorMap* tm_v,
                                            const float* lse, const float* delta, int k0,
                                            int kvh, int b, int group, int H, int Lq,
                                            int rank) {
  constexpr int BOXES = D / 64;
  constexpr uint16_t BOTH = (1 << ATT_PAIR) - 1;
  using S = DkvSmem<D, STAGES>;
  mbar_expect_tx(sm.kv_full, 2 * S::TILE);
  for (int c = 0; c < BOXES; ++c) {
    tma_load(sm.k + c * ATT_BOX, tm_k, sm.kv_full, 64 * c, k0, kvh, b);
    tma_load(sm.v + c * ATT_BOX, tm_v, sm.kv_full, 64 * c, k0, kvh, b);
  }
  const int n_qt = Lq / BWD_N;
  for (int i = 0; i < group * n_qt; ++i) {
    const int s = i % STAGES;
    const int hq = kvh * group + i / n_qt, row0 = (i % n_qt) * BWD_N;
    const long long stat = ((long long)b * H + hq) * Lq + row0;
    mbar_wait(&sm.empty[s], ((i / STAGES) & 1) ^ 1);
    mbar_expect_tx(&sm.full[s], 2 * (S::STEP + S::STATS));
    for (int box = rank; box < 2 * BOXES; box += ATT_PAIR) {
      const bool is_do = box >= BOXES;
      const int c = box % BOXES;
      tma_load_multicast((is_do ? sm.dout(s) : sm.q(s)) + c * BWD_BOX, is_do ? tm_do : tm_q,
                         &sm.full[s], BOTH, 64 * c, row0, hq, b);
    }
    bulk_load(sm.lse(s), lse + stat, S::STATS, &sm.full[s]);
    bulk_load(sm.delta(s), delta + stat, S::STATS, &sm.full[s]);
  }
}

// B5-dkv's step on s^T and dp^T (64 keys x 64 queries, fp32, unscaled k .
// q^T and v . dO^T): p^T = exp(s^T - lse) and ds^T = p^T (dp^T - delta) per
// query column, each as two register-A operands, hi and lo.
__device__ __forceinline__ void dkv_step(float (&s)[32], float (&dp)[32], const float* lse,
                                         const float* delta, uint32_t (&p_hi)[4][4],
                                         uint32_t (&p_lo)[4][4], uint32_t (&ds_hi)[4][4],
                                         uint32_t (&ds_lo)[4][4], float c, int tq) {
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const float2 ls = *reinterpret_cast<const float2*>(lse + 8 * j + 2 * tq);
    const float2 dl = *reinterpret_cast<const float2*>(delta + 8 * j + 2 * tq);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float x = (i & 1) ? ls.y : ls.x;
      const float p = exp2_approx(fmaf(s[4 * j + i], c, -x * LOG2E));
      s[4 * j + i] = p;
      dp[4 * j + i] = p * (dp[4 * j + i] - ((i & 1) ? dl.y : dl.x));
    }
  }
  split_hi_lo(s, p_hi, p_lo);
  split_hi_lo(dp, ds_hi, ds_lo);
}

// Kernel B5-dkv.
template <int D>
__global__ void __cluster_dims__(ATT_PAIR, 1, 1) __launch_bounds__(ATT_THREADS, 1)
attn_long_bwd_dkv_wgmma_kernel(const __grid_constant__ CUtensorMap tm_q,
                               const __grid_constant__ CUtensorMap tm_k,
                               const __grid_constant__ CUtensorMap tm_v,
                               const __grid_constant__ CUtensorMap tm_do,
                               const __grid_constant__ CUtensorMap tm_dk,
                               const __grid_constant__ CUtensorMap tm_dv,
                               const float* __restrict__ lse, const float* __restrict__ delta,
                               int group, int H, int Lq, int Lk, float scale) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const DkvSmem<D, DKV_STAGES> sm(smem_raw);
  const int k0 = blockIdx.x * ATT_M, kvh = blockIdx.y, b = blockIdx.z;
  const int n_steps = group * (Lq / BWD_N);
  if (threadIdx.x == 0) sm.init_barriers();
  cluster_sync();
  const int wg = threadIdx.x / 128;
  if (wg == 0) {
    setmaxnreg_dec<40>();
    if (threadIdx.x == 0)
      dkv_produce(sm, &tm_q, &tm_do, &tm_k, &tm_v, lse, delta, k0, kvh, b, group, H, Lq,
                  cluster_rank());
    cluster_sync();
  } else {
    setmaxnreg_inc<232>();
    const int cw = wg - 1, t = threadIdx.x % 128, lane = t % 32;
    unsigned char* k_rows = sm.k + cw * 64 * 128;
    unsigned char* v_rows = sm.v + cw * 64 * 128;
    const float c = scale * LOG2E;
    mbar_wait(sm.kv_full, 0);

    // two turns a step: s^T and dp^T, then (after the step's exp and
    // splits, beside the other warpgroup's products) dv += p^T . dO and
    // dk += ds^T . q, hi then lo; dk and dv stay in registers over the
    // GQA group's heads
    float dk[D / 2], dv[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) dk[i] = dv[i] = 0.f;
    float s[32], dp[32];
    uint32_t p_hi[4][4], p_lo[4][4], ds_hi[4][4], ds_lo[4][4];
    turns_start(cw);
    for (int i = 0; i < n_steps; ++i) {
      const int st = i % DKV_STAGES;
      mbar_wait(&sm.full[st], (i / DKV_STAGES) & 1);
      turn_begin(cw);
      wgmma_fence();
      bwd_scores_issue<D>(s, k_rows, sm.q(st));
      bwd_scores_issue<D>(dp, v_rows, sm.dout(st));
      wgmma_commit();
      turn_end(cw, false);
      wgmma_wait<0>();
      fence_regs(s);
      fence_regs(dp);
      dkv_step(s, dp, sm.lse(st), sm.delta(st), p_hi, p_lo, ds_hi, ds_lo, c, t % 4);
      turn_begin(cw);
      wgmma_fence();
      bwd_acc_issue<D>(dv, p_hi, sm.dout(st));
      bwd_acc_issue<D>(dv, p_lo, sm.dout(st));
      bwd_acc_issue<D>(dk, ds_hi, sm.q(st));
      bwd_acc_issue<D>(dk, ds_lo, sm.q(st));
      wgmma_commit();
      turn_end(cw, i == n_steps - 1);
      wgmma_wait<0>();
      fence_regs(dk);
      fence_regs(dv);
      fence_regs(p_hi);
      fence_regs(p_lo);
      fence_regs(ds_hi);
      fence_regs(ds_lo);
      release_slot(&sm.empty[st], lane);
    }
    // dk * scale and dv as bf16 into this warpgroup's rows of the k and v
    // tiles (no longer read), then stored by TMA
    const float one[2] = {1.f, 1.f};
    acc_to_swizzled<D>(k_rows, ATT_BOX, dk, one, t, scale);
    acc_to_swizzled<D>(v_rows, ATT_BOX, dv, one, t);
    fence_async_shared();
    named_barrier_sync(1 + cw, 128);
    const int row0 = k0 + 64 * cw;
    if (t == 0 && row0 < Lk) {
      for (int cc = 0; cc < D / 64; ++cc) {
        tma_store(&tm_dk, k_rows + cc * ATT_BOX, 64 * cc, row0, kvh, b);
        tma_store(&tm_dv, v_rows + cc * ATT_BOX, 64 * cc, row0, kvh, b);
      }
      tma_store_wait();
    }
    cluster_sync();
  }
}

// The backward kernels' operand roles on one tile, for the card test that
// pins them (`wgmma_bwd_tile_product` in ops/tensor_maps.py): x (128 x D) a
// resident tile by TMA with boxes of 128 rows, y (64 x D) a streamed tile
// with boxes of 64 rows; s = x[64:128] . y^T (64 x 64, y K-major, as k in
// B5-dq's scores and q, dO in B5-dkv's) and o = bf16(s) . y (64 x D, y
// MN-major from the same shared memory, as k in t . k and q, dO in ds^T . q
// and p^T . dO).
template <int D>
__global__ void __launch_bounds__(128)
wgmma_bwd_tile_kernel(const __grid_constant__ CUtensorMap tm_x,
                      const __grid_constant__ CUtensorMap tm_y, float* s_out, float* o_out) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* x = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  unsigned char* y = x + (D / 64) * ATT_BOX;
  uint64_t* bar = reinterpret_cast<uint64_t*>(y + (D / 64) * BWD_BOX);
  const int t = threadIdx.x;
  if (t == 0) {
    mbar_init(bar, 1);
    mbar_init_fence();
  }
  __syncthreads();
  if (t == 0) {
    mbar_expect_tx(bar, (D / 64) * (ATT_BOX + BWD_BOX));
    for (int c = 0; c < D / 64; ++c) {
      tma_load(x + c * ATT_BOX, &tm_x, bar, 64 * c, 0, 0, 0);
      tma_load(y + c * BWD_BOX, &tm_y, bar, 64 * c, 0, 0, 0);
    }
  }
  mbar_wait(bar, 0);
  float s[32];
  wgmma_fence();
  bwd_scores_issue<D>(s, x + 64 * 128, y);
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs(s);
  uint32_t p[4][4];
#pragma unroll
  for (int kb = 0; kb < 4; ++kb)
#pragma unroll
    for (int e = 0; e < 4; ++e) p[kb][e] = pack_bf16(s[8 * kb + 2 * e], s[8 * kb + 2 * e + 1]);
  float o[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
  wgmma_fence();
  bwd_acc_issue<D>(o, p, y);
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs(o);
  fence_regs(p);
  const int warp = t / 32, g = (t % 32) / 4, tq = t % 4;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = warp * 16 + g + 8 * (i >> 1), col = 2 * tq + (i & 1);
#pragma unroll
    for (int j = 0; j < 8; ++j) s_out[row * 64 + 8 * j + col] = s[4 * j + i];
#pragma unroll
    for (int j = 0; j < D / 8; ++j) o_out[row * D + 8 * j + col] = o[4 * j + i];
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

// Encode `n` tensor maps from the descriptions at `maps` (MAP_SPEC values
// each) of the operands at `bases`.
inline cudaError_t encode_maps(CUtensorMap* tm, const void* const* bases, const long long* maps,
                               int n) {
  for (int i = 0; i < n; ++i) {
    const cudaError_t err = encode_tensor_map(&tm[i], bases[i], maps + i * MAP_SPEC);
    if (err != cudaSuccess) return err;
  }
  return cudaSuccess;
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
  cudaError_t err = encode_maps(tm, bases, maps, 4);
  if (err != cudaSuccess) return err;
  const int smem = AttnSmem<D, LONG_STAGES>::BYTES;
  err = cudaFuncSetAttribute(
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

// B5-dq on the operands at `bases` that `maps` describes (q, k, v, dO, dq).
template <int D>
cudaError_t launch_dq_wgmma(const void* const bases[5], const long long* maps,
                            const void* delta, void* lse, int B, int H, int KVH, int Lq,
                            int Lk, float scale, cudaStream_t stream) {
  if (!spec_is(maps, D, Lq, H, B, ATT_M) || !spec_is(maps + MAP_SPEC, D, Lk, KVH, B, BWD_N) ||
      !spec_is(maps + 2 * MAP_SPEC, D, Lk, KVH, B, BWD_N) ||
      !spec_is(maps + 3 * MAP_SPEC, D, Lq, H, B, ATT_M) ||
      !spec_is(maps + 4 * MAP_SPEC, D, Lq, H, B, 64))
    return cudaErrorInvalidValue;
  CUtensorMap tm[5];
  cudaError_t err = encode_maps(tm, bases, maps, 5);
  if (err != cudaSuccess) return err;
  const int smem = DqSmem<D, DQ_STAGES>::BYTES;
  err = cudaFuncSetAttribute(attn_long_bwd_dq_wgmma_kernel<D>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const int tiles = Lq / ATT_M;  // whole pairs: a tile past Lq stores nothing
  const dim3 grid((tiles + ATT_PAIR - 1) / ATT_PAIR * ATT_PAIR, H, B);
  attn_long_bwd_dq_wgmma_kernel<D><<<grid, ATT_THREADS, smem, stream>>>(
      tm[0], tm[1], tm[2], tm[3], tm[4], static_cast<const float*>(delta),
      static_cast<float*>(lse), H / KVH, H, Lq, Lk, scale);
  return cudaGetLastError();
}

// B5-dkv on the operands at `bases` that `maps` describes (q, k, v, dO, dk,
// dv), then the row spans of lse and delta (ROWS_SPEC values each).
template <int D>
cudaError_t launch_dkv_wgmma(const void* const bases[6], const long long* maps,
                             const void* lse, const void* delta, int B, int H, int KVH,
                             int Lq, int Lk, float scale, cudaStream_t stream) {
  const long long* rows = maps + 6 * MAP_SPEC;
  if (!spec_is(maps, D, Lq, H, B, BWD_N) || !spec_is(maps + MAP_SPEC, D, Lk, KVH, B, ATT_M) ||
      !spec_is(maps + 2 * MAP_SPEC, D, Lk, KVH, B, ATT_M) ||
      !spec_is(maps + 3 * MAP_SPEC, D, Lq, H, B, BWD_N) ||
      !spec_is(maps + 4 * MAP_SPEC, D, Lk, KVH, B, 64) ||
      !spec_is(maps + 5 * MAP_SPEC, D, Lk, KVH, B, 64) ||
      !rows_spec_is(rows, Lq, H, B, BWD_N) || !rows_spec_is(rows + ROWS_SPEC, Lq, H, B, BWD_N) ||
      reinterpret_cast<uintptr_t>(lse) % 16 || reinterpret_cast<uintptr_t>(delta) % 16)
    return cudaErrorInvalidValue;
  CUtensorMap tm[6];
  cudaError_t err = encode_maps(tm, bases, maps, 6);
  if (err != cudaSuccess) return err;
  const int smem = DkvSmem<D, DKV_STAGES>::BYTES;
  err = cudaFuncSetAttribute(attn_long_bwd_dkv_wgmma_kernel<D>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const int tiles = Lk / ATT_M;  // whole pairs: a tile past Lk stores nothing
  const dim3 grid((tiles + ATT_PAIR - 1) / ATT_PAIR * ATT_PAIR, KVH, B);
  attn_long_bwd_dkv_wgmma_kernel<D><<<grid, ATT_THREADS, smem, stream>>>(
      tm[0], tm[1], tm[2], tm[3], tm[4], tm[5], static_cast<const float*>(lse),
      static_cast<const float*>(delta), H / KVH, H, Lq, Lk, scale);
  return cudaGetLastError();
}

bool bad_long_shape(int B, int H, int KVH, int Lq, int Lk, int D, bool bias,
                    const void* bias_ptr) {
  return bad_shape(B, H, KVH, Lq, Lk) || Lq % ALIGN || Lk % ALIGN ||
         (D != 64 && D != 128) || (bias && bias_ptr == nullptr);
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

// B5-dq: dq (B, H, Lq, D) bf16 and lse. `maps`: the descriptions of q (boxes
// of 128 rows), k, v (64 rows), dO (128 rows) and dq (64 rows).
extern "C" int mmada_flash_attention_long_bwd_dq_bf16(
    const void* q, const void* k, const void* v, const void* dout,
    const void* delta, void* dq, void* lse, int B, int H, int KVH, int Lq,
    int Lk, int D, const long long* maps, float scale, void* stream) {
  if (bad_long_shape(B, H, KVH, Lq, Lk, D, false, nullptr)) return (int)cudaErrorInvalidValue;
  const void* bases[5] = {q, k, v, dout, dq};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return D == 128 ? (int)launch_dq_wgmma<128>(bases, maps, delta, lse, B, H, KVH, Lq, Lk,
                                              scale, s)
                  : (int)launch_dq_wgmma<64>(bases, maps, delta, lse, B, H, KVH, Lq, Lk,
                                             scale, s);
}

// B5-dq-bias: strides = [q, k, v, dO, dq, bias] x 3.
extern "C" int mmada_flash_attention_long_bwd_dq_bias_bf16(
    const void* q, const void* k, const void* v, const void* dout,
    const void* delta, const void* bias, void* dq, void* lse, int B, int H,
    int KVH, int Lq, int Lk, int D, const long long* strides, float scale,
    void* stream) {
  if (bad_long_shape(B, H, KVH, Lq, Lk, D, true, bias)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return D == 128 ? (int)launch_dq<128, true>(q, k, v, dout, delta, bias, dq, lse, B, H, KVH,
                                              Lq, Lk, strides, scale, s)
                  : (int)launch_dq<64, true>(q, k, v, dout, delta, bias, dq, lse, B, H, KVH,
                                             Lq, Lk, strides, scale, s);
}

// B5-dkv: dk, dv (B, KVH, Lk, D) bf16. `maps`: the descriptions of q (boxes
// of 64 rows), k, v (128 rows), dO (64 rows), dk and dv (64 rows), then the
// 64-row spans of lse and delta.
extern "C" int mmada_flash_attention_long_bwd_dkv_bf16(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* delta, void* dk, void* dv, int B, int H,
    int KVH, int Lq, int Lk, int D, const long long* maps, float scale,
    void* stream) {
  if (bad_long_shape(B, H, KVH, Lq, Lk, D, false, nullptr)) return (int)cudaErrorInvalidValue;
  const void* bases[6] = {q, k, v, dout, dk, dv};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return D == 128 ? (int)launch_dkv_wgmma<128>(bases, maps, lse, delta, B, H, KVH, Lq, Lk,
                                               scale, s)
                  : (int)launch_dkv_wgmma<64>(bases, maps, lse, delta, B, H, KVH, Lq, Lk,
                                              scale, s);
}

// B5-dkv-bias: strides = [q, k, v, dO, dk, dv, bias] x 3.
extern "C" int mmada_flash_attention_long_bwd_dkv_bias_bf16(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* delta, const void* bias, void* dk, void* dv,
    int B, int H, int KVH, int Lq, int Lk, int D, const long long* strides,
    float scale, void* stream) {
  if (bad_long_shape(B, H, KVH, Lq, Lk, D, true, bias)) return (int)cudaErrorInvalidValue;
  return dispatch_dkv<true, true>(q, k, v, dout, lse, delta, bias, dk, dv, B, H, KVH, Lq, Lk,
                                  D, strides, scale, stream);
}

// The tile product of wgmma_bwd_tile_kernel, for the card test: x (128 x D),
// y (64 x D) bf16 as `maps` describes them (boxes of 128 and 64 rows);
// s_out (64 x 64) and o_out (64 x D) fp32, contiguous. D 64 or 128.
extern "C" int mmada_wgmma_bwd_tile_bf16(const void* x, const void* y, void* s_out, void* o_out,
                                         int D, const long long* maps, void* stream) {
  if ((D != 64 && D != 128) || !spec_is(maps, D, 128, 1, 1, ATT_M) ||
      !spec_is(maps + MAP_SPEC, D, 64, 1, 1, BWD_N))
    return (int)cudaErrorInvalidValue;
  const void* bases[2] = {x, y};
  CUtensorMap tm[2];
  cudaError_t err = encode_maps(tm, bases, maps, 2);
  if (err != cudaSuccess) return (int)err;
  const int smem = (D / 64) * (ATT_BOX + BWD_BOX) + 8 + 1024;
  auto kernel = D == 128 ? wgmma_bwd_tile_kernel<128> : wgmma_bwd_tile_kernel<64>;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<1, 128, smem, static_cast<cudaStream_t>(stream)>>>(
      tm[0], tm[1], static_cast<float*>(s_out), static_cast<float*>(o_out));
  return (int)cudaGetLastError();
}
