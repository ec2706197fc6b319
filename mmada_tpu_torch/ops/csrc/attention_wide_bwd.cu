// Kernel B8's tensor-core body ("wgmma"), for Hopper (sm_90a): the attention
// backward (B8-dq, B8-dkv) on bf16 operands at the head widths 16-256 other
// than 64 and 128, both tiers, without a bias and with one. This file holds
// its instance of 256 columns (real widths 144-256); the instances of 64
// and 128 columns are B3's and B5's kernels as they are (the entries of
// flash_attention_bwd.cu and flash_attention_long.cu take a narrower D).
//
// It stands for the TPU kernels that B8's ffma body (attention_generic.cu)
// stands for where B3 / B5 do not reach, mmada_tpu/ops/flash_attention.py's
// dq bodies `_attn_bwd_dq_kernel` / `_attn_bwd_dq_bias_kernel` (:719, :746,
// called at :895) and the staged `:1018` / `:1062` (called at :1185), and
// the dkv bodies `_attn_bwd_dkv_kernel` / `_attn_bwd_dkv_bias_kernel` (:753,
// :799, called at :963) and the staged `:1070` / `:1110` (called at :1240).
// `flash_attention.generic_body(dtype, D)` sends a call here.
//
// The function is exactly B3's (ONE_PASS) and B5's at D 128
// (flash_attention_bwd_wgmma.cuh:8-31): q and k rotated, s = (q . k^T) *
// scale in fp32 (+ the fp32 bias as round(round(s * scale) + bias)); the
// one-pass dq takes p = exp(s - m) / l from a first walk and rounds p and ds
// to bf16 once to enter the tensor cores, the long dq is online (the
// accumulator rescaled by exp(m - m'), divided by max(l, 1e-30) last) and
// enters every fp32 left operand as hi + lo; dkv takes p = exp(s - lse),
// one bf16 value (one-pass) or hi + lo (long). A width d below 256 runs
// through it zero-filled as B7's wgmma body does (attention_wide.cu:35-40):
// the tensor maps keep the real d with 64-column boxes, TMA fills the
// columns past d with zeros, the stores drop them, a box wholly past d is
// never loaded and its shared memory is zeroed once; the scale is
// 1/sqrt(d). The bias is read from global memory into the scores (keys
// past Lk at -inf in dq; query columns past Lq at p = ds = 0 in dkv).
//
// Budget at D 256 (a block may have 232,448 bytes of shared memory; a
// consumer thread 232 registers after setmaxnreg):
//
//   dq: B3's layout keeps a resident 128-row q tile and dO tile (64 KB
//   each) and streams K + V stages; a stage of 64 keys is 64 KB, so two
//   stages (256 KB in all) do not fit. So the stages hold 32 keys (K + V
//   32 KB) and the ring three of them: 128 + 96 KB = 224 KB, 230,456 bytes
//   with the barriers and the 1,024-byte alignment. Registers: the
//   accumulator 64 x 256 fp32 is 128 a thread, s and dp (64 x 32) 16 each,
//   ds packed 8 (long: hi + lo, 16): about 180 with the row statistics and
//   addresses, where 64-key stages would need 208-224. Each warpgroup owns
//   64 query rows, issues its products in turns with the other (B3's
//   ping-pong), pipelined by one stage as B3: the turn of stage j issues acc
//   += ds_{j-1} . K_{j-1} (m64n256k16, ds from registers) and s_j, dp_j
//   (m64n32k16 from shared memory).
//
//   dkv: B3's dkv holds dk and dv of 64 keys x D a warpgroup: at D 256 that
//   is 256 registers a thread. Here the block owns 64 keys and its two
//   consumer warpgroups split the 256 output columns of dk and dv (64 +
//   64 registers each). A step (64 queries of one query head) goes:
//   each warpgroup forms s^T and dp^T of the 64 keys and its half of the
//   queries (m64n32k16, K-major k, v against the q, dO stage), then p^T and
//   ds^T in fp32 from the stage's lse and delta; both write their halves as
//   bf16 (long: hi and lo) into exchange tiles of 64 x 64 in shared memory
//   with the 128-byte swizzle, meet at a named barrier, and issue dv +=
//   p^T . dO and dk += ds^T . q for their 128 columns as shared-memory
//   wgmma (m64n128k16, the stage's dO and q MN-major). That is the bound's
//   4 units of L x L x D (6 in the long tier, with the lo halves) and no
//   recomputed score. Shared memory: k and v resident (32 KB each), two
//   stages of q + dO (64 KB each), the exchange tiles (16 KB; long 32 KB)
//   and the lse / delta spans: 231,464 bytes in the long tier. The two
//   warpgroups run in step (two barriers a step), not in turns.
//
// Keep each commit-to-wait region straight-line code: ptxas serialises every
// wgmma of a kernel that has one under a runtime condition (C7520).

#include "flash_attention_bwd_wgmma.cuh"

namespace {

constexpr int WD = 256;            // the instance's width
constexpr int WDQ_STAGES = 3;
constexpr int WDKV_STAGES = 2;
constexpr int XCHG_BAR = 5;        // the dkv warpgroups' named barrier (1-4: turns, epilogues)

// Zero the 64-column boxes at or past nb (wholly past the real width) of
// `tiles` tiles of `box` bytes a box, `stride` bytes apart from `first`: TMA
// never writes them, so the zeros last. All threads, before the first load.
__device__ __forceinline__ void zero_boxes(unsigned char* first, int tiles, int stride, int box,
                                           int nb) {
  const uint4 zero = make_uint4(0, 0, 0, 0);
  for (int i = 0; i < tiles; ++i)
    for (int c = nb; c < WD / 64; ++c) {
      uint4* p = reinterpret_cast<uint4*>(first + i * stride + c * box);
      for (int e = threadIdx.x; e < box / 16; e += ATT_THREADS) p[e] = zero;
    }
  fence_async_shared();  // before the wgmma (async proxy) reads them
}

// The fp32 bias plane of one (batch, head): its row stride in elements.
struct BiasRows {
  const float* p;
  long long sq;
};

// ------------------------------------------------------------------- dq

// Shared memory of the dq kernel: the resident q and dO tiles (128 rows, four
// boxes of ATT_BOX), then WDQ_STAGES stages of a K and a V tile of 32 keys
// (four boxes of WKBOX each), then the barriers.
struct WideDqSmem {
  static constexpr int TILE = ATT_M * WD * 2;
  static constexpr int STEP = WKN * WD * 2;
  static constexpr int BYTES =
      2 * TILE + 2 * WDQ_STAGES * STEP + 8 * (1 + 2 * WDQ_STAGES) + 1024;
  unsigned char* q;
  unsigned char* dout;
  uint64_t* q_full;
  uint64_t* full;
  uint64_t* empty;

  __device__ explicit WideDqSmem(unsigned char* raw) {
    q = reinterpret_cast<unsigned char*>(
        (reinterpret_cast<uintptr_t>(raw) + 1023) & ~static_cast<uintptr_t>(1023));
    dout = q + TILE;
    q_full = reinterpret_cast<uint64_t*>(q + 2 * TILE + 2 * WDQ_STAGES * STEP);
    full = q_full + 1;
    empty = full + WDQ_STAGES;
  }

  __device__ unsigned char* k(int s) const { return q + 2 * TILE + s * STEP; }
  __device__ unsigned char* v(int s) const { return q + 2 * TILE + (WDQ_STAGES + s) * STEP; }

  __device__ void init_barriers() const {
    mbar_init(q_full, 1);
    for (int s = 0; s < WDQ_STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 8 * ATT_PAIR);
    }
    mbar_init_fence();
  }

  __device__ void zero(int nb) const {
    if (nb >= WD / 64) return;
    zero_boxes(q, 2, TILE, ATT_BOX, nb);
    zero_boxes(k(0), 2 * WDQ_STAGES, STEP, WKBOX, nb);
  }
};

// The dq producer thread: the q and dO tiles' nb boxes, then n1 stages of a K
// tile alone (the one-pass tier's first walk) and n2 of K and V, stage i of
// keys WKN * (i or i - n1); of a stage's boxes (K's nb, then V's) this block
// issues those of index `rank` modulo the pair, to both blocks.
__device__ __forceinline__ void wide_dq_produce(const WideDqSmem& sm, const CUtensorMap* tm_q,
                                                const CUtensorMap* tm_do, const CUtensorMap* tm_k,
                                                const CUtensorMap* tm_v, int q0, int h, int kvh,
                                                int b, int nb, int n1, int n2, int rank) {
  constexpr uint16_t BOTH = (1 << ATT_PAIR) - 1;
  mbar_expect_tx(sm.q_full, 2 * nb * ATT_BOX);
  for (int c = 0; c < nb; ++c) {
    tma_load(sm.q + c * ATT_BOX, tm_q, sm.q_full, 64 * c, q0, h, b);
    tma_load(sm.dout + c * ATT_BOX, tm_do, sm.q_full, 64 * c, q0, h, b);
  }
  for (int i = 0; i < n1 + n2; ++i) {
    const int s = i % WDQ_STAGES;
    const bool with_v = i >= n1;
    const int key0 = (with_v ? i - n1 : i) * WKN;
    mbar_wait(&sm.empty[s], ((i / WDQ_STAGES) & 1) ^ 1);
    mbar_expect_tx(&sm.full[s], (with_v ? 2 : 1) * nb * WKBOX);
    for (int box = rank; box < (with_v ? 2 : 1) * nb; box += ATT_PAIR) {
      const bool is_v = box >= nb;
      const int c = is_v ? box - nb : box;
      tma_load_multicast((is_v ? sm.v(s) : sm.k(s)) + c * WKBOX, is_v ? tm_v : tm_k,
                         &sm.full[s], BOTH, 64 * c, key0, kvh, b);
    }
  }
}

// A stage's scores in place: with a bias x = round(round(s * scale) +
// bias) (query rows `row`, row + 8; keys key0 + 8j + 2tq, +1; natural
// units), without one s as it is (the caller's log2 units); keys past Lk
// at -inf.
template <bool BIAS>
__device__ __forceinline__ void dq_scores(float (&s)[16], const BiasRows& bias, int row, int key0,
                                          int Lq, int Lk, int tq, float scale) {
  if constexpr (BIAS) {
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = row + 8 * (i >> 1), key = key0 + 8 * j + 2 * tq + (i & 1);
        float x = __fmul_rn(s[4 * j + i], scale);
        if (r < Lq && key < Lk) x = __fadd_rn(x, __ldg(bias.p + r * bias.sq + key));
        s[4 * j + i] = x;
      }
  }
  mask_keys(s, key0, Lk, tq);
}

// Kernel B8-dq, wgmma body at D 256: one block per (128-row query tile,
// head, batch), pairs of neighbouring tiles in a cluster sharing each K / V
// stage. nb: the 64-column boxes the real width covers; bias: the fp32
// bias's base (null without one), bsb / bsh / bsq its batch, head and row
// strides in elements (0 on a broadcast axis).
template <bool BIAS, bool ONE_PASS>
__global__ void __cluster_dims__(ATT_PAIR, 1, 1) __launch_bounds__(ATT_THREADS, 1)
attn_wide_dq_wgmma_kernel(const __grid_constant__ CUtensorMap tm_q,
                    const __grid_constant__ CUtensorMap tm_k,
                    const __grid_constant__ CUtensorMap tm_v,
                    const __grid_constant__ CUtensorMap tm_do,
                    const __grid_constant__ CUtensorMap tm_dq, const float* __restrict__ bias,
                    long long bsb, long long bsh, long long bsq,
                    const float* __restrict__ delta, float* __restrict__ lse, int rep, int H,
                    int Lq, int Lk, int nb, float scale) {
  constexpr int S = WDQ_STAGES;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const WideDqSmem sm(smem_raw);
  const int q0 = blockIdx.x * ATT_M, h = blockIdx.y, b = blockIdx.z;
  const int n_tiles = (Lk + WKN - 1) / WKN;
  const int n1 = ONE_PASS ? n_tiles : 0;  // the first walk's K-only stages
  if (threadIdx.x == 0) sm.init_barriers();
  sm.zero(nb);
  cluster_sync();  // the pair's barriers and zeros are ready before any load or arrival
  const int wg = threadIdx.x / 128;
  if (wg == 0) {
    setmaxnreg_dec<40>();
    if (threadIdx.x == 0)
      wide_dq_produce(sm, &tm_q, &tm_do, &tm_k, &tm_v, q0, h, h / rep, b, nb, n1, n_tiles,
                      cluster_rank());
    cluster_sync();  // the pair's last multicasts and arrivals are done
    return;
  }
  setmaxnreg_inc<232>();
  const int cw = wg - 1, t = threadIdx.x % 128, lane = t % 32, tq = lane % 4;
  unsigned char* q_rows = sm.q + cw * 64 * 128;
  const unsigned char* do_rows = sm.dout + cw * 64 * 128;
  const int row0 = q0 + 64 * cw, row = row0 + (t / 32) * 16 + lane / 4;  // this thread's rows
  const BiasRows br{BIAS ? bias + b * bsb + h * bsh : nullptr, bsq};
  const float c = scale * LOG2E;  // unbiased: scores in log2 units, as B3 / B5
  const long long stat0 = ((long long)b * H + h) * Lq;
  float dl[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) dl[r] = row + 8 * r < Lq ? delta[stat0 + row + 8 * r] : 0.f;
  turns_start(cw);
  mbar_wait(sm.q_full, 0);

  float m[2] = {NEG_F32, NEG_F32}, l[2] = {0.f, 0.f}, inv[2] = {1.f, 1.f};
  float s[16], dp[16];
  if constexpr (ONE_PASS) {
    // the first walk (B3's pass 1): the row max m (log2 units; with a bias
    // natural units, on x) and this thread's part of the row sum l
    for (int j = 0; j < n1; ++j) {
      const int st = j % S;
      mbar_wait(&sm.full[st], (j / S) & 1);
      turn_begin(cw);
      wgmma_fence();
      scores32_issue<WD, ATT_BOX, WKBOX>(s, q_rows, sm.k(st));
      wgmma_commit();
      turn_end(cw, false);
      wgmma_wait<0>();
      fence_regs(s);
      release_slot(&sm.empty[st], lane);
      dq_scores<BIAS>(s, br, row, j * WKN, Lq, Lk, tq, scale);
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        float sum = 0.f;
        if constexpr (BIAS) {
          const float m_new = fmaxf(m[r], row_max(s, r));
#pragma unroll
          for (int n = 0; n < 4; ++n)
            sum += exp2_approx(__fmul_rn(s[4 * n + 2 * r] - m_new, LOG2E)) +
                   exp2_approx(__fmul_rn(s[4 * n + 2 * r + 1] - m_new, LOG2E));
          l[r] = l[r] * exp2_approx(__fmul_rn(m[r] - m_new, LOG2E)) + sum;
          m[r] = m_new;
        } else {
          const float m_new = fmaxf(m[r], row_max(s, r) * c);
#pragma unroll
          for (int n = 0; n < 4; ++n)
            sum += exp2_approx(fmaf(s[4 * n + 2 * r], c, -m_new)) +
                   exp2_approx(fmaf(s[4 * n + 2 * r + 1], c, -m_new));
          l[r] = l[r] * exp2_approx(m[r] - m_new) + sum;
          m[r] = m_new;
        }
      }
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l[r] = quad_sum(l[r]);
      inv[r] = __frcp_rn(l[r]);
    }
  }

  float acc[WD / 2];
#pragma unroll
  for (int i = 0; i < WD / 2; ++i) acc[i] = 0.f;
  uint32_t hi[2][4], lo[2][4];
  // stage j's step on s and dp: the one-pass tier's ds = p (dp - delta) with
  // p = exp(s - m) / l (the division as B3's: a multiply by the correctly
  // rounded reciprocal and one FMA correction), rounded once to bf16; the
  // long tier's online step (B5-dq's dq_step): the new max, acc rescaled, t =
  // p (dp - delta) as hi + lo
  auto step = [&](int j) {
    dq_scores<BIAS>(s, br, row, j * WKN, Lq, Lk, tq, scale);
    if constexpr (ONE_PASS) {
#pragma unroll
      for (int i = 0; i < 16; ++i) {
        const int r = (i >> 1) & 1;
        const float ex = BIAS ? exp2_approx(__fmul_rn(s[i] - m[r], LOG2E))
                              : exp2_approx(fmaf(s[i], c, -m[r]));
        const float y = ex * inv[r];
        s[i] = fmaf(inv[r], fmaf(-y, l[r], ex), y) * (dp[i] - dl[r]);
      }
      pack32<false>(s, hi, lo);
    } else {
      float a[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        float m_new;
        if constexpr (BIAS) {
          m_new = fmaxf(m[r], row_max(s, r));
          a[r] = exp2f(__fmul_rn(m[r] - m_new, LOG2E));
        } else {
          m_new = fmaxf(m[r], row_max(s, r) * c);
          a[r] = exp2f(m[r] - m_new);
        }
        m[r] = m_new;
        float sum = 0.f;
#pragma unroll
        for (int n = 0; n < 4; ++n)
#pragma unroll
          for (int u = 0; u < 2; ++u) {
            const int i = 4 * n + 2 * r + u;
            const float p = BIAS ? exp2_approx(__fmul_rn(s[i] - m_new, LOG2E))
                                 : exp2_approx(fmaf(s[i], c, -m_new));
            sum += p;
            s[i] = p * (dp[i] - dl[r]);
          }
        l[r] = l[r] * a[r] + sum;
      }
#pragma unroll
      for (int n = 0; n < WD / 8; ++n) {
        acc[4 * n] *= a[0];
        acc[4 * n + 1] *= a[0];
        acc[4 * n + 2] *= a[1];
        acc[4 * n + 3] *= a[1];
      }
      pack32<true>(s, hi, lo);
    }
  };

  // the second walk (the long tier's only one), pipelined by one stage
  {
    const int st = n1 % S;
    mbar_wait(&sm.full[st], (n1 / S) & 1);
    turn_begin(cw);
    wgmma_fence();
    scores32_issue<WD, ATT_BOX, WKBOX>(s, q_rows, sm.k(st));
    scores32_issue<WD, ATT_BOX, WKBOX>(dp, do_rows, sm.v(st));
    wgmma_commit();
    turn_end(cw, false);
    wgmma_wait<0>();
    fence_regs(s);
    fence_regs(dp);
  }
  step(0);
  for (int j = 1; j < n_tiles; ++j) {
    const int i = n1 + j, st = i % S, prev = (i - 1) % S;
    mbar_wait(&sm.full[st], (i / S) & 1);
    turn_begin(cw);
    wgmma_fence();
    acc32_issue(acc, hi, sm.k(prev));
    if constexpr (!ONE_PASS) acc32_issue(acc, lo, sm.k(prev));
    scores32_issue<WD, ATT_BOX, WKBOX>(s, q_rows, sm.k(st));
    scores32_issue<WD, ATT_BOX, WKBOX>(dp, do_rows, sm.v(st));
    wgmma_commit();
    turn_end(cw, false);
    wgmma_wait<0>();
    fence_regs(acc);
    fence_regs(s);
    fence_regs(dp);
    fence_regs(hi);
    if constexpr (!ONE_PASS) fence_regs(lo);
    release_slot(&sm.empty[prev], lane);
    step(j);
  }
  const int last = (n1 + n_tiles - 1) % S;
  turn_begin(cw);
  wgmma_fence();
  acc32_issue(acc, hi, sm.k(last));
  if constexpr (!ONE_PASS) acc32_issue(acc, lo, sm.k(last));
  wgmma_commit();
  turn_end(cw, true);
  wgmma_wait<0>();
  fence_regs(acc);
  fence_regs(hi);
  if constexpr (!ONE_PASS) fence_regs(lo);
  release_slot(&sm.empty[last], lane);

  // the one-pass p is normalised already; the long tier divides last
  float div[2] = {1.f, 1.f};
  if constexpr (!ONE_PASS) {
    div[0] = fmaxf(quad_sum(l[0]), 1e-30f);
    div[1] = fmaxf(quad_sum(l[1]), 1e-30f);
  }
  // bf16 dq * scale into this warpgroup's rows of the q tile (no longer
  // read), one TMA store per box the real width reaches
  acc_to_swizzled<WD>(q_rows, ATT_BOX, acc, div, t, scale);
  fence_async_shared();
  named_barrier_sync(1 + cw, 128);
  if (t == 0 && row0 < Lq) {
    for (int cc = 0; cc < nb; ++cc) tma_store(&tm_dq, q_rows + cc * ATT_BOX, 64 * cc, row0, h, b);
    tma_store_wait();
  }
  if (t % 4 == 0) {
#pragma unroll
    for (int r = 0; r < 2; ++r)
      if (row + 8 * r < Lq)
        lse[stat0 + row + 8 * r] = (BIAS ? m[r] : m[r] * LN2) + logf(ONE_PASS ? l[r] : div[r]);
  }
  cluster_sync();
}

// ------------------------------------------------------------------ dkv

// Shared memory of the dkv kernel: the resident k and v tiles (64 keys, four
// boxes of STEP_BOX), WDKV_STAGES stages of a q and a dO tile (64 queries),
// the exchange tiles (64 keys x 64 queries bf16, one swizzled box each: p^T
// and ds^T, then in the long tier their lo halves), the stages' lse and delta
// spans, then the barriers.
template <bool ONE_PASS>
struct WideDkvSmem {
  static constexpr int TILE = STEP_N * WD * 2;
  static constexpr int XT = STEP_N * 128;
  static constexpr int XTILES = ONE_PASS ? 2 : 4;
  static constexpr int STATS = STEP_N * 4;
  static constexpr int BYTES = (2 + 2 * WDKV_STAGES) * TILE + XTILES * XT +
                               2 * WDKV_STAGES * STATS + 8 * (1 + 2 * WDKV_STAGES) + 1024;
  unsigned char* k;
  uint64_t* kv_full;
  uint64_t* full;
  uint64_t* empty;

  __device__ explicit WideDkvSmem(unsigned char* raw) {
    k = reinterpret_cast<unsigned char*>(
        (reinterpret_cast<uintptr_t>(raw) + 1023) & ~static_cast<uintptr_t>(1023));
    kv_full = reinterpret_cast<uint64_t*>(lse(0) + 2 * WDKV_STAGES * STEP_N);
    full = kv_full + 1;
    empty = full + WDKV_STAGES;
  }

  __device__ unsigned char* v() const { return k + TILE; }
  __device__ unsigned char* q(int s) const { return k + (2 + s) * TILE; }
  __device__ unsigned char* dout(int s) const { return k + (2 + WDKV_STAGES + s) * TILE; }
  // exchange tile x: 0 p^T, 1 ds^T (their bf16 roundings), 2 and 3 the rest
  __device__ unsigned char* xchg(int x) const {
    return k + (2 + 2 * WDKV_STAGES) * TILE + x * XT;
  }
  __device__ float* lse(int s) const {
    return reinterpret_cast<float*>(xchg(XTILES)) + s * STEP_N;
  }
  __device__ float* delta(int s) const { return lse(WDKV_STAGES + s); }

  __device__ void init_barriers() const {
    mbar_init(kv_full, 1);
    for (int s = 0; s < WDKV_STAGES; ++s) {
      mbar_init(&full[s], 1 + 32);  // the TMA thread and the stats warp's lanes
      mbar_init(&empty[s], 8 * ATT_PAIR);
    }
    mbar_init_fence();
  }

  __device__ void zero(int nb) const {
    if (nb >= WD / 64) return;
    zero_boxes(k, 2 + 2 * WDKV_STAGES, TILE, STEP_BOX, nb);
  }
};

// The dkv producer thread: the k and v tiles' nb boxes (this block's own),
// then one stage per (query head of the GQA group, 64-row query tile): the q
// and dO boxes, shared with the pair as wide_dq_produce's.
template <bool ONE_PASS>
__device__ __forceinline__ void wide_dkv_produce(const WideDkvSmem<ONE_PASS>& sm,
                                                 const CUtensorMap* tm_q, const CUtensorMap* tm_do,
                                                 const CUtensorMap* tm_k, const CUtensorMap* tm_v,
                                                 int k0, int kvh, int b, int group, int n_qt,
                                                 int nb, int rank) {
  constexpr uint16_t BOTH = (1 << ATT_PAIR) - 1;
  mbar_expect_tx(sm.kv_full, 2 * nb * STEP_BOX);
  for (int c = 0; c < nb; ++c) {
    tma_load(sm.k + c * STEP_BOX, tm_k, sm.kv_full, 64 * c, k0, kvh, b);
    tma_load(sm.v() + c * STEP_BOX, tm_v, sm.kv_full, 64 * c, k0, kvh, b);
  }
  for (int i = 0; i < group * n_qt; ++i) {
    const int s = i % WDKV_STAGES;
    const int hq = kvh * group + i / n_qt, row0 = (i % n_qt) * STEP_N;
    mbar_wait(&sm.empty[s], ((i / WDKV_STAGES) & 1) ^ 1);
    mbar_expect_tx(&sm.full[s], 2 * nb * STEP_BOX);
    for (int box = rank; box < 2 * nb; box += ATT_PAIR) {
      const bool is_do = box >= nb;
      const int c = is_do ? box - nb : box;
      tma_load_multicast((is_do ? sm.dout(s) : sm.q(s)) + c * STEP_BOX, is_do ? tm_do : tm_q,
                         &sm.full[s], BOTH, 64 * c, row0, hq, b);
    }
  }
}

// The stats warp (warp 1 of the producer warpgroup, B3's dkv_stats): each
// stage's 64 lse and delta values by ordinary loads, lse = +inf and delta = 0
// for query rows at or past Lq (so p = 0 and ds = 0 there), then one arrival
// per lane on the stage's full barrier.
template <bool ONE_PASS>
__device__ __forceinline__ void wide_dkv_stats(const WideDkvSmem<ONE_PASS>& sm, const float* lse,
                                               const float* delta, int kvh, int b, int group,
                                               int H, int Lq, int n_qt, int lane) {
  for (int i = 0; i < group * n_qt; ++i) {
    const int s = i % WDKV_STAGES;
    const int hq = kvh * group + i / n_qt, row0 = (i % n_qt) * STEP_N;
    const long long stat = ((long long)b * H + hq) * Lq + row0;
    mbar_wait(&sm.empty[s], ((i / WDKV_STAGES) & 1) ^ 1);
#pragma unroll
    for (int e = lane; e < STEP_N; e += 32) {
      const bool live = row0 + e < Lq;
      sm.lse(s)[e] = live ? lse[stat + e] : INFINITY;
      sm.delta(s)[e] = live ? delta[stat + e] : 0.f;
    }
    mbar_arrive(&sm.full[s]);
  }
}

// Kernel B8-dkv, wgmma body at D 256: one block per (64-key tile, kv head,
// batch), pairs of neighbouring key tiles in a cluster sharing each q / dO
// stage; the consumer warpgroup cw owns the output columns 128 cw.. of dk
// and dv. Arguments as attn_wide_dq_wgmma_kernel's; group: query heads per kv head.
template <bool BIAS, bool ONE_PASS>
__global__ void __cluster_dims__(ATT_PAIR, 1, 1) __launch_bounds__(ATT_THREADS, 1)
attn_wide_dkv_wgmma_kernel(const __grid_constant__ CUtensorMap tm_q,
                     const __grid_constant__ CUtensorMap tm_k,
                     const __grid_constant__ CUtensorMap tm_v,
                     const __grid_constant__ CUtensorMap tm_do,
                     const __grid_constant__ CUtensorMap tm_dk,
                     const __grid_constant__ CUtensorMap tm_dv, const float* __restrict__ bias,
                     long long bsb, long long bsh, long long bsq, const float* __restrict__ lse,
                     const float* __restrict__ delta, int group, int H, int Lq, int Lk, int nb,
                     float scale) {
  constexpr int S = WDKV_STAGES;
  using Smem = WideDkvSmem<ONE_PASS>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const Smem sm(smem_raw);
  const int k0 = blockIdx.x * STEP_N, kvh = blockIdx.y, b = blockIdx.z;
  const int n_qt = (Lq + STEP_N - 1) / STEP_N, n_steps = group * n_qt;
  if (threadIdx.x == 0) sm.init_barriers();
  sm.zero(nb);
  cluster_sync();
  const int wg = threadIdx.x / 128;
  if (wg == 0) {
    setmaxnreg_dec<40>();
    if (threadIdx.x == 0)
      wide_dkv_produce(sm, &tm_q, &tm_do, &tm_k, &tm_v, k0, kvh, b, group, n_qt, nb,
                       cluster_rank());
    else if (threadIdx.x / 32 == 1)
      wide_dkv_stats(sm, lse, delta, kvh, b, group, H, Lq, n_qt, threadIdx.x % 32);
    cluster_sync();
    return;
  }
  setmaxnreg_inc<232>();
  const int cw = wg - 1, t = threadIdx.x % 128, lane = t % 32, tq = lane % 4;
  const int krow = (t / 32) * 16 + lane / 4;  // this thread's first key row of the tile
  const float c = scale * LOG2E;
  mbar_wait(sm.kv_full, 0);

  float dk[WD / 4], dv[WD / 4];  // 64 keys x this warpgroup's 128 columns
#pragma unroll
  for (int i = 0; i < WD / 4; ++i) dk[i] = dv[i] = 0.f;
  float s[16], dp[16];
  for (int i = 0; i < n_steps; ++i) {
    const int st = i % S;
    mbar_wait(&sm.full[st], (i / S) & 1);
    // s^T and dp^T: the 64 keys x this warpgroup's 32 queries (32 cw..)
    wgmma_fence();
    scores32_issue<WD, STEP_BOX, STEP_BOX>(s, sm.k, sm.q(st) + cw * 32 * 128);
    scores32_issue<WD, STEP_BOX, STEP_BOX>(dp, sm.v(), sm.dout(st) + cw * 32 * 128);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(s);
    fence_regs(dp);
    // p^T = exp(s^T - lse) and ds^T = p^T (dp^T - delta) per query column;
    // with a bias, s^T becomes x = round(round(s^T * scale) + bias^T)
    const float* ls = sm.lse(st) + 32 * cw;
    const float* dl = sm.delta(st) + 32 * cw;
    const int hq = kvh * group + i / n_qt, q0 = (i % n_qt) * STEP_N + 32 * cw;
    const float* bq = BIAS ? bias + b * bsb + hq * bsh : nullptr;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float2 lv = *reinterpret_cast<const float2*>(ls + 8 * j + 2 * tq);
      const float2 dv2 = *reinterpret_cast<const float2*>(dl + 8 * j + 2 * tq);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int u = e & 1, key = k0 + krow + 8 * (e >> 1), qc = q0 + 8 * j + 2 * tq + u;
        const float x = u ? lv.y : lv.x;
        float p;
        if constexpr (BIAS) {
          float y = __fmul_rn(s[4 * j + e], scale);
          if (qc < Lq && key < Lk) y = __fadd_rn(y, __ldg(bq + qc * bsq + key));
          p = exp2_approx(__fmul_rn(y - x, LOG2E));
        } else {
          p = exp2_approx(fmaf(s[4 * j + e], c, -x * LOG2E));
        }
        s[4 * j + e] = p;
        dp[4 * j + e] = p * (dp[4 * j + e] - (u ? dv2.y : dv2.x));
      }
    }
    // both warpgroups are done with the last step's exchange tiles
    named_barrier_sync(XCHG_BAR, 256);
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int row = krow + 8 * r;
        const int at = row * 128 + (((4 * cw + j) ^ (row & 7)) << 4) + 4 * tq;
        const float p0 = s[4 * j + 2 * r], p1 = s[4 * j + 2 * r + 1];
        const float d0 = dp[4 * j + 2 * r], d1 = dp[4 * j + 2 * r + 1];
        const uint32_t ph = pack_bf16(p0, p1), dh = pack_bf16(d0, d1);
        *reinterpret_cast<uint32_t*>(sm.xchg(0) + at) = ph;
        *reinterpret_cast<uint32_t*>(sm.xchg(1) + at) = dh;
        if constexpr (!ONE_PASS) {
          *reinterpret_cast<uint32_t*>(sm.xchg(2) + at) = pack_bf16_rest(p0, p1, ph);
          *reinterpret_cast<uint32_t*>(sm.xchg(3) + at) = pack_bf16_rest(d0, d1, dh);
        }
      }
    fence_async_shared();  // the writes before the wgmma (async proxy) reads them
    named_barrier_sync(XCHG_BAR, 256);
    // dv += p^T . dO and dk += ds^T . q over the stage's 64 queries, for this
    // warpgroup's 128 columns (boxes 2 cw, 2 cw + 1 of the stage's tiles)
    const unsigned char* d_cols = sm.dout(st) + 2 * cw * STEP_BOX;
    const unsigned char* q_cols = sm.q(st) + 2 * cw * STEP_BOX;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const uint64_t bd = desc_sw128(d_cols + kk * 16 * 128, STEP_BOX, 1024);
      const uint64_t bq2 = desc_sw128(q_cols + kk * 16 * 128, STEP_BOX, 1024);
      wgmma_ss_n128_mn(dv, desc_sw128(sm.xchg(0) + kk * 32, 16, 1024), bd, 1);
      wgmma_ss_n128_mn(dk, desc_sw128(sm.xchg(1) + kk * 32, 16, 1024), bq2, 1);
      if constexpr (!ONE_PASS) {
        wgmma_ss_n128_mn(dv, desc_sw128(sm.xchg(2) + kk * 32, 16, 1024), bd, 1);
        wgmma_ss_n128_mn(dk, desc_sw128(sm.xchg(3) + kk * 32, 16, 1024), bq2, 1);
      }
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(dk);
    fence_regs(dv);
    fence_async_shared();  // the lse and delta reads before the stats warp's next writes
    release_slot(&sm.empty[st], lane);
  }
  // dk * scale and dv as bf16 into this warpgroup's boxes of the k and v
  // tiles (read by no product after the last step's barrier), then stored by
  // TMA (rows past Lk and boxes past nb dropped)
  const float one[2] = {1.f, 1.f};
  acc_to_swizzled<WD / 2>(sm.k + 2 * cw * STEP_BOX, STEP_BOX, dk, one, t, scale);
  acc_to_swizzled<WD / 2>(sm.v() + 2 * cw * STEP_BOX, STEP_BOX, dv, one, t);
  fence_async_shared();
  named_barrier_sync(1 + cw, 128);
  if (t == 0 && k0 < Lk) {
    for (int cc = 2 * cw; cc < 2 * cw + 2 && cc < nb; ++cc) {
      tma_store(&tm_dk, sm.k + cc * STEP_BOX, 64 * cc, k0, kvh, b);
      tma_store(&tm_dv, sm.v() + cc * STEP_BOX, 64 * cc, k0, kvh, b);
    }
    tma_store_wait();
  }
  cluster_sync();
}

// ----------------------------------------------------------------- host

template <bool BIAS, bool ONE_PASS>
cudaError_t launch_wide_dq(const CUtensorMap (&tm)[5], const float* bias, const long long* bst,
                           const void* delta, void* lse, int B, int H, int KVH, int Lq, int Lk,
                           int d, float scale, cudaStream_t stream) {
  auto kernel = attn_wide_dq_wgmma_kernel<BIAS, ONE_PASS>;
  const int smem = WideDqSmem::BYTES;
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const int tiles = (Lq + ATT_M - 1) / ATT_M;
  const dim3 grid((tiles + ATT_PAIR - 1) / ATT_PAIR * ATT_PAIR, H, B);
  kernel<<<grid, ATT_THREADS, smem, stream>>>(
      tm[0], tm[1], tm[2], tm[3], tm[4], bias, bst[0], bst[1], bst[2],
      static_cast<const float*>(delta), static_cast<float*>(lse), H / KVH, H, Lq, Lk,
      (d + 63) / 64, scale);
  return cudaGetLastError();
}

template <bool BIAS, bool ONE_PASS>
cudaError_t launch_wide_dkv(const CUtensorMap (&tm)[6], const float* bias, const long long* bst,
                            const void* lse, const void* delta, int B, int H, int KVH, int Lq,
                            int Lk, int d, float scale, cudaStream_t stream) {
  auto kernel = attn_wide_dkv_wgmma_kernel<BIAS, ONE_PASS>;
  const int smem = WideDkvSmem<ONE_PASS>::BYTES;
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const int tiles = (Lk + STEP_N - 1) / STEP_N;
  const dim3 grid((tiles + ATT_PAIR - 1) / ATT_PAIR * ATT_PAIR, KVH, B);
  kernel<<<grid, ATT_THREADS, smem, stream>>>(
      tm[0], tm[1], tm[2], tm[3], tm[4], tm[5], bias, bst[0], bst[1], bst[2],
      static_cast<const float*>(lse), static_cast<const float*>(delta), H / KVH, H, Lq, Lk,
      (d + 63) / 64, scale);
  return cudaGetLastError();
}

bool bad_wide_args(int B, int H, int KVH, int Lq, int Lk, int D, int long_tier) {
  return bad_shape(B, H, KVH, Lq, Lk) || D <= 128 || D > WD || D % 16 ||
         (long_tier != 0 && long_tier != 1) || B > 65535 || H > 65535;
}

}  // namespace

// C entries, bound with ctypes: B8's wgmma body at its instance of 256
// columns. q, dO (B, H, Lq, D) and k, v (B, KVH, Lk, D): bf16, D a multiple
// of 16 from 144 to 256, q and k rotated already; delta and lse: contiguous
// fp32 (B, H, Lq); bias: fp32 (B|1, H|1, Lq, Lk) with a contiguous last dim,
// or null. long_tier 0: the one-pass function; 1: the long one. `maps`: the
// wrapper's descriptions (ops/tensor_maps.py, MAP_SPEC values each, boxes of
// 64 columns) of the operands, then the bias's element strides (batch, head,
// row; 0 on a broadcast axis). Each returns a cudaError_t; 0 is success.

// dq (B, H, Lq, D) bf16 and lse. maps: q (boxes of 128 rows), k, v (32
// rows), dO (128 rows), dq (64 rows).
extern "C" int mmada_attention_wide_dq_bf16(const void* q, const void* k, const void* v,
                                            const void* dout, const void* delta,
                                            const void* bias, void* dq, void* lse, int long_tier,
                                            int B, int H, int KVH, int Lq, int Lk, int D,
                                            const long long* maps, float scale, void* stream) {
  if (bad_wide_args(B, H, KVH, Lq, Lk, D, long_tier) ||
      !instance_spec_is(maps, D, Lq, H, B, ATT_M) ||
      !instance_spec_is(maps + MAP_SPEC, D, Lk, KVH, B, WKN) ||
      !instance_spec_is(maps + 2 * MAP_SPEC, D, Lk, KVH, B, WKN) ||
      !instance_spec_is(maps + 3 * MAP_SPEC, D, Lq, H, B, ATT_M) ||
      !instance_spec_is(maps + 4 * MAP_SPEC, D, Lq, H, B, 64))
    return (int)cudaErrorInvalidValue;
  CUtensorMap tm[5];
  const void* bases[5] = {q, k, v, dout, dq};
  cudaError_t err = encode_maps(tm, bases, maps, 5);
  if (err != cudaSuccess) return (int)err;
  const float* bp = static_cast<const float*>(bias);
  const long long* bst = maps + 5 * MAP_SPEC;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (long_tier)
    err = bp ? launch_wide_dq<true, false>(tm, bp, bst, delta, lse, B, H, KVH, Lq, Lk, D, scale, s)
             : launch_wide_dq<false, false>(tm, bp, bst, delta, lse, B, H, KVH, Lq, Lk, D, scale,
                                            s);
  else
    err = bp ? launch_wide_dq<true, true>(tm, bp, bst, delta, lse, B, H, KVH, Lq, Lk, D, scale, s)
             : launch_wide_dq<false, true>(tm, bp, bst, delta, lse, B, H, KVH, Lq, Lk, D, scale,
                                           s);
  return (int)err;
}

// dk, dv (B, KVH, Lk, D) bf16, summed over each kv head's query heads. maps:
// q (boxes of 64 rows), k, v (64 rows), dO (64 rows), dk and dv (64 rows).
extern "C" int mmada_attention_wide_dkv_bf16(const void* q, const void* k, const void* v,
                                             const void* dout, const void* lse,
                                             const void* delta, const void* bias, void* dk,
                                             void* dv, int long_tier, int B, int H, int KVH,
                                             int Lq, int Lk, int D, const long long* maps,
                                             float scale, void* stream) {
  if (bad_wide_args(B, H, KVH, Lq, Lk, D, long_tier) ||
      !instance_spec_is(maps, D, Lq, H, B, STEP_N) ||
      !instance_spec_is(maps + MAP_SPEC, D, Lk, KVH, B, STEP_N) ||
      !instance_spec_is(maps + 2 * MAP_SPEC, D, Lk, KVH, B, STEP_N) ||
      !instance_spec_is(maps + 3 * MAP_SPEC, D, Lq, H, B, STEP_N) ||
      !instance_spec_is(maps + 4 * MAP_SPEC, D, Lk, KVH, B, 64) ||
      !instance_spec_is(maps + 5 * MAP_SPEC, D, Lk, KVH, B, 64))
    return (int)cudaErrorInvalidValue;
  CUtensorMap tm[6];
  const void* bases[6] = {q, k, v, dout, dk, dv};
  cudaError_t err = encode_maps(tm, bases, maps, 6);
  if (err != cudaSuccess) return (int)err;
  const float* bp = static_cast<const float*>(bias);
  const long long* bst = maps + 6 * MAP_SPEC;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (long_tier)
    err = bp ? launch_wide_dkv<true, false>(tm, bp, bst, lse, delta, B, H, KVH, Lq, Lk, D, scale,
                                            s)
             : launch_wide_dkv<false, false>(tm, bp, bst, lse, delta, B, H, KVH, Lq, Lk, D,
                                             scale, s);
  else
    err = bp ? launch_wide_dkv<true, true>(tm, bp, bst, lse, delta, B, H, KVH, Lq, Lk, D, scale,
                                           s)
             : launch_wide_dkv<false, true>(tm, bp, bst, lse, delta, B, H, KVH, Lq, Lk, D, scale,
                                            s);
  return (int)err;
}
