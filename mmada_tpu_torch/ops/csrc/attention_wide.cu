// Kernel B7's tensor-core body ("wgmma"), for Hopper (sm_90a): attention
// on bf16 operands at the head widths 16-512 other than 64 and 128, both
// tiers, without a bias and with one.
//
// It stands for the same TPU kernels as B7's ffma body
// (csrc/attention_generic.cu), mmada_tpu/ops/flash_attention.py's forwards
// where B1/B2/B4 do not reach: the one-pass `_attn_kernel` /
// `_attn_rope_kernel` (:59-92, called at :650) and `_attn_bias_kernel` /
// `_attn_rope_bias_kernel` (:148-178, called at :686); the long
// `_attn_online_kernel` / `_attn_online_bias_kernel` (:224, :259, called at
// :471, :497) and the staged ones of the same function (:291, :333, called
// at :392, :418). `flash_attention.generic_body(dtype, D)` sends a call here;
// RoPE runs first, at the real width, by attention_generic.cu's rotation
// kernel into contiguous scratch that this kernel reads.
//
// The functions (s = (q . k^T) * scale in fp32, + the fp32 bias (B|1, H|1,
// Lq, Lk) as round(round(s * scale) + bias); keys past Lk score -inf):
//   one-pass (LONG false): p = exp(s - rowmax) / rowsum in fp32, rounded to
//     bf16 BEFORE p . v (flash_attention.py:73-83), so K is walked twice:
//     pass 1 the row max m and sum l, pass 2 the normalised p and p . v;
//   long (LONG true): p = exp(s - m) in fp32, never normalised, p . v taken
//     as p_hi . v + p_lo . v (the bf16 rounding of p and the rest), divided
//     by max(l, 1e-30) last; m starts at the finite fp32 min.
// Both in natural units, exp(x - m) as exp2((x - m) log2 e): p moves by a
// few fp32 ulps, far inside the bf16 bars. A row whose every key carries the
// finite min as its bias has every score at that min and averages v (B2's
// and B4-bias's function).
//
// Design: B2's skeleton (hopper_sm90.cuh) at an instance width D of 64, 128
// or 256 over K/V tiles of 64 keys (the instance of 512, for the widths
// 272-512, has a layout of its own: its note stands above its kernel,
// attn_wide512_wgmma_kernel): one block per (128-row query tile, head,
// batch), pairs of blocks in a cluster sharing each K/V tile by TMA
// multicast, a producer warpgroup (one thread issues every TMA load) and two
// consumer warpgroups of 64 rows that issue their wgmma products in turns;
// q . k^T as m64n64k16 from shared memory, p . v as m64nDk16 with p from
// registers (m64n256k16 at D 256), the output stored by TMA. A width d below
// the instance runs through it zero-filled: the tensor maps keep the real d
// with 64-column boxes, so TMA fills the columns past d with zeros, which
// add exact zeros to q . k^T, and the stores drop the columns past d; a box
// wholly past d is never loaded, its shared memory zeroed once. The scale is
// 1/sqrt(d). At D 256 a 128-row Q tile is 64 KB and a 64-key K + V stage 64
// KB, so the ring holds two stages (192 KB); at 64 and 128 three. The
// output (D/2 fp32 a thread: 128 at D 256) stays in registers; the bias is
// read from global memory straight into the scores after each product
// (a 128 x 64 fp32 bias tile a stage would not fit at D 256).
//
// Bound: 4 B H Lq Lk D flops at 989 TFLOP/s (bf16 dense) against q, k, v, o
// (+ the bias) at 3.35 TB/s: at L ~ 1.2k the flops. The one-pass tier's two
// walks make the tensor cores do 6 of those units, the long tier's split
// p . v 6 as well: at most 2/3 of the bound's rate (every instance).

#include "hopper_sm90.cuh"

namespace {

template <int D>
struct WideSmem {
  static constexpr int STAGES = D == 256 ? 2 : 3;
  static constexpr int BOXES = D / 64;
  static constexpr int Q_TILE = ATT_M * D * 2;  // BOXES boxes of ATT_BOX
  static constexpr int KV = STEP_N * D * 2;     // BOXES boxes of STEP_BOX
  static constexpr int STAGE = 2 * KV;
  static constexpr int BYTES = Q_TILE + STAGES * STAGE + 8 * (1 + 2 * STAGES) + 1024;
  unsigned char* q;
  uint64_t* q_full;
  uint64_t* full;
  uint64_t* empty;

  __device__ explicit WideSmem(unsigned char* raw) {
    q = reinterpret_cast<unsigned char*>(
        (reinterpret_cast<uintptr_t>(raw) + 1023) & ~static_cast<uintptr_t>(1023));
    q_full = reinterpret_cast<uint64_t*>(q + Q_TILE + STAGES * STAGE);
    full = q_full + 1;
    empty = full + STAGES;
  }

  __device__ unsigned char* k(int s) const { return q + Q_TILE + s * STAGE; }
  __device__ unsigned char* v(int s) const { return k(s) + KV; }

  __device__ void init_barriers() const {
    mbar_init(q_full, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 8 * ATT_PAIR);
    }
    mbar_init_fence();
  }

  // Zero the boxes of 64 columns at or past box nb (wholly past the real
  // width) of the Q tile and of every slot's K and V tiles: TMA never
  // writes them, so the zeros last. All threads, before the first load.
  __device__ void zero_boxes(int nb) const {
    if (nb >= BOXES) return;
    const uint4 zero = make_uint4(0, 0, 0, 0);
    for (int c = nb; c < BOXES; ++c) {
      uint4* qb = reinterpret_cast<uint4*>(q + c * ATT_BOX);
      for (int i = threadIdx.x; i < ATT_BOX / 16; i += ATT_THREADS) qb[i] = zero;
      for (int s = 0; s < STAGES; ++s) {
        uint4* kb = reinterpret_cast<uint4*>(k(s) + c * STEP_BOX);
        uint4* vb = reinterpret_cast<uint4*>(v(s) + c * STEP_BOX);
        for (int i = threadIdx.x; i < STEP_BOX / 16; i += ATT_THREADS) kb[i] = vb[i] = zero;
      }
    }
    fence_async_shared();  // before the wgmma (async proxy) reads them
  }
};

// The producer thread: the Q tile's nb boxes, then n1 slots of a K tile
// (pass 1) and n2 of K and V, slot i of keys STEP_N * (i or i - n1); of a
// slot's boxes (K's nb, then V's) this block issues those of index `rank`
// modulo the pair, to both blocks.
template <int D>
__device__ __forceinline__ void wide_produce(const WideSmem<D>& sm, const CUtensorMap* tm_q,
                                             const CUtensorMap* tm_k, const CUtensorMap* tm_v,
                                             int q0, int h, int kvh, int b, int nb, int n1,
                                             int n2, int rank) {
  constexpr int S = WideSmem<D>::STAGES;
  constexpr uint16_t BOTH = (1 << ATT_PAIR) - 1;
  mbar_expect_tx(sm.q_full, nb * ATT_BOX);
  for (int c = 0; c < nb; ++c) tma_load(sm.q + c * ATT_BOX, tm_q, sm.q_full, 64 * c, q0, h, b);
  for (int i = 0; i < n1 + n2; ++i) {
    const int s = i % S;
    const bool with_v = i >= n1;
    const int key0 = (with_v ? i - n1 : i) * STEP_N;
    mbar_wait(&sm.empty[s], ((i / S) & 1) ^ 1);
    mbar_expect_tx(&sm.full[s], (with_v ? 2 : 1) * nb * STEP_BOX);
    for (int box = rank; box < (with_v ? 2 : 1) * nb; box += ATT_PAIR) {
      const bool is_v = box >= nb;
      const int c = is_v ? box - nb : box;
      tma_load_multicast((is_v ? sm.v(s) : sm.k(s)) + c * STEP_BOX, is_v ? tm_v : tm_k,
                         &sm.full[s], BOTH, 64 * c, key0, kvh, b);
    }
  }
}

// The fp32 bias plane of one (batch, head): its row stride in elements.
struct BiasRows {
  const float* p;
  long long sq;
};

// A tile's scores in natural units, in place: s * scale (+ the bias of
// query rows `row`, row + 8 and keys key0 + 8j + 2tq, +1), -inf past Lk
// (N / 2 keys: 64, or 32 at the instance of 512).
template <bool BIAS, int N>
__device__ __forceinline__ void wide_scores(float (&s)[N], const BiasRows& bias, int row,
                                            int key0, int Lq, int Lk, int tq, float scale) {
#pragma unroll
  for (int j = 0; j < N / 4; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = row + 8 * (i >> 1), key = key0 + 8 * j + 2 * tq + (i & 1);
      float x = __fmul_rn(s[4 * j + i], scale);
      if (BIAS && r < Lq && key < Lk) x = __fadd_rn(x, __ldg(bias.p + r * bias.sq + key));
      s[4 * j + i] = key < Lk ? x : -INFINITY;
    }
}

__device__ __forceinline__ float exp_nat(float x) { return exp2f(x * LOG2E); }

// One-pass pass 2: p = exp(s - m) / l as register-A fragments (the division
// as a multiply by the correctly rounded reciprocal `inv` and one FMA
// correction step, as B1), rounded to bf16; KB k16 steps (16 KB keys).
template <int KB>
__device__ __forceinline__ void wide_probs(uint32_t (&p)[KB][4], const float (&s)[8 * KB],
                                           const float m[2], const float l[2],
                                           const float inv[2]) {
#pragma unroll
  for (int kb = 0; kb < KB; ++kb)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = e & 1;
      float x[2];
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const float ex = exp_nat(s[8 * kb + 2 * e + u] - m[r]);
        const float y = ex * inv[r];
        x[u] = fmaf(inv[r], fmaf(-y, l[r], ex), y);
      }
      p[kb][e] = pack_bf16(x[0], x[1]);
    }
}

// The long tier's online step on a tile of scores (natural units): the new
// row max m, p = exp(s - m) in place, l = l a + rowsum(p) (this thread's
// part), o rescaled by a, p as its bf16 rounding hi and the rest lo.
template <int D>
__device__ __forceinline__ void wide_online(float (&o)[D / 2], float (&s)[32], float m[2],
                                            float l[2], uint32_t (&hi)[4][4],
                                            uint32_t (&lo)[4][4]) {
  float a[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float m_new = fmaxf(m[r], row_max(s, r));
    a[r] = exp_nat(m[r] - m_new);
    m[r] = m_new;
    float sum = 0.f;
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        float& x = s[4 * n + 2 * r + u];
        x = exp_nat(x - m_new);
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
  for (int kb = 0; kb < 4; ++kb)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float x0 = s[8 * kb + 2 * e], x1 = s[8 * kb + 2 * e + 1];
      hi[kb][e] = pack_bf16(x0, x1);
      lo[kb][e] = pack_bf16_rest(x0, x1, hi[kb][e]);
    }
}

// Kernel B7, wgmma body. nb: the 64-column boxes the real width d covers;
// bias: the fp32 bias's base (null without one), bsb / bsh its batch and
// head strides in elements (0 on a broadcast axis), bsq its row stride.
template <int D, bool BIAS, bool LONG>
__global__ void __cluster_dims__(ATT_PAIR, 1, 1) __launch_bounds__(ATT_THREADS, 1)
attn_wide_wgmma_kernel(const __grid_constant__ CUtensorMap tm_q,
                       const __grid_constant__ CUtensorMap tm_k,
                       const __grid_constant__ CUtensorMap tm_v,
                       const __grid_constant__ CUtensorMap tm_o, const float* __restrict__ bias,
                       long long bsb, long long bsh, long long bsq, int rep, int Lq, int Lk,
                       int nb, float scale) {
  using Smem = WideSmem<D>;
  constexpr int S = Smem::STAGES;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const Smem sm(smem_raw);
  const int q0 = blockIdx.x * ATT_M, h = blockIdx.y, b = blockIdx.z;
  const int n_tiles = (Lk + STEP_N - 1) / STEP_N;
  const int n1 = LONG ? 0 : n_tiles;  // pass 1's K-only slots
  if (threadIdx.x == 0) sm.init_barriers();
  sm.zero_boxes(nb);
  cluster_sync();  // the pair's barriers and zeros are ready before any load or arrival
  const int wg = threadIdx.x / 128;
  if (wg == 0) {
    setmaxnreg_dec<40>();
    if (threadIdx.x == 0)
      wide_produce(sm, &tm_q, &tm_k, &tm_v, q0, h, h / rep, b, nb, n1, n_tiles, cluster_rank());
    cluster_sync();  // the pair's last multicasts and arrivals are done
    return;
  }
  setmaxnreg_inc<232>();
  const int cw = wg - 1, t = threadIdx.x % 128, lane = t % 32, tq = lane % 4;
  unsigned char* q_rows = sm.q + cw * 64 * 128;
  const int row = q0 + 64 * cw + (t / 32) * 16 + lane / 4;  // this thread's first query row
  const BiasRows br{BIAS ? bias + b * bsb + h * bsh : nullptr, bsq};
  turns_start(cw);
  mbar_wait(sm.q_full, 0);

  float o[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
  float m[2] = {NEG_F32, NEG_F32}, l[2] = {0.f, 0.f};  // l: this thread's part
  float s[32];
  float div[2] = {1.f, 1.f};
  if constexpr (!LONG) {
    // pass 1: the row max m and sum l, one turn per K tile
    for (int j = 0; j < n1; ++j) {
      const int st = j % S;
      mbar_wait(&sm.full[st], (j / S) & 1);
      turn_begin(cw);
      wgmma_fence();
      step_scores_issue<D>(s, q_rows, sm.k(st));
      wgmma_commit();
      turn_end(cw, false);
      wgmma_wait<0>();
      fence_regs(s);
      release_slot(&sm.empty[st], lane);
      wide_scores<BIAS>(s, br, row, j * STEP_N, Lq, Lk, tq, scale);
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const float m_new = fmaxf(m[r], row_max(s, r));
        float sum = 0.f;
#pragma unroll
        for (int n = 0; n < 8; ++n)
          sum += exp_nat(s[4 * n + 2 * r] - m_new) + exp_nat(s[4 * n + 2 * r + 1] - m_new);
        l[r] = l[r] * exp_nat(m[r] - m_new) + sum;
        m[r] = m_new;
      }
    }
    float inv[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l[r] = quad_sum(l[r]);
      inv[r] = __frcp_rn(l[r]);
    }

    // pass 2, pipelined by one tile: the turn of tile j issues o += p_{j-1}
    // . V_{j-1} and s_j = q . K_j^T together, then forms p_j while the other
    // warpgroup's products run (no wgmma under a runtime condition)
    uint32_t p[4][4];
    {
      const int st = n1 % S;
      mbar_wait(&sm.full[st], (n1 / S) & 1);
      turn_begin(cw);
      wgmma_fence();
      step_scores_issue<D>(s, q_rows, sm.k(st));
      wgmma_commit();
      turn_end(cw, false);
      wgmma_wait<0>();
      fence_regs(s);
      wide_scores<BIAS>(s, br, row, 0, Lq, Lk, tq, scale);
      wide_probs(p, s, m, l, inv);
    }
    for (int j = 1; j < n_tiles; ++j) {
      const int i = n1 + j, st = i % S, prev = (i - 1) % S;
      mbar_wait(&sm.full[st], (i / S) & 1);
      turn_begin(cw);
      wgmma_fence();
      step_acc_issue<D>(o, p, sm.v(prev));
      step_scores_issue<D>(s, q_rows, sm.k(st));
      wgmma_commit();
      turn_end(cw, false);
      wgmma_wait<0>();
      fence_regs(o);
      fence_regs(s);
      fence_regs(p);
      release_slot(&sm.empty[prev], lane);
      wide_scores<BIAS>(s, br, row, j * STEP_N, Lq, Lk, tq, scale);
      wide_probs(p, s, m, l, inv);
    }
    const int last = (n1 + n_tiles - 1) % S;
    turn_begin(cw);
    wgmma_fence();
    step_acc_issue<D>(o, p, sm.v(last));
    wgmma_commit();
    turn_end(cw, true);
    wgmma_wait<0>();
    fence_regs(o);
    fence_regs(p);
    release_slot(&sm.empty[last], lane);
  } else {
    // one online walk, pipelined by one tile as B4: the turn of tile j
    // issues o += p_{j-1} . V_{j-1} (hi, then lo) and s_j = q . K_j^T, then
    // takes tile j's online step while the other warpgroup's products run
    uint32_t hi[4][4], lo[4][4];
    mbar_wait(&sm.full[0], 0);
    turn_begin(cw);
    wgmma_fence();
    step_scores_issue<D>(s, q_rows, sm.k(0));
    wgmma_commit();
    turn_end(cw, false);
    wgmma_wait<0>();
    fence_regs(s);
    wide_scores<BIAS>(s, br, row, 0, Lq, Lk, tq, scale);
    wide_online<D>(o, s, m, l, hi, lo);
    for (int j = 1; j < n_tiles; ++j) {
      const int st = j % S, prev = (j - 1) % S;
      mbar_wait(&sm.full[st], (j / S) & 1);
      turn_begin(cw);
      wgmma_fence();
      step_acc_issue<D>(o, hi, sm.v(prev));
      step_acc_issue<D>(o, lo, sm.v(prev));
      step_scores_issue<D>(s, q_rows, sm.k(st));
      wgmma_commit();
      turn_end(cw, false);
      wgmma_wait<0>();
      fence_regs(o);
      fence_regs(s);
      fence_regs(hi);
      fence_regs(lo);
      release_slot(&sm.empty[prev], lane);
      wide_scores<BIAS>(s, br, row, j * STEP_N, Lq, Lk, tq, scale);
      wide_online<D>(o, s, m, l, hi, lo);
    }
    const int last = (n_tiles - 1) % S;
    turn_begin(cw);
    wgmma_fence();
    step_acc_issue<D>(o, hi, sm.v(last));
    step_acc_issue<D>(o, lo, sm.v(last));
    wgmma_commit();
    turn_end(cw, true);
    wgmma_wait<0>();
    fence_regs(o);
    fence_regs(hi);
    fence_regs(lo);
    release_slot(&sm.empty[last], lane);
#pragma unroll
    for (int r = 0; r < 2; ++r) div[r] = fmaxf(quad_sum(l[r]), 1e-30f);
  }
  // the epilogue: bf16 into this warpgroup's rows of the Q tile, then one
  // TMA store per box the real width reaches (columns past d are dropped)
  acc_to_swizzled<D>(q_rows, ATT_BOX, o, div, t);
  fence_async_shared();
  named_barrier_sync(1 + cw, 128);
  const int row0 = q0 + 64 * cw;
  if (t == 0 && row0 < Lq) {
    for (int c = 0; c < nb; ++c) tma_store(&tm_o, q_rows + c * ATT_BOX, 64 * c, row0, h, b);
    tma_store_wait();
  }
  cluster_sync();
}

// ------------------------------------------------ the instance of 512
//
// At D 512 a 128-row Q tile (128 KB) and one 64-key K + V stage (128 KB) do
// not fit a block's 227 KB, so the instance of 512 (real widths 272-512)
// has its own layout. A block owns 64 query rows; pairs of neighbouring
// tiles share each K / V tile by multicast, as at 256 (on the H100 clusters
// of four ran slower, single blocks no faster). Both consumer
// warpgroups take all 64 rows and split the width between them: warpgroup
// cw contracts q . k^T over the columns 256 cw..256 cw + 255 (m64n32k16
// from shared memory) and accumulates the output's same 256 columns
// (m64n256k16, p from registers, 128 fp32 registers a thread). The two
// halves of the scores are summed in fp32 through shared memory
// (`exchange`): each warpgroup adds the other's partial at the same
// accumulator positions, so both hold the same scores, form the same row
// statistics and the same p, and no p tile is exchanged. K and V stream in
// tiles of 32 keys (WKN) through two rings of two slots each, every load
// issued one step ahead of its use. A step issues o += p_{j-1} . V_{j-1}
// and s_j = q . K_j^T as one group, waits for it, exchanges the scores and
// forms p_j (the two warpgroups work in step: each exchange is a barrier).
// Waiting for the scores alone while the product ran (wgmma.wait_group 1)
// made ptxas serialise every wgmma of the kernel (C7513: the scores'
// registers are defined while a wgmma of the group is in flight) and ran
// slower. Shared memory: Q 64 KB, two K and two V slots of 32 KB,
// the exchange buffers (16 values a thread, two parities, both warpgroups:
// 32 KB): 230,472 bytes with the barriers and the alignment. The one-pass
// tier walks K twice as the other instances do (6 units of L x L x D), the
// long tier once with p as hi + lo (6).

constexpr int W5_D = 512;      // the instance's width
constexpr int W5_M = 64;       // query rows a block
constexpr int XCHG_BAR = 3;    // the consumer warpgroups' named barrier (1-2: epilogues)

struct Wide512Smem {
  static constexpr int BOXES = W5_D / 64;
  static constexpr int Q_TILE = W5_M * W5_D * 2;  // BOXES boxes of STEP_BOX
  static constexpr int KV = WKN * W5_D * 2;       // BOXES boxes of WKBOX
  static constexpr int XCHG = 16 * 128 * 4;       // one warpgroup's partial scores
  static constexpr int BYTES = Q_TILE + 4 * KV + 4 * XCHG + 8 * 9 + 1024;
  unsigned char* q;
  uint64_t* q_full;
  uint64_t* full_k;
  uint64_t* empty_k;
  uint64_t* full_v;
  uint64_t* empty_v;

  __device__ explicit Wide512Smem(unsigned char* raw) {
    q = reinterpret_cast<unsigned char*>(
        (reinterpret_cast<uintptr_t>(raw) + 1023) & ~static_cast<uintptr_t>(1023));
    q_full = reinterpret_cast<uint64_t*>(q + Q_TILE + 4 * KV + 4 * XCHG);
    full_k = q_full + 1;
    empty_k = full_k + 2;
    full_v = empty_k + 2;
    empty_v = full_v + 2;
  }

  __device__ unsigned char* k(int s) const { return q + Q_TILE + s * KV; }
  __device__ unsigned char* v(int s) const { return q + Q_TILE + (2 + s) * KV; }
  __device__ float* xchg(int cw, int parity) const {
    return reinterpret_cast<float*>(q + Q_TILE + 4 * KV + (2 * cw + parity) * XCHG);
  }

  __device__ void init_barriers() const {
    mbar_init(q_full, 1);
    for (int s = 0; s < 2; ++s) {
      mbar_init(&full_k[s], 1);
      mbar_init(&full_v[s], 1);
      mbar_init(&empty_k[s], 8 * ATT_PAIR);
      mbar_init(&empty_v[s], 8 * ATT_PAIR);
    }
    mbar_init_fence();
  }

  // As WideSmem::zero_boxes: the boxes at or past nb of the Q tile and of
  // every K and V slot.
  __device__ void zero_boxes(int nb) const {
    const uint4 zero = make_uint4(0, 0, 0, 0);
    for (int c = nb; c < BOXES; ++c) {
      uint4* qb = reinterpret_cast<uint4*>(q + c * STEP_BOX);
      for (int i = threadIdx.x; i < STEP_BOX / 16; i += ATT_THREADS) qb[i] = zero;
      for (int s = 0; s < 4; ++s) {
        uint4* kb = reinterpret_cast<uint4*>(k(s) + c * WKBOX);
        for (int i = threadIdx.x; i < WKBOX / 16; i += ATT_THREADS) kb[i] = zero;
      }
    }
    fence_async_shared();
  }
};

// The producer thread of the instance of 512: the Q tile's nb boxes, then
// n1 K tiles alone (the one-pass tier's first walk), then K_j and V_j for j
// < n2 in turn, each into its ring's slot once both blocks have released
// it; of a tile's boxes this block issues those of index `rank` modulo the
// pair, to both blocks.
__device__ __forceinline__ void wide512_produce(const Wide512Smem& sm, const CUtensorMap* tm_q,
                                                const CUtensorMap* tm_k,
                                                const CUtensorMap* tm_v, int q0, int h, int kvh,
                                                int b, int nb, int n1, int n2, int rank) {
  constexpr uint16_t ALL = (1 << ATT_PAIR) - 1;
  mbar_expect_tx(sm.q_full, nb * STEP_BOX);
  for (int c = 0; c < nb; ++c) tma_load(sm.q + c * STEP_BOX, tm_q, sm.q_full, 64 * c, q0, h, b);
  auto load = [&](bool is_v, int i, int key0) {
    const int s = i % 2;
    uint64_t* full = is_v ? sm.full_v : sm.full_k;
    mbar_wait(&(is_v ? sm.empty_v : sm.empty_k)[s], ((i / 2) & 1) ^ 1);
    mbar_expect_tx(&full[s], nb * WKBOX);
    unsigned char* tile = is_v ? sm.v(s) : sm.k(s);
    for (int c = rank; c < nb; c += ATT_PAIR)
      tma_load_multicast(tile + c * WKBOX, is_v ? tm_v : tm_k, &full[s], ALL, 64 * c, key0,
                         kvh, b);
  };
  for (int i = 0; i < n1; ++i) load(false, i, i * WKN);
  for (int j = 0; j < n2; ++j) {
    load(false, n1 + j, j * WKN);
    load(true, j, j * WKN);
  }
}

// Both warpgroups' halves of a tile's scores summed: this warpgroup writes
// its 16 values to `mine` (value i of thread t at i * 128 + t), meets the
// other at XCHG_BAR and adds the other's values at the same positions. Each
// sum is the same two fp32 partials, so both warpgroups hold the same
// scores. The buffers alternate by step parity, so one barrier a step
// suffices.
__device__ __forceinline__ void exchange(float (&s)[16], float* mine, const float* other,
                                         int t) {
#pragma unroll
  for (int i = 0; i < 16; ++i) mine[i * 128 + t] = s[i];
  named_barrier_sync(XCHG_BAR, 256);
#pragma unroll
  for (int i = 0; i < 16; ++i) s[i] += other[i * 128 + t];
}

// The long tier's online step on a 32-key tile (natural units): the new
// row max m, a = exp(m_old - m), p = exp(s - m) in place, l = l a +
// rowsum(p) (this thread's part), p as its bf16 rounding hi and the rest
// lo. The caller rescales the output by a once the product that reads it
// is done.
__device__ __forceinline__ void wide_online32(float (&s)[16], float m[2], float l[2], float a[2],
                                              uint32_t (&hi)[2][4], uint32_t (&lo)[2][4]) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float m_new = fmaxf(m[r], row_max(s, r));
    a[r] = exp_nat(m[r] - m_new);
    m[r] = m_new;
    float sum = 0.f;
#pragma unroll
    for (int n = 0; n < 4; ++n)
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        float& x = s[4 * n + 2 * r + u];
        x = exp_nat(x - m_new);
        sum += x;
      }
    l[r] = l[r] * a[r] + sum;
  }
  pack32<true>(s, hi, lo);
}

// Kernel B7, wgmma body, instance of 512 columns: one block per (64-row
// query tile, head, batch), pairs of neighbouring tiles in a cluster; the
// arguments as attn_wide_wgmma_kernel's.
template <bool BIAS, bool LONG>
__global__ void __cluster_dims__(ATT_PAIR, 1, 1) __launch_bounds__(ATT_THREADS, 1)
attn_wide512_wgmma_kernel(const __grid_constant__ CUtensorMap tm_q,
                          const __grid_constant__ CUtensorMap tm_k,
                          const __grid_constant__ CUtensorMap tm_v,
                          const __grid_constant__ CUtensorMap tm_o,
                          const float* __restrict__ bias, long long bsb, long long bsh,
                          long long bsq, int rep, int Lq, int Lk, int nb, float scale) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const Wide512Smem sm(smem_raw);
  const int q0 = blockIdx.x * W5_M, h = blockIdx.y, b = blockIdx.z;
  const int n_tiles = (Lk + WKN - 1) / WKN;
  const int n1 = LONG ? 0 : n_tiles;  // the first walk's K tiles
  if (threadIdx.x == 0) sm.init_barriers();
  sm.zero_boxes(nb);
  cluster_sync();  // the pair's barriers and zeros are ready before any load or arrival
  const int wg = threadIdx.x / 128;
  if (wg == 0) {
    setmaxnreg_dec<40>();
    if (threadIdx.x == 0)
      wide512_produce(sm, &tm_q, &tm_k, &tm_v, q0, h, h / rep, b, nb, n1, n_tiles,
                      cluster_rank());
    cluster_sync();  // the pair's last multicasts and arrivals are done
    return;
  }
  setmaxnreg_inc<232>();
  const int cw = wg - 1, t = threadIdx.x % 128, lane = t % 32, tq = lane % 4;
  const unsigned char* q_half = sm.q + 4 * cw * STEP_BOX;  // this warpgroup's columns
  const int half = 4 * cw * WKBOX;                          // its columns of a K or V tile
  const int row = q0 + (t / 32) * 16 + lane / 4;            // this thread's first query row
  const BiasRows br{BIAS ? bias + b * bsb + h * bsh : nullptr, bsq};
  mbar_wait(sm.q_full, 0);

  float o[128];
#pragma unroll
  for (int i = 0; i < 128; ++i) o[i] = 0.f;
  float m[2] = {NEG_F32, NEG_F32}, l[2] = {0.f, 0.f};  // l: this thread's part
  float s[16];
  float div[2] = {1.f, 1.f};
  int parity = 0;  // of the exchange buffers
  // the scores of K tile i of the K ring (keys key0..), whole: this
  // warpgroup's half, then the other's added; -inf past Lk
  auto scores_alone = [&](int i, int key0) {
    const int st = i % 2;
    mbar_wait(&sm.full_k[st], (i / 2) & 1);
    wgmma_fence();
    scores32_issue<256, STEP_BOX, WKBOX>(s, q_half, sm.k(st) + half);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(s);
    release_slot(&sm.empty_k[st], lane);
    exchange(s, sm.xchg(cw, parity), sm.xchg(cw ^ 1, parity), t);
    parity ^= 1;
    wide_scores<BIAS>(s, br, row, key0, Lq, Lk, tq, scale);
  };
  if constexpr (!LONG) {
    // pass 1: the row max m and sum l
    for (int j = 0; j < n1; ++j) {
      scores_alone(j, j * WKN);
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const float m_new = fmaxf(m[r], row_max(s, r));
        float sum = 0.f;
#pragma unroll
        for (int n = 0; n < 4; ++n)
          sum += exp_nat(s[4 * n + 2 * r] - m_new) + exp_nat(s[4 * n + 2 * r + 1] - m_new);
        l[r] = l[r] * exp_nat(m[r] - m_new) + sum;
        m[r] = m_new;
      }
    }
    float inv[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l[r] = quad_sum(l[r]);
      inv[r] = __frcp_rn(l[r]);
    }

    // pass 2: step j issues o += p_{j-1} . V_{j-1} and s_j = q . K_j^T
    // as one group, then forms p_j
    uint32_t p[2][4];
    scores_alone(n1, 0);
    wide_probs(p, s, m, l, inv);
    for (int j = 1; j < n_tiles; ++j) {
      const int i = n1 + j, st = i % 2, vs = (j - 1) % 2;
      mbar_wait(&sm.full_k[st], (i / 2) & 1);
      mbar_wait(&sm.full_v[vs], ((j - 1) / 2) & 1);
      wgmma_fence();
      acc32_issue(o, p, sm.v(vs) + half);
      scores32_issue<256, STEP_BOX, WKBOX>(s, q_half, sm.k(st) + half);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(o);
      fence_regs(s);
      fence_regs(p);
      release_slot(&sm.empty_k[st], lane);
      release_slot(&sm.empty_v[vs], lane);
      exchange(s, sm.xchg(cw, parity), sm.xchg(cw ^ 1, parity), t);
      parity ^= 1;
      wide_scores<BIAS>(s, br, row, j * WKN, Lq, Lk, tq, scale);
      wide_probs(p, s, m, l, inv);
    }
    const int vs = (n_tiles - 1) % 2;
    mbar_wait(&sm.full_v[vs], ((n_tiles - 1) / 2) & 1);
    wgmma_fence();
    acc32_issue(o, p, sm.v(vs) + half);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(o);
    fence_regs(p);
    release_slot(&sm.empty_v[vs], lane);
  } else {
    // one online walk: step j issues o += p_{j-1} . V_{j-1} (hi, then lo)
    // and s_j as one group, then takes tile j's online step and rescales o
    uint32_t hi[2][4], lo[2][4];
    float a[2];
    scores_alone(0, 0);
    wide_online32(s, m, l, a, hi, lo);
    for (int j = 1; j < n_tiles; ++j) {
      const int st = j % 2, vs = (j - 1) % 2;
      mbar_wait(&sm.full_k[st], (j / 2) & 1);
      mbar_wait(&sm.full_v[vs], ((j - 1) / 2) & 1);
      wgmma_fence();
      acc32_issue(o, hi, sm.v(vs) + half);
      acc32_issue(o, lo, sm.v(vs) + half);
      scores32_issue<256, STEP_BOX, WKBOX>(s, q_half, sm.k(st) + half);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(o);
      fence_regs(s);
      fence_regs(hi);
      fence_regs(lo);
      release_slot(&sm.empty_k[st], lane);
      release_slot(&sm.empty_v[vs], lane);
      exchange(s, sm.xchg(cw, parity), sm.xchg(cw ^ 1, parity), t);
      parity ^= 1;
      wide_scores<BIAS>(s, br, row, j * WKN, Lq, Lk, tq, scale);
      wide_online32(s, m, l, a, hi, lo);
#pragma unroll
      for (int n = 0; n < 32; ++n) {
        o[4 * n] *= a[0];
        o[4 * n + 1] *= a[0];
        o[4 * n + 2] *= a[1];
        o[4 * n + 3] *= a[1];
      }
    }
    const int vs = (n_tiles - 1) % 2;
    mbar_wait(&sm.full_v[vs], ((n_tiles - 1) / 2) & 1);
    wgmma_fence();
    acc32_issue(o, hi, sm.v(vs) + half);
    acc32_issue(o, lo, sm.v(vs) + half);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(o);
    fence_regs(hi);
    fence_regs(lo);
    release_slot(&sm.empty_v[vs], lane);
#pragma unroll
    for (int r = 0; r < 2; ++r) div[r] = fmaxf(quad_sum(l[r]), 1e-30f);
  }
  // the epilogue: bf16 over this warpgroup's half of the Q tile (read by it
  // alone), then one TMA store per box of it the real width reaches
  unsigned char* out_half = sm.q + 4 * cw * STEP_BOX;
  acc_to_swizzled<256>(out_half, STEP_BOX, o, div, t);
  fence_async_shared();
  named_barrier_sync(1 + cw, 128);
  if (t == 0 && q0 < Lq) {
    for (int c = 4 * cw; c < nb && c < 4 * cw + 4; ++c)
      tma_store(&tm_o, sm.q + c * STEP_BOX, 64 * c, q0, h, b);
    tma_store_wait();
  }
  cluster_sync();
}

// Whether `spec` describes a (batches, heads, rows, d) bf16 operand in boxes
// of 64 columns and `box_rows` rows, as the padded instances read it.
bool wide_spec_is(const long long* spec, int d, int rows, int heads, int batches,
                  int box_rows) {
  return spec[0] == d && spec[1] == rows && spec[2] == heads && spec[3] == batches &&
         spec[7] == 64 && spec[8] == box_rows && spec[9] == 1 && spec[10] == 1;
}

template <int D, bool BIAS, bool LONG>
cudaError_t launch_wide(const CUtensorMap (&tm)[4], const float* bias, const long long* bst,
                        int B, int H, int KVH, int Lq, int Lk, int d, float scale,
                        cudaStream_t stream) {
  auto kernel = attn_wide_wgmma_kernel<D, BIAS, LONG>;
  const int smem = WideSmem<D>::BYTES;
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  // whole pairs of query tiles (a tile past Lq computes and stores nothing)
  const int tiles = (Lq + ATT_M - 1) / ATT_M;
  const dim3 grid((tiles + ATT_PAIR - 1) / ATT_PAIR * ATT_PAIR, H, B);
  kernel<<<grid, ATT_THREADS, smem, stream>>>(tm[0], tm[1], tm[2], tm[3], bias, bst[0], bst[1],
                                              bst[2], H / KVH, Lq, Lk, (d + 63) / 64, scale);
  return cudaGetLastError();
}

template <bool BIAS, bool LONG>
cudaError_t launch_wide512(const CUtensorMap (&tm)[4], const float* bias, const long long* bst,
                           int B, int H, int KVH, int Lq, int Lk, int d, float scale,
                           cudaStream_t stream) {
  auto kernel = attn_wide512_wgmma_kernel<BIAS, LONG>;
  const int smem = Wide512Smem::BYTES;
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const int tiles = (Lq + W5_M - 1) / W5_M;
  const dim3 grid((tiles + ATT_PAIR - 1) / ATT_PAIR * ATT_PAIR, H, B);
  kernel<<<grid, ATT_THREADS, smem, stream>>>(tm[0], tm[1], tm[2], tm[3], bias, bst[0], bst[1],
                                              bst[2], H / KVH, Lq, Lk, (d + 63) / 64, scale);
  return cudaGetLastError();
}

template <int D>
cudaError_t wide_tiers(const CUtensorMap (&tm)[4], const float* bias, const long long* bst,
                       bool long_tier, int B, int H, int KVH, int Lq, int Lk, int d,
                       float scale, cudaStream_t s) {
  if (long_tier)
    return bias ? launch_wide<D, true, true>(tm, bias, bst, B, H, KVH, Lq, Lk, d, scale, s)
                : launch_wide<D, false, true>(tm, bias, bst, B, H, KVH, Lq, Lk, d, scale, s);
  return bias ? launch_wide<D, true, false>(tm, bias, bst, B, H, KVH, Lq, Lk, d, scale, s)
              : launch_wide<D, false, false>(tm, bias, bst, B, H, KVH, Lq, Lk, d, scale, s);
}

cudaError_t wide512_tiers(const CUtensorMap (&tm)[4], const float* bias, const long long* bst,
                          bool long_tier, int B, int H, int KVH, int Lq, int Lk, int d,
                          float scale, cudaStream_t s) {
  if (long_tier)
    return bias ? launch_wide512<true, true>(tm, bias, bst, B, H, KVH, Lq, Lk, d, scale, s)
                : launch_wide512<false, true>(tm, bias, bst, B, H, KVH, Lq, Lk, d, scale, s);
  return bias ? launch_wide512<true, false>(tm, bias, bst, B, H, KVH, Lq, Lk, d, scale, s)
              : launch_wide512<false, false>(tm, bias, bst, B, H, KVH, Lq, Lk, d, scale, s);
}

}  // namespace

// C entry, bound with ctypes: B7's wgmma body. q (B, H, Lq, D), k and v (B,
// KVH, Lk, D), o (B, H, Lq, D): bf16, D a multiple of 16 from 16 to 512 and
// neither 64 nor 128 (those are B1-B4's), rotated already if RoPE applies.
// bias: fp32 (B|1, H|1, Lq, Lk) with a contiguous last dim, or null.
// long_tier 0: the one-pass function; 1: the long one. `maps`: the
// wrapper's descriptions (ops/tensor_maps.py, MAP_SPEC values each, boxes of
// 64 columns) of q (boxes of 128 rows; 64 past D 256), k and v (64 rows; 32
// past D 256) and o (64 rows), then the bias's element strides (batch, head,
// row; 0 on a broadcast axis). Returns a cudaError_t; 0 is success.
extern "C" int mmada_attention_wide_fwd_bf16(const void* q, const void* k, const void* v,
                                             void* o, const void* bias, int long_tier, int B,
                                             int H, int KVH, int Lq, int Lk, int D,
                                             const long long* maps, float scale, void* stream) {
  if (bad_shape(B, H, KVH, Lq, Lk) || D < 16 || D > W5_D || D % 16 || D == 64 || D == 128 ||
      (long_tier != 0 && long_tier != 1) || B > 65535 || H > 65535)
    return (int)cudaErrorInvalidValue;
  const int q_rows = D > 256 ? W5_M : ATT_M, kv_rows = D > 256 ? WKN : STEP_N;
  if (!wide_spec_is(maps, D, Lq, H, B, q_rows) ||
      !wide_spec_is(maps + MAP_SPEC, D, Lk, KVH, B, kv_rows) ||
      !wide_spec_is(maps + 2 * MAP_SPEC, D, Lk, KVH, B, kv_rows) ||
      !wide_spec_is(maps + 3 * MAP_SPEC, D, Lq, H, B, 64))
    return (int)cudaErrorInvalidValue;
  CUtensorMap tm[4];
  const void* bases[4] = {q, k, v, o};
  cudaError_t err = encode_maps(tm, bases, maps, 4);
  if (err != cudaSuccess) return (int)err;
  const float* b = static_cast<const float*>(bias);
  const long long* bst = maps + 4 * MAP_SPEC;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool lt = long_tier != 0;
  if (D < 64) err = wide_tiers<64>(tm, b, bst, lt, B, H, KVH, Lq, Lk, D, scale, s);
  else if (D < 128) err = wide_tiers<128>(tm, b, bst, lt, B, H, KVH, Lq, Lk, D, scale, s);
  else if (D <= 256) err = wide_tiers<256>(tm, b, bst, lt, B, H, KVH, Lq, Lk, D, scale, s);
  else err = wide512_tiers(tm, b, bst, lt, B, H, KVH, Lq, Lk, D, scale, s);
  return (int)err;
}
