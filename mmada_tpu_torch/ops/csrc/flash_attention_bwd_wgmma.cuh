// The wgmma bodies of the attention backward, for Hopper (sm_90a): the dq
// kernel and the dk/dv kernel of the long tier (B5-dq, B5-dkv, unbiased and
// biased, in flash_attention_long.cu) and, with ONE_PASS, of the one-pass
// tier (B3, in flash_attention_bwd.cu); and the pieces of them that the long
// tier's biased forward (B4-bias) streams its tiles with.
//
// Both tiers take q and k rotated, bf16 operands through TMA tensor maps,
// and delta = rowsum(dO * O) in fp32, computed outside. With s = (q . k^T) *
// scale in fp32 (+ the fp32 bias (B|1, H|1, Lq, Lk), added as round(round(s *
// scale) + bias)):
//
//   B5-dq:  online over the keys: m' = max(m, rowmax(s)); a = exp(m - m');
//           p = exp(s - m'); l = l a + rowsum(p); acc = acc a + t . k with
//           t = p (dO . v^T - delta); dq = bf16(acc / max(l, 1e-30) * scale),
//           lse = m + log(max(l, 1e-30)) (fp32, (B, H, Lq))
//   B3-dq:  pass 1 finds m and l; pass 2 forms p = exp(s - m) / l, dp = dO .
//           v^T, ds = p (dp - delta); dq = bf16(ds . k * scale), lse = m +
//           log l. (mmada_tpu/ops/flash_attention.py `_attn_bwd_dq_kernel`
//           :719, called at :895)
//   dkv:    p = exp(s - lse); dv = p^T . dO; ds = p (dO . v^T - delta);
//           dk = ds^T . q * scale, summed over the GQA group's query heads
//           (B3: `_attn_bwd_dkv_kernel` :753, called at :963)
//
// The two tiers differ in how p and ds enter the tensor cores. The long tier
// keeps the TPU tier's fp32 p: each fp32 left operand (t, p^T, ds^T) enters
// as hi + lo, two bf16 values (split_hi_lo), two products. The one-pass tier
// rounds p and ds to bf16 once (pack_bf16_a), one product, as flash-attention
// backward kernels usually do. So B5-dq does 8 units of L x L x D where its
// bound counts 6, B5-dkv 12 where it counts 8; B3-dq 8 (its pass 1 computes
// q . k^T again), B3-dkv 8, as its bound.
//
// Design (the attention skeleton of hopper_sm90.cuh): pairs of blocks in a
// cluster, a TMA producer warpgroup and two consumer warpgroups of 64 rows
// that issue their products in turns, a ring of slots on mbarriers, every
// product a wgmma. Each streamed tile is 64 rows (STEP_N): the dq kernel
// streams K and V tiles of 64 keys past a resident 128-row q and dO tile, the
// dkv kernel streams q and dO tiles of 64 queries (with their 64 lse and delta
// values) past a resident 128-row k and v tile. The pair shares the stream:
// each block's producer loads half of a slot's boxes and multicasts them into
// both blocks. A streamed tile is read both ways: K-major as the B operand of
// a score product (q . k^T, dO . v^T; k . q^T, v . dO^T) and MN-major as the
// B operand of an accumulation (t . k; p^T . dO, ds^T . q), whose A operand
// comes from registers. B3's dq kernel runs on a persistent grid (its
// clusters walk several work items, the ring running on from one to the
// next; an item's loads start after the item before has stored its dq);
// the other kernels, B3-bias's dq too, run one cluster a work item.
//
// Registers bound the shapes (232 a consumer thread after setmaxnreg). The
// dq kernel holds acc (64 x D), s and dp (64 x 64) and t's halves: 160 at D =
// 128, so it pipelines by one tile as B4 (a turn issues tile j-1's
// accumulation and tile j's scores together). The dkv kernel holds dk and dv
// (128 at D = 128) beside s^T and dp^T or their halves, so a step takes two
// turns and waits for its own products; the other warpgroup's products fill
// the gap. A score product that starts a sum does not read its accumulator
// (wgmma_ss_n64_first): with "+f" operands the old s and dp stayed live
// through the next products, and ptxas serialised B5-dkv's wgmma (C7512).
//
// Ragged edges (B3 takes any Lq and Lk): TMA zero-fills the rows of a tile
// past its operand's extent and its stores drop them. In dq, key columns
// past Lk get s = -inf (mask_keys), so p = 0 there. In dkv, query columns
// past Lq get lse = +inf and delta = 0, so p = 0 and ds = 0 there. The lse
// and delta spans: the long tier copies each step's 64 values with one bulk
// copy (its rows start 256 bytes apart). At an unaligned Lq a (batch, head)'s
// rows start anywhere (1,548 bytes apart at 387), where neither a bulk copy
// nor a TMA box may start (16-byte aligned starts only), so B3 reads them
// with ordinary loads: warp 1 of the producer warpgroup (idle otherwise)
// writes each step's spans, masked, into the slot, and arrives on its full
// barrier beside the TMA bytes. The long tier's lengths are multiples of 128
// and never reach those edges.
//
// With a bias (BIAS true: B5-dq-bias, B5-dkv-bias; with ONE_PASS B3-bias),
// each step's fp32 bias tile comes by TMA into a ring of its own, BIAS_SLOTS
// slots on their own barriers (the block's own rows: dq's 128 query rows x
// 64 keys, dkv's 64 query rows x 128 keys, both 32 KB, in boxes of 32 keys),
// beside a K/V (q/dO) ring of three slots, so that 224 KB of shared memory
// hold it all. A bias slot is released as soon as the step's exps have read
// it (B3-dq reads each key tile's bias twice: its pass 1 loads every K tile
// with its bias tile). The scores are then formed as the function has them,
// x = round(round(s * scale) + bias), with the max and lse in natural units:
// log2 units would turn a mask's finite min into -inf and a row that the
// mask shuts out entirely into NaN, where it averages v (p = 1 on each key;
// lse = the finite min). Only the difference to the max goes to log2 units,
// exp2((x - m) log2 e). B3's keys past Lk (TMA zero-fills K and the bias
// there, so x = 0) are masked after the bias is added, in both passes.
// The bias values are read from shared memory inside the loop that forms p,
// not held beside s, dp and the halves. A bias broadcast over the heads is
// read by every head of a batch row: with `heads_fastest` the grid runs a
// tile's heads side by side (tile_and_head), so that the bias rows come from
// HBM about once rather than once for each head.
//
// A consumer reads a ring slot that TMA or a bulk copy wrote (the bias tile,
// the long tier's lse and delta spans) with ordinary loads, and the slot's
// next load is the async proxy's: it fences (fence.proxy.async) before it
// frees the slot, or the load could land before a read.

#pragma once

#include "hopper_sm90.cuh"

namespace {

constexpr int DQ_STAGES = 4;    // the unbiased dq kernels' ring: K and V tiles (5: no faster)
constexpr int DKV_STAGES = 4;   // the unbiased dkv kernels' ring: q, dO, lse and delta
constexpr int BIAS_STAGES = 3;  // the biased kernels' K/V (q/dO) ring beside the bias ring
constexpr int BIAS_SLOTS = 2;   // the biased kernels' ring of bias tiles

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

// x as the register-A operand of four k16 steps, rounded once to bf16.
__device__ __forceinline__ void pack_bf16_a(const float (&x)[32], uint32_t (&a)[4][4]) {
#pragma unroll
  for (int kb = 0; kb < 4; ++kb)
#pragma unroll
    for (int e = 0; e < 4; ++e) a[kb][e] = pack_bf16(x[8 * kb + 2 * e], x[8 * kb + 2 * e + 1]);
}

// The bias ring of a biased kernel at `base`: BIAS_SLOTS tiles of `TILE`
// bytes (boxes of BOX bytes), then their full and empty barriers. Empty (0
// bytes) for an unbiased kernel. Its addresses are computed from the one
// base, so that a consumer holds no more pointers than that.
template <bool BIAS, int BOX_ROWS, int COLS>
struct BiasRing {
  static constexpr int BOX = BOX_ROWS * 128;  // BOX_ROWS rows of BIAS_COLS fp32
  static constexpr int TILE = BOX * (COLS / BIAS_COLS);
  static constexpr int SLOTS = BIAS ? BIAS_SLOTS : 0;
  static constexpr int BYTES = SLOTS * (TILE + 16);  // tiles and barriers
  unsigned char* base;

  __device__ unsigned char* tile(int s) const { return base + s * TILE; }
  __device__ uint64_t* full(int s) const {
    return reinterpret_cast<uint64_t*>(base + SLOTS * TILE) + s;
  }
  __device__ uint64_t* empty(int s) const { return full(SLOTS + s); }

  __device__ void init_barriers() const {
    for (int s = 0; s < SLOTS; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), 8);  // one arrival per consumer warp of this block
    }
  }

  // The producer: step i's tile, boxes of keys col0.. at rows row0.., once
  // the slot's previous tile has been read.
  __device__ void load(const CUtensorMap* tm, int i, int col0, int row0, int hb, int bb) const {
    const int s = i % SLOTS;
    mbar_wait(empty(s), ((i / SLOTS) & 1) ^ 1);
    mbar_expect_tx(full(s), TILE);
    for (int c = 0; c < COLS / BIAS_COLS; ++c)
      tma_load(tile(s) + c * BOX, tm, full(s), col0 + BIAS_COLS * c, row0, hb, bb);
  }

  // A consumer: wait for step i's tile.
  __device__ const unsigned char* wait(int i) const {
    const int s = i % SLOTS;
    mbar_wait(full(s), (i / SLOTS) & 1);
    return tile(s);
  }

  // A consumer warp done reading step i's tile. The reads are the generic
  // proxy's and the tile's next load is the async proxy's (TMA): without
  // the proxy fence the load could land before a read (on the card the
  // biased B5-dq then gave other bits from one run to the next).
  __device__ void release(int i, int lane) const {
    __syncwarp();
    fence_async_shared();
    if (lane == 0) mbar_arrive(empty(i % SLOTS));
  }
};

// The (tile, head, batch) of this block's work item `item`: on B3's
// persistent grid (PERSISTENT; 1-D, item_grid) as work_item decodes it, on
// the long tier's grid of one cluster an item (tile_grid) from the block's
// index, as tile_and_head reads it.
template <bool PERSISTENT>
__device__ __forceinline__ int3 cluster_item(int item, int pairs, int H, bool heads_fastest) {
  if constexpr (PERSISTENT) return work_item(item, pairs, H, heads_fastest);
  const int2 th = tile_and_head(heads_fastest, H);
  return make_int3(th.x, th.y, blockIdx.z);
}

// The shared memory of a kernel that streams K and V tiles of 64 keys past
// RESIDENT resident 128-row tiles (the dq kernels: q and dO; B4-bias: q),
// with a bias ring when BIAS.
template <int D, int STAGES, bool BIAS, int RESIDENT = 2>
struct DqSmem {
  static constexpr int TILE = 128 * D * 2;    // a resident q or dO tile
  static constexpr int STEP = STEP_N * D * 2;  // a K or V tile
  using Ring = BiasRing<BIAS, ATT_M, STEP_N>;  // 128 query rows x 64 keys
  static constexpr int BYTES =
      RESIDENT * TILE + 2 * STAGES * STEP + Ring::BYTES + 8 * (2 + 2 * STAGES) + 1024;
  unsigned char* q;
  unsigned char* dout;  // RESIDENT 2 only
  uint64_t* q_full;  // then q_empty: the resident tiles free again (B3's persistent grid)
  uint64_t* full;
  uint64_t* empty;
  Ring bias;

  __device__ explicit DqSmem(unsigned char* raw) {
    q = reinterpret_cast<unsigned char*>(
        (reinterpret_cast<uintptr_t>(raw) + 1023) & ~static_cast<uintptr_t>(1023));
    dout = q + TILE;
    bias.base = q + RESIDENT * TILE + 2 * STAGES * STEP;
    q_full = reinterpret_cast<uint64_t*>(bias.base + Ring::BYTES);
    full = q_full + 2;
    empty = full + STAGES;
  }

  // both consumer warpgroups' stores have read the resident tiles (computed,
  // not held: a member would hold one more pointer in the producer's 40
  // registers)
  __device__ uint64_t* q_empty() const { return q_full + 1; }

  // slot s's K and V tiles (computed, not looked up: a runtime index into
  // an array of pointers would put the array in local memory)
  __device__ unsigned char* k(int s) const { return q + RESIDENT * TILE + s * STEP; }
  __device__ unsigned char* v(int s) const {
    return q + RESIDENT * TILE + (STAGES + s) * STEP;
  }

  __device__ void init_barriers() const {
    mbar_init(q_full, 1);
    mbar_init(q_empty(), 2);  // one arrival per consumer warpgroup
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 8 * ATT_PAIR);
    }
    bias.init_barriers();
    mbar_init_fence();
  }
};

// The producer thread of such a kernel, for one work item: the resident
// tiles (this block's own: q, and dO with RESIDENT 2), then `k_only` loads
// of a K tile alone (B3-dq's pass 1), then n_tiles of K and V tiles, load i
// of 64 keys from STEP_N * (i or i - k_only), the ring's load g + i (g: the
// loads of the block's earlier items), into slot (g + i) % STAGES once both
// blocks' consumers released it; of a slot's boxes (K's, then V's) this block
// issues those of index `rank` modulo the pair, to both blocks. With a bias,
// each K/V load's bias tile (query rows q0.., head hb, batch bb) too.
template <int D, int STAGES, bool BIAS, int RESIDENT>
__device__ __forceinline__ void dq_produce(const DqSmem<D, STAGES, BIAS, RESIDENT>& sm,
                                           const CUtensorMap* tm_q, const CUtensorMap* tm_do,
                                           const CUtensorMap* tm_k, const CUtensorMap* tm_v,
                                           const CUtensorMap* tm_b, int q0, int h, int kvh,
                                           int b, int hb, int bb, int n_tiles, int k_only,
                                           int g, int rank) {
  constexpr int BOXES = D / 64;
  constexpr uint16_t BOTH = (1 << ATT_PAIR) - 1;
  using S = DqSmem<D, STAGES, BIAS, RESIDENT>;
  mbar_expect_tx(sm.q_full, RESIDENT * S::TILE);
  for (int c = 0; c < BOXES; ++c) {
    tma_load(sm.q + c * ATT_BOX, tm_q, sm.q_full, 64 * c, q0, h, b);
    if constexpr (RESIDENT == 2)
      tma_load(sm.dout + c * ATT_BOX, tm_do, sm.q_full, 64 * c, q0, h, b);
  }
  for (int i = 0; i < k_only + n_tiles; ++i) {
    const int s = (g + i) % STAGES;
    const bool with_v = i >= k_only;
    const int key0 = (with_v ? i - k_only : i) * STEP_N;
    mbar_wait(&sm.empty[s], (((g + i) / STAGES) & 1) ^ 1);
    mbar_expect_tx(&sm.full[s], (with_v ? 2 : 1) * S::STEP);
    for (int box = rank; box < (with_v ? 2 : 1) * BOXES; box += ATT_PAIR) {
      const bool is_v = box >= BOXES;
      const int c = box % BOXES;
      tma_load_multicast((is_v ? sm.v(s) : sm.k(s)) + c * STEP_BOX, is_v ? tm_v : tm_k,
                         &sm.full[s], BOTH, 64 * c, key0, kvh, b);
    }
    if constexpr (BIAS) sm.bias.load(tm_b, g + i, key0, q0, hb, bb);
  }
}

// x = round(round(s * scale) + bias) in place for this thread's 64 x 64
// scores (dq's tile rows `row` and row + 8: the bias tile's rows), as the
// forward forms them.
__device__ __forceinline__ void add_bias_rows(float (&s)[32], const unsigned char* bias,
                                              int row, int tq, float scale) {
#pragma unroll
  for (int r = 0; r < 2; ++r)
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      const float2 bv = *bias_row_pair(bias, ATT_M * 128, row, 0, tq, n, r);
      float& x0 = s[4 * n + 2 * r];
      float& x1 = s[4 * n + 2 * r + 1];
      x0 = __fadd_rn(__fmul_rn(x0, scale), bv.x);
      x1 = __fadd_rn(__fmul_rn(x1, scale), bv.y);
    }
}

// The long tier's online step for one tile of 64 keys: s (fp32, unscaled
// scores) and, for B5-dq, dp (dO . v^T) in; the new row max m, p = exp(s -
// m), l = l a + rowsum(p) (this thread's part), acc rescaled by a, and t as
// two register-A operands, hi and lo: t = p (dp - delta) for B5-dq, t = p
// itself with FWD (B4-bias). Without a bias m is in log2 units (c = scale
// log2 e); with one, s becomes x = round(round(s * scale) + bias) (the bias
// tile's rows `row` and row + 8) and m stays in natural units.
template <int D, bool BIAS, bool FWD = false>
__device__ __forceinline__ void dq_step(float (&acc)[D / 2], float (&s)[32],
                                        const float (&dp)[32], float m[2], float l[2],
                                        const float delta[2], uint32_t (&hi)[4][4],
                                        uint32_t (&lo)[4][4], float scale, float c,
                                        const unsigned char* bias, int row, int tq) {
  float a[2];
  if constexpr (BIAS) add_bias_rows(s, bias, row, tq, scale);
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
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const int i = 4 * n + 2 * r + u;
        const float p = BIAS ? exp2_approx(__fmul_rn(s[i] - m_new, LOG2E))
                             : exp2_approx(fmaf(s[i], c, -m_new));
        sum += p;
        s[i] = FWD ? p : p * (dp[i] - delta[r]);
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

// B3-dq's step for one tile of 64 keys from key0: s and dp (fp32, unscaled
// scores and dO . v^T) in; p = exp(s - m) / l with pass 1's row max m (log2
// units, c = scale log2 e) and row sum l, the division as a multiply by the
// row's correctly rounded reciprocal `inv` and one FMA correction step, as
// B1's pass 2; keys past Lk at p = 0; ds = p (dp - delta), rounded once to
// bf16, as the register-A operand `ds`. With a bias (B3-bias), s becomes x
// = round(round(s * scale) + bias) (the bias tile's rows `row` and row + 8)
// before the keys past Lk are masked, m is in natural units, and p = exp2((x
// - m) log2 e) / l.
template <bool BIAS>
__device__ __forceinline__ void dq_step_normalised(float (&s)[32], const float (&dp)[32],
                                                   const float m[2], const float l[2],
                                                   const float inv[2], const float delta[2],
                                                   uint32_t (&ds)[4][4], float scale, float c,
                                                   const unsigned char* bias, int row,
                                                   int key0, int Lk, int tq) {
  if constexpr (BIAS) add_bias_rows(s, bias, row, tq, scale);
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
        const float ex = BIAS ? exp2_approx(__fmul_rn(s[i] - m[r], LOG2E))
                              : exp2_approx(fmaf(s[i], c, -m[r]));
        const float y = ex * inv[r];
        const float p = fmaf(inv[r], fmaf(-y, l[r], ex), y);
        x[u] = p * (dp[i] - delta[r]);
      }
      ds[kb][e] = pack_bf16(x[0], x[1]);
    }
}

// Kernel B5-dq (B5-dq-bias with BIAS; B3's dq kernel with ONE_PASS, B3-bias's
// with both). Only B3's walks work items (PERSISTENT): B3-bias's, its
// consumers holding the bias reads beside the item loop, spilled 16 bytes at
// D = 128 on the persistent grid, so it runs one cluster an item.
// `bias_heads` / `bias_batches`: the bias map's extents of those axes (1:
// broadcast, read at index 0). Each cluster takes the work item (a pair of
// query tiles, a head, a batch: cluster_item) of its index; with PERSISTENT
// it walks on by the grid's clusters (B3's persistent grid: the ring's slots
// and phases run on from one item to the next). The producer waits until
// both warpgroups' dq stores have read the staged rows (q_empty) before it
// loads the next item's resident tiles and then its K and V tiles, so those
// loads do not overlap this item's products: the grid saves the launch,
// barrier set-up and teardown of a cluster an item, not load latency. On
// a grid of one cluster an item the loop runs once.
template <int D, bool BIAS, bool ONE_PASS>
__global__ void __cluster_dims__(ATT_PAIR, 1, 1) __launch_bounds__(ATT_THREADS, 1)
attn_bwd_dq_wgmma_kernel(const __grid_constant__ CUtensorMap tm_q,
                         const __grid_constant__ CUtensorMap tm_k,
                         const __grid_constant__ CUtensorMap tm_v,
                         const __grid_constant__ CUtensorMap tm_do,
                         const __grid_constant__ CUtensorMap tm_dq,
                         const __grid_constant__ CUtensorMap tm_b,
                         const float* __restrict__ delta, float* __restrict__ lse, int rep,
                         int B, int H, int Lq, int Lk, int bias_heads, int bias_batches,
                         int heads_fastest, float scale) {
  constexpr int STAGES = BIAS ? BIAS_STAGES : DQ_STAGES;
  constexpr bool PERSISTENT = ONE_PASS && !BIAS;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const DqSmem<D, STAGES, BIAS> sm(smem_raw);
  const int pairs = ((Lq + ATT_M - 1) / ATT_M + ATT_PAIR - 1) / ATT_PAIR;
  const int n_items = pairs * H * B, stride = gridDim.x / ATT_PAIR;
  const int n_tiles = (Lk + STEP_N - 1) / STEP_N;
  const int n1 = ONE_PASS ? n_tiles : 0;  // pass 1's loads of K alone
  if (threadIdx.x == 0) sm.init_barriers();
  cluster_sync();  // the pair's barriers are ready before any multicast or remote arrival
  const int wg = threadIdx.x / 128;
  if (wg == 0) {
    setmaxnreg_dec<40>();
    if (threadIdx.x == 0) {
      for (int item = blockIdx.x / ATT_PAIR, k = 0;; item += stride, ++k) {
        const int3 w = cluster_item<PERSISTENT>(item, pairs, H, heads_fastest);
        if constexpr (PERSISTENT) mbar_wait(sm.q_empty(), (k & 1) ^ 1);
        dq_produce(sm, &tm_q, &tm_do, &tm_k, &tm_v, &tm_b, w.x * ATT_M, w.y, w.y / rep, w.z,
                   bias_heads > 1 ? w.y : 0, bias_batches > 1 ? w.z : 0, n_tiles, n1,
                   k * (n1 + n_tiles), cluster_rank());
        if (!PERSISTENT || item + stride >= n_items) break;
      }
    }
    cluster_sync();
  } else {
    setmaxnreg_inc<232>();
    const int cw = wg - 1, t = threadIdx.x % 128, lane = t % 32, tq = lane % 4;
    const int row = 64 * cw + (t / 32) * 16 + lane / 4;  // this thread's first tile row
    unsigned char* q_rows = sm.q + cw * 64 * 128;
    const unsigned char* do_rows = sm.dout + cw * 64 * 128;
    const float c = scale * LOG2E;  // unbiased: scores in log2 units
    turns_start(cw);
    for (int item = blockIdx.x / ATT_PAIR, k = 0;; item += stride, ++k) {
      const int3 w = cluster_item<PERSISTENT>(item, pairs, H, heads_fastest);
      const int h = w.y, b = w.z, row0 = w.x * ATT_M + 64 * cw;
      const int g = k * (n1 + n_tiles);  // the ring's loads of this block's earlier items
      const bool last_item = !PERSISTENT || item + stride >= n_items;
      // this thread's rows: row0 + 16 w + g and + 8 (rows past Lq, of a
      // ragged tile or of the pair's padding, read no delta and store nothing)
      const long long stat0 = ((long long)b * H + h) * Lq;
      int rows[2];
      float dl[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        rows[r] = row0 + (t / 32) * 16 + (t % 32) / 4 + 8 * r;
        dl[r] = rows[r] < Lq ? delta[stat0 + rows[r]] : 0.f;
      }
      mbar_wait(sm.q_full, k & 1);

      float m[2] = {NEG_F32, NEG_F32}, l[2] = {0.f, 0.f}, inv[2] = {1.f, 1.f};
      float s[32], dp[32];
      if constexpr (ONE_PASS) {
        // pass 1 (B1's over 64-key tiles): the row max m (log2 units; with
        // a bias natural units, on x) and this thread's part of the row sum
        // l; one turn per K tile
        for (int j = 0; j < n1; ++j) {
          const int st = (g + j) % STAGES;
          mbar_wait(&sm.full[st], ((g + j) / STAGES) & 1);
          turn_begin(cw);
          wgmma_fence();
          step_scores_issue<D>(s, q_rows, sm.k(st));
          wgmma_commit();
          turn_end(cw, false);
          wgmma_wait<0>();
          fence_regs(s);
          release_slot(&sm.empty[st], lane);
          if constexpr (BIAS) {
            add_bias_rows(s, sm.bias.wait(g + j), row, tq, scale);
            sm.bias.release(g + j, lane);
          }
          mask_keys(s, j * STEP_N, Lk, tq);
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            float sum = 0.f;
            if constexpr (BIAS) {
              const float m_new = fmaxf(m[r], row_max(s, r));
#pragma unroll
              for (int n = 0; n < 8; ++n)
                sum += exp2_approx(__fmul_rn(s[4 * n + 2 * r] - m_new, LOG2E)) +
                       exp2_approx(__fmul_rn(s[4 * n + 2 * r + 1] - m_new, LOG2E));
              l[r] = l[r] * exp2_approx(__fmul_rn(m[r] - m_new, LOG2E)) + sum;
              m[r] = m_new;
            } else {
              const float m_new = fmaxf(m[r], row_max(s, r) * c);
#pragma unroll
              for (int n = 0; n < 8; ++n)
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

      // pass 2, pipelined by one tile, as B4: the turn of tile j issues acc
      // += t_{j-1} . K_{j-1} (B5: hi, then lo) and s_j, dp_j together, then
      // takes tile j's step while the other warpgroup's products run. Its
      // load is the ring's g + n1 + j.
      float acc[D / 2];
#pragma unroll
      for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
      uint32_t hi[4][4], lo[4][4];
      const int g2 = g + n1;
      // tile j's step (a biased kernel's reads, and then releases, its bias
      // tile: the ring's load g2 + j)
      auto step = [&](int j) {
        const unsigned char* bias = nullptr;
        if constexpr (BIAS) bias = sm.bias.wait(g2 + j);
        if constexpr (ONE_PASS)
          dq_step_normalised<BIAS>(s, dp, m, l, inv, dl, hi, scale, c, bias, row, j * STEP_N,
                                   Lk, tq);
        else
          dq_step<D, BIAS>(acc, s, dp, m, l, dl, hi, lo, scale, c, bias, row, tq);
        if constexpr (BIAS) sm.bias.release(g2 + j, lane);
      };
      {
        const int st = g2 % STAGES;
        mbar_wait(&sm.full[st], (g2 / STAGES) & 1);
        turn_begin(cw);
        wgmma_fence();
        step_scores_issue<D>(s, q_rows, sm.k(st));
        step_scores_issue<D>(dp, do_rows, sm.v(st));
        wgmma_commit();
        turn_end(cw, false);
        wgmma_wait<0>();
        fence_regs(s);
        fence_regs(dp);
      }
      step(0);
      for (int j = 1; j < n_tiles; ++j) {
        const int i = g2 + j, st = i % STAGES, prev = (i - 1) % STAGES;
        mbar_wait(&sm.full[st], (i / STAGES) & 1);
        turn_begin(cw);
        wgmma_fence();
        step_acc_issue<D>(acc, hi, sm.k(prev));
        if constexpr (!ONE_PASS) step_acc_issue<D>(acc, lo, sm.k(prev));
        step_scores_issue<D>(s, q_rows, sm.k(st));
        step_scores_issue<D>(dp, do_rows, sm.v(st));
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
      const int last = (g2 + n_tiles - 1) % STAGES;
      turn_begin(cw);
      wgmma_fence();
      step_acc_issue<D>(acc, hi, sm.k(last));
      if constexpr (!ONE_PASS) step_acc_issue<D>(acc, lo, sm.k(last));
      wgmma_commit();
      turn_end(cw, last_item);
      wgmma_wait<0>();
      fence_regs(acc);
      fence_regs(hi);
      if constexpr (!ONE_PASS) fence_regs(lo);
      release_slot(&sm.empty[last], lane);
      // B3's p is normalised already; B5 divides last
      float div[2] = {1.f, 1.f};
      if constexpr (!ONE_PASS) {
        div[0] = fmaxf(quad_sum(l[0]), 1e-30f);
        div[1] = fmaxf(quad_sum(l[1]), 1e-30f);
      }
      attn_store<D>(q_rows, &tm_dq, acc, div, t, cw, row0, Lq, h, b, scale);
      if (PERSISTENT && t == 0) mbar_arrive(sm.q_empty());  // its store has read the staged rows
      if (t % 4 == 0) {
#pragma unroll
        for (int r = 0; r < 2; ++r)
          if (rows[r] < Lq)
            lse[stat0 + rows[r]] =
                (BIAS ? m[r] : m[r] * LN2) + logf(ONE_PASS ? l[r] : div[r]);
      }
      if (last_item) break;
    }
    cluster_sync();
  }
}

template <int D, int STAGES, bool BIAS>
struct DkvSmem {
  static constexpr int TILE = 128 * D * 2;    // the resident k or v tile
  static constexpr int STEP = STEP_N * D * 2;  // a q or dO tile
  static constexpr int STATS = STEP_N * 4;     // a span of lse or delta
  using Ring = BiasRing<BIAS, STEP_N, ATT_M>;  // 64 query rows x 128 keys
  static constexpr int BYTES = 2 * TILE + 2 * STAGES * STEP + Ring::BYTES +
                               2 * STAGES * STATS + 8 * (1 + 2 * STAGES) + 1024;
  unsigned char* k;
  unsigned char* v;
  uint64_t* kv_full;
  uint64_t* full;
  uint64_t* empty;
  Ring bias;

  __device__ explicit DkvSmem(unsigned char* raw) {
    k = reinterpret_cast<unsigned char*>(
        (reinterpret_cast<uintptr_t>(raw) + 1023) & ~static_cast<uintptr_t>(1023));
    v = k + TILE;
    // the bias ring follows the q and dO tiles (1024-byte aligned), the
    // stats spans follow it
    bias.base = k + 2 * TILE + 2 * STAGES * STEP;
    kv_full = reinterpret_cast<uint64_t*>(bias.base + Ring::BYTES + 2 * STAGES * STATS);
    full = kv_full + 1;
    empty = full + STAGES;
  }

  // slot s's q and dO tiles and lse and delta spans (computed, as DqSmem's)
  __device__ unsigned char* q(int s) const { return k + 2 * TILE + s * STEP; }
  __device__ unsigned char* dout(int s) const { return k + 2 * TILE + (STAGES + s) * STEP; }
  __device__ float* lse(int s) const {
    return reinterpret_cast<float*>(bias.base + Ring::BYTES + s * STATS);
  }
  __device__ float* delta(int s) const {
    return reinterpret_cast<float*>(bias.base + Ring::BYTES + (STAGES + s) * STATS);
  }

  // `writers`: arrivals a slot's full barrier takes besides the TMA thread's
  // (B3's stats warp: 32)
  __device__ void init_barriers(int writers) const {
    mbar_init(kv_full, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1 + writers);
      mbar_init(&empty[s], 8 * ATT_PAIR);
    }
    bias.init_barriers();
    mbar_init_fence();
  }
};

// The dkv kernels' producer thread: the k and v tiles (this block's own),
// then one step per (query head of the GQA group, 64-row query tile): q and
// dO boxes shared with the pair as dq_produce's K and V; in the long tier
// (STATS) this block's own bulk copy of the step's 64 lse and delta values;
// with a bias, the step's bias tile (query rows of the step, the block's keys
// k0..).
template <int D, int STAGES, bool BIAS, bool STATS>
__device__ __forceinline__ void dkv_produce(const DkvSmem<D, STAGES, BIAS>& sm,
                                            const CUtensorMap* tm_q, const CUtensorMap* tm_do,
                                            const CUtensorMap* tm_k, const CUtensorMap* tm_v,
                                            const CUtensorMap* tm_b, const float* lse,
                                            const float* delta, int k0, int kvh, int b,
                                            int group, int H, int Lq, int n_qt, bool bias_heads,
                                            bool bias_batches, int rank) {
  constexpr int BOXES = D / 64;
  constexpr uint16_t BOTH = (1 << ATT_PAIR) - 1;
  using S = DkvSmem<D, STAGES, BIAS>;
  mbar_expect_tx(sm.kv_full, 2 * S::TILE);
  for (int c = 0; c < BOXES; ++c) {
    tma_load(sm.k + c * ATT_BOX, tm_k, sm.kv_full, 64 * c, k0, kvh, b);
    tma_load(sm.v + c * ATT_BOX, tm_v, sm.kv_full, 64 * c, k0, kvh, b);
  }
  for (int i = 0; i < group * n_qt; ++i) {
    const int s = i % STAGES;
    const int hq = kvh * group + i / n_qt, row0 = (i % n_qt) * STEP_N;
    mbar_wait(&sm.empty[s], ((i / STAGES) & 1) ^ 1);
    mbar_expect_tx(&sm.full[s], 2 * (S::STEP + (STATS ? S::STATS : 0)));
    for (int box = rank; box < 2 * BOXES; box += ATT_PAIR) {
      const bool is_do = box >= BOXES;
      const int c = box % BOXES;
      tma_load_multicast((is_do ? sm.dout(s) : sm.q(s)) + c * STEP_BOX, is_do ? tm_do : tm_q,
                         &sm.full[s], BOTH, 64 * c, row0, hq, b);
    }
    if constexpr (STATS) {
      const long long stat = ((long long)b * H + hq) * Lq + row0;
      bulk_load(sm.lse(s), lse + stat, S::STATS, &sm.full[s]);
      bulk_load(sm.delta(s), delta + stat, S::STATS, &sm.full[s]);
    }
    if constexpr (BIAS)
      sm.bias.load(tm_b, i, k0, row0, bias_heads ? hq : 0, bias_batches ? b : 0);
  }
}

// B3's stats warp (warp 1 of the producer warpgroup, `lane` its lane): each
// step's 64 lse and delta values by ordinary loads into the step's slot,
// lse = +inf and delta = 0 for query rows at or past Lq (so p = 0 and ds = 0
// there), then one arrival per lane on the slot's full barrier (a release:
// the consumers' wait orders their reads after these writes).
template <int D, int STAGES, bool BIAS>
__device__ __forceinline__ void dkv_stats(const DkvSmem<D, STAGES, BIAS>& sm, const float* lse,
                                          const float* delta, int kvh, int b, int group, int H,
                                          int Lq, int n_qt, int lane) {
  for (int i = 0; i < group * n_qt; ++i) {
    const int s = i % STAGES;
    const int hq = kvh * group + i / n_qt, row0 = (i % n_qt) * STEP_N;
    const long long stat = ((long long)b * H + hq) * Lq + row0;
    mbar_wait(&sm.empty[s], ((i / STAGES) & 1) ^ 1);
#pragma unroll
    for (int e = lane; e < STEP_N; e += 32) {
      const bool live = row0 + e < Lq;
      sm.lse(s)[e] = live ? lse[stat + e] : INFINITY;
      sm.delta(s)[e] = live ? delta[stat + e] : 0.f;
    }
    mbar_arrive(&sm.full[s]);
  }
}

// The dkv step on s^T and dp^T (64 keys x 64 queries, fp32, unscaled k .
// q^T and v . dO^T): p^T = exp(s^T - lse) and ds^T = p^T (dp^T - delta) per
// query column, as register-A operands: two each, hi and lo, in the long
// tier; rounded once to bf16 with ONE_PASS (B3: p_hi and ds_hi only). With a
// bias, s^T becomes x = round(round(s^T * scale) + bias^T) (bias[query][key],
// the tile's keys `key` and key + 8 as this thread's rows), and p^T =
// exp2((x - lse) log2 e).
template <bool BIAS, bool ONE_PASS>
__device__ __forceinline__ void dkv_step(float (&s)[32], float (&dp)[32], const float* lse,
                                         const float* delta, uint32_t (&p_hi)[4][4],
                                         uint32_t (&p_lo)[4][4], uint32_t (&ds_hi)[4][4],
                                         uint32_t (&ds_lo)[4][4], float scale, float c,
                                         uint32_t bias, int tq) {
  if constexpr (BIAS) {  // x in place, before the lse and delta values are read
    // this thread's first key row of the block's tile, from the thread index
    // read here (not held over the loop: the consumers' 232 registers hold
    // dk, dv, s^T and dp^T with nothing to spare)
    const int t = thread_index(), key = 64 * (t / 128 - 1) + (t % 128) / 32 * 16 + t % 32 / 4;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const uint32_t at = bias + bias_col_offset(STEP_N * 128, key, tq, i);
#pragma unroll
      for (int j = 0; j < 8; ++j) {  // bias_col_at's element (j, i)
        const float bv = ld_shared_f32(at + 1024 * j);
        s[4 * j + i] = __fadd_rn(__fmul_rn(s[4 * j + i], scale), bv);
      }
    }
  }
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const float2 ls = *reinterpret_cast<const float2*>(lse + 8 * j + 2 * tq);
    const float2 dl = *reinterpret_cast<const float2*>(delta + 8 * j + 2 * tq);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float x = (i & 1) ? ls.y : ls.x;
      const float p = BIAS ? exp2_approx(__fmul_rn(s[4 * j + i] - x, LOG2E))
                           : exp2_approx(fmaf(s[4 * j + i], c, -x * LOG2E));
      s[4 * j + i] = p;
      dp[4 * j + i] = p * (dp[4 * j + i] - ((i & 1) ? dl.y : dl.x));
    }
  }
  if constexpr (ONE_PASS) {
    pack_bf16_a(s, p_hi);
    pack_bf16_a(dp, ds_hi);
  } else {
    split_hi_lo(s, p_hi, p_lo);
    split_hi_lo(dp, ds_hi, ds_lo);
  }
}

// Kernel B5-dkv (B5-dkv-bias with BIAS; B3's dkv kernel with ONE_PASS, B3-bias's
// with both).
template <int D, bool BIAS, bool ONE_PASS>
__global__ void __cluster_dims__(ATT_PAIR, 1, 1) __launch_bounds__(ATT_THREADS, 1)
attn_bwd_dkv_wgmma_kernel(const __grid_constant__ CUtensorMap tm_q,
                          const __grid_constant__ CUtensorMap tm_k,
                          const __grid_constant__ CUtensorMap tm_v,
                          const __grid_constant__ CUtensorMap tm_do,
                          const __grid_constant__ CUtensorMap tm_dk,
                          const __grid_constant__ CUtensorMap tm_dv,
                          const __grid_constant__ CUtensorMap tm_b,
                          const float* __restrict__ lse, const float* __restrict__ delta,
                          int group, int H, int KVH, int Lq, int Lk, int bias_heads,
                          int bias_batches, int heads_fastest, float scale) {
  constexpr int STAGES = BIAS ? BIAS_STAGES : DKV_STAGES;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const DkvSmem<D, STAGES, BIAS> sm(smem_raw);
  const int2 th = tile_and_head(heads_fastest, KVH);
  const int k0 = th.x * ATT_M, kvh = th.y, b = blockIdx.z;
  const int n_qt = (Lq + STEP_N - 1) / STEP_N;
  const int n_steps = group * n_qt;
  if (threadIdx.x == 0) sm.init_barriers(ONE_PASS ? 32 : 0);
  cluster_sync();
  const int wg = threadIdx.x / 128;
  if (wg == 0) {
    setmaxnreg_dec<40>();
    if (threadIdx.x == 0)
      dkv_produce<D, STAGES, BIAS, !ONE_PASS>(sm, &tm_q, &tm_do, &tm_k, &tm_v, &tm_b, lse,
                                              delta, k0, kvh, b, group, H, Lq, n_qt,
                                              bias_heads > 1, bias_batches > 1, cluster_rank());
    else if (ONE_PASS && threadIdx.x / 32 == 1)
      dkv_stats(sm, lse, delta, kvh, b, group, H, Lq, n_qt, threadIdx.x % 32);
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
    // dk += ds^T . q (B5: hi then lo); dk and dv stay in registers over the
    // GQA group's heads
    float dk[D / 2], dv[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) dk[i] = dv[i] = 0.f;
    float s[32], dp[32];
    uint32_t p_hi[4][4], p_lo[4][4], ds_hi[4][4], ds_lo[4][4];
    turns_start(cw);
    for (int i = 0; i < n_steps; ++i) {
      const int st = i % STAGES;
      mbar_wait(&sm.full[st], (i / STAGES) & 1);
      turn_begin(cw);
      wgmma_fence();
      step_scores_issue<D>(s, k_rows, sm.q(st));
      step_scores_issue<D>(dp, v_rows, sm.dout(st));
      wgmma_commit();
      turn_end(cw, false);
      wgmma_wait<0>();
      fence_regs(s);
      fence_regs(dp);
      uint32_t bias = 0;
      if constexpr (BIAS) bias = smem_u32(sm.bias.wait(i));
      dkv_step<BIAS, ONE_PASS>(s, dp, sm.lse(st), sm.delta(st), p_hi, p_lo, ds_hi, ds_lo, scale,
                               c, bias, lane % 4);
      if constexpr (BIAS) sm.bias.release(i, lane);
      turn_begin(cw);
      wgmma_fence();
      step_acc_issue<D>(dv, p_hi, sm.dout(st));
      if constexpr (!ONE_PASS) step_acc_issue<D>(dv, p_lo, sm.dout(st));
      step_acc_issue<D>(dk, ds_hi, sm.q(st));
      if constexpr (!ONE_PASS) step_acc_issue<D>(dk, ds_lo, sm.q(st));
      wgmma_commit();
      turn_end(cw, i == n_steps - 1);
      wgmma_wait<0>();
      fence_regs(dk);
      fence_regs(dv);
      fence_regs(p_hi);
      fence_regs(ds_hi);
      if constexpr (!ONE_PASS) {
        fence_regs(p_lo);
        fence_regs(ds_lo);
      }
      fence_async_shared();  // the lse and delta reads before the slot's next bulk copies
      release_slot(&sm.empty[st], lane);
    }
    // dk * scale and dv as bf16 into this warpgroup's rows of the k and v
    // tiles (no longer read), then stored by TMA (rows past Lk dropped)
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

// Whether `spec` describes a (batches, heads, rows, d) bf16 operand in boxes
// of 64 columns and `box_rows` rows: what an instance of width D >= d reads
// (at d = D, 64 or 128, spec_is's description; at a narrower d, B8's wgmma
// body, TMA zero-fills the columns past d and its stores drop them).
inline bool instance_spec_is(const long long* spec, int d, int rows, int heads, int batches,
                             int box_rows) {
  return spec[0] == d && spec[1] == rows && spec[2] == heads && spec[3] == batches &&
         spec[7] == 64 && spec[8] == box_rows && spec[9] == 1 && spec[10] == 1;
}

// The fp32 bias map of a biased launch from its description `spec`, where
// the kernel takes it; an unbiased launch passes `fallback` (unread).
inline cudaError_t encode_bias_map(CUtensorMap* map, const void* bias, const long long* spec,
                                   const CUtensorMap& fallback) {
  if (bias == nullptr) {
    *map = fallback;
    return cudaSuccess;
  }
  return encode_tensor_map(map, bias, spec, CU_TENSOR_MAP_DATA_TYPE_FLOAT32);
}

// The grid of a kernel over `tiles` 128-row tiles (whole pairs: a tile past
// L stores nothing) and H heads, in tile_and_head's order.
inline dim3 tile_grid(int tiles, int H, int B, bool heads_fastest) {
  const int padded = (tiles + ATT_PAIR - 1) / ATT_PAIR * ATT_PAIR;
  return heads_fastest ? dim3(padded * H, 1, B) : dim3(padded, H, B);
}

// B3's persistent 1-D grid over `items` work items (work_item): as many
// clusters as the card holds at once of `kernel` with `smem` bytes of shared
// memory a block, at most one an item.
template <class Kernel>
cudaError_t item_grid(Kernel kernel, int smem, int items, dim3* grid) {
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3(ATT_PAIR);
  config.blockDim = dim3(ATT_THREADS);
  config.dynamicSmemBytes = smem;
  int clusters = 0;
  const cudaError_t err =
      cudaOccupancyMaxActiveClusters(&clusters, reinterpret_cast<void*>(kernel), &config);
  if (err != cudaSuccess) return err;
  if (clusters < 1) return cudaErrorInvalidConfiguration;
  *grid = dim3(ATT_PAIR * (clusters < items ? clusters : items));
  return cudaSuccess;
}

// The dq kernel on the operands at `bases` that `maps` describes (q, k, v,
// dO, dq; with BIAS the bias, then the grid order): B3's (ONE_PASS, no bias)
// on item_grid's persistent grid, the others one cluster an item
// (tile_grid). d: the operands' real width (B8's wgmma body runs a width
// below D through this instance, zero-filled).
template <int D, bool BIAS, bool ONE_PASS>
cudaError_t launch_dq_wgmma(const void* const bases[6], const long long* maps,
                            const void* delta, void* lse, int B, int H, int KVH, int Lq,
                            int Lk, float scale, cudaStream_t stream, int d = D) {
  const long long* bias = maps + 5 * MAP_SPEC;
  if (!instance_spec_is(maps, d, Lq, H, B, ATT_M) ||
      !instance_spec_is(maps + MAP_SPEC, d, Lk, KVH, B, STEP_N) ||
      !instance_spec_is(maps + 2 * MAP_SPEC, d, Lk, KVH, B, STEP_N) ||
      !instance_spec_is(maps + 3 * MAP_SPEC, d, Lq, H, B, ATT_M) ||
      !instance_spec_is(maps + 4 * MAP_SPEC, d, Lq, H, B, 64) ||
      (BIAS && !bias_spec_is(bias, Lk, Lq, H, B, ATT_M)))
    return cudaErrorInvalidValue;
  CUtensorMap tm[6];
  cudaError_t err = encode_maps(tm, bases, maps, 5);
  if (err == cudaSuccess) err = encode_bias_map(&tm[5], BIAS ? bases[5] : nullptr, bias, tm[0]);
  if (err != cudaSuccess) return err;
  constexpr int STAGES = BIAS ? BIAS_STAGES : DQ_STAGES;
  const int smem = DqSmem<D, STAGES, BIAS>::BYTES;
  err = cudaFuncSetAttribute(attn_bwd_dq_wgmma_kernel<D, BIAS, ONE_PASS>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const bool heads_fastest = BIAS && bias[MAP_SPEC] != 0;
  const int tiles = (Lq + ATT_M - 1) / ATT_M;
  dim3 grid = tile_grid(tiles, H, B, heads_fastest);
  if (ONE_PASS && !BIAS)
    err = item_grid(attn_bwd_dq_wgmma_kernel<D, BIAS, ONE_PASS>, smem,
                    (tiles + ATT_PAIR - 1) / ATT_PAIR * H * B, &grid);
  if (err != cudaSuccess) return err;
  attn_bwd_dq_wgmma_kernel<D, BIAS, ONE_PASS><<<grid, ATT_THREADS, smem, stream>>>(
          tm[0], tm[1], tm[2], tm[3], tm[4], tm[5], static_cast<const float*>(delta),
          static_cast<float*>(lse), H / KVH, B, H, Lq, Lk, BIAS ? (int)bias[2] : 1,
          BIAS ? (int)bias[3] : 1, heads_fastest, scale);
  return cudaGetLastError();
}

// The dkv kernel on the operands at `bases` that `maps` describes (q, k, v,
// dO, dk, dv), then the row spans of lse and delta (ROWS_SPEC values each);
// with BIAS the bias, then the grid order. d as launch_dq_wgmma's.
template <int D, bool BIAS, bool ONE_PASS>
cudaError_t launch_dkv_wgmma(const void* const bases[7], const long long* maps,
                             const void* lse, const void* delta, int B, int H, int KVH,
                             int Lq, int Lk, float scale, cudaStream_t stream, int d = D) {
  const long long* rows = maps + 6 * MAP_SPEC;
  const long long* bias = rows + 2 * ROWS_SPEC;
  if (!instance_spec_is(maps, d, Lq, H, B, STEP_N) ||
      !instance_spec_is(maps + MAP_SPEC, d, Lk, KVH, B, ATT_M) ||
      !instance_spec_is(maps + 2 * MAP_SPEC, d, Lk, KVH, B, ATT_M) ||
      !instance_spec_is(maps + 3 * MAP_SPEC, d, Lq, H, B, STEP_N) ||
      !instance_spec_is(maps + 4 * MAP_SPEC, d, Lk, KVH, B, 64) ||
      !instance_spec_is(maps + 5 * MAP_SPEC, d, Lk, KVH, B, 64) ||
      !rows_spec_is(rows, Lq, H, B, STEP_N) || !rows_spec_is(rows + ROWS_SPEC, Lq, H, B, STEP_N) ||
      reinterpret_cast<uintptr_t>(lse) % 16 || reinterpret_cast<uintptr_t>(delta) % 16 ||
      (BIAS && !bias_spec_is(bias, Lk, Lq, H, B, STEP_N)))
    return cudaErrorInvalidValue;
  CUtensorMap tm[7];
  cudaError_t err = encode_maps(tm, bases, maps, 6);
  if (err == cudaSuccess) err = encode_bias_map(&tm[6], BIAS ? bases[6] : nullptr, bias, tm[0]);
  if (err != cudaSuccess) return err;
  constexpr int STAGES = BIAS ? BIAS_STAGES : DKV_STAGES;
  const int smem = DkvSmem<D, STAGES, BIAS>::BYTES;
  err = cudaFuncSetAttribute(attn_bwd_dkv_wgmma_kernel<D, BIAS, ONE_PASS>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const bool heads_fastest = BIAS && bias[MAP_SPEC] != 0;
  attn_bwd_dkv_wgmma_kernel<D, BIAS, ONE_PASS>
      <<<tile_grid((Lk + ATT_M - 1) / ATT_M, KVH, B, heads_fastest), ATT_THREADS, smem,
         stream>>>(tm[0], tm[1], tm[2], tm[3], tm[4], tm[5], tm[6],
                   static_cast<const float*>(lse), static_cast<const float*>(delta), H / KVH,
                   H, KVH, Lq, Lk, BIAS ? (int)bias[2] : 1, BIAS ? (int)bias[3] : 1,
                   heads_fastest, scale);
  return cudaGetLastError();
}

}  // namespace
