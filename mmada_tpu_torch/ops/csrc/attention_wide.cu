// Kernel B7's tensor-core body ("wgmma"), for Hopper (sm_90a): attention
// on bf16 operands at the head widths 16-256 other than 64 and 128, both
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
// or 256 over K/V tiles of 64 keys: one block per (128-row query tile, head,
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
// p . v 6 as well: at most 2/3 of the bound's rate.

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
// query rows `row`, row + 8 and keys key0 + 8j + 2tq, +1), -inf past Lk.
template <bool BIAS>
__device__ __forceinline__ void wide_scores(float (&s)[32], const BiasRows& bias, int row,
                                            int key0, int Lq, int Lk, int tq, float scale) {
#pragma unroll
  for (int j = 0; j < 8; ++j)
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
// correction step, as B1), rounded to bf16.
__device__ __forceinline__ void wide_probs(uint32_t (&p)[4][4], const float (&s)[32],
                                           const float m[2], const float l[2],
                                           const float inv[2]) {
#pragma unroll
  for (int kb = 0; kb < 4; ++kb)
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

}  // namespace

// C entry, bound with ctypes: B7's wgmma body. q (B, H, Lq, D), k and v (B,
// KVH, Lk, D), o (B, H, Lq, D): bf16, D a multiple of 16 from 16 to 256 and
// neither 64 nor 128 (those are B1-B4's), rotated already if RoPE applies.
// bias: fp32 (B|1, H|1, Lq, Lk) with a contiguous last dim, or null.
// long_tier 0: the one-pass function; 1: the long one. `maps`: the
// wrapper's descriptions (ops/tensor_maps.py, MAP_SPEC values each, boxes of
// 64 columns) of q (boxes of 128 rows), k and v (64 rows) and o (64 rows),
// then the bias's element strides (batch, head, row; 0 on a broadcast axis).
// Returns a cudaError_t; 0 is success.
extern "C" int mmada_attention_wide_fwd_bf16(const void* q, const void* k, const void* v,
                                             void* o, const void* bias, int long_tier, int B,
                                             int H, int KVH, int Lq, int Lk, int D,
                                             const long long* maps, float scale, void* stream) {
  if (bad_shape(B, H, KVH, Lq, Lk) || D < 16 || D > 256 || D % 16 || D == 64 || D == 128 ||
      (long_tier != 0 && long_tier != 1) || B > 65535 || H > 65535)
    return (int)cudaErrorInvalidValue;
  if (!wide_spec_is(maps, D, Lq, H, B, ATT_M) ||
      !wide_spec_is(maps + MAP_SPEC, D, Lk, KVH, B, STEP_N) ||
      !wide_spec_is(maps + 2 * MAP_SPEC, D, Lk, KVH, B, STEP_N) ||
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
  else err = wide_tiers<256>(tm, b, bst, lt, B, H, KVH, Lq, Lk, D, scale, s);
  return (int)err;
}
