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
// streamed); here there is one kernel without a bias (B4) and one with
// (B4-bias). B5-dq replaces `_attn_bwd_dq_staged_kernel` (:1018) and its
// `_bias` (:1062), called at :1185; B5-dkv, `_attn_bwd_dkv_staged_kernel`
// (:1070) and its `_bias` (:1110), called at :1240. q and k arrive rotated
// (RoPE runs outside in fp32, as the TPU tier does), bf16 through TMA tensor
// maps; Lq and Lk are multiples of 128, as the TPU tiers require. With s =
// (q . k^T) * scale in fp32 (+ the fp32 bias (B|1, H|1, Lq, Lk), added as
// round(round(s * scale) + bias)), walking the K tiles once with a running
// max m and sum l per query row:
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
// hi + lo, two bf16 values: about 16 significant bits of p instead of the 8 a
// bf16 p would keep, where a bf16 p would compute a third function. q . k^T
// and dO . v^T multiply bf16 inputs exactly and sum in fp32; the scale
// multiplies the fp32 product (the TPU scales q first: the two differ by fp32
// rounding).
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
// is stored by TMA.
//
// B4-bias (attn_long_fwd_bias_wgmma_kernel) is B4 with the bias, on the
// stream of B5-dq-bias: K/V tiles of 64 keys in a ring of BIAS_STAGES slots,
// beside a ring of its own for the block's 128 x 64 fp32 bias tile of each
// step (by TMA from the bias's tensor map, boxes of 32 keys): a 128-key tile
// of fp32 bias (64 KB) would not fit beside B4's ring. Its online step takes
// the function's scores x = round(round(s * scale) + bias) with the max in
// natural units and only the difference to it in log2 units, exp2((x - m)
// log2 e): log2 units would turn a mask's finite min into -inf and a row that
// the mask shuts out entirely into NaN, where it averages v. A bias
// broadcast over the heads runs with the heads fastest in the grid
// (tile_and_head), so that its rows come from HBM about once.
//
// B5-dq and B5-dkv, unbiased and biased, take the same skeleton; their
// bodies, shared with the one-pass tier's B3, are in
// flash_attention_bwd_wgmma.cuh.
//
// Bound (on an H100 SXM: 989 TFLOP/s bf16 dense, 3.35 TB/s): B4 needs
// 4*B*H*Lq*Lk*D flops, B5-dq 6 and B5-dkv 8, against a few bytes per row
// (q, k, v, o; dO, dq, delta, lse; dk, dv; the bias once), so at L >= 4096
// all are bound by operations. The split products make the tensor cores do
// 6, 8 and 12 of those units: even at the tensor cores' peak B4 and B5-dkv
// take 1.5 times the bound, B5-dq 1.33 times.

#include "flash_attention_bwd_wgmma.cuh"

namespace {

constexpr int ALIGN = 128;  // Lq, Lk multiples of this, as the TPU tiers
constexpr int LONG_STAGES = 3;  // B4's K/V ring
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

// Kernel B4-bias. Its shared memory is B5-dq-bias's without the dO tile:
// the resident Q tile, BIAS_STAGES K/V slots, the bias ring (dq_produce
// streams them with RESIDENT 1). Pipelined by one tile, as B4: the turn of
// tile j issues o += p_{j-1} . V_{j-1} (hi, then lo) and s_j = q . K_j^T
// together, then takes tile j's online step (dq_step with FWD, which reads
// and releases the step's bias tile) while the other warpgroup's products
// run.
template <int D>
__global__ void __cluster_dims__(ATT_PAIR, 1, 1) __launch_bounds__(ATT_THREADS, 1)
attn_long_fwd_bias_wgmma_kernel(const __grid_constant__ CUtensorMap tm_q,
                                const __grid_constant__ CUtensorMap tm_k,
                                const __grid_constant__ CUtensorMap tm_v,
                                const __grid_constant__ CUtensorMap tm_o,
                                const __grid_constant__ CUtensorMap tm_b, int rep, int H,
                                int Lq, int Lk, int bias_heads, int bias_batches,
                                int heads_fastest, float scale) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const DqSmem<D, BIAS_STAGES, true, 1> sm(smem_raw);
  const int2 th = tile_and_head(heads_fastest, H);
  const int q0 = th.x * ATT_M, h = th.y, b = blockIdx.z;
  const int n_tiles = Lk / STEP_N;
  if (threadIdx.x == 0) sm.init_barriers();
  cluster_sync();  // the pair's barriers are ready before any multicast or remote arrival
  const int wg = threadIdx.x / 128;
  if (wg == 0) {
    setmaxnreg_dec<40>();
    if (threadIdx.x == 0)  // (no dO: tm_q stands in for its unread map)
      dq_produce(sm, &tm_q, &tm_q, &tm_k, &tm_v, &tm_b, q0, h, h / rep, b,
                 bias_heads > 1 ? h : 0, bias_batches > 1 ? b : 0, n_tiles, 0, 0, cluster_rank());
    cluster_sync();  // the pair's last multicasts and arrivals are done
  } else {
    setmaxnreg_inc<232>();
    const int cw = wg - 1, t = threadIdx.x % 128, lane = t % 32, tq = lane % 4;
    const int row = 64 * cw + (t / 32) * 16 + lane / 4;  // this thread's first tile row
    unsigned char* q_rows = sm.q + cw * 64 * 128;
    mbar_wait(sm.q_full, 0);

    float o[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
    float m[2] = {NEG_F32, NEG_F32}, l[2] = {0.f, 0.f};  // l: this thread's part
    const float no_delta[2] = {0.f, 0.f};
    float s[32];
    uint32_t hi[4][4], lo[4][4];
    // tile j's online step (s stands in for dp, which FWD does not read)
    auto step = [&](int j) {
      const unsigned char* bias = sm.bias.wait(j);
      dq_step<D, true, true>(o, s, s, m, l, no_delta, hi, lo, scale, 0.f, bias, row, tq);
      sm.bias.release(j, lane);
    };
    turns_start(cw);
    mbar_wait(&sm.full[0], 0);
    turn_begin(cw);
    wgmma_fence();
    step_scores_issue<D>(s, q_rows, sm.k(0));
    wgmma_commit();
    turn_end(cw, false);
    wgmma_wait<0>();
    fence_regs(s);
    step(0);
    for (int j = 1; j < n_tiles; ++j) {
      const int st = j % BIAS_STAGES, prev = (j - 1) % BIAS_STAGES;
      mbar_wait(&sm.full[st], (j / BIAS_STAGES) & 1);
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
      step(j);
    }
    const int last = (n_tiles - 1) % BIAS_STAGES;
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
    const float div[2] = {fmaxf(quad_sum(l[0]), 1e-30f), fmaxf(quad_sum(l[1]), 1e-30f)};
    attn_store<D>(q_rows, &tm_o, o, div, t, cw, q0 + 64 * cw, Lq, h, b);
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
// The fp32 bias tile reads, for the card test that pins the bias map's
// swizzle against bias_at: a tile of `cols` keys (2 or 4 boxes of BIAS_COLS)
// and `rows` query rows by TMA, then each of two warpgroups reads its part
// as the kernels do: `transposed` false, B2's and B5-dq-bias's read
// (bias_row_pair: 128 rows x 64 keys, warpgroup cw rows 64 cw..); true,
// B5-dkv-bias's (bias_col_at: 64 rows x 128 keys, warpgroup cw keys 64
// cw.., read as the rows of k . q^T). out (128 x 64, fp32, row-major) gets
// element (row, key), or (key, query) when transposed.
__global__ void __launch_bounds__(256)
bias_tile_kernel(const __grid_constant__ CUtensorMap tm_b, int transposed, float* out) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* tile = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  uint64_t* bar = reinterpret_cast<uint64_t*>(tile + ATT_M * STEP_N * 4);
  const int rows = transposed ? STEP_N : ATT_M, boxes = transposed ? 4 : 2;
  const int t = threadIdx.x;
  if (t == 0) {
    mbar_init(bar, 1);
    mbar_init_fence();
  }
  __syncthreads();
  if (t == 0) {
    mbar_expect_tx(bar, ATT_M * STEP_N * 4);
    for (int c = 0; c < boxes; ++c)
      tma_load(tile + c * rows * 128, &tm_b, bar, BIAS_COLS * c, 0, 0, 0);
  }
  mbar_wait(bar, 0);
  const int cw = t / 128, w = (t % 128) / 32, g = (t % 32) / 4, tq = t % 4;
  const int first = 64 * cw + 16 * w + g;  // this thread's first accumulator row
  float bv[32];
  bias_values(bv, tile, rows * 128, first, tq, transposed);
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i)
      out[(first + 8 * (i >> 1)) * 64 + 8 * j + 2 * tq + (i & 1)] = bv[4 * j + i];
}

template <int D>
__global__ void __launch_bounds__(128)
wgmma_bwd_tile_kernel(const __grid_constant__ CUtensorMap tm_x,
                      const __grid_constant__ CUtensorMap tm_y, float* s_out, float* o_out) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* x = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  unsigned char* y = x + (D / 64) * ATT_BOX;
  uint64_t* bar = reinterpret_cast<uint64_t*>(y + (D / 64) * STEP_BOX);
  const int t = threadIdx.x;
  if (t == 0) {
    mbar_init(bar, 1);
    mbar_init_fence();
  }
  __syncthreads();
  if (t == 0) {
    mbar_expect_tx(bar, (D / 64) * (ATT_BOX + STEP_BOX));
    for (int c = 0; c < D / 64; ++c) {
      tma_load(x + c * ATT_BOX, &tm_x, bar, 64 * c, 0, 0, 0);
      tma_load(y + c * STEP_BOX, &tm_y, bar, 64 * c, 0, 0, 0);
    }
  }
  mbar_wait(bar, 0);
  float s[32];
  wgmma_fence();
  step_scores_issue<D>(s, x + 64 * 128, y);
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
  step_acc_issue<D>(o, p, y);
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
// B4-bias on the operands at `bases` that `maps` describes (q, k, v, o,
// then the fp32 bias and the grid order).
template <int D>
cudaError_t launch_fwd_bias(const void* const bases[5], const long long* maps, int B, int H,
                            int KVH, int Lq, int Lk, float scale, cudaStream_t stream) {
  const long long* bias = maps + 4 * MAP_SPEC;
  if (!spec_is(maps, D, Lq, H, B, ATT_M) || !spec_is(maps + MAP_SPEC, D, Lk, KVH, B, STEP_N) ||
      !spec_is(maps + 2 * MAP_SPEC, D, Lk, KVH, B, STEP_N) ||
      !spec_is(maps + 3 * MAP_SPEC, D, Lq, H, B, 64) || !bias_spec_is(bias, Lk, Lq, H, B, ATT_M))
    return cudaErrorInvalidValue;
  CUtensorMap tm[5];
  cudaError_t err = encode_maps(tm, bases, maps, 4);
  if (err == cudaSuccess)
    err = encode_tensor_map(&tm[4], bases[4], bias, CU_TENSOR_MAP_DATA_TYPE_FLOAT32);
  if (err != cudaSuccess) return err;
  const int smem = DqSmem<D, BIAS_STAGES, true, 1>::BYTES;
  err = cudaFuncSetAttribute(attn_long_fwd_bias_wgmma_kernel<D>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const bool heads_fastest = bias[MAP_SPEC] != 0;
  attn_long_fwd_bias_wgmma_kernel<D>
      <<<tile_grid(Lq / ATT_M, H, B, heads_fastest), ATT_THREADS, smem, stream>>>(
          tm[0], tm[1], tm[2], tm[3], tm[4], H / KVH, H, Lq, Lk, (int)bias[2], (int)bias[3],
          heads_fastest, scale);
  return cudaGetLastError();
}

// D 64 or 128; `wide` (the backward entries, which B8's wgmma body also
// takes): any multiple of 16 up to 128, run through the instance of 64 or
// 128 columns zero-filled past D
bool bad_long_shape(int B, int H, int KVH, int Lq, int Lk, int D, bool bias,
                    const void* bias_ptr, bool wide = false) {
  return bad_shape(B, H, KVH, Lq, Lk) || Lq % ALIGN || Lk % ALIGN ||
         (wide ? D < 16 || D > 128 || D % 16 : D != 64 && D != 128) ||
         (bias && bias_ptr == nullptr);
}

}  // namespace

// C entries, bound with ctypes: q, dO (B, H, Lq, D) and k, v (B, KVH, Lk,
// D) bf16, Lq and Lk multiples of 128, D 64 or 128 (the backward entries
// also any other multiple of 16 below 128: B8's wgmma body, through the
// instance of 64 or 128 columns); delta and lse:
// contiguous fp32 (B, H, Lq); the bias: fp32 (B|1, H|1, Lq, Lk). Each takes
// `maps`, the wrapper's descriptions (ops/tensor_maps.py, MAP_SPEC values
// each, every stride a multiple of 16 bytes) of the operands it reads and
// writes through TMA. Each returns a cudaError_t; 0 is success.

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

// B4-bias: B4's `maps` but k and v in boxes of 64 rows, then the bias's
// (fp32, boxes of 32 columns and 128 rows, broadcast axes of extent 1) and
// the grid order (nonzero: heads fastest, tile_and_head).
extern "C" int mmada_flash_attention_long_fwd_bias_bf16(
    const void* q, const void* k, const void* v, void* o, const void* bias, int B,
    int H, int KVH, int Lq, int Lk, int D, const long long* maps, float scale,
    void* stream) {
  if (bad_long_shape(B, H, KVH, Lq, Lk, D, true, bias)) return (int)cudaErrorInvalidValue;
  const void* bases[5] = {q, k, v, o, bias};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return D == 128 ? (int)launch_fwd_bias<128>(bases, maps, B, H, KVH, Lq, Lk, scale, s)
                  : (int)launch_fwd_bias<64>(bases, maps, B, H, KVH, Lq, Lk, scale, s);
}

// B5-dq: dq (B, H, Lq, D) bf16 and lse. `maps`: the descriptions of q (boxes
// of 128 rows), k, v (64 rows), dO (128 rows) and dq (64 rows).
extern "C" int mmada_flash_attention_long_bwd_dq_bf16(
    const void* q, const void* k, const void* v, const void* dout,
    const void* delta, void* dq, void* lse, int B, int H, int KVH, int Lq,
    int Lk, int D, const long long* maps, float scale, void* stream) {
  if (bad_long_shape(B, H, KVH, Lq, Lk, D, false, nullptr, true))
    return (int)cudaErrorInvalidValue;
  const void* bases[6] = {q, k, v, dout, dq, nullptr};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto launch =
      D > 64 ? launch_dq_wgmma<128, false, false> : launch_dq_wgmma<64, false, false>;
  return (int)launch(bases, maps, delta, lse, B, H, KVH, Lq, Lk, scale, s, D);
}

// B5-dq-bias: B5-dq's `maps`, then the bias's (fp32, boxes of 32 columns
// and 128 rows, broadcast axes of extent 1) and the grid order (nonzero:
// heads fastest, tile_and_head).
extern "C" int mmada_flash_attention_long_bwd_dq_bias_bf16(
    const void* q, const void* k, const void* v, const void* dout,
    const void* delta, const void* bias, void* dq, void* lse, int B, int H,
    int KVH, int Lq, int Lk, int D, const long long* maps, float scale,
    void* stream) {
  if (bad_long_shape(B, H, KVH, Lq, Lk, D, true, bias, true))
    return (int)cudaErrorInvalidValue;
  const void* bases[6] = {q, k, v, dout, dq, bias};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto launch =
      D > 64 ? launch_dq_wgmma<128, true, false> : launch_dq_wgmma<64, true, false>;
  return (int)launch(bases, maps, delta, lse, B, H, KVH, Lq, Lk, scale, s, D);
}

// B5-dkv: dk, dv (B, KVH, Lk, D) bf16. `maps`: the descriptions of q (boxes
// of 64 rows), k, v (128 rows), dO (64 rows), dk and dv (64 rows), then the
// 64-row spans of lse and delta.
extern "C" int mmada_flash_attention_long_bwd_dkv_bf16(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* delta, void* dk, void* dv, int B, int H,
    int KVH, int Lq, int Lk, int D, const long long* maps, float scale,
    void* stream) {
  if (bad_long_shape(B, H, KVH, Lq, Lk, D, false, nullptr, true))
    return (int)cudaErrorInvalidValue;
  const void* bases[7] = {q, k, v, dout, dk, dv, nullptr};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto launch =
      D > 64 ? launch_dkv_wgmma<128, false, false> : launch_dkv_wgmma<64, false, false>;
  return (int)launch(bases, maps, lse, delta, B, H, KVH, Lq, Lk, scale, s, D);
}

// B5-dkv-bias: B5-dkv's `maps`, then the bias's (boxes of 32 columns and 64
// rows) and the grid order.
extern "C" int mmada_flash_attention_long_bwd_dkv_bias_bf16(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* delta, const void* bias, void* dk, void* dv,
    int B, int H, int KVH, int Lq, int Lk, int D, const long long* maps,
    float scale, void* stream) {
  if (bad_long_shape(B, H, KVH, Lq, Lk, D, true, bias, true))
    return (int)cudaErrorInvalidValue;
  const void* bases[7] = {q, k, v, dout, dk, dv, bias};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto launch =
      D > 64 ? launch_dkv_wgmma<128, true, false> : launch_dkv_wgmma<64, true, false>;
  return (int)launch(bases, maps, lse, delta, B, H, KVH, Lq, Lk, scale, s, D);
}

// The bias tile reads of bias_tile_kernel, for the card test: the bias
// (fp32, (1, 1, rows, cols), as `map` describes it: boxes of 32 columns and
// 128 rows, or 64 with `transposed`); out fp32 (128 x 64), contiguous.
extern "C" int mmada_bias_tile_f32(const void* bias, void* out, int transposed,
                                   const long long* map, void* stream) {
  const int rows = transposed ? STEP_N : ATT_M, cols = transposed ? ATT_M : STEP_N;
  if (!bias_spec_is(map, cols, rows, 1, 1, rows)) return (int)cudaErrorInvalidValue;
  CUtensorMap tm;
  cudaError_t err = encode_tensor_map(&tm, bias, map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32);
  if (err != cudaSuccess) return (int)err;
  const int smem = ATT_M * STEP_N * 4 + 8 + 1024;
  err = cudaFuncSetAttribute(bias_tile_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  bias_tile_kernel<<<1, 256, smem, static_cast<cudaStream_t>(stream)>>>(
      tm, transposed, static_cast<float*>(out));
  return (int)cudaGetLastError();
}

// The tile product of wgmma_bwd_tile_kernel, for the card test: x (128 x D),
// y (64 x D) bf16 as `maps` describes them (boxes of 128 and 64 rows);
// s_out (64 x 64) and o_out (64 x D) fp32, contiguous. D 64 or 128.
extern "C" int mmada_wgmma_bwd_tile_bf16(const void* x, const void* y, void* s_out, void* o_out,
                                         int D, const long long* maps, void* stream) {
  if ((D != 64 && D != 128) || !spec_is(maps, D, 128, 1, 1, ATT_M) ||
      !spec_is(maps + MAP_SPEC, D, 64, 1, 1, STEP_N))
    return (int)cudaErrorInvalidValue;
  const void* bases[2] = {x, y};
  CUtensorMap tm[2];
  cudaError_t err = encode_maps(tm, bases, maps, 2);
  if (err != cudaSuccess) return (int)err;
  const int smem = (D / 64) * (ATT_BOX + STEP_BOX) + 8 + 1024;
  auto kernel = D == 128 ? wgmma_bwd_tile_kernel<128> : wgmma_bwd_tile_kernel<64>;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<1, 128, smem, static_cast<cudaStream_t>(stream)>>>(
      tm[0], tm[1], static_cast<float*>(s_out), static_cast<float*>(o_out));
  return (int)cudaGetLastError();
}
