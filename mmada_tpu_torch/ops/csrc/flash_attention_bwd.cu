// Backward of one-pass bidirectional attention, for Hopper (sm_90a): the dq
// kernel and the dk/dv kernel, without a bias (kernels B3) and with one
// (B3-bias).
//
// Replaces the TPU kernels of `flash_attention_bwd` in
// mmada_tpu/ops/flash_attention.py: `_attn_bwd_dq_kernel` (:719) and
// `_attn_bwd_dq_bias_kernel` (:746), called at :895, and
// `_attn_bwd_dkv_kernel` (:753) and `_attn_bwd_dkv_bias_kernel` (:799),
// called at :963. All take q and k already rotated (RoPE and its pullback
// run outside, as in the JAX package), bf16 q / k / v / dO, and delta =
// rowsum(dO * O) in fp32, computed outside. With s = (q . k^T) * scale in
// fp32, plus the fp32 bias (B|1, H|1, Lq, Lk) in the biased kernels
// (round(round(s * scale) + bias), as the forward), and key columns past Lk
// at -inf (p = 0 there):
//
//   dq kernel:  m, l = row max and row sum of exp(s - m)       (pass 1)
//               p = exp(s - m) / l; dp = dO . v^T; ds = p (dp - delta)
//               dq = bf16((ds . k) * scale); lse = m + log(l)  (pass 2)
//   dkv kernel: p = exp(s - lse); dv = p^T . dO; dp = dO . v^T;
//               ds = p (dp - delta); dk = (ds^T . q) * scale;
//               summed over the query heads that share the kv head
//
// B3 and B3-bias run on wgmma: the long tier's B5-dq and B5-dkv bodies with
// ONE_PASS (flash_attention_bwd_wgmma.cuh; B3-bias with BIAS too, as
// B5-bias): the skeleton of hopper_sm90.cuh (a TMA producer warpgroup, two
// consumer warpgroups of 64 rows in turns, pairs of blocks sharing each
// streamed tile by multicast), the operands through TMA tensor maps. The dq
// kernel takes B1's two passes over K/V tiles of 64 keys (pass 1 streams K
// alone, with its bias tiles when biased) and the dq step of B5-dq on p
// normalised before the cast: ds enters ds . k as one bf16 value. The dkv
// kernel streams (query head, 64-row query tile) steps past a resident
// 128-key tile, as B5-dkv, with p and ds as one bf16 value each. Ragged
// edges: TMA zero-fills rows past Lq and Lk (and the bias past them) and
// drops them on store; keys past Lk get p = 0 in dq (masked after the bias
// is added), query columns past Lq get p = ds = 0 in dkv (lse = +inf and
// delta = 0 as the producer warpgroup's stats warp writes them: at an
// unaligned Lq their spans start where no bulk copy or TMA box may, so it
// reads them with ordinary loads).
// Tiles of 64 keys (dq) and 64 query rows (dkv) keep the ragged tail short:
// L 387 takes 7 steps where 6.05 are needed (4 of 128 would need 3.02).
// The dq kernels run on a persistent grid: as many clusters as the card
// holds at once, each walking several (tile pair, head, batch) items, its
// ring running on from one item to the next. An item's loads wait for the
// item before's dq store, so the grid saves the launch, barrier set-up and
// teardown of a cluster an item, not load latency (at the stage-1 batch 7%
// faster than one cluster an item, on an H100). The dkv kernels run one
// cluster an item: walking items there made the shared body of the long
// tier's biased dkv spill registers.
//
// The bias comes by TMA, a tile a step, into a ring of its own (the biased
// kernels hold 3 K/V or q/dO slots and 2 bias slots); dkv reads it
// transposed, bias[query][key]. A bias broadcast over the heads (the
// model's mask) runs with the heads fastest in the grid, so that its rows
// come from HBM about once. The max and lse are in natural units; only x -
// m goes to log2 units.
//
// Query rows whose every key is masked (the padding of a masked frame): each
// score rounds to the finite min, so dq's p is 1/Lk on such a row and its lse
// is the finite min (min + log Lk rounds back to it), which makes dkv's
// p = exp(s - lse) = 1 for each of its keys, as the TPU's dkv kernel has it.
// The model gives those rows a zero cotangent (no real row attends to a pad
// key, and no loss reads a pad row), so dO = delta = 0 there and they add
// nothing; with a nonzero cotangent every output stays finite.
//
// Rounding. q.k^T and dO.v^T multiply bf16 inputs exactly and sum in fp32,
// as the TPU kernel's fp32 dots do. p and ds are fp32 and are rounded to
// bf16 (round to nearest even) to enter the tensor cores for ds.k, p^T.dO
// and ds^T.q, the usual choice of flash-attention backward kernels: each
// term then carries a relative error of at most 2^-9, against the TPU
// kernel's fp32 products, and the outputs a further bf16 rounding.
//
// Bound (on an H100 SXM: 989 TFLOP/s bf16 dense, 3.35 TB/s): dq needs
// 6*B*H*Lq*Lk*D flops (the kernels do 8: pass 1 recomputes q.k^T) against
// q + k + v + dO + dq (+ delta, lse, bias) bytes; dkv 8*B*H*Lq*Lk*D flops
// against q + k + v + dO + dk + dv (+ lse, delta, bias). At the stage-1
// training shape (B 15, H 32, L 387, D 128) both are bound by bytes by a
// small margin; at longer L by operations.

#include "flash_attention_bwd_wgmma.cuh"

namespace {

// D 64 or 128 (B3), or a multiple of 16 below 128 (B8's wgmma body, run
// through the instance of 64 or 128 columns, zero-filled past D)
bool bad_args(int B, int H, int KVH, int Lq, int Lk, int D) {
  return bad_shape(B, H, KVH, Lq, Lk) || D < 16 || D > 128 || D % 16;
}

}  // namespace

// C entries, bound with ctypes. q, dO (B, H, Lq, D) and k, v (B, KVH, Lk, D):
// bf16, any Lq and Lk, D 64 or 128 (B3, B3-bias) or another multiple of 16
// below 128 (B8's wgmma body: the instance of 64 or 128 columns, its
// operands described in boxes of 64 columns); delta and lse: contiguous fp32
// (B, H, Lq). Each returns a cudaError_t; 0 is success.

// B3's dq: dq (B, H, Lq, D) bf16 and lse. `maps`: the wrapper's descriptions
// (ops/tensor_maps.py, MAP_SPEC values each, every stride a multiple of 16
// bytes) of q (boxes of 128 rows), k, v (64 rows), dO (128 rows) and dq (64
// rows). It runs on a persistent grid (item_grid), whose clusters walk
// several items each.
extern "C" int mmada_flash_attention_bwd_dq_bf16(
    const void* q, const void* k, const void* v, const void* dout,
    const void* delta, void* dq, void* lse, int B, int H, int KVH, int Lq,
    int Lk, int D, const long long* maps, float scale, void* stream) {
  if (bad_args(B, H, KVH, Lq, Lk, D)) return (int)cudaErrorInvalidValue;
  const void* bases[6] = {q, k, v, dout, dq, nullptr};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto launch =
      D > 64 ? launch_dq_wgmma<128, false, true> : launch_dq_wgmma<64, false, true>;
  return (int)launch(bases, maps, delta, lse, B, H, KVH, Lq, Lk, scale, s, D);
}

// B3's dkv: dk, dv (B, KVH, Lk, D) bf16. `maps`: the descriptions of q
// (boxes of 64 rows), k, v (128 rows), dO (64 rows), dk and dv (64 rows),
// then the 64-row spans of lse and delta (ROWS_SPEC values each; their bases
// 16-byte aligned).
extern "C" int mmada_flash_attention_bwd_dkv_bf16(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* delta, void* dk, void* dv, int B, int H,
    int KVH, int Lq, int Lk, int D, const long long* maps, float scale,
    void* stream) {
  if (bad_args(B, H, KVH, Lq, Lk, D)) return (int)cudaErrorInvalidValue;
  const void* bases[7] = {q, k, v, dout, dk, dv, nullptr};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto launch =
      D > 64 ? launch_dkv_wgmma<128, false, true> : launch_dkv_wgmma<64, false, true>;
  return (int)launch(bases, maps, lse, delta, B, H, KVH, Lq, Lk, scale, s, D);
}

// The biased entries (B3-bias) take the fp32 bias (B|1, H|1, Lq, Lk) after
// delta (dq) or lse and delta (dkv), and `maps` as the unbiased ones, then
// the bias's description (boxes of 32 columns and 128 query rows for dq, 64
// for dkv; broadcast axes of extent 1) and the grid order (nonzero: heads
// fastest).

// dq-bias, on the persistent grid as B3's dq.
extern "C" int mmada_flash_attention_bwd_dq_bias_bf16(
    const void* q, const void* k, const void* v, const void* dout,
    const void* delta, const void* bias, void* dq, void* lse, int B, int H,
    int KVH, int Lq, int Lk, int D, const long long* maps, float scale,
    void* stream) {
  if (bad_args(B, H, KVH, Lq, Lk, D) || bias == nullptr) return (int)cudaErrorInvalidValue;
  const void* bases[6] = {q, k, v, dout, dq, bias};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto launch =
      D > 64 ? launch_dq_wgmma<128, true, true> : launch_dq_wgmma<64, true, true>;
  return (int)launch(bases, maps, delta, lse, B, H, KVH, Lq, Lk, scale, s, D);
}

// dkv-bias.
extern "C" int mmada_flash_attention_bwd_dkv_bias_bf16(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* delta, const void* bias, void* dk, void* dv,
    int B, int H, int KVH, int Lq, int Lk, int D, const long long* maps,
    float scale, void* stream) {
  if (bad_args(B, H, KVH, Lq, Lk, D) || bias == nullptr) return (int)cudaErrorInvalidValue;
  const void* bases[7] = {q, k, v, dout, dk, dv, bias};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto launch =
      D > 64 ? launch_dkv_wgmma<128, true, true> : launch_dkv_wgmma<64, true, true>;
  return (int)launch(bases, maps, lse, delta, B, H, KVH, Lq, Lk, scale, s, D);
}
