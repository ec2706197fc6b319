// Attention at any head width and in fp32, for Hopper (sm_90a), on the CUDA
// cores: kernel B7's ffma body (forward), B8-dq and B8-dkv (backward).
//
// B7 stands for the TPU kernels of mmada_tpu/ops/flash_attention.py where the
// wgmma kernels B1-B5 do not reach (operands in fp32, or a head width other
// than 64 and 128): the one-pass forward `_attn_kernel` / `_attn_rope_kernel`
// (:59-92, called at :650) and `_attn_bias_kernel` / `_attn_rope_bias_kernel`
// (:148-178, called at :686); the long forward `_attn_online_kernel` /
// `_attn_online_bias_kernel` (:224, :259, called at :471, :497) and the
// staged one of the same function (:291, :333, called at :392, :418). B8-dq
// stands for the dq bodies (:719, :746 called at :895; :1018, :1062 called at
// :1185), B8-dkv for the dkv bodies (:753, :799 called at :963; :1070, :1110
// called at :1240). Which kernel a call takes is `flash_attention.kernel_for`
// (dtype, head_dim); the wrappers in ops/flash_attention.py and
// ops/flash_attention_long.py launch these.
//
// The functions, per (batch, query head h, kv head h / (H / KVH)), in fp32
// whatever the operands' type (bf16 operands are widened as they load):
//
//   s     = (q . k^T) * scale  [+ bias (B|1, H|1, Lq, Lk), fp32]
//   one-pass tier (LONG = false): p = exp(s - rowmax s) / rowsum, rounded to
//           the type of v BEFORE p . v (the invariant of the TPU kernel,
//           flash_attention.py:73-83; in fp32 the rounding changes nothing),
//           out = p . v summed in fp32. RoPE first, by rope_generic_kernel:
//           q and k rotated in fp32 and rounded to their type, as
//           `_rope_tile`.
//   long tier (LONG = true): p = exp(s - m) in fp32, never rounded, out =
//           (p . v) / max(rowsum p, 1e-30): the online softmax, divided last.
//   dq:     ds = p (dO . v^T - delta), dq = ds . k * scale (one-pass: p
//           normalised; long: p unnormalised and dq divided by l last),
//           lse = m + log l.
//   dk, dv: p = exp(s - lse), dv = p^T . dO, dk = (p (dO . v^T - delta))^T .
//           q * scale, each summed over the query heads of the kv head.
//
// Keys past Lk take no part (score -inf, so p = 0), query rows past Lq none.
// A row whose every key carries the finite fp32 min as its bias has every
// score at that min: p = 1 / Lk, so the row averages v (the XLA tier's
// function, as B2).
//
// Arithmetic: fp32 FFMA on the CUDA cores, fp32 accumulators, expf and IEEE
// division; no tensor core, no TF32 (TF32 keeps a 10-bit mantissa). RoPE uses
// unfused multiplies and adds, to round as the plain version does.
//
// B7 has two bodies, chosen by `flash_attention.generic_body(dtype, D)`: bf16
// at every width 16-512 other than 64 and 128 takes the tensor cores (the
// "wgmma" body, csrc/attention_wide.cu); fp32 at every width takes the
// "ffma" body here (attn_fwd_ffma_kernel: 64-row tiles, the whole width to
// 256 in one block, register tiles fed by float4 reads, K and V staged by
// cp.async; its design note stands above the kernel). This file also holds
// the rotation both bodies run before attention with RoPE
// (rope_generic_kernel, at the real width).
//
// B8 has two bodies too (`generic_body(dtype, D, backward=True)`): bf16 at
// 16-256 other than 64 and 128 take the tensor cores (csrc/attention_wide_bwd.cu,
// and B3's / B5's kernels at the instances of 64 and 128), fp32 at every
// width and bf16 past 256 the "ffma" bodies here (attn_bwd_dq_ffma_kernel,
// attn_bwd_dkv_ffma_kernel: B7's ffma body's register tiles and cp.async
// ring; their design note stands above them).
//
// Bound: 4 B H Lq Lk D flops (forward; backward 8 B H Lq Lk D for dq and
// dk/dv together, counted as the function needs them) against the fp32 rate
// of 67 TFLOP/s on the CUDA cores, or the operands' bytes at 3.35 TB/s. At
// the serving shapes (L ~ 1.2k, D >= 64) the flops bound them. B7's ffma body
// does the bound's 4 units (one walk);
// B8's ffma dq does 4 units of L x L x D in the one-pass tier (a first walk
// for the row max and sum, then s, dp and ds . k) and 3 in the long one
// (online), its dkv 4 (s^T, dp^T, p^T . dO, ds^T . q), as the bound counts.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;  // 16 x 16
constexpr float NEG_F32 = -3.402823466e38f;
constexpr int ROPE_THREADS = 256;

using bf16 = __nv_bfloat16;

__device__ __forceinline__ float widen(float x) { return x; }
__device__ __forceinline__ float widen(bf16 x) { return __bfloat162float(x); }
template <typename T> __device__ __forceinline__ T narrow(float x);
template <> __device__ __forceinline__ float narrow<float>(float x) { return x; }
template <> __device__ __forceinline__ bf16 narrow<bf16>(float x) { return __float2bfloat16_rn(x); }

// A (batch, head, row, D) operand: base and element strides; the last dim is
// contiguous.
struct Operand {
  const void* p;
  long long sb, sh, sl;
};

struct Bias {  // fp32 (B|1, H|1, Lq, Lk): a broadcast axis has stride 0
  const float* p;
  long long sb, sh, sq;
};

struct Shape {
  int B, H, KVH, Lq, Lk, D;
  float scale;
};

template <typename T>
__device__ __forceinline__ const T* rows_of(const Operand& o, int b, int h, int row) {
  return static_cast<const T*>(o.p) + b * o.sb + h * o.sh + row * o.sl;
}

__device__ __forceinline__ float half_warp_max(float x) {
#pragma unroll
  for (int o = 8; o; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float half_warp_sum(float x) {
#pragma unroll
  for (int o = 8; o; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// ------------------------------------------------------------ B7, body "ffma"
//
// One block of 256 threads (16 x 16: ty, tx) owns BM = 16 RI query rows (RI
// = 8 rows a thread up to D 128, 4 at DP 256) and DP output columns (the
// whole width up to 256; two passes of 256 past it). Q stays in shared
// memory for the block's life, its width rounded up to 64 and zero-filled.
// Each 64-key tile arrives as D / 64 K chunks (64 keys x 64 columns) and V
// chunks (32 keys x DP columns; 16 at DP 256) through a ring of FSLOTS
// slots filled by cp.async, two chunks in flight beside the one in use;
// rows past Lk and columns past D arrive as zeros (cp.async's src-size 0).
// Thread (ty, tx) holds the scores of rows RI ty + i and keys tx + 16 j (j <
// 4) and the outputs of rows RI ty + i, columns 64 c + 4 tx + e: a score
// step reads RI float4 of q (the same for the 16 lanes of a row group:
// broadcast) and four of k for 16 RI FFMAs, a p . v step RI float4 of p and
// DP / 64 of v per key for RI DP / 16 FFMAs. Rows of 16 bytes of padding
// keep the float4 reads of 16 neighbouring rows on distinct banks. The
// fp32 one-pass tier and the long tier walk K once (an online softmax: the
// row max m, the sum l, the outputs rescaled by exp(m - m')); the one-pass
// tier divides by l at the end, the long tier by max(l, 1e-30). In fp32
// that is the one-pass function up to the order of fp32 sums: rounding p
// to fp32 before p . v is the identity. The one-pass tier sums each tile's
// p . v in registers of its own and adds it to the outputs at the tile's
// end (a sum in blocks of 64 keys): its plain version normalises p first,
// so a different order of sums is all that parts them, and a sum over
// 1,155 keys in one running fp32 total reached the bar of 1e-5 on the t2i
// frame where blocks of 64 stay below it. At 8 rows a thread (about 250 registers) one block fills an
// SM, and each float4 read from shared memory feeds twice the FFMAs of 4
// rows a thread at two blocks an SM, the faster of the two on the H100.

constexpr int FT = 64;        // keys of a tile
constexpr int FKC = 64;       // columns of a K chunk
constexpr int FSLOTS = 3;     // the cp.async ring
constexpr int FPS = FT + 4;   // padded row of the fp32 p tile

__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ float4 load4(const bf16* p) {  // four bf16, widened
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  return make_float4(__uint_as_float(u.x << 16), __uint_as_float(u.x & 0xffff0000u),
                     __uint_as_float(u.y << 16), __uint_as_float(u.y & 0xffff0000u));
}

__device__ __forceinline__ void store4(float* p, const float (&x)[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(x[0], x[1], x[2], x[3]);
}

__device__ __forceinline__ void store4(bf16* p, const float (&x)[4]) {
  __nv_bfloat162 a = __floats2bfloat162_rn(x[0], x[1]), b = __floats2bfloat162_rn(x[2], x[3]);
  *reinterpret_cast<uint2*>(p) =
      make_uint2(*reinterpret_cast<unsigned*>(&a), *reinterpret_cast<unsigned*>(&b));
}

// 16 bytes from global (src) into shared memory (dst), or 16 zero bytes
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(s), "l"(src), "r"(valid ? 16 : 0) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// Shared memory of the ffma body, in elements of T: the fp32 p tile, then Q
// (64 rows of round_up(D, 64) + PAD), then FSLOTS ring slots. Rows are
// padded by 16 bytes, so that the float4 reads of 16 neighbouring rows fall
// on distinct banks.
template <typename T, int DP>
struct FfmaSmem {
  static constexpr int RI = DP == 256 ? 4 : 8;  // query rows a thread
  static constexpr int BM = 16 * RI;                    // query rows a block
  static constexpr int PAD = 16 / (int)sizeof(T);
  static constexpr int E = 16 / (int)sizeof(T);  // elements of a 16-byte piece
  static constexpr int VC = DP == 256 ? 16 : 32;  // keys of a V chunk
  static constexpr int KS = FKC + PAD;           // row of a K chunk
  static constexpr int VS = DP + PAD;            // row of a V chunk
  static constexpr int SLOT = FT * KS > VC * VS ? FT * KS : VC * VS;
  static constexpr int P_BYTES = BM * FPS * 4;
  __host__ __device__ static int qs(int D) { return (D + 63) / 64 * 64 + PAD; }
  __host__ __device__ static int bytes(int D) {
    return P_BYTES + (BM * qs(D) + FSLOTS * SLOT) * (int)sizeof(T);
  }
};

// The chunk c of a block's sequence: each tile's nk K chunks, then its nv V
// chunks.
__device__ __forceinline__ void chunk_of(int c, int nk, int nv, int& tile, int& idx) {
  tile = c / (nk + nv);
  idx = c - tile * (nk + nv);
}

// s[i][j] += the dot of q row RI ty + i with k row tx + 16 j over one chunk
// of FKC columns; q points at (row RI ty, the chunk's first column), k at
// (row tx, column 0) of the K chunk.
template <typename T, int RI>
__device__ __forceinline__ void score_chunk(float (&s)[RI][4], const T* q, int qs, const T* k,
                                            int ks) {
#pragma unroll 4
  for (int d = 0; d < FKC; d += 4) {
    float4 a[RI], b[4];
#pragma unroll
    for (int i = 0; i < RI; ++i) a[i] = load4(q + i * qs + d);
#pragma unroll
    for (int j = 0; j < 4; ++j) b[j] = load4(k + j * 16 * ks + d);
#pragma unroll
    for (int i = 0; i < RI; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = fmaf(a[i].x, b[j].x, s[i][j]);
        s[i][j] = fmaf(a[i].y, b[j].y, s[i][j]);
        s[i][j] = fmaf(a[i].z, b[j].z, s[i][j]);
        s[i][j] = fmaf(a[i].w, b[j].w, s[i][j]);
      }
  }
}

// o[i][4 c + e] += sum over the VC keys of a V chunk of p[RI ty + i][key] *
// v[key][64 c + 4 tx + e]; p points at (row RI ty, the chunk's first key) of
// the p tile, v at (key 0, column 4 tx) of the V chunk.
template <typename T, int RI, int NC, int VC>
__device__ __forceinline__ void pv_chunk(float (&o)[RI][4 * NC], const float* p, const T* v,
                                         int vs) {
#pragma unroll 2
  for (int n = 0; n < VC; n += 4) {
    float pr[RI][4];
#pragma unroll
    for (int i = 0; i < RI; ++i) {
      const float4 x = load4(p + i * FPS + n);
      pr[i][0] = x.x;
      pr[i][1] = x.y;
      pr[i][2] = x.z;
      pr[i][3] = x.w;
    }
#pragma unroll
    for (int u = 0; u < 4; ++u)
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        const float4 x = load4(v + (n + u) * vs + 64 * c);
#pragma unroll
        for (int i = 0; i < RI; ++i) {
          o[i][4 * c] = fmaf(pr[i][u], x.x, o[i][4 * c]);
          o[i][4 * c + 1] = fmaf(pr[i][u], x.y, o[i][4 * c + 1]);
          o[i][4 * c + 2] = fmaf(pr[i][u], x.z, o[i][4 * c + 2]);
          o[i][4 * c + 3] = fmaf(pr[i][u], x.w, o[i][4 * c + 3]);
        }
      }
  }
}

// B7's ffma body. grid (query tiles of BM rows, B * H, column passes of DP).
template <typename T, int DP, bool BIAS, bool LONG>
__global__ void __launch_bounds__(THREADS, 1)
attn_fwd_ffma_kernel(Operand q, Operand k, Operand v, Operand o, Bias bias, Shape sh) {
  using S = FfmaSmem<T, DP>;
  constexpr int RI = S::RI, BM = S::BM;
  // the one-pass tier walks once and sums each tile's p . v apart before
  // adding it (BLOCKED), which keeps its distance from the normalise-first
  // plain version inside the fp32 bar at 1,155 keys; the long tier's
  // function is the online one
  constexpr bool BLOCKED = !LONG;
  constexpr int NC = DP / 64;
  constexpr int E = S::E;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* ps = reinterpret_cast<float*>(smem_raw);
  T* qs = reinterpret_cast<T*>(smem_raw + S::P_BYTES);
  const int QS = S::qs(sh.D);
  T* ring = qs + BM * QS;
  const T* dummy = static_cast<const T*>(q.p);  // a valid address for zero-filled pieces
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const int q0 = blockIdx.x * BM, b = blockIdx.y / sh.H, h = blockIdx.y % sh.H;
  const int kh = h / (sh.H / sh.KVH), c0 = blockIdx.z * DP;
  constexpr int VC = S::VC, NV = FT / VC;
  const int nk = (sh.D + FKC - 1) / FKC, tiles = (sh.Lk + FT - 1) / FT;
  const int total = tiles * (nk + NV);

  {  // Q: BM rows of round_up(D, 64) columns, zeros past Lq and D
    const T* src = rows_of<T>(q, b, h, min(q0, sh.Lq - 1));
    const int per_row = (QS - S::PAD) / E;
    for (int i = tid; i < BM * per_row; i += THREADS) {
      const int r = i / per_row, c = (i - r * per_row) * E;
      const bool ok = q0 + r < sh.Lq && c < sh.D;
      cp_async16(qs + r * QS + c, ok ? src + r * q.sl + c : dummy, ok);
    }
    cp_async_commit();
  }
  auto issue = [&](int c) {
    T* slot = ring + (c % FSLOTS) * S::SLOT;
    int tile, idx;
    chunk_of(c, nk, NV, tile, idx);
    if (idx < nk) {  // K chunk: keys tile * FT.., columns idx * FKC..
      const int key0 = tile * FT;
      const T* src = rows_of<T>(k, b, kh, min(key0, sh.Lk - 1)) + idx * FKC;
      constexpr int PR = FKC / E;
      for (int i = tid; i < FT * PR; i += THREADS) {
        const int r = i / PR, c2 = (i - r * PR) * E;
        const bool ok = key0 + r < sh.Lk && idx * FKC + c2 < sh.D;
        cp_async16(slot + r * S::KS + c2, ok ? src + r * k.sl + c2 : dummy, ok);
      }
    } else {  // V chunk: keys tile * FT + VC (idx - nk).., columns c0..
      const int key0 = tile * FT + (idx - nk) * VC;
      const T* src = rows_of<T>(v, b, kh, min(key0, sh.Lk - 1)) + c0;
      constexpr int PR = DP / E;
      for (int i = tid; i < VC * PR; i += THREADS) {
        const int r = i / PR, c2 = (i - r * PR) * E;
        const bool ok = key0 + r < sh.Lk && c0 + c2 < sh.D;
        cp_async16(slot + r * S::VS + c2, ok ? src + r * v.sl + c2 : dummy, ok);
      }
    }
  };

  float m[RI], l[RI], acc[RI][4 * NC];
#pragma unroll
  for (int i = 0; i < RI; ++i) {
    m[i] = LONG ? NEG_F32 : -INFINITY;  // the long tier's running max starts at the finite min
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < 4 * NC; ++j) acc[i][j] = 0.f;
  }
  for (int c = 0; c < FSLOTS - 1; ++c) {
    if (c < total) issue(c);
    cp_async_commit();
  }
  int chunk = 0;
  // the next chunk's slot, once it has landed and every thread is done with
  // the slot before it; the chunk FSLOTS - 1 ahead is queued into that one
  auto next_slot = [&]() -> const T* {
    cp_async_wait<FSLOTS - 2>();
    __syncthreads();
    if (chunk + FSLOTS - 1 < total) issue(chunk + FSLOTS - 1);
    cp_async_commit();
    return ring + (chunk++ % FSLOTS) * S::SLOT;
  };
  const float* bias_bh = BIAS ? bias.p + b * bias.sb + h * bias.sh : nullptr;
  // the scores of tile t from its nk K chunks: s * scale (+ bias), -inf past Lk
  auto scores = [&](float (&s)[RI][4], int t) {
#pragma unroll
    for (int i = 0; i < RI; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
    for (int kc = 0; kc < nk; ++kc)
      score_chunk<T, RI>(s, qs + RI * ty * QS + kc * FKC, QS, next_slot() + tx * S::KS, S::KS);
#pragma unroll
    for (int i = 0; i < RI; ++i) {
      const int r = q0 + RI * ty + i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int key = t * FT + tx + 16 * j;
        float x = __fmul_rn(s[i][j], sh.scale);
        if (BIAS && r < sh.Lq && key < sh.Lk) x = __fadd_rn(x, bias_bh[r * bias.sq + key]);
        s[i][j] = key < sh.Lk ? x : -INFINITY;
      }
    }
  };
  // the online step of row i on a tile's scores: the new row max, p = exp(s
  // - m) in place, l and the outputs rescaled
  auto online = [&](float (&s)[4], int i) {
    const float mx = half_warp_max(fmaxf(fmaxf(s[0], s[1]), fmaxf(s[2], s[3])));
    const float mn = fmaxf(m[i], mx);
    const float alpha = expf(m[i] - mn);
    float e = 0.f;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      s[j] = expf(s[j] - mn);
      e += s[j];
    }
    l[i] = l[i] * alpha + half_warp_sum(e);
    m[i] = mn;
#pragma unroll
    for (int j = 0; j < 4 * NC; ++j) acc[i][j] *= alpha;
  };

  for (int t = 0; t < tiles; ++t) {
    float s[RI][4];
    scores(s, t);
#pragma unroll
    for (int i = 0; i < RI; ++i) {
      online(s[i], i);
#pragma unroll
      for (int j = 0; j < 4; ++j) ps[(RI * ty + i) * FPS + tx + 16 * j] = s[i][j];
    }
    if constexpr (BLOCKED) {  // the tile's p . v summed apart, then added
      float tacc[RI][4 * NC];
#pragma unroll
      for (int i = 0; i < RI; ++i)
#pragma unroll
        for (int j = 0; j < 4 * NC; ++j) tacc[i][j] = 0.f;
      for (int vc = 0; vc < NV; ++vc)
        pv_chunk<T, RI, NC, VC>(tacc, ps + RI * ty * FPS + vc * VC, next_slot() + 4 * tx, S::VS);
#pragma unroll
      for (int i = 0; i < RI; ++i)
#pragma unroll
        for (int j = 0; j < 4 * NC; ++j) acc[i][j] += tacc[i][j];
    } else {
      for (int vc = 0; vc < NV; ++vc)
        pv_chunk<T, RI, NC, VC>(acc, ps + RI * ty * FPS + vc * VC, next_slot() + 4 * tx, S::VS);
    }
  }
  cp_async_wait<0>();
#pragma unroll
  for (int i = 0; i < RI; ++i) {
    const int r = q0 + RI * ty + i;
    if (r >= sh.Lq) continue;
    const float div = LONG ? fmaxf(l[i], 1e-30f) : l[i];
    T* out = const_cast<T*>(rows_of<T>(o, b, h, r)) + c0;
#pragma unroll
    for (int cc = 0; cc < NC; ++cc) {
      const int col = 64 * cc + 4 * tx;
      if (c0 + col >= sh.D) continue;
      float x[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) x[e] = acc[i][4 * cc + e] / div;
      store4(out + col, x);
    }
  }
}

// ------------------------------------------------------------ B8, body "ffma"
//
// B7's ffma body turned to the backward: one block of 256 threads (16 x 16:
// ty, tx) owns R = 16 RI rows of the side it writes (dq: query rows; dkv:
// keys) and DP output columns (the whole width up to 256; two passes of 256
// past it, each recomputing the scores), and keeps two tiles of those rows
// in shared memory for its life (dq: q and dO; dkv: k and v), their width
// rounded up to 64 and zero-filled. The other side streams past them in
// tiles of 64 rows (dq: keys; dkv: the queries of each query head of the
// kv head's group), each as chunks through B7's ring of FSLOTS cp.async
// slots: score chunks (64 rows x 64 columns; dq: K's then V's, dkv: q's then
// dO's) and value chunks (VC rows x DP columns; dq: K's, dkv: dO's then
// q's). Rows past the ends and columns past D arrive as zeros.
//
// Thread (ty, tx) holds the scores of its RI rows RI ty + i and the tile's
// rows tx + 16 j (j < 4), as B7: s and dp (dq: q . k^T and dO . v^T; dkv:
// k . q^T and v . dO^T), each a product of RI float4 reads of the resident
// tile (a broadcast across the 16 lanes of a row group) and four of the
// chunk per 16 RI FFMAs. It forms ds (dq) or p^T and ds^T (dkv) in fp32,
// writes them to fp32 tiles in shared memory, and the value chunks stream
// through pv_chunk into its outputs (rows RI ty + i, columns 64 c + 4 tx +
// e): dq += ds . k, dv += p^T . dO and dk += ds^T . q. Every product and sum
// is fp32 (bf16 operands widened as they load), so the function is the plain
// version's up to the order of fp32 sums.
//
// dq's one-pass tier walks K twice, as the plain version's order wants: a
// first walk (K's score chunks alone) for the row max m and sum l, then p =
// exp(s - m) / l exactly, ds = p (dp - delta). The long tier walks once with
// B5-dq's online schedule (the running max, l and the outputs rescaled by
// exp(m - m'), divided by max(l, 1e-30) last), which is its function. dkv
// takes p = exp(s - lse) (both tiers), query columns past Lq at p = 0.
//
// RI: dq 8 rows a thread up to DP 128 (about 250 registers: the outputs,
// s and dp 32 each; 4 with a bias, whose addresses at 8 made ptxas spill),
// 4 at DP 256 (2 past D 256 in fp32: two resident tiles of the whole
// width, 516 floats a row, fit in shared memory only so); dkv
// 4 up to DP 128 and 2 at DP 256, since dk, dv and a step's partial sums
// (3 x RI x DP / 16) are live together. dkv sums each step's 64 queries
// apart before adding them: its sums run over every query of the group's
// heads (1,548 at 4 heads of 387), where the plain version's products sum
// a head's at a time, and a single chain of fp32 sums lay up to 1.7x the
// plain version's distance from float64 (D 16, GQA; 1.35x at D 256).

// Shared memory of the backward ffma kernels: NP fp32 tiles of R x FPS (dq:
// ds; dkv: p^T and ds^T), then in elements of T the two resident tiles (R
// rows of round_up(D, 64) + PAD) and FSLOTS ring slots.
template <typename T, int DP, int RI, int NP>
struct BwdSmem {
  static constexpr int R = 16 * RI;
  static constexpr int PAD = 16 / (int)sizeof(T);
  static constexpr int VC = DP == 256 ? 16 : 32;  // rows of a value chunk
  static constexpr int KS = FKC + PAD;           // row of a score chunk
  static constexpr int VS = DP + PAD;            // row of a value chunk
  static constexpr int SLOT = FT * KS > VC * VS ? FT * KS : VC * VS;
  static constexpr int P_TILE = R * FPS;         // floats of one fp32 tile
  __host__ __device__ static int rs(int D) { return (D + 63) / 64 * 64 + PAD; }
  __host__ __device__ static int bytes(int D) {
    return NP * P_TILE * 4 + (2 * R * rs(D) + FSLOTS * SLOT) * (int)sizeof(T);
  }
};

// `rows` rows of `cols` columns (16-byte pieces) from src (row 0, column
// col0 of an operand of row stride sl) into dst (row stride ds) by
// cp.async; rows at or past `valid` and columns at or past D as zeros.
template <typename T>
__device__ __forceinline__ void stage_rows(T* dst, int ds, const T* src, long long sl, int rows,
                                           int valid, int cols, int col0, int D,
                                           const T* dummy) {
  constexpr int E = 16 / (int)sizeof(T);
  const int per_row = cols / E;
  for (int i = threadIdx.x; i < rows * per_row; i += THREADS) {
    const int r = i / per_row, c = (i - r * per_row) * E;
    const bool ok = r < valid && col0 + c < D;
    cp_async16(dst + r * ds + c, ok ? src + r * sl + c : dummy, ok);
  }
}

// The ring of a backward ffma kernel: chunk c's slot once it has landed and
// every thread is done with the slot before it, queuing chunk c + FSLOTS - 1
// (`issue`) into that one.
template <typename T, int SLOT, class Issue>
struct Ring {
  T* ring;
  int total, chunk;
  Issue issue;

  __device__ void start() {
    for (int c = 0; c < FSLOTS - 1; ++c) {
      if (c < total) issue(c, ring + c * SLOT);
      cp_async_commit();
    }
  }

  __device__ const T* next() {
    cp_async_wait<FSLOTS - 2>();
    __syncthreads();
    const int c = chunk + FSLOTS - 1;
    if (c < total) issue(c, ring + (c % FSLOTS) * SLOT);
    cp_async_commit();
    return ring + (chunk++ % FSLOTS) * SLOT;
  }
};

template <typename T, int SLOT, class Issue>
__device__ __forceinline__ Ring<T, SLOT, Issue> make_ring(T* ring, int total, Issue issue) {
  return Ring<T, SLOT, Issue>{ring, total, 0, issue};
}

// s[i][j] = resident row RI ty + i . chunk row tx + 16 j over the whole
// width: nk score chunks from the ring; res points at (row RI ty, column 0)
// of the resident tile (row stride rs).
template <typename T, int RI, int KS, class R>
__device__ __forceinline__ void dots(float (&s)[RI][4], const T* res, int rs, int nk, R& ring) {
  const int tx = threadIdx.x & 15;
#pragma unroll
  for (int i = 0; i < RI; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
  for (int kc = 0; kc < nk; ++kc)
    score_chunk<T, RI>(s, res + kc * FKC, rs, ring.next() + tx * KS, KS);
}

// acc += the NV value chunks of a step (the ring's next ones) against the
// fp32 tile rows at p, summed apart first.
template <typename T, int RI, int NC, int VC, int NV, class R>
__device__ __forceinline__ void step_sum(float (&acc)[RI][4 * NC], const float* p, R& ring,
                                         int col, int vs) {
  float part[RI][4 * NC];
#pragma unroll
  for (int i = 0; i < RI; ++i)
#pragma unroll
    for (int j = 0; j < 4 * NC; ++j) part[i][j] = 0.f;
  for (int vc = 0; vc < NV; ++vc) pv_chunk<T, RI, NC, VC>(part, p + vc * VC, ring.next() + col, vs);
#pragma unroll
  for (int i = 0; i < RI; ++i)
#pragma unroll
    for (int j = 0; j < 4 * NC; ++j) acc[i][j] += part[i][j];
}

// B8-dq's ffma body. grid (query tiles of 16 RI rows, B * H, column passes
// of DP). delta and lse: (B, H, Lq) contiguous fp32; lse is written by the
// blocks of the first column pass.
template <typename T, int DP, int RI, bool BIAS, bool LONG>
__global__ void __launch_bounds__(THREADS, 1)
attn_bwd_dq_ffma_kernel(Operand q, Operand k, Operand v, Operand dout, Operand dq,
                        const float* __restrict__ delta, float* __restrict__ lse, Bias bias,
                        Shape sh) {
  using S = BwdSmem<T, DP, RI, 1>;
  constexpr int BM = S::R, NC = DP / 64, VC = S::VC, NV = FT / VC;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* ps = reinterpret_cast<float*>(smem_raw);
  const int RS = S::rs(sh.D);
  T* qs = reinterpret_cast<T*>(smem_raw + S::P_TILE * 4);
  T* dos = qs + BM * RS;
  const T* dummy = static_cast<const T*>(q.p);  // a valid address for zero-filled pieces
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const int q0 = blockIdx.x * BM, b = blockIdx.y / sh.H, h = blockIdx.y % sh.H;
  const int kh = h / (sh.H / sh.KVH), c0 = blockIdx.z * DP;
  const int nk = (sh.D + FKC - 1) / FKC, tiles = (sh.Lk + FT - 1) / FT;
  const int n1 = LONG ? 0 : tiles * nk;  // the first walk's K score chunks
  const int per = 2 * nk + NV;           // a tile's K and V score chunks, K value chunks

  stage_rows<T>(qs, RS, rows_of<T>(q, b, h, min(q0, sh.Lq - 1)), q.sl, BM, sh.Lq - q0, RS - S::PAD,
                0, sh.D, dummy);
  stage_rows<T>(dos, RS, rows_of<T>(dout, b, h, min(q0, sh.Lq - 1)), dout.sl, BM, sh.Lq - q0,
                RS - S::PAD, 0, sh.D, dummy);
  cp_async_commit();
  auto issue = [&](int c, T* slot) {
    int tile, idx;
    if (c < n1) {
      tile = c / nk;
      idx = c - tile * nk;
    } else {
      tile = (c - n1) / per;
      idx = c - n1 - tile * per;
    }
    const int key0 = tile * FT;
    if (idx < 2 * nk) {  // a K (then V) score chunk: 64 keys, columns FKC (idx % nk)..
      const Operand& o = idx < nk ? k : v;
      const int col = (idx % nk) * FKC;
      stage_rows<T>(slot, S::KS, rows_of<T>(o, b, kh, min(key0, sh.Lk - 1)) + col, o.sl, FT,
                    sh.Lk - key0, FKC, col, sh.D, dummy);
    } else {  // a K value chunk: VC keys, columns c0..
      const int r0 = key0 + (idx - 2 * nk) * VC;
      stage_rows<T>(slot, S::VS, rows_of<T>(k, b, kh, min(r0, sh.Lk - 1)) + c0, k.sl, VC,
                    sh.Lk - r0, DP, c0, sh.D, dummy);
    }
  };
  auto ring = make_ring<T, S::SLOT>(dos + BM * RS, n1 + tiles * per, issue);
  ring.start();

  float m[RI], l[RI], acc[RI][4 * NC];
#pragma unroll
  for (int i = 0; i < RI; ++i) {
    m[i] = LONG ? NEG_F32 : -INFINITY;  // the long tier's running max starts at the finite min
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < 4 * NC; ++j) acc[i][j] = 0.f;
  }
  // delta of this thread's rows, read where it is used (not held: at 8 rows
  // a thread the registers hold the outputs, s and dp)
  const float* delta_rows = delta + (long long)blockIdx.y * sh.Lq + q0 + RI * ty;
  const int live_rows = sh.Lq - q0 - RI * ty;
  const float* bias_bh = BIAS ? bias.p + b * bias.sb + h * bias.sh : nullptr;
  // s * scale (+ bias), -inf past Lk, for tile t
  auto scaled = [&](float (&s)[RI][4], int t) {
#pragma unroll
    for (int i = 0; i < RI; ++i) {
      const int r = q0 + RI * ty + i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int key = t * FT + tx + 16 * j;
        float x = __fmul_rn(s[i][j], sh.scale);
        if (BIAS && r < sh.Lq && key < sh.Lk) x = __fadd_rn(x, bias_bh[r * bias.sq + key]);
        s[i][j] = key < sh.Lk ? x : -INFINITY;
      }
    }
  };
  const T* q_rows = qs + RI * ty * RS;
  const T* do_rows = dos + RI * ty * RS;
  if constexpr (!LONG) {  // the first walk: the row max and sum
    for (int t = 0; t < tiles; ++t) {
      float s[RI][4];
      dots<T, RI, S::KS>(s, q_rows, RS, nk, ring);
      scaled(s, t);
#pragma unroll
      for (int i = 0; i < RI; ++i) {
        const float mn = fmaxf(m[i], half_warp_max(fmaxf(fmaxf(s[i][0], s[i][1]),
                                                         fmaxf(s[i][2], s[i][3]))));
        float e = 0.f;
#pragma unroll
        for (int j = 0; j < 4; ++j) e += expf(s[i][j] - mn);
        l[i] = l[i] * expf(m[i] - mn) + half_warp_sum(e);
        m[i] = mn;
      }
    }
  }
  for (int t = 0; t < tiles; ++t) {
    float s[RI][4], dp[RI][4];
    dots<T, RI, S::KS>(s, q_rows, RS, nk, ring);
    scaled(s, t);
    dots<T, RI, S::KS>(dp, do_rows, RS, nk, ring);
#pragma unroll
    for (int i = 0; i < RI; ++i) {
      if constexpr (LONG) {  // the online step: the new max, l and the outputs rescaled
        const float mn = fmaxf(m[i], half_warp_max(fmaxf(fmaxf(s[i][0], s[i][1]),
                                                         fmaxf(s[i][2], s[i][3]))));
        const float alpha = expf(m[i] - mn);
        float e = 0.f;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s[i][j] = expf(s[i][j] - mn);
          e += s[i][j];
        }
        l[i] = l[i] * alpha + half_warp_sum(e);
        m[i] = mn;
#pragma unroll
        for (int j = 0; j < 4 * NC; ++j) acc[i][j] *= alpha;
      } else {  // p normalised, as the plain version
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = expf(s[i][j] - m[i]) / l[i];
      }
      const float dl = i < live_rows ? __ldg(delta_rows + i) : 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j)
        ps[(RI * ty + i) * FPS + tx + 16 * j] = s[i][j] * (dp[i][j] - dl);
    }
    for (int vc = 0; vc < NV; ++vc)
      pv_chunk<T, RI, NC, VC>(acc, ps + RI * ty * FPS + vc * VC, ring.next() + 4 * tx, S::VS);
  }
  cp_async_wait<0>();
#pragma unroll
  for (int i = 0; i < RI; ++i) {
    const int r = q0 + RI * ty + i;
    if (r >= sh.Lq) continue;
    const float div = LONG ? fmaxf(l[i], 1e-30f) : 1.f;
    T* out = const_cast<T*>(rows_of<T>(dq, b, h, r)) + c0;
#pragma unroll
    for (int cc = 0; cc < NC; ++cc) {
      const int col = 64 * cc + 4 * tx;
      if (c0 + col >= sh.D) continue;
      float x[4];
#pragma unroll
      for (int e = 0; e < 4; ++e)
        x[e] = LONG ? acc[i][4 * cc + e] / div * sh.scale : acc[i][4 * cc + e] * sh.scale;
      store4(out + col, x);
    }
    if (blockIdx.z == 0 && tx == 0)
      lse[(long long)blockIdx.y * sh.Lq + r] = m[i] + logf(LONG ? div : l[i]);
  }
}

// B8-dkv's ffma body (both tiers: p = exp(s - lse) either way). grid (key
// tiles of 16 RI keys, B * KVH, column passes of DP); the block walks every
// query row of every query head of its kv head.
template <typename T, int DP, int RI, bool BIAS>
__global__ void __launch_bounds__(THREADS, 1)
attn_bwd_dkv_ffma_kernel(Operand q, Operand k, Operand v, Operand dout, Operand dk, Operand dv,
                         const float* __restrict__ lse, const float* __restrict__ delta, Bias bias,
                         Shape sh) {
  using S = BwdSmem<T, DP, RI, 2>;
  constexpr int BK = S::R, NC = DP / 64, VC = S::VC, NV = FT / VC;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* pts = reinterpret_cast<float*>(smem_raw);  // p^T, then ds^T
  float* dss = pts + S::P_TILE;
  const int RS = S::rs(sh.D);
  T* ks = reinterpret_cast<T*>(smem_raw + 2 * S::P_TILE * 4);
  T* vs = ks + BK * RS;
  const T* dummy = static_cast<const T*>(q.p);
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const int k0 = blockIdx.x * BK, b = blockIdx.y / sh.KVH, kh = blockIdx.y % sh.KVH;
  const int rep = sh.H / sh.KVH, c0 = blockIdx.z * DP;
  const int nk = (sh.D + FKC - 1) / FKC, n_qt = (sh.Lq + FT - 1) / FT;
  const int per = 2 * nk + 2 * NV;  // a step's q and dO score chunks, dO and q value chunks

  stage_rows<T>(ks, RS, rows_of<T>(k, b, kh, min(k0, sh.Lk - 1)), k.sl, BK, sh.Lk - k0,
                RS - S::PAD, 0, sh.D, dummy);
  stage_rows<T>(vs, RS, rows_of<T>(v, b, kh, min(k0, sh.Lk - 1)), v.sl, BK, sh.Lk - k0,
                RS - S::PAD, 0, sh.D, dummy);
  cp_async_commit();
  auto issue = [&](int c, T* slot) {
    const int step = c / per, idx = c - step * per;
    const int hq = kh * rep + step / n_qt, row0 = (step % n_qt) * FT;
    if (idx < 2 * nk) {  // a q (then dO) score chunk: 64 queries, columns FKC (idx % nk)..
      const Operand& o = idx < nk ? q : dout;
      const int col = (idx % nk) * FKC;
      stage_rows<T>(slot, S::KS, rows_of<T>(o, b, hq, min(row0, sh.Lq - 1)) + col, o.sl, FT,
                    sh.Lq - row0, FKC, col, sh.D, dummy);
    } else {  // a dO (then q) value chunk: VC queries, columns c0..
      const int vc = idx - 2 * nk;
      const Operand& o = vc < NV ? dout : q;
      const int r0 = row0 + (vc % NV) * VC;
      stage_rows<T>(slot, S::VS, rows_of<T>(o, b, hq, min(r0, sh.Lq - 1)) + c0, o.sl, VC,
                    sh.Lq - r0, DP, c0, sh.D, dummy);
    }
  };
  auto ring = make_ring<T, S::SLOT>(vs + BK * RS, rep * n_qt * per, issue);
  ring.start();

  float adk[RI][4 * NC], adv[RI][4 * NC];
#pragma unroll
  for (int i = 0; i < RI; ++i)
#pragma unroll
    for (int j = 0; j < 4 * NC; ++j) adk[i][j] = adv[i][j] = 0.f;
  const T* k_rows = ks + RI * ty * RS;
  const T* v_rows = vs + RI * ty * RS;
  for (int step = 0; step < rep * n_qt; ++step) {
    const int hq = kh * rep + step / n_qt, row0 = (step % n_qt) * FT;
    const long long stat0 = ((long long)b * sh.H + hq) * sh.Lq;
    // transposed tiles: rows are keys k0 + RI ty + i, columns queries row0 + tx + 16 j
    float s[RI][4], dp[RI][4];
    dots<T, RI, S::KS>(s, k_rows, RS, nk, ring);
    dots<T, RI, S::KS>(dp, v_rows, RS, nk, ring);
    const float* bias_bh = BIAS ? bias.p + b * bias.sb + hq * bias.sh : nullptr;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int qc = row0 + tx + 16 * j;
      const bool live = qc < sh.Lq;
      const float ls = live ? lse[stat0 + qc] : 0.f;
      const float dl = live ? delta[stat0 + qc] : 0.f;
#pragma unroll
      for (int i = 0; i < RI; ++i) {
        const int key = k0 + RI * ty + i;
        float x = __fmul_rn(s[i][j], sh.scale);
        if (BIAS && live && key < sh.Lk) x = __fadd_rn(x, bias_bh[qc * bias.sq + key]);
        const float p = live ? expf(x - ls) : 0.f;
        pts[(RI * ty + i) * FPS + tx + 16 * j] = p;
        dss[(RI * ty + i) * FPS + tx + 16 * j] = p * (dp[i][j] - dl);
      }
    }
    // the step's 64 queries summed apart, then added (the outputs' sums run
    // over every query of the group's heads: blocked, their rounding stays
    // near the plain version's per-head products)
    step_sum<T, RI, NC, VC, NV>(adv, pts + RI * ty * FPS, ring, 4 * tx, S::VS);
    step_sum<T, RI, NC, VC, NV>(adk, dss + RI * ty * FPS, ring, 4 * tx, S::VS);
  }
  cp_async_wait<0>();
#pragma unroll
  for (int i = 0; i < RI; ++i) {
    const int r = k0 + RI * ty + i;
    if (r >= sh.Lk) continue;
    T* gk = const_cast<T*>(rows_of<T>(dk, b, kh, r)) + c0;
    T* gv = const_cast<T*>(rows_of<T>(dv, b, kh, r)) + c0;
#pragma unroll
    for (int cc = 0; cc < NC; ++cc) {
      const int col = 64 * cc + 4 * tx;
      if (c0 + col >= sh.D) continue;
      float xk[4], xv[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        xk[e] = adk[i][4 * cc + e] * sh.scale;
        xv[e] = adv[i][4 * cc + e];
      }
      store4(gk + col, xk);
      store4(gv + col, xv);
    }
  }
}

// RoPE of every row of x (B, heads, L, D) into the contiguous out: out = x *
// cos + rotate_half(x) * sin in fp32, rotate_half(x) = [-x2, x1], rounded to
// T; one thread per pair of columns (c, c + D/2).
template <typename T>
__global__ void __launch_bounds__(ROPE_THREADS)
rope_generic_kernel(Operand x, T* __restrict__ out, const float* __restrict__ sin_t,
                    const float* __restrict__ cos_t, long long pairs, int heads, int L, int D) {
  const long long i = (long long)blockIdx.x * ROPE_THREADS + threadIdx.x;
  if (i >= pairs) return;
  const int half = D / 2;
  const long long row = i / half;
  const int c = (int)(i % half), pos = (int)(row % L);
  const long long bh = row / L;
  const T* src = rows_of<T>(x, (int)(bh / heads), (int)(bh % heads), pos);
  const float a = widen(src[c]), bb = widen(src[c + half]);
  const float* sn = sin_t + (long long)pos * D;
  const float* cs = cos_t + (long long)pos * D;
  out[row * D + c] = narrow<T>(__fadd_rn(__fmul_rn(a, cs[c]), __fmul_rn(-bb, sn[c])));
  out[row * D + c + half] =
      narrow<T>(__fadd_rn(__fmul_rn(bb, cs[c + half]), __fmul_rn(a, sn[c + half])));
}

template <typename T>
cudaError_t rope(const Operand& x, void* out, const float* sin_t, const float* cos_t, int B,
                 int heads, int L, int D, cudaStream_t stream) {
  const long long pairs = (long long)B * heads * L * (D / 2);
  const unsigned grid = (unsigned)((pairs + ROPE_THREADS - 1) / ROPE_THREADS);
  rope_generic_kernel<T><<<grid, ROPE_THREADS, 0, stream>>>(x, static_cast<T*>(out), sin_t,
                                                            cos_t, pairs, heads, L, D);
  return cudaGetLastError();
}

Operand operand(const void* p, const long long* s) { return Operand{p, s[0], s[1], s[2]}; }

Bias bias_of(const void* p, const long long* s) {
  return Bias{static_cast<const float*>(p), p ? s[0] : 0, p ? s[1] : 0, p ? s[2] : 0};
}

bool bad_shape(const Shape& s) {
  return s.B < 1 || s.H < 1 || s.KVH < 1 || s.H % s.KVH || s.Lq < 1 || s.Lk < 1 ||
         s.D < 16 || s.D > 512 || s.D % 16 || s.B * s.H > 65535;
}

// Whether the ffma body can read an operand with cp.async: base and every
// stride it steps over multiples of 16 bytes.
template <typename T>
bool pieces_aligned(const Operand& x, int batches, int heads) {
  constexpr long long E = 16 / sizeof(T);
  return reinterpret_cast<uintptr_t>(x.p) % 16 == 0 && x.sl % E == 0 &&
         (heads == 1 || x.sh % E == 0) && (batches == 1 || x.sb % E == 0);
}

template <typename T, int DP, bool BIAS, bool LONG>
cudaError_t launch_ffma(const Operand& q, const Operand& k, const Operand& v, const Operand& o,
                        const Bias& bias, const Shape& sh, cudaStream_t stream) {
  auto kernel = attn_fwd_ffma_kernel<T, DP, BIAS, LONG>;
  const int smem = FfmaSmem<T, DP>::bytes(sh.D);
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((sh.Lq + FfmaSmem<T, DP>::BM - 1) / FfmaSmem<T, DP>::BM, sh.B * sh.H,
                  (sh.D + DP - 1) / DP);
  kernel<<<grid, THREADS, smem, stream>>>(q, k, v, o, bias, sh);
  return cudaGetLastError();
}

template <typename T, int DP>
cudaError_t ffma_tiers(const Operand& q, const Operand& k, const Operand& v, const Operand& o,
                       const Bias& bias, bool long_tier, const Shape& sh, cudaStream_t stream) {
  if (long_tier)
    return bias.p ? launch_ffma<T, DP, true, true>(q, k, v, o, bias, sh, stream)
                  : launch_ffma<T, DP, false, true>(q, k, v, o, bias, sh, stream);
  return bias.p ? launch_ffma<T, DP, true, false>(q, k, v, o, bias, sh, stream)
                : launch_ffma<T, DP, false, false>(q, k, v, o, bias, sh, stream);
}

// B7's ffma body: fp32 at any width (DP the width rounded up to 64, 128 or
// 256; two passes of 256 past 256). bf16 takes the wgmma body at every
// width (csrc/attention_wide.cu): the entry refuses it here.
cudaError_t fwd(Operand q, Operand k, Operand v, Operand o, Bias bias, bool long_tier,
                const Shape& sh, cudaStream_t stream) {
  if (!pieces_aligned<float>(q, sh.B, sh.H) || !pieces_aligned<float>(k, sh.B, sh.KVH) ||
      !pieces_aligned<float>(v, sh.B, sh.KVH) || !pieces_aligned<float>(o, sh.B, sh.H))
    return cudaErrorInvalidValue;
  if (sh.D <= 64) return ffma_tiers<float, 64>(q, k, v, o, bias, long_tier, sh, stream);
  if (sh.D <= 128) return ffma_tiers<float, 128>(q, k, v, o, bias, long_tier, sh, stream);
  return ffma_tiers<float, 256>(q, k, v, o, bias, long_tier, sh, stream);
}

template <typename T, int DP, int RI, bool BIAS, bool LONG>
cudaError_t launch_dq_ffma(const Operand& q, const Operand& k, const Operand& v,
                           const Operand& dout, const Operand& g, const float* delta, float* lse,
                           const Bias& bias, const Shape& sh, cudaStream_t stream) {
  auto kernel = attn_bwd_dq_ffma_kernel<T, DP, RI, BIAS, LONG>;
  const int smem = BwdSmem<T, DP, RI, 1>::bytes(sh.D);
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((sh.Lq + 16 * RI - 1) / (16 * RI), sh.B * sh.H, (sh.D + DP - 1) / DP);
  kernel<<<grid, THREADS, smem, stream>>>(q, k, v, dout, g, delta, lse, bias, sh);
  return cudaGetLastError();
}

template <typename T, int DP, int RI, bool BIAS>
cudaError_t launch_dkv_ffma(const Operand& q, const Operand& k, const Operand& v,
                            const Operand& dout, const Operand& gk, const Operand& gv,
                            const float* lse, const float* delta, const Bias& bias,
                            const Shape& sh, cudaStream_t stream) {
  auto kernel = attn_bwd_dkv_ffma_kernel<T, DP, RI, BIAS>;
  const int smem = BwdSmem<T, DP, RI, 2>::bytes(sh.D);
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((sh.Lk + 16 * RI - 1) / (16 * RI), sh.B * sh.KVH, (sh.D + DP - 1) / DP);
  kernel<<<grid, THREADS, smem, stream>>>(q, k, v, dout, gk, gv, lse, delta, bias, sh);
  return cudaGetLastError();
}

// RI rows a thread unbiased, at most 4 biased (at 8 the bias's addresses
// made ptxas spill)
template <typename T, int DP, int RI>
cudaError_t dq_tiers(const Operand& q, const Operand& k, const Operand& v, const Operand& dout,
                     const Operand& g, const float* delta, float* lse, const Bias& bias,
                     bool long_tier, const Shape& sh, cudaStream_t s) {
  constexpr int RB = RI > 4 ? 4 : RI;
  if (long_tier)
    return bias.p ? launch_dq_ffma<T, DP, RB, true, true>(q, k, v, dout, g, delta, lse, bias, sh, s)
                  : launch_dq_ffma<T, DP, RI, false, true>(q, k, v, dout, g, delta, lse, bias, sh,
                                                           s);
  return bias.p ? launch_dq_ffma<T, DP, RB, true, false>(q, k, v, dout, g, delta, lse, bias, sh, s)
                : launch_dq_ffma<T, DP, RI, false, false>(q, k, v, dout, g, delta, lse, bias, sh,
                                                          s);
}

template <typename T, int DP, int RI>
cudaError_t dkv_bias(const Operand& q, const Operand& k, const Operand& v, const Operand& dout,
                     const Operand& gk, const Operand& gv, const float* lse, const float* delta,
                     const Bias& bias, const Shape& sh, cudaStream_t s) {
  return bias.p ? launch_dkv_ffma<T, DP, RI, true>(q, k, v, dout, gk, gv, lse, delta, bias, sh, s)
                : launch_dkv_ffma<T, DP, RI, false>(q, k, v, dout, gk, gv, lse, delta, bias, sh,
                                                    s);
}

// B8's ffma bodies: fp32 at any width (DP the width rounded up to 64, 128
// or 256; two passes of 256 past 256), bf16 past 256 (the wgmma body takes
// bf16 up to 256: the entries refuse it here).
template <typename T>
cudaError_t dq(Operand q, Operand k, Operand v, Operand dout, Operand g, const float* delta,
               float* lse, Bias bias, bool long_tier, const Shape& sh, cudaStream_t stream) {
  if (!pieces_aligned<T>(q, sh.B, sh.H) || !pieces_aligned<T>(k, sh.B, sh.KVH) ||
      !pieces_aligned<T>(v, sh.B, sh.KVH) || !pieces_aligned<T>(dout, sh.B, sh.H) ||
      !pieces_aligned<T>(g, sh.B, sh.H))
    return cudaErrorInvalidValue;
  if constexpr (sizeof(T) == 2) {
    if (sh.D <= 256) return cudaErrorInvalidValue;
    return dq_tiers<T, 256, 4>(q, k, v, dout, g, delta, lse, bias, long_tier, sh, stream);
  } else {
    if (sh.D <= 64)
      return dq_tiers<T, 64, 8>(q, k, v, dout, g, delta, lse, bias, long_tier, sh, stream);
    if (sh.D <= 128)
      return dq_tiers<T, 128, 8>(q, k, v, dout, g, delta, lse, bias, long_tier, sh, stream);
    if (sh.D <= 256)
      return dq_tiers<T, 256, 4>(q, k, v, dout, g, delta, lse, bias, long_tier, sh, stream);
    return dq_tiers<T, 256, 2>(q, k, v, dout, g, delta, lse, bias, long_tier, sh, stream);
  }
}

template <typename T>
cudaError_t dkv(Operand q, Operand k, Operand v, Operand dout, Operand gk, Operand gv,
                const float* lse, const float* delta, Bias bias, const Shape& sh,
                cudaStream_t stream) {
  if (!pieces_aligned<T>(q, sh.B, sh.H) || !pieces_aligned<T>(k, sh.B, sh.KVH) ||
      !pieces_aligned<T>(v, sh.B, sh.KVH) || !pieces_aligned<T>(dout, sh.B, sh.H) ||
      !pieces_aligned<T>(gk, sh.B, sh.KVH) || !pieces_aligned<T>(gv, sh.B, sh.KVH))
    return cudaErrorInvalidValue;
  if constexpr (sizeof(T) == 2) {
    if (sh.D <= 256) return cudaErrorInvalidValue;
    return dkv_bias<T, 256, 2>(q, k, v, dout, gk, gv, lse, delta, bias, sh, stream);
  } else {
    if (sh.D <= 64) return dkv_bias<T, 64, 4>(q, k, v, dout, gk, gv, lse, delta, bias, sh, stream);
    if (sh.D <= 128)
      return dkv_bias<T, 128, 4>(q, k, v, dout, gk, gv, lse, delta, bias, sh, stream);
    return dkv_bias<T, 256, 2>(q, k, v, dout, gk, gv, lse, delta, bias, sh, stream);
  }
}

}  // namespace

// C entries, bound with ctypes. `dtype`: 0 for fp32 operands, 1 for bf16 (q,
// k, v, dout and every output of one call share it). Every operand is (B,
// heads, rows, D) with a contiguous last dim, described by three element
// strides (batch, head, row) in `strides`, in the order of the pointers; a
// bias is fp32 (B|1, H|1, Lq, Lk), its three strides last (0 on a broadcast
// axis), or null. lse and delta: contiguous fp32 (B, H, Lq). Each returns a
// cudaError_t; 0 is success.

// Kernel B7's ffma body, fp32 only (`dtype` 0; bf16 takes the wgmma body).
// long_tier 0: the one-pass function (q and k already rotated, with RoPE:
// mmada_attention_generic_rope); 1: the long function. strides: q, k, v, o,
// bias.
extern "C" int mmada_attention_generic_fwd(const void* q, const void* k, const void* v,
                                           void* o, const void* bias, int dtype,
                                           int long_tier, int B, int H, int KVH, int Lq,
                                           int Lk, int D, const long long* strides,
                                           float scale, void* stream) {
  const Shape sh{B, H, KVH, Lq, Lk, D, scale};
  if (bad_shape(sh) || dtype != 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Operand oq = operand(q, strides), ok = operand(k, strides + 3),
                ov = operand(v, strides + 6), oo = operand(o, strides + 9);
  const Bias ob = bias_of(bias, strides + 12);
  return (int)fwd(oq, ok, ov, oo, ob, long_tier, sh, s);
}

// Kernel B8-dq's ffma body: (dq, lse) from q, k (rotated), v, dout and delta;
// fp32 at any width, bf16 past 256. long_tier 0: the one-pass function; 1:
// the long one. strides: q, k, v, dout, dq, bias.
extern "C" int mmada_attention_generic_dq(
    const void* q, const void* k, const void* v, const void* dout, const void* delta,
    const void* bias, void* dq_out, void* lse, int dtype, int long_tier, int B, int H, int KVH,
    int Lq, int Lk, int D, const long long* strides, float scale, void* stream) {
  const Shape sh{B, H, KVH, Lq, Lk, D, scale};
  if (bad_shape(sh) || (dtype != 0 && dtype != 1)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Operand oq = operand(q, strides), ok = operand(k, strides + 3),
                ov = operand(v, strides + 6), od = operand(dout, strides + 9),
                og = operand(dq_out, strides + 12);
  const Bias ob = bias_of(bias, strides + 15);
  const float* dl = static_cast<const float*>(delta);
  float* ls = static_cast<float*>(lse);
  return (int)(dtype ? dq<bf16>(oq, ok, ov, od, og, dl, ls, ob, long_tier, sh, s)
                     : dq<float>(oq, ok, ov, od, og, dl, ls, ob, long_tier, sh, s));
}

// Kernel B8-dkv's ffma body: (dk, dv) from q, k (rotated), v, dout, lse and
// delta (both tiers' function); fp32 at any width, bf16 past 256. strides:
// q, k, v, dout, dk, dv, bias.
extern "C" int mmada_attention_generic_dkv(
    const void* q, const void* k, const void* v, const void* dout, const void* lse,
    const void* delta, const void* bias, void* dk_out, void* dv_out, int dtype, int B, int H,
    int KVH, int Lq, int Lk, int D, const long long* strides, float scale, void* stream) {
  const Shape sh{B, H, KVH, Lq, Lk, D, scale};
  if (bad_shape(sh) || (dtype != 0 && dtype != 1)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Operand oq = operand(q, strides), ok = operand(k, strides + 3),
                ov = operand(v, strides + 6), od = operand(dout, strides + 9),
                gk = operand(dk_out, strides + 12), gv = operand(dv_out, strides + 15);
  const Bias ob = bias_of(bias, strides + 18);
  const float* ls = static_cast<const float*>(lse);
  const float* dl = static_cast<const float*>(delta);
  return (int)(dtype ? dkv<bf16>(oq, ok, ov, od, gk, gv, ls, dl, ob, sh, s)
                     : dkv<float>(oq, ok, ov, od, gk, gv, ls, dl, ob, sh, s));
}

// RoPE at the real width D of x (B, heads, L, D; element strides batch, head,
// row in `strides`) into the contiguous out of x's type: both of B7's bodies
// read q and k so rotated (the wgmma body's instances are 64, 128 or 256
// wide, and RoPE pairs column c with c + D/2 of the real D).
extern "C" int mmada_attention_generic_rope(const void* x, void* out, const void* rope_sin,
                                            const void* rope_cos, int dtype, int B, int heads,
                                            int L, int D, const long long* strides,
                                            void* stream) {
  if (B < 1 || heads < 1 || L < 1 || D < 16 || D > 512 || D % 16 || (dtype != 0 && dtype != 1) ||
      rope_sin == nullptr || rope_cos == nullptr)
    return (int)cudaErrorInvalidValue;
  const Operand ox = operand(x, strides);
  const float* sn = static_cast<const float*>(rope_sin);
  const float* cs = static_cast<const float*>(rope_cos);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return (int)(dtype ? rope<bf16>(ox, out, sn, cs, B, heads, L, D, s)
                     : rope<float>(ox, out, sn, cs, B, heads, L, D, s));
}
