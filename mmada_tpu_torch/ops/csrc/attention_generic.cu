// Attention at any head width and in fp32, for Hopper (sm_90a): kernels B7
// (forward), B8-dq and B8-dkv (backward), on the CUDA cores.
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
//           out = p . v summed in fp32. RoPE first, by rope_kernel: q and k
//           rotated in fp32 and rounded to their type, as `_rope_tile`.
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
// Design (simple and right first): a block of 256 threads (16 x 16) owns a
// tile of 64 query rows (B7, B8-dq) or 64 keys (B8-dkv) and at most DC = 128
// output columns; a head wider than 128 takes one block per 128-column chunk
// (the grid's z), each recomputing the scores over the full width. A score
// tile (64 x 64) is a product over D in chunks of 16 columns staged in shared
// memory in fp32; each thread holds 4 x 4 scores (rows ty + 16 i, columns
// tx + 16 j) and 4 x DC/16 outputs, so a row's max and sum are shuffles
// within a half warp. p (or ds) goes to shared memory, and the value rows
// stream through it 16 at a time for the product into the outputs. D is a
// runtime loop: one instance per (type, bias, tier) serves every width.
// The one-pass forward and dq walk K twice (pass 1: row max and sum; pass 2:
// the normalised p), the long forward once.
//
// Bound: 4 B H Lq Lk D flops (forward; backward 8 B H Lq Lk D for dq and
// dk/dv together, counted as the function needs them) against the fp32 rate
// of 67 TFLOP/s on the CUDA cores, or the operands' bytes at 3.35 TB/s. At
// the serving shapes (L ~ 1.2k, D >= 64) the flops bound them. This design
// recomputes the scores (twice in the one-pass tier, once more per extra
// 128-column chunk) and reads two fp32 values from shared memory per two
// FFMAs, so it reaches a fraction of that rate: the times stand beside the
// bound in PERF.md.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int THREADS = 256;  // 16 x 16
constexpr int TILE = 64;      // query rows / keys of a tile
constexpr int KC = 16;        // contraction chunk of a score product
constexpr int DC = 128;       // output columns of a block
constexpr int NJ = DC / 16;   // output columns of a thread
constexpr int SP = TILE + 1;  // padded row of the p tile
constexpr int SA = KC + 1;    // padded row of a score chunk
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

// acc[i][j] = sum over d < D of a[ty + 16 i][d] * b[tx + 16 j][d]: a and b
// point at row 0 of their 64-row tiles (row stride sa_l, sb_l); rows at or
// past a_rows / b_rows read as 0. sa, sb: 64 x SA floats of shared memory.
template <typename T>
__device__ __forceinline__ void dot_tile(float (&acc)[4][4], const T* a, long long a_l,
                                         int a_rows, const T* b, long long b_l, int b_rows,
                                         int D, float* sa, float* sb) {
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
  for (int d0 = 0; d0 < D; d0 += KC) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = e * 16 + ty;
      sa[r * SA + tx] = r < a_rows ? widen(a[r * a_l + d0 + tx]) : 0.f;
      sb[r * SA + tx] = r < b_rows ? widen(b[r * b_l + d0 + tx]) : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < KC; ++kk) {
      float av[4], bv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) av[i] = sa[(ty + 16 * i) * SA + kk];
#pragma unroll
      for (int j = 0; j < 4; ++j) bv[j] = sb[(tx + 16 * j) * SA + kk];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }
}

// acc[i][j] += sum over t < 64 of p[ty + 16 i][t] * v[t][tx + 16 j]: p is
// the 64 x SP tile in shared memory, v points at row 0 (column 0 of this
// block's chunk) of a 64-row tile of row stride v_l, rows at or past v_rows
// read as 0; nc (a multiple of 16, at most DC) columns. sv: KC x DC floats.
template <typename T>
__device__ __forceinline__ void pv_tile(float (&acc)[4][NJ], const float* p, const T* v,
                                        long long v_l, int v_rows, int nc, float* sv) {
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  for (int t0 = 0; t0 < TILE; t0 += KC) {
    for (int idx = tid; idx < KC * nc; idx += THREADS) {
      const int t = idx / nc, c = idx - t * nc;
      sv[t * DC + c] = t0 + t < v_rows ? widen(v[(t0 + t) * v_l + c]) : 0.f;
    }
    __syncthreads();
#pragma unroll 4
    for (int t = 0; t < KC; ++t) {
      float pv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = p[(ty + 16 * i) * SP + t0 + t];
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        if (16 * j < nc) {
          const float vv = sv[t * DC + tx + 16 * j];
#pragma unroll
          for (int i = 0; i < 4; ++i) acc[i][j] = fmaf(pv[i], vv, acc[i][j]);
        }
      }
    }
    __syncthreads();
  }
}

// The scores of the 64 x 64 tile (query rows q0 + ty + 16 i, keys k0 + tx +
// 16 j): s = dot * scale + bias, -inf for keys at or past Lk.
template <typename T, bool BIAS>
__device__ __forceinline__ void score_tile(float (&s)[4][4], const Operand& q, const Operand& k,
                                           const Bias& bias, const Shape& sh, int b, int h,
                                           int kh, int q0, int k0, float* sa, float* sb) {
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
  dot_tile<T>(s, rows_of<T>(q, b, h, q0), q.sl, sh.Lq - q0, rows_of<T>(k, b, kh, k0), k.sl,
              sh.Lk - k0, sh.D, sa, sb);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = q0 + ty + 16 * i;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = k0 + tx + 16 * j;
      float x = __fmul_rn(s[i][j], sh.scale);
      if (BIAS && r < sh.Lq && c < sh.Lk) x = __fadd_rn(x, bias.p[b * bias.sb + h * bias.sh +
                                                                 r * bias.sq + c]);
      s[i][j] = c < sh.Lk ? x : -INFINITY;
    }
  }
}

// Pass 1 of the one-pass forward and of dq: the row max m and the row sum l
// of exp(s - m) over every key (online over the tiles).
template <typename T, bool BIAS>
__device__ __forceinline__ void row_stats(float (&m)[4], float (&l)[4], const Operand& q,
                                          const Operand& k, const Bias& bias, const Shape& sh,
                                          int b, int h, int kh, int q0, float* sa, float* sb) {
  for (int k0 = 0; k0 < sh.Lk; k0 += TILE) {
    float s[4][4];
    score_tile<T, BIAS>(s, q, k, bias, sh, b, h, kh, q0, k0, sa, sb);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float mx = half_warp_max(fmaxf(fmaxf(s[i][0], s[i][1]), fmaxf(s[i][2], s[i][3])));
      const float mn = fmaxf(m[i], mx);
      float e = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) e += expf(s[i][j] - mn);
      l[i] = l[i] * expf(m[i] - mn) + half_warp_sum(e);
      m[i] = mn;
    }
  }
}

struct Smem {
  float a[TILE * SA];
  float b[TILE * SA];
  float p[TILE * SP];
  float v[KC * DC];
};

// B7. grid (query tiles, B * H, column chunks).
template <typename T, bool BIAS, bool LONG>
__global__ void __launch_bounds__(THREADS)
attn_fwd_generic_kernel(Operand q, Operand k, Operand v, Operand o, Bias bias, Shape sh) {
  __shared__ Smem sm;
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const int q0 = blockIdx.x * TILE, b = blockIdx.y / sh.H, h = blockIdx.y % sh.H;
  const int kh = h / (sh.H / sh.KVH), d0 = blockIdx.z * DC, nc = min(DC, sh.D - d0);
  // the long tier's running max starts at the finite min, as its plain version
  float m[4], l[4], acc[4][NJ];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = LONG ? NEG_F32 : -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < NJ; ++j) acc[i][j] = 0.f;
  }
  if (!LONG) row_stats<T, BIAS>(m, l, q, k, bias, sh, b, h, kh, q0, sm.a, sm.b);
  for (int k0 = 0; k0 < sh.Lk; k0 += TILE) {
    float s[4][4];
    score_tile<T, BIAS>(s, q, k, bias, sh, b, h, kh, q0, k0, sm.a, sm.b);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      if (LONG) {  // online: rescale what the earlier tiles summed
        const float mx = half_warp_max(fmaxf(fmaxf(s[i][0], s[i][1]), fmaxf(s[i][2], s[i][3])));
        const float mn = fmaxf(m[i], mx);
        const float alpha = expf(m[i] - mn);
        m[i] = mn;
        float e = 0.f;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s[i][j] = expf(s[i][j] - mn);
          e += s[i][j];
        }
        l[i] = l[i] * alpha + half_warp_sum(e);
#pragma unroll
        for (int j = 0; j < NJ; ++j) acc[i][j] *= alpha;
      } else {  // normalised, then rounded to v's type
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = widen(narrow<T>(expf(s[i][j] - m[i]) / l[i]));
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) sm.p[(ty + 16 * i) * SP + tx + 16 * j] = s[i][j];
    }
    pv_tile<T>(acc, sm.p, rows_of<T>(v, b, kh, k0) + d0, v.sl, sh.Lk - k0, nc, sm.v);
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = q0 + ty + 16 * i;
    if (r >= sh.Lq) continue;
    const float inv = LONG ? fmaxf(l[i], 1e-30f) : 1.f;
    T* out = const_cast<T*>(rows_of<T>(o, b, h, r)) + d0;
#pragma unroll
    for (int j = 0; j < NJ; ++j)
      if (16 * j < nc) out[tx + 16 * j] = narrow<T>(LONG ? acc[i][j] / inv : acc[i][j]);
  }
}

// B8-dq. grid (query tiles, B * H, column chunks). delta and lse: (B, H, Lq)
// contiguous fp32; lse is written by the blocks of the first column chunk.
template <typename T, bool BIAS, bool LONG>
__global__ void __launch_bounds__(THREADS)
attn_bwd_dq_generic_kernel(Operand q, Operand k, Operand v, Operand dout, Operand dq,
                           const float* __restrict__ delta, float* __restrict__ lse, Bias bias,
                           Shape sh) {
  __shared__ Smem sm;
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const int q0 = blockIdx.x * TILE, b = blockIdx.y / sh.H, h = blockIdx.y % sh.H;
  const int kh = h / (sh.H / sh.KVH), d0 = blockIdx.z * DC, nc = min(DC, sh.D - d0);
  float m[4], l[4], dl[4], acc[4][NJ];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = q0 + ty + 16 * i;
    m[i] = LONG ? NEG_F32 : -INFINITY;
    l[i] = 0.f;
    dl[i] = r < sh.Lq ? delta[(long long)blockIdx.y * sh.Lq + r] : 0.f;
#pragma unroll
    for (int j = 0; j < NJ; ++j) acc[i][j] = 0.f;
  }
  row_stats<T, BIAS>(m, l, q, k, bias, sh, b, h, kh, q0, sm.a, sm.b);
  if (LONG) {
#pragma unroll
    for (int i = 0; i < 4; ++i) l[i] = fmaxf(l[i], 1e-30f);
  }
  for (int k0 = 0; k0 < sh.Lk; k0 += TILE) {
    float s[4][4], dp[4][4];
    score_tile<T, BIAS>(s, q, k, bias, sh, b, h, kh, q0, k0, sm.a, sm.b);
    dot_tile<T>(dp, rows_of<T>(dout, b, h, q0), dout.sl, sh.Lq - q0, rows_of<T>(v, b, kh, k0),
                v.sl, sh.Lk - k0, sh.D, sm.a, sm.b);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        float p = expf(s[i][j] - m[i]);
        if (!LONG) p = p / l[i];
        sm.p[(ty + 16 * i) * SP + tx + 16 * j] = p * (dp[i][j] - dl[i]);
      }
    pv_tile<T>(acc, sm.p, rows_of<T>(k, b, kh, k0) + d0, k.sl, sh.Lk - k0, nc, sm.v);
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = q0 + ty + 16 * i;
    if (r >= sh.Lq) continue;
    T* out = const_cast<T*>(rows_of<T>(dq, b, h, r)) + d0;
#pragma unroll
    for (int j = 0; j < NJ; ++j)
      if (16 * j < nc)
        out[tx + 16 * j] = narrow<T>(LONG ? acc[i][j] / l[i] * sh.scale : acc[i][j] * sh.scale);
    if (blockIdx.z == 0 && tx == 0) lse[(long long)blockIdx.y * sh.Lq + r] = m[i] + logf(l[i]);
  }
}

// B8-dkv (both tiers: p = exp(s - lse) either way). grid (key tiles, B *
// KVH, column chunks); the block walks every query row of every query head
// of its kv head.
template <typename T, bool BIAS>
__global__ void __launch_bounds__(THREADS)
attn_bwd_dkv_generic_kernel(Operand q, Operand k, Operand v, Operand dout, Operand dk,
                            Operand dv, const float* __restrict__ lse,
                            const float* __restrict__ delta, Bias bias, Shape sh) {
  __shared__ Smem sm;
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const int k0 = blockIdx.x * TILE, b = blockIdx.y / sh.KVH, kh = blockIdx.y % sh.KVH;
  const int rep = sh.H / sh.KVH, d0 = blockIdx.z * DC, nc = min(DC, sh.D - d0);
  float adk[4][NJ], adv[4][NJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j) adk[i][j] = adv[i][j] = 0.f;
  for (int h = kh * rep; h < (kh + 1) * rep; ++h) {
    const long long row0 = ((long long)b * sh.H + h) * sh.Lq;
    for (int q0 = 0; q0 < sh.Lq; q0 += TILE) {
      // transposed tiles: rows are keys k0 + ty + 16 i, columns queries q0 + tx + 16 j
      float s[4][4], dp[4][4];
      dot_tile<T>(s, rows_of<T>(k, b, kh, k0), k.sl, sh.Lk - k0, rows_of<T>(q, b, h, q0), q.sl,
                  sh.Lq - q0, sh.D, sm.a, sm.b);
      dot_tile<T>(dp, rows_of<T>(v, b, kh, k0), v.sl, sh.Lk - k0, rows_of<T>(dout, b, h, q0),
                  dout.sl, sh.Lq - q0, sh.D, sm.a, sm.b);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = q0 + tx + 16 * j;
        const float ls = c < sh.Lq ? lse[row0 + c] : 0.f;
        const float dl = c < sh.Lq ? delta[row0 + c] : 0.f;
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int r = k0 + ty + 16 * i;
          float x = __fmul_rn(s[i][j], sh.scale);
          if (BIAS && r < sh.Lk && c < sh.Lq)
            x = __fadd_rn(x, bias.p[b * bias.sb + h * bias.sh + c * bias.sq + r]);
          const float p = c < sh.Lq ? expf(x - ls) : 0.f;
          s[i][j] = p;
          dp[i][j] = p * (dp[i][j] - dl);
        }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) sm.p[(ty + 16 * i) * SP + tx + 16 * j] = s[i][j];
      pv_tile<T>(adv, sm.p, rows_of<T>(dout, b, h, q0) + d0, dout.sl, sh.Lq - q0, nc, sm.v);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) sm.p[(ty + 16 * i) * SP + tx + 16 * j] = dp[i][j];
      pv_tile<T>(adk, sm.p, rows_of<T>(q, b, h, q0) + d0, q.sl, sh.Lq - q0, nc, sm.v);
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = k0 + ty + 16 * i;
    if (r >= sh.Lk) continue;
    T* gk = const_cast<T*>(rows_of<T>(dk, b, kh, r)) + d0;
    T* gv = const_cast<T*>(rows_of<T>(dv, b, kh, r)) + d0;
#pragma unroll
    for (int j = 0; j < NJ; ++j)
      if (16 * j < nc) {
        gk[tx + 16 * j] = narrow<T>(adk[i][j] * sh.scale);
        gv[tx + 16 * j] = narrow<T>(adv[i][j]);
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

dim3 grid_of(int rows, int heads, int D) {
  return dim3((rows + TILE - 1) / TILE, heads, (D + DC - 1) / DC);
}

template <typename T>
cudaError_t fwd(Operand q, Operand k, Operand v, Operand o, Bias bias, bool long_tier,
                const Shape& sh, cudaStream_t stream) {
  const dim3 grid = grid_of(sh.Lq, sh.B * sh.H, sh.D);
  if (long_tier) {
    if (bias.p) attn_fwd_generic_kernel<T, true, true><<<grid, THREADS, 0, stream>>>(q, k, v, o, bias, sh);
    else attn_fwd_generic_kernel<T, false, true><<<grid, THREADS, 0, stream>>>(q, k, v, o, bias, sh);
  } else {
    if (bias.p) attn_fwd_generic_kernel<T, true, false><<<grid, THREADS, 0, stream>>>(q, k, v, o, bias, sh);
    else attn_fwd_generic_kernel<T, false, false><<<grid, THREADS, 0, stream>>>(q, k, v, o, bias, sh);
  }
  return cudaGetLastError();
}

template <typename T>
cudaError_t dq(Operand q, Operand k, Operand v, Operand dout, Operand g, const float* delta,
               float* lse, Bias bias, bool long_tier, const Shape& sh, cudaStream_t stream) {
  const dim3 grid = grid_of(sh.Lq, sh.B * sh.H, sh.D);
  if (long_tier) {
    if (bias.p) attn_bwd_dq_generic_kernel<T, true, true><<<grid, THREADS, 0, stream>>>(q, k, v, dout, g, delta, lse, bias, sh);
    else attn_bwd_dq_generic_kernel<T, false, true><<<grid, THREADS, 0, stream>>>(q, k, v, dout, g, delta, lse, bias, sh);
  } else {
    if (bias.p) attn_bwd_dq_generic_kernel<T, true, false><<<grid, THREADS, 0, stream>>>(q, k, v, dout, g, delta, lse, bias, sh);
    else attn_bwd_dq_generic_kernel<T, false, false><<<grid, THREADS, 0, stream>>>(q, k, v, dout, g, delta, lse, bias, sh);
  }
  return cudaGetLastError();
}

template <typename T>
cudaError_t dkv(Operand q, Operand k, Operand v, Operand dout, Operand gk, Operand gv,
                const float* lse, const float* delta, Bias bias, const Shape& sh,
                cudaStream_t stream) {
  const dim3 grid = grid_of(sh.Lk, sh.B * sh.KVH, sh.D);
  if (bias.p) attn_bwd_dkv_generic_kernel<T, true><<<grid, THREADS, 0, stream>>>(q, k, v, dout, gk, gv, lse, delta, bias, sh);
  else attn_bwd_dkv_generic_kernel<T, false><<<grid, THREADS, 0, stream>>>(q, k, v, dout, gk, gv, lse, delta, bias, sh);
  return cudaGetLastError();
}

}  // namespace

// C entries, bound with ctypes. `dtype`: 0 for fp32 operands, 1 for bf16 (q,
// k, v, dout and every output of one call share it). Every operand is (B,
// heads, rows, D) with a contiguous last dim, described by three element
// strides (batch, head, row) in `strides`, in the order of the pointers; a
// bias is fp32 (B|1, H|1, Lq, Lk), its three strides last (0 on a broadcast
// axis), or null. lse and delta: contiguous fp32 (B, H, Lq). Each returns a
// cudaError_t; 0 is success.

// Kernel B7. long_tier 0: the one-pass function, with RoPE when rope_sin and
// rope_cos are fp32 (L, D) tables (Lq == Lk; q_rot and k_rot contiguous
// scratch of q's and k's type and size); 1: the long function (no RoPE).
// strides: q, k, v, o, bias.
extern "C" int mmada_attention_generic_fwd(
    const void* q, const void* k, const void* v, void* o, const void* bias,
    const void* rope_sin, const void* rope_cos, void* q_rot, void* k_rot, int dtype,
    int long_tier, int B, int H, int KVH, int Lq, int Lk, int D, const long long* strides,
    float scale, void* stream) {
  const Shape sh{B, H, KVH, Lq, Lk, D, scale};
  const bool roped = rope_sin != nullptr;
  if (bad_shape(sh) || (dtype != 0 && dtype != 1) || (roped != (rope_cos != nullptr)) ||
      (roped && (long_tier || Lq != Lk || q_rot == nullptr || k_rot == nullptr)))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  Operand oq = operand(q, strides), ok = operand(k, strides + 3);
  if (roped) {
    const float* sn = static_cast<const float*>(rope_sin);
    const float* cs = static_cast<const float*>(rope_cos);
    cudaError_t err = dtype ? rope<bf16>(oq, q_rot, sn, cs, B, H, Lq, D, s)
                            : rope<float>(oq, q_rot, sn, cs, B, H, Lq, D, s);
    if (err == cudaSuccess)
      err = dtype ? rope<bf16>(ok, k_rot, sn, cs, B, KVH, Lk, D, s)
                  : rope<float>(ok, k_rot, sn, cs, B, KVH, Lk, D, s);
    if (err != cudaSuccess) return (int)err;
    oq = Operand{q_rot, (long long)H * Lq * D, (long long)Lq * D, D};
    ok = Operand{k_rot, (long long)KVH * Lk * D, (long long)Lk * D, D};
  }
  const Operand ov = operand(v, strides + 6), oo = operand(o, strides + 9);
  const Bias ob = bias_of(bias, strides + 12);
  return (int)(dtype ? fwd<bf16>(oq, ok, ov, oo, ob, long_tier, sh, s)
                     : fwd<float>(oq, ok, ov, oo, ob, long_tier, sh, s));
}

// Kernel B8-dq: (dq, lse) from q, k (rotated), v, dout and delta. strides: q,
// k, v, dout, dq, bias.
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

// Kernel B8-dkv: (dk, dv) from q, k (rotated), v, dout, lse and delta.
// strides: q, k, v, dout, dk, dv, bias.
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
