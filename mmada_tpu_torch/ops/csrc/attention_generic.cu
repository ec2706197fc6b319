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
// at the widths 16-256 other than 64 and 128 take the tensor cores (the
// "wgmma" body, csrc/attention_wide.cu); fp32 at every width and bf16 past
// 256 take the "ffma" body here (attn_fwd_ffma_kernel: 64-row tiles, the
// whole width to 256 in one block, register tiles fed by float4 reads, K and
// V staged by cp.async; its design note stands above the kernel). This file
// also holds the rotation both bodies run before attention with RoPE
// (rope_generic_kernel, at the real width).
//
// B8 (simple and right first): a block of 256 threads (16 x 16) owns a tile
// of 64 query rows (B8-dq) or 64 keys (B8-dkv) and at most DC = 128 output
// columns; a head wider than 128 takes one block per 128-column chunk (the
// grid's z), each recomputing the scores over the full width. A score tile
// (64 x 64) is a product over D in chunks of 16 columns staged in shared
// memory in fp32; each thread holds 4 x 4 scores (rows ty + 16 i, columns
// tx + 16 j) and 4 x DC/16 outputs, so a row's max and sum are shuffles
// within a half warp. p (or ds) goes to shared memory, and the value rows
// stream through it 16 at a time for the product into the outputs. D is a
// runtime loop: one instance per (type, bias, tier) serves every width. dq
// walks K twice (pass 1: row max and sum; pass 2: the normalised p).
//
// Bound: 4 B H Lq Lk D flops (forward; backward 8 B H Lq Lk D for dq and
// dk/dv together, counted as the function needs them) against the fp32 rate
// of 67 TFLOP/s on the CUDA cores, or the operands' bytes at 3.35 TB/s. At
// the serving shapes (L ~ 1.2k, D >= 64) the flops bound them. B7's ffma body
// does the bound's 4 units in fp32 (one walk) and 6 in bf16 (two walks); B8
// recomputes the scores (twice in dq, once more per extra 128-column chunk)
// and reads two fp32 values from shared memory per two FFMAs, so it reaches
// a fraction of that rate: the times stand beside the bound in PERF.md.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

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
// frame where blocks of 64 stay below it. bf16 operands (D 272-512) in the
// one-pass tier keep the two walks (pass 1 the row max and sum, pass 2 p
// normalised and rounded to bf16), since there the rounding is part of the
// function. At 8 rows a thread (about 250 registers) one block fills an
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

// The chunk c of a block's sequence: pass 1's K chunks (n1 of them, nk a
// tile), then each tile's nk K chunks and its nv V chunks.
__device__ __forceinline__ void chunk_of(int c, int n1, int nk, int nv, int& tile, int& idx) {
  const int per = nk + nv;
  if (c < n1) {
    tile = c / nk;
    idx = c - tile * nk;
  } else {
    tile = (c - n1) / per;
    idx = c - n1 - tile * per;
  }
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
  // bf16's one-pass tier walks K twice (p normalised, then rounded); fp32's
  // walks once and sums each tile's p . v apart before adding it (BLOCKED),
  // which keeps its distance from the normalise-first plain version inside
  // the fp32 bar at 1,155 keys; the long tier's function is the online one
  constexpr bool TWO_WALK = sizeof(T) == 2 && !LONG;
  constexpr bool BLOCKED = !TWO_WALK && !LONG;
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
  const int n1 = TWO_WALK ? tiles * nk : 0;
  const int total = n1 + tiles * (nk + NV);

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
    chunk_of(c, n1, nk, NV, tile, idx);
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
  // - m) in place, l and (unless `stats`) the outputs rescaled
  auto online = [&](float (&s)[4], int i, bool stats) {
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
    if (!stats) {
#pragma unroll
      for (int j = 0; j < 4 * NC; ++j) acc[i][j] *= alpha;
    }
  };

  if constexpr (TWO_WALK) {  // pass 1: the row max and sum
    for (int t = 0; t < tiles; ++t) {
      float s[RI][4];
      scores(s, t);
#pragma unroll
      for (int i = 0; i < RI; ++i) online(s[i], i, true);
    }
  }
  for (int t = 0; t < tiles; ++t) {
    float s[RI][4];
    scores(s, t);
#pragma unroll
    for (int i = 0; i < RI; ++i) {
      if constexpr (TWO_WALK) {  // normalised, then rounded to v's type
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = widen(narrow<T>(expf(s[i][j] - m[i]) / l[i]));
      } else {
        online(s[i], i, false);
      }
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
    const float div = TWO_WALK ? 1.f : LONG ? fmaxf(l[i], 1e-30f) : l[i];
    T* out = const_cast<T*>(rows_of<T>(o, b, h, r)) + c0;
#pragma unroll
    for (int cc = 0; cc < NC; ++cc) {
      const int col = 64 * cc + 4 * tx;
      if (c0 + col >= sh.D) continue;
      float x[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) x[e] = TWO_WALK ? acc[i][4 * cc + e] : acc[i][4 * cc + e] / div;
      store4(out + col, x);
    }
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
// 256; two passes of 256 past 256), bf16 past 256 (the wgmma body takes
// bf16 up to 256: the entry refuses it here).
template <typename T>
cudaError_t fwd(Operand q, Operand k, Operand v, Operand o, Bias bias, bool long_tier,
                const Shape& sh, cudaStream_t stream) {
  if (!pieces_aligned<T>(q, sh.B, sh.H) || !pieces_aligned<T>(k, sh.B, sh.KVH) ||
      !pieces_aligned<T>(v, sh.B, sh.KVH) || !pieces_aligned<T>(o, sh.B, sh.H))
    return cudaErrorInvalidValue;
  if constexpr (sizeof(T) == 2) {
    if (sh.D <= 256) return cudaErrorInvalidValue;
    return ffma_tiers<T, 256>(q, k, v, o, bias, long_tier, sh, stream);
  } else {
    if (sh.D <= 64) return ffma_tiers<T, 64>(q, k, v, o, bias, long_tier, sh, stream);
    if (sh.D <= 128) return ffma_tiers<T, 128>(q, k, v, o, bias, long_tier, sh, stream);
    return ffma_tiers<T, 256>(q, k, v, o, bias, long_tier, sh, stream);
  }
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

// Kernel B7's ffma body. long_tier 0: the one-pass function (q and k
// already rotated, with RoPE: mmada_attention_generic_rope); 1: the long
// function. strides: q, k, v, o, bias.
extern "C" int mmada_attention_generic_fwd(const void* q, const void* k, const void* v,
                                           void* o, const void* bias, int dtype,
                                           int long_tier, int B, int H, int KVH, int Lq,
                                           int Lk, int D, const long long* strides,
                                           float scale, void* stream) {
  const Shape sh{B, H, KVH, Lq, Lk, D, scale};
  if (bad_shape(sh) || (dtype != 0 && dtype != 1)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Operand oq = operand(q, strides), ok = operand(k, strides + 3),
                ov = operand(v, strides + 6), oo = operand(o, strides + 9);
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
