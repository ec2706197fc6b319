"""Attention past the one-pass range: Hopper kernels B4 and B5 + plain versions.

Counterpart of the long-sequence tiers of `mmada_tpu/ops/flash_attention.py`:
the forward of `flash_attention_online` (:435; bodies `_attn_online_kernel`
:224 and `_attn_online_bias_kernel` :259, called at :471 and :497) and of
`flash_attention_staged` (:344; `_attn_staged_kernel` :291 and
`_attn_staged_bias_kernel` :333, called at :392 and :418), which compute one
function, and the staged backward `flash_attention_bwd_staged` (:1121; dq
bodies :1018 / :1062 called at :1185, dkv bodies :1070 / :1110 called at
:1240). The kernels are in `csrc/flash_attention_long.cu` (B5's bodies,
shared with the one-pass tier's B3, in `csrc/flash_attention_bwd_wgmma.cuh`).
B4, B5-dq and B5-dkv, unbiased and biased, run on `wgmma` and read their
operands through TMA tensor maps (`tensor_maps.py`; a bias no map describes
is copied first, counted in the wrapper's `.bias_copies`).

The function, on q and k already rotated (RoPE runs outside, in fp32, as the
JAX tier does): s = q.k^T in fp32 times 1/sqrt(D), plus the fp32 bias (B|1,
H|1, Lq, Lk) if there is one; p = exp(s - rowmax(s)) in fp32, NOT normalised
and NOT rounded to the dtype of v; out = (p.v in fp32) / max(rowsum(p),
1e-30), in the dtype of q. That is the online softmax with the division
last, which the TPU kernels walk K for tile by tile. It differs from the
one-pass tier's function (`flash_attention`, B1: p normalised, then cast to
the dtype of v) by the rounding of p: in bf16 the two give different outputs
on a large share of entries. The backward: dq = (p (dp - delta)).k /
max(rowsum(p), 1e-30) * scale with dp = dO.v^T, the row logsumexp lse = m +
log(rowsum(p)), and dk, dv from p = exp(s - lse), all in fp32 before the
final cast.

Each wrapper launches its kernel for a CUDA tensor (bf16, head_dim 64 or
128, Lq and Lk multiples of 128, as the JAX tiers require) and raises for
anything the kernel does not take; it never falls back. For a CPU tensor it
computes the plain version (`*_reference`), which takes any length; the CPU
tests hold it against the JAX kernels and `chip_smoke.py` holds the kernel
against it on the card. Each wrapper counts its launches in `.launches`
(unbiased) and `.bias_launches` (biased).
"""

from __future__ import annotations

from typing import Optional

import torch

from mmada_tpu_torch.ops.flash_attention import (
    NEG_F32,
    _bias_map_operand,
    _check_operand,
    _count_launch,
    _entry,
    _HEAD_DIMS,
    _heads_fastest,
    _heads_like_q,
    _launch,
    _launch_dkv_wgmma,
    _launch_dq_wgmma,
    _scores,
    attention_bwd_dkv_reference,
    attention_delta,
    bias_as_float,
)
from mmada_tpu_torch.ops.tensor_maps import (
    OUT_ROWS,
    STEP_ROWS,
    TILE_ROWS,
    describe,
    describe_bias,
    spec_array,
    tma_operand,
)

_SOURCE = "flash_attention_long"
ALIGN = 128  # Lq and Lk of the kernels: multiples of this, as the JAX tiers


def _check_aligned(q: torch.Tensor, k: torch.Tensor) -> None:
    lq, lk = q.shape[2], k.shape[2]
    if lq % ALIGN or lk % ALIGN:
        raise ValueError(f"the long-L kernels take Lq, Lk multiples of {ALIGN}, "
                         f"got {lq}, {lk}")


def flash_attention_long_reference(
    q: torch.Tensor,                      # (B, H, Lq, D), rotated
    k: torch.Tensor,                      # (B, KVH, Lk, D), rotated
    v: torch.Tensor,                      # (B, KVH, Lk, D)
    bias: Optional[torch.Tensor] = None,  # (B|1, H|1, Lq, Lk) fp32 or bool
) -> torch.Tensor:
    """B4's function in plain PyTorch: fp32 unnormalised p, p.v in fp32,
    divided last. The running max starts at the finite fp32 min, as in the
    kernel, so a row of -inf scores gives 0 instead of 0/0."""
    h = q.shape[1]
    s = _scores(q, _heads_like_q(k, h), bias)
    m = s.amax(dim=-1, keepdim=True).clamp_min(NEG_F32)
    p = s.sub_(m).exp_()
    l = p.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    return (torch.matmul(p, _heads_like_q(v, h)) / l).to(q.dtype)


def _long_fwd_maps(q, k, v, out, bias=None) -> list:
    """The tensor maps of B4's operands (q, k and v in tiles of 128 rows, the
    output stored 64 rows at a time) or B4-bias's (k and v in tiles of 64
    keys beside its bias tiles: the fp32 bias in boxes of 32 columns and
    128 rows)."""
    kv_rows = TILE_ROWS if bias is None else STEP_ROWS
    maps = [describe(q, TILE_ROWS), describe(k, kv_rows), describe(v, kv_rows),
            describe(out, OUT_ROWS)]
    return maps if bias is None else maps + [describe_bias(bias, TILE_ROWS)]


def flash_attention_long(q, k, v, bias=None) -> torch.Tensor:
    """B4 for CUDA tensors (`.launches`, or B4-bias and `.bias_launches`
    with a bias), its plain version for CPU tensors. q and k rotated; square
    or not. Both read their operands through TMA tensor maps (`tensor_maps`:
    an operand a map cannot describe is copied first; a bias so copied
    counts in `.bias_copies`); B4-bias runs a bias broadcast over the heads
    with the heads fastest in its grid (`_heads_fastest`)."""
    if q.device.type == "cpu":
        return flash_attention_long_reference(q, k, v, bias)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention_long runs on cuda or cpu, not {q.device}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        _check_operand(name, t, q.device, aligned=False)
    b, h, lq, d = q.shape
    kvh, lk = k.shape[1], k.shape[2]
    if k.shape != v.shape or k.shape[0] != b or k.shape[3] != d or h % kvh:
        raise ValueError(f"bad shapes q {tuple(q.shape)} k {tuple(k.shape)} v {tuple(v.shape)}")
    if d not in _HEAD_DIMS:
        raise ValueError(f"head_dim {d} not in the kernel's {_HEAD_DIMS}")
    _check_aligned(q, k)
    bias = bias_as_float(bias)
    q, k, v = (tma_operand(t) for t in (q, k, v))
    # written as (B, Lq, H, D) so the caller's merge of the heads is a view
    out = torch.empty((b, lq, h, d), dtype=q.dtype, device=q.device).transpose(1, 2)
    ptrs = [q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr()]
    tail, name = (), "mmada_flash_attention_long_fwd_bf16"
    if bias is not None:
        bias = _bias_map_operand(flash_attention_long, bias, b, h, lq, lk, q.device)
        ptrs.append(bias.data_ptr())
        tail, name = (_heads_fastest(bias),), "mmada_flash_attention_long_fwd_bias_bf16"
    args = spec_array(*_long_fwd_maps(q, k, v, out, bias))
    args.extend(tail)
    _launch(_entry(_SOURCE, name, len(ptrs), arrays=1), q.device, *ptrs, b, h, kvh, lq, lk, d,
            args.buffer_info()[0], 1.0 / (d ** 0.5))
    _count_launch(flash_attention_long, bias)
    return out


flash_attention_long.launches = 0
flash_attention_long.bias_launches = 0
flash_attention_long.bias_copies = 0


def attention_bwd_dq_long_reference(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, dout: torch.Tensor,
    delta: torch.Tensor,                  # (B, H, Lq) fp32
    bias: Optional[torch.Tensor] = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """B5-dq's function in plain PyTorch: dq (dtype of q) = (p (dp -
    delta)).k / l * scale with the unnormalised fp32 p, l = max(rowsum(p),
    1e-30), and lse = m + log l (fp32)."""
    h = q.shape[1]
    kf = _heads_like_q(k, h)
    s = _scores(q, kf, bias)
    m = s.amax(dim=-1, keepdim=True).clamp_min(NEG_F32)
    p = s.sub_(m).exp_()
    l = p.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    dp = torch.matmul(dout.float(), _heads_like_q(v, h).transpose(-1, -2))
    t = p.mul_(dp.sub_(delta[..., None]))
    dq = torch.matmul(t, kf) / l * (1.0 / (q.shape[-1] ** 0.5))
    return dq.to(q.dtype), (m + torch.log(l))[..., 0]


# B5-dkv's function is the one-pass tier's plain dkv: both TPU bodies take
# p = exp(s - lse) and every product in fp32 (the kernels differ only in the
# rounding of p and ds entering the tensor cores).
attention_bwd_dkv_long_reference = attention_bwd_dkv_reference


def attention_bwd_dq_long(q, k, v, dout, delta, bias=None) -> tuple[torch.Tensor, torch.Tensor]:
    """(dq, lse) through B5-dq (CUDA tensors; `.launches`, or B5-dq-bias and
    `.bias_launches`) or its plain version (CPU tensors). Both read their
    operands through TMA tensor maps (`tensor_maps`: an operand a map cannot
    describe is copied first; a bias so copied counts in `.bias_copies`)."""
    if q.device.type == "cpu":
        return attention_bwd_dq_long_reference(q, k, v, dout, delta, bias)
    if q.device.type != "cuda":
        raise ValueError(f"attention_bwd_dq_long runs on cuda or cpu, not {q.device}")
    _check_aligned(q, k)
    bias = bias_as_float(bias)
    out = _launch_dq_wgmma(_SOURCE, "flash_attention_long_bwd", attention_bwd_dq_long, q, k, v,
                           dout, delta, bias)
    _count_launch(attention_bwd_dq_long, bias)
    return out


attention_bwd_dq_long.launches = 0
attention_bwd_dq_long.bias_launches = 0
attention_bwd_dq_long.bias_copies = 0


def attention_bwd_dkv_long(q, k, v, dout, lse, delta, bias=None) -> tuple[torch.Tensor,
                                                                          torch.Tensor]:
    """(dk, dv) through B5-dkv (CUDA tensors; `.launches`, or B5-dkv-bias and
    `.bias_launches`) or its plain version (CPU tensors). Both read their
    operands through TMA tensor maps and bulk copies (a bias copied first
    counts in `.bias_copies`)."""
    if q.device.type == "cpu":
        return attention_bwd_dkv_long_reference(q, k, v, dout, lse, delta, bias)
    if q.device.type != "cuda":
        raise ValueError(f"attention_bwd_dkv_long runs on cuda or cpu, not {q.device}")
    _check_aligned(q, k)
    bias = bias_as_float(bias)
    out = _launch_dkv_wgmma(_SOURCE, "flash_attention_long_bwd", attention_bwd_dkv_long, q, k,
                            v, dout, lse, delta, bias)
    _count_launch(attention_bwd_dkv_long, bias)
    return out


attention_bwd_dkv_long.launches = 0
attention_bwd_dkv_long.bias_launches = 0
attention_bwd_dkv_long.bias_copies = 0


def flash_attention_bwd_long(
    q: torch.Tensor,     # (B, H, Lq, D), rotated
    k: torch.Tensor,     # (B, KVH, Lk, D), rotated
    v: torch.Tensor,
    out: torch.Tensor,   # the forward's output
    dout: torch.Tensor,  # its cotangent
    bias: Optional[torch.Tensor] = None,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dq, dk, dv) of the long tier, as `flash_attention_bwd_staged`: delta
    = rowsum(dO * O) in fp32, then B5-dq (which gives lse), then B5-dkv;
    plain versions for CPU tensors. No gradient goes to the bias."""
    bias = bias_as_float(bias)
    delta = attention_delta(out, dout)
    dq, lse = attention_bwd_dq_long(q, k, v, dout, delta, bias)
    dk, dv = attention_bwd_dkv_long(q, k, v, dout, lse, delta, bias)
    return dq, dk, dv


def flash_attention_bwd_long_reference(q, k, v, out, dout, bias=None):
    """`flash_attention_bwd_long` through the plain versions, on any device."""
    bias = bias_as_float(bias)
    delta = attention_delta(out, dout)
    dq, lse = attention_bwd_dq_long_reference(q, k, v, dout, delta, bias)
    dk, dv = attention_bwd_dkv_long_reference(q, k, v, dout, lse, delta, bias)
    return dq, dk, dv
