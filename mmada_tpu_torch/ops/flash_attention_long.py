"""Attention past the one-pass range: Hopper kernels B4 and B5 + plain versions.

Counterpart of the long-sequence tiers of `mmada_tpu/ops/flash_attention.py`:
the forward of `flash_attention_online` (:435; bodies `_attn_online_kernel`
:224 and `_attn_online_bias_kernel` :259, called at :471 and :497) and of
`flash_attention_staged` (:344; `_attn_staged_kernel` :291 and
`_attn_staged_bias_kernel` :333, called at :392 and :418), which compute one
function, and the staged backward `flash_attention_bwd_staged` (:1121; dq
bodies :1018 / :1062 called at :1185, dkv bodies :1070 / :1110 called at
:1240). The kernels are in `csrc/flash_attention_long.cu`, but for the
biased B5-dkv, which is `csrc/flash_attention_dkv.cuh`'s (shared with B3).
B4, B5-dq and B5-dkv run on `wgmma` and read their operands through TMA
tensor maps (`tensor_maps.py`); their biased kernels run on `mma.sync` and
take 16-byte aligned rows.

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
    _bias_strides,
    _check_bwd_shapes,
    _check_operand,
    _count_launch,
    _entry,
    _HEAD_DIMS,
    _heads_like_q,
    _launch,
    _launch_bwd_dkv,
    _launch_bwd_dq,
    _scores,
    _strides,
    attention_bwd_dkv_reference,
    attention_delta,
    bias_as_float,
)
from mmada_tpu_torch.ops.tensor_maps import (
    OUT_ROWS,
    STEP_ROWS,
    TILE_ROWS,
    describe,
    describe_rows,
    rows_operand,
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


def flash_attention_long(q, k, v, bias=None) -> torch.Tensor:
    """B4 for CUDA tensors (`.launches`, or `.bias_launches` with a bias),
    its plain version for CPU tensors. q and k rotated; square or not. B4
    reads its operands through TMA tensor maps (`tensor_maps`: an operand a
    map cannot describe is copied first); B4-bias takes 16-byte aligned
    rows."""
    if q.device.type == "cpu":
        return flash_attention_long_reference(q, k, v, bias)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention_long runs on cuda or cpu, not {q.device}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        _check_operand(name, t, q.device, aligned=bias is not None)
    b, h, lq, d = q.shape
    kvh, lk = k.shape[1], k.shape[2]
    if k.shape != v.shape or k.shape[0] != b or k.shape[3] != d or h % kvh:
        raise ValueError(f"bad shapes q {tuple(q.shape)} k {tuple(k.shape)} v {tuple(v.shape)}")
    if d not in _HEAD_DIMS:
        raise ValueError(f"head_dim {d} not in the kernel's {_HEAD_DIMS}")
    _check_aligned(q, k)
    bias = bias_as_float(bias)
    if bias is None:
        q, k, v = (tma_operand(t) for t in (q, k, v))
    # written as (B, Lq, H, D) so the caller's merge of the heads is a view
    out = torch.empty((b, lq, h, d), dtype=q.dtype, device=q.device).transpose(1, 2)
    ptrs = [q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr()]
    scale = 1.0 / (d ** 0.5)
    if bias is None:
        maps = spec_array(describe(q, TILE_ROWS), describe(k, TILE_ROWS),
                          describe(v, TILE_ROWS), describe(out, OUT_ROWS))
        _launch(_entry(_SOURCE, "mmada_flash_attention_long_fwd_bf16", 4, arrays=1), q.device,
                *ptrs, b, h, kvh, lq, lk, d, maps.buffer_info()[0], scale)
    else:
        _launch(_entry(_SOURCE, "mmada_flash_attention_long_fwd_bias_bf16", 5), q.device,
                *ptrs, bias.data_ptr(), b, h, kvh, lq, lk, d,
                _strides(q, k, v, out, extra=_bias_strides(bias, b, h, lq, lk, q.device)),
                scale)
    _count_launch(flash_attention_long, bias)
    return out


flash_attention_long.launches = 0
flash_attention_long.bias_launches = 0


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


def _launch_dq_wgmma(q, k, v, dout, delta):
    """B5-dq: (dq, lse) with q, k, v and dO read through tensor maps (an
    operand a map cannot describe copied first); dq stored by TMA."""
    b, h, kvh, lq, lk, d = _check_bwd_shapes(q, k, v, dout, [("delta", delta)], aligned=False)
    q, k, v, dout = (tma_operand(t) for t in (q, k, v, dout))
    dq = torch.empty((b, h, lq, d), dtype=q.dtype, device=q.device)
    lse = torch.empty((b, h, lq), dtype=torch.float32, device=q.device)
    maps = spec_array(describe(q, TILE_ROWS), describe(k, STEP_ROWS), describe(v, STEP_ROWS),
                      describe(dout, TILE_ROWS), describe(dq, OUT_ROWS))
    _launch(_entry(_SOURCE, "mmada_flash_attention_long_bwd_dq_bf16", 7, arrays=1), q.device,
            q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(), delta.data_ptr(),
            dq.data_ptr(), lse.data_ptr(), b, h, kvh, lq, lk, d, maps.buffer_info()[0],
            1.0 / (d ** 0.5))
    return dq, lse


def _launch_dkv_wgmma(q, k, v, dout, lse, delta):
    """B5-dkv: (dk, dv) with q, k, v and dO read through tensor maps and lse,
    delta by bulk copies of STEP_ROWS values (each copied first if it cannot
    be read so); dk and dv stored by TMA."""
    b, h, kvh, lq, lk, d = _check_bwd_shapes(q, k, v, dout, [("lse", lse), ("delta", delta)],
                                             aligned=False)
    q, k, v, dout = (tma_operand(t) for t in (q, k, v, dout))
    lse, delta = rows_operand(lse), rows_operand(delta)
    dk = torch.empty((b, kvh, lk, d), dtype=k.dtype, device=q.device)
    dv = torch.empty((b, kvh, lk, d), dtype=k.dtype, device=q.device)
    maps = spec_array(describe(q, STEP_ROWS), describe(k, TILE_ROWS), describe(v, TILE_ROWS),
                      describe(dout, STEP_ROWS), describe(dk, OUT_ROWS), describe(dv, OUT_ROWS),
                      describe_rows(lse, STEP_ROWS), describe_rows(delta, STEP_ROWS))
    _launch(_entry(_SOURCE, "mmada_flash_attention_long_bwd_dkv_bf16", 8, arrays=1), q.device,
            q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(), lse.data_ptr(),
            delta.data_ptr(), dk.data_ptr(), dv.data_ptr(), b, h, kvh, lq, lk, d,
            maps.buffer_info()[0], 1.0 / (d ** 0.5))
    return dk, dv


def attention_bwd_dq_long(q, k, v, dout, delta, bias=None) -> tuple[torch.Tensor, torch.Tensor]:
    """(dq, lse) through B5-dq (CUDA tensors; `.launches`, or B5-dq-bias and
    `.bias_launches`) or its plain version (CPU tensors). B5-dq reads its
    operands through TMA tensor maps (`tensor_maps`: an operand a map cannot
    describe is copied first); B5-dq-bias takes 16-byte aligned rows."""
    if q.device.type == "cpu":
        return attention_bwd_dq_long_reference(q, k, v, dout, delta, bias)
    if q.device.type != "cuda":
        raise ValueError(f"attention_bwd_dq_long runs on cuda or cpu, not {q.device}")
    _check_aligned(q, k)
    bias = bias_as_float(bias)
    if bias is None:
        out = _launch_dq_wgmma(q, k, v, dout, delta)
    else:
        out = _launch_bwd_dq(_SOURCE, "mmada_flash_attention_long_bwd_dq", q, k, v, dout,
                             delta, bias)
    _count_launch(attention_bwd_dq_long, bias)
    return out


attention_bwd_dq_long.launches = 0
attention_bwd_dq_long.bias_launches = 0


def attention_bwd_dkv_long(q, k, v, dout, lse, delta, bias=None) -> tuple[torch.Tensor,
                                                                          torch.Tensor]:
    """(dk, dv) through B5-dkv (CUDA tensors; `.launches`, or B5-dkv-bias and
    `.bias_launches`) or its plain version (CPU tensors). B5-dkv reads its
    operands through TMA tensor maps and bulk copies; B5-dkv-bias takes
    16-byte aligned rows."""
    if q.device.type == "cpu":
        return attention_bwd_dkv_long_reference(q, k, v, dout, lse, delta, bias)
    if q.device.type != "cuda":
        raise ValueError(f"attention_bwd_dkv_long runs on cuda or cpu, not {q.device}")
    _check_aligned(q, k)
    bias = bias_as_float(bias)
    if bias is None:
        out = _launch_dkv_wgmma(q, k, v, dout, lse, delta)
    else:
        out = _launch_bwd_dkv(_SOURCE, "mmada_flash_attention_long_bwd_dkv", q, k, v, dout,
                              lse, delta, bias)
    _count_launch(attention_bwd_dkv_long, bias)
    return out


attention_bwd_dkv_long.launches = 0
attention_bwd_dkv_long.bias_launches = 0


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
