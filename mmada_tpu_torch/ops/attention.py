"""Bidirectional (non-causal) multi-head attention for masked diffusion.

Counterpart of `mmada_tpu/ops/attention.py`. Every call goes through
`KernelAttention`, the `torch.autograd.Function` counterpart of the
`jax.custom_vjp` `_pallas_attention` (:134-250), in one of two kernel tiers,
on both devices: on the card it launches the Hopper kernels, on the CPU
their plain versions, so the CPU computes the card's function and a tensor
that requires grad keeps its graph on both. A bool bias is first made fp32 0
/ finite min, as JAX does (:280-283). The routing, by length:

  * Lq, Lk <= 4096: the one-pass tier, `flash_attention`
    (ops/flash_attention.py; B1, B2 with a bias, the RoPE rotation done in
    the C entry) and `flash_attention_bwd` (B3, B3-bias);
  * Lq = Lk = L > 4096, L a multiple of 128: the long tier,
    `flash_attention_long` (ops/flash_attention_long.py; B4) and
    `flash_attention_bwd_long` (B5-dq, B5-dkv), biased or not: JAX's
    `flash_attention_online` / `flash_attention_staged` forward (:97-131)
    and `flash_attention_bwd_staged`, one function (p kept in fp32 and
    divided last), RoPE applied outside in fp32 (`apply_rope`);
  * Lq = Lk = L > 4096, L not a multiple of 128: the one-pass tier again.
    JAX sends these to `xla_attention` (:276-277), whose function is B1's
    (p normalised in fp32, cast to v's dtype, then p.v); the kernels take
    any length, and B3 computes its gradient;
  * Lq != Lk with either past 4096 (the block-KV decode's step: a block's
    queries over a long frame's cached keys, no RoPE): the one-pass tier.
    The JAX long tiers take one L for q and k (`flash_attention.py:360`,
    `:451`), so JAX sends this shape to `xla_attention` (:313-326), whose
    function is B1's; B4 would compute the long tier's (p kept in fp32 and
    divided last), so it does not take it.

The backward runs the tier's dq and dkv kernels on q/k rotated in fp32
outside the kernels, the rotation pulled back by autograd of the fp32
`apply_rope` (the casts of `jax.vjp` of it). No gradient reaches the bias or
the rope tables (JAX returns zeros for them, :245).

Routing of the backward differs from the JAX package's, not its function:
JAX sends L < 256, and head_dim not a multiple of 128, to an XLA recompute
(`_kernel_bwd_eligible`), because its kernels pad to 128-row tiles. The
port's kernels take every shape its forward kernels take (head_dim 64 or
128, GQA, rectangular Lq != Lk without RoPE in the one-pass tier), so the
port has no such routing: the kernels' wrappers refuse any other shape.

Every tier computes the softmax in fp32, as the JAX kernel tiers do (JAX
takes a `softmax_dtype` for its XLA path only).

Bias semantics: a boolean bias marks *allowed* pairs; a float bias is added
to the scores before the softmax.
"""

from __future__ import annotations

from typing import Optional

import torch

from mmada_tpu_torch.ops.flash_attention import (
    bias_as_float,
    flash_attention,
    flash_attention_bwd,
)
from mmada_tpu_torch.ops.flash_attention_long import (
    ALIGN,
    flash_attention_bwd_long,
    flash_attention_long,
)

NEG_INF = float(torch.finfo(torch.float32).min)
ONE_PASS_MAX_LEN = 4096


def _rotate_half(x: torch.Tensor) -> torch.Tensor:
    x1, x2 = x.chunk(2, dim=-1)
    return torch.cat([-x2, x1], dim=-1)


def apply_rope(
    q: torch.Tensor,    # (B, H, L, D)
    k: torch.Tensor,
    sin: torch.Tensor,  # (L, D)
    cos: torch.Tensor,
    full_precision: bool = True,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Neox rotate-half RoPE as a standalone pass: the long tier's and the
    block-KV cache's rotation (the one-pass kernel's C entry runs the same
    rotation on the card). q and k go through one pass, their heads side by
    side (half the launches of two passes; the cache's steps are
    host-bound), and come back as views of its output."""
    dtype = q.dtype
    x = torch.cat([q, k], dim=1)
    if full_precision:
        x, sin, cos = x.float(), sin.float(), cos.float()
    else:
        sin, cos = sin.to(dtype), cos.to(dtype)
    x = (x * cos + _rotate_half(x) * sin).to(dtype)
    return x.split([q.shape[1], k.shape[1]], dim=1)


def attention_backward(q, k, v, out, dout, rope_sin=None, rope_cos=None,
                       bias=None, bwd=flash_attention_bwd):
    """(dq, dk, dv) of kernel attention, as `_pallas_attention_bwd`: q/k
    rotated in fp32 outside the kernels, `bwd` (a tier's dq and dkv kernels,
    `flash_attention_bwd` or `flash_attention_bwd_long`, or their plain
    versions) on the rotated values and the bias, the rotation pulled back by
    autograd of the fp32 `apply_rope`."""
    if rope_sin is None:
        return bwd(q, k, v, out, dout, bias)
    with torch.enable_grad():
        q_in = q.detach().requires_grad_()
        k_in = k.detach().requires_grad_()
        q_rot, k_rot = apply_rope(q_in, k_in, rope_sin, rope_cos)
    dq_rot, dk_rot, dv = bwd(q_rot.detach(), k_rot.detach(), v, out, dout, bias)
    dq, dk = torch.autograd.grad((q_rot, k_rot), (q_in, k_in), (dq_rot, dk_rot))
    return dq, dk, dv


class KernelAttention(torch.autograd.Function):
    """Kernel attention with the kernels' backward (`_pallas_attention`), in
    the one-pass tier or, with `long=True`, the long tier. `bias` is None or
    the fp32 (B|1, H|1, Lq, Lk) bias; it gets no gradient."""

    @staticmethod
    def forward(ctx, q, k, v, bias, rope_sin, rope_cos, long=False):
        if not long:
            out = flash_attention(q, k, v, rope_sin=rope_sin, rope_cos=rope_cos, bias=bias)
        else:
            qr, kr = (q, k) if rope_sin is None else apply_rope(q, k, rope_sin, rope_cos)
            out = flash_attention_long(qr, kr, v, bias)
        ctx.long = long
        # the output rides along for delta = rowsum(dO * O), and the bias is
        # the one tensor every layer shares (no extra memory: both are alive
        # anyway)
        ctx.save_for_backward(q, k, v, out, bias, rope_sin, rope_cos)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, bias, rope_sin, rope_cos = ctx.saved_tensors
        if dout.stride(-1) != 1 or any(s % 8 for s in dout.stride()[:3]):
            dout = dout.contiguous()  # e.g. the broadcast cotangent of a sum
        bwd = flash_attention_bwd_long if ctx.long else flash_attention_bwd
        grads = attention_backward(q, k, v, out, dout, rope_sin, rope_cos, bias, bwd=bwd)
        return (*grads, None, None, None, None)


def long_tier(lq: int, lk: int) -> bool:
    """Whether (Lq, Lk) takes the long tier (B4, B5): one length past 4096,
    a multiple of 128. Every other shape takes the one-pass tier (B1-B3)."""
    return lq == lk > ONE_PASS_MAX_LEN and lq % ALIGN == 0


def bidirectional_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    bias: Optional[torch.Tensor] = None,
    rope_sin: Optional[torch.Tensor] = None,  # (L, D): q/k arrive un-roped
    rope_cos: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    long = long_tier(q.shape[2], k.shape[2])
    return KernelAttention.apply(q, k, v, bias_as_float(bias), rope_sin, rope_cos, long)
