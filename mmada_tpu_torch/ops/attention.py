"""Bidirectional (non-causal) multi-head attention for masked diffusion.

Counterpart of `mmada_tpu/ops/attention.py`:

  * `xla_attention` - the plain attention with fp32 softmax (any bias, any
    length); the CPU path for what the one-pass kernel does not cover;
  * `flash_attention` (ops/flash_attention.py) - the one-pass kernels, B1
    and, with a bias, B2, with the RoPE rotation done inside the C entry;
  * `KernelAttention` - the `torch.autograd.Function` around it, the
    counterpart of the `jax.custom_vjp` `_pallas_attention` (:134-250):
    forward through `flash_attention`, backward through
    `flash_attention_bwd` (the dq and dkv kernels, biased or not) on q/k
    rotated in fp32 outside the kernels, the rotation pulled back by
    autograd of the fp32 `apply_rope` (the casts of `jax.vjp` of it). No
    gradient reaches the bias or the rope tables (JAX returns zeros for
    them, :245).

`bidirectional_attention` sends every call with Lq, Lk <= 4096 through
`KernelAttention`, a bool bias first made fp32 0 / finite min as JAX does
(:280-283): on the card that launches the Hopper kernels, on the CPU their
plain versions, so a tensor that requires grad keeps its graph on both. On
the card L > 4096 raises: those kernel tiers (ROADMAP queue B: B4 long-L
online/staged forward, B5 staged backward) are not ported yet, and the port
does not quietly substitute plain PyTorch for a kernel. On the CPU those
calls take `xla_attention`, which autograd differentiates directly.

Routing of the backward differs from the JAX package's, not its function:
JAX sends L < 256, and head_dim not a multiple of 128, to an XLA recompute
(`_kernel_bwd_eligible`), because its kernels pad to 128-row tiles. The
port's kernels take every shape its forward kernel takes (L <= 4096 at any
alignment, head_dim 64 or 128, GQA, rectangular Lq != Lk without RoPE), so
the port has no such routing: the kernels' wrappers refuse any other shape.

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

NEG_INF = float(torch.finfo(torch.float32).min)
ONE_PASS_MAX_LEN = 4096


def _merge_bias(scores: torch.Tensor, bias: Optional[torch.Tensor]) -> torch.Tensor:
    return scores if bias is None else scores + bias_as_float(bias).to(scores.dtype)


def xla_attention(
    q: torch.Tensor,  # (B, H, L, D)
    k: torch.Tensor,  # (B, KVH, L, D)
    v: torch.Tensor,  # (B, KVH, L, D)
    bias: Optional[torch.Tensor] = None,  # (B|1, 1|H, L, L) bool or float
    softmax_dtype: torch.dtype = torch.float32,
) -> torch.Tensor:
    orig_dtype = q.dtype
    n_heads, n_kv = q.shape[1], k.shape[1]
    if n_heads != n_kv:
        rep = n_heads // n_kv
        k = k.repeat_interleave(rep, dim=1)
        v = v.repeat_interleave(rep, dim=1)
    scale = float(1.0 / torch.tensor(float(q.shape[-1]), dtype=softmax_dtype).sqrt())
    scores = torch.matmul(q.to(softmax_dtype), k.to(softmax_dtype).transpose(-1, -2))
    scores = _merge_bias(scores * scale, bias)
    probs = torch.softmax(scores, dim=-1)
    out = torch.matmul(probs.to(orig_dtype).to(softmax_dtype), v.to(softmax_dtype))
    return out.to(orig_dtype)


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
    """Neox rotate-half RoPE as a standalone pass (the one-pass kernel's C
    entry runs the same rotation on the card)."""
    dtype = q.dtype
    if full_precision:
        q, k = q.float(), k.float()
        sin, cos = sin.float(), cos.float()
    else:
        sin, cos = sin.to(dtype), cos.to(dtype)
    q = q * cos + _rotate_half(q) * sin
    k = k * cos + _rotate_half(k) * sin
    return q.to(dtype), k.to(dtype)


def _bwd_tier_staged(q: torch.Tensor, k: torch.Tensor) -> bool:
    """Past the one-pass range: the staged backward kernels' tier (B5)."""
    return q.shape[2] > ONE_PASS_MAX_LEN or k.shape[2] > ONE_PASS_MAX_LEN


def attention_backward(q, k, v, out, dout, rope_sin=None, rope_cos=None,
                       bias=None, bwd=flash_attention_bwd):
    """(dq, dk, dv) of one-pass attention, as `_pallas_attention_bwd`: q/k
    rotated in fp32 outside the kernels, `bwd` (the dq and dkv kernels, or
    `flash_attention_bwd_reference`) on the rotated values and the bias, the
    rotation pulled back by autograd of the fp32 `apply_rope`."""
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
    """One-pass attention with the kernels' backward (`_pallas_attention`).
    `bias` is None or the fp32 (B|1, H|1, Lq, Lk) bias; it gets no
    gradient."""

    @staticmethod
    def forward(ctx, q, k, v, bias, rope_sin, rope_cos):
        out = flash_attention(q, k, v, rope_sin=rope_sin, rope_cos=rope_cos, bias=bias)
        # the output rides along for delta = rowsum(dO * O), and the bias is
        # the one tensor every layer shares (no extra memory: both are alive
        # anyway)
        ctx.save_for_backward(q, k, v, out, bias, rope_sin, rope_cos)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, bias, rope_sin, rope_cos = ctx.saved_tensors
        if q.is_cuda and _bwd_tier_staged(q, k):
            raise NotImplementedError(
                f"no backward kernel for q {tuple(q.shape)} k {tuple(k.shape)}: past "
                "4096 tokens that is the staged backward, not ported yet (ROADMAP B5)")
        if dout.stride(-1) != 1 or any(s % 8 for s in dout.stride()[:3]):
            dout = dout.contiguous()  # e.g. the broadcast cotangent of a sum
        grads = attention_backward(q, k, v, out, dout, rope_sin, rope_cos, bias)
        return (*grads, None, None, None)


def bidirectional_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    bias: Optional[torch.Tensor] = None,
    softmax_dtype: torch.dtype = torch.float32,
    rope_sin: Optional[torch.Tensor] = None,  # (L, D): q/k arrive un-roped
    rope_cos: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    if q.shape[2] <= ONE_PASS_MAX_LEN and k.shape[2] <= ONE_PASS_MAX_LEN:
        return KernelAttention.apply(q, k, v, bias_as_float(bias), rope_sin, rope_cos)
    if q.is_cuda:
        raise NotImplementedError(
            f"attention past 4096 tokens (q {tuple(q.shape)}, k {tuple(k.shape)}, "
            f"bias {'none' if bias is None else tuple(bias.shape)}) needs the long-L "
            "kernel tiers, not ported yet (ROADMAP queue B: B4 forward, B5 backward)"
        )
    if rope_sin is not None:
        q, k = apply_rope(q, k, rope_sin, rope_cos)
    return xla_attention(q, k, v, bias=bias, softmax_dtype=softmax_dtype)
