"""Bidirectional (non-causal) multi-head attention for masked diffusion.

Counterpart of `mmada_tpu/ops/attention.py`:

  * `xla_attention` - the plain attention with fp32 softmax (any bias, any
    length); the CPU path for what the one-pass kernel does not cover;
  * `flash_attention` (ops/flash_attention.py) - the one-pass kernel, with
    the RoPE rotation done inside its C entry;
  * `KernelAttention` - the `torch.autograd.Function` around it, the
    counterpart of the `jax.custom_vjp` `_pallas_attention` (:134-250):
    forward through `flash_attention`, backward through
    `flash_attention_bwd` (the dq and dkv kernels) on q/k rotated in fp32
    outside the kernels, the rotation pulled back by autograd of the fp32
    `apply_rope` (the casts of `jax.vjp` of it). No gradient reaches the rope
    tables.

`bidirectional_attention` sends every unbiased call with L <= 4096 through
`KernelAttention`: on the card that launches the Hopper kernels, on the CPU
their plain versions, so a tensor that requires grad keeps its graph on both.
On the card a bias or L > 4096 raises: those kernel tiers (ROADMAP queue B:
B2 biased one-pass, B4 long-L online/staged, B5 staged backward) are not
ported yet, and the port does not quietly substitute plain PyTorch for a
kernel. On the CPU those calls take `xla_attention`, which autograd
differentiates directly.

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

from mmada_tpu_torch.ops.flash_attention import flash_attention, flash_attention_bwd

NEG_INF = float(torch.finfo(torch.float32).min)
ONE_PASS_MAX_LEN = 4096


def _merge_bias(scores: torch.Tensor, bias: Optional[torch.Tensor]) -> torch.Tensor:
    if bias is None:
        return scores
    if bias.dtype == torch.bool:
        bias = torch.where(bias, 0.0, NEG_INF).to(scores.dtype)
    else:
        bias = bias.to(scores.dtype)
    return scores + bias


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
                       bwd=flash_attention_bwd):
    """(dq, dk, dv) of one-pass attention, as `_pallas_attention_bwd`: q/k
    rotated in fp32 outside the kernels, `bwd` (the dq and dkv kernels, or
    `flash_attention_bwd_reference`) on the rotated values, the rotation
    pulled back by autograd of the fp32 `apply_rope`."""
    if rope_sin is None:
        return bwd(q, k, v, out, dout)
    with torch.enable_grad():
        q_in = q.detach().requires_grad_()
        k_in = k.detach().requires_grad_()
        q_rot, k_rot = apply_rope(q_in, k_in, rope_sin, rope_cos)
    dq_rot, dk_rot, dv = bwd(q_rot.detach(), k_rot.detach(), v, out, dout)
    dq, dk = torch.autograd.grad((q_rot, k_rot), (q_in, k_in), (dq_rot, dk_rot))
    return dq, dk, dv


class KernelAttention(torch.autograd.Function):
    """One-pass attention with the kernels' backward (`_pallas_attention`)."""

    @staticmethod
    def forward(ctx, q, k, v, rope_sin, rope_cos):
        out = flash_attention(q, k, v, rope_sin=rope_sin, rope_cos=rope_cos)
        # the output rides along for delta = rowsum(dO * O) (no extra
        # memory: it is alive anyway)
        ctx.save_for_backward(q, k, v, out, rope_sin, rope_cos)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, rope_sin, rope_cos = ctx.saved_tensors
        if q.is_cuda and _bwd_tier_staged(q, k):
            raise NotImplementedError(
                f"no backward kernel for q {tuple(q.shape)} k {tuple(k.shape)}: past "
                "4096 tokens that is the staged backward, not ported yet (ROADMAP B5)")
        if dout.stride(-1) != 1 or any(s % 8 for s in dout.stride()[:3]):
            dout = dout.contiguous()  # e.g. the broadcast cotangent of a sum
        return (*attention_backward(q, k, v, out, dout, rope_sin, rope_cos), None, None)


def bidirectional_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    bias: Optional[torch.Tensor] = None,
    softmax_dtype: torch.dtype = torch.float32,
    rope_sin: Optional[torch.Tensor] = None,  # (L, D): q/k arrive un-roped
    rope_cos: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    one_pass = q.shape[2] <= ONE_PASS_MAX_LEN and k.shape[2] <= ONE_PASS_MAX_LEN
    if bias is None and one_pass:
        return KernelAttention.apply(q, k, v, rope_sin, rope_cos)
    if q.is_cuda:
        raise NotImplementedError(
            "attention with a bias or past 4096 tokens needs the biased / "
            "long-L kernel tiers, not ported yet (ROADMAP queue B: B2, B4)"
        )
    if rope_sin is not None:
        q, k = apply_rope(q, k, rope_sin, rope_cos)
    return xla_attention(q, k, v, bias=bias, softmax_dtype=softmax_dtype)
