"""Bidirectional (non-causal) multi-head attention for masked diffusion.

Counterpart of `mmada_tpu/ops/attention.py`:

  * `xla_attention` - the plain attention with fp32 softmax (any bias, any
    length); the CPU path for what the one-pass kernel does not cover;
  * `flash_attention` (ops/flash_attention.py) - the one-pass kernel, with
    the RoPE rotation done inside its C entry.

`bidirectional_attention` sends every unbiased call with L <= 4096 to
`flash_attention`: on the card that launches the Hopper kernel, on the CPU its
plain version. On the card a bias or L > 4096 raises: those kernel tiers
(ROADMAP queue B: B2 biased one-pass, B4 long-L online/staged) are not ported
yet, and the port does not quietly substitute plain PyTorch for a kernel.

Bias semantics: a boolean bias marks *allowed* pairs; a float bias is added
to the scores before the softmax.
"""

from __future__ import annotations

from typing import Optional

import torch

from mmada_tpu_torch.ops.flash_attention import flash_attention

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
        return flash_attention(q, k, v, rope_sin=rope_sin, rope_cos=rope_cos)
    if q.is_cuda:
        raise NotImplementedError(
            "attention with a bias or past 4096 tokens needs the biased / "
            "long-L kernel tiers, not ported yet (ROADMAP queue B: B2, B4)"
        )
    if rope_sin is not None:
        q, k = apply_rope(q, k, rope_sin, rope_cos)
    return xla_attention(q, k, v, bias=bias, softmax_dtype=softmax_dtype)
