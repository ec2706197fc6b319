"""Normalization layers with fp32 compute islands.

Counterpart of `mmada_tpu/ops/norms.py`: RMSNorm computes the variance in
fp32, casts the normalized activations back to the input dtype, then applies
the affine weight; Gemma-RMS applies `x * (1 + w)`. GroupNorm (MAGVIT-v2's)
stays in fp32 through its affine step and casts last.
"""

from __future__ import annotations

from typing import Optional

import torch


def rms_norm(
    x: torch.Tensor,
    weight: Optional[torch.Tensor],
    eps: float = 1e-5,
    gemma_style: bool = False,
    compute_dtype: torch.dtype = torch.float32,
) -> torch.Tensor:
    orig_dtype = x.dtype
    xf = x.to(compute_dtype)
    variance = xf.square().mean(dim=-1, keepdim=True)
    x = (xf * torch.rsqrt(variance + eps)).to(orig_dtype)
    if weight is None:
        return x
    if gemma_style:
        return x * (1.0 + weight).to(orig_dtype)
    return x * weight.to(orig_dtype)


def layer_norm(
    x: torch.Tensor,
    weight: Optional[torch.Tensor],
    bias: Optional[torch.Tensor],
    eps: float = 1e-5,
    compute_dtype: torch.dtype = torch.float32,
) -> torch.Tensor:
    orig_dtype = x.dtype
    xf = x.to(compute_dtype)
    mean = xf.mean(dim=-1, keepdim=True)
    var = xf.var(dim=-1, keepdim=True, unbiased=False)
    x = ((xf - mean) * torch.rsqrt(var + eps)).to(orig_dtype)
    if weight is not None:
        x = x * weight.to(orig_dtype)
    if bias is not None:
        x = x + bias.to(orig_dtype)
    return x


def group_norm(
    x: torch.Tensor,  # NHWC
    weight: torch.Tensor,
    bias: torch.Tensor,
    num_groups: int = 32,
    eps: float = 1e-6,
) -> torch.Tensor:
    """GroupNorm over NHWC tensors (VQGAN `Normalize`: groups of
    `c // num_groups` contiguous channels, population variance, eps 1e-6),
    in fp32; the affine step is fp32 too and the result is cast back to
    `x`'s dtype."""
    orig_dtype = x.dtype
    n, h, w, c = x.shape
    xf = x.float().reshape(n, h, w, num_groups, c // num_groups)
    var, mean = torch.var_mean(xf, dim=(1, 2, 4), keepdim=True, unbiased=False)
    xf = ((xf - mean) * torch.rsqrt(var + eps)).reshape(n, h, w, c)
    return (xf * weight + bias).to(orig_dtype)
