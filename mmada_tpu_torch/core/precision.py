"""Precision policy: bf16 matmuls with fp32 islands (torch dtypes).

Counterpart of `mmada_tpu/core/precision.py`: RMSNorm, attention softmax,
RoPE and the vocab head's output run in fp32; weights and activations in the
policy's compute dtype. Two contexts fix how cuBLAS and cuDNN compute, whatever
the caller's flags: `exact_bf16_reductions` (bf16 products with fp32 sums)
and `exact_fp32_products` (fp32 products without TF32, MAGVIT-v2's).
"""

from __future__ import annotations

import contextlib
import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class Policy:
    param_dtype: torch.dtype = torch.float32      # storage dtype of weights
    compute_dtype: torch.dtype = torch.bfloat16   # matmul/activation dtype
    norm_dtype: torch.dtype = torch.float32       # RMSNorm/LayerNorm island
    softmax_dtype: torch.dtype = torch.float32    # attention + sampling softmax
    rope_dtype: torch.dtype = torch.float32       # rope_full_precision analog
    logits_dtype: torch.dtype = torch.float32     # final head output


# Parity/testing: everything fp32 so outputs can be compared elementwise.
FP32 = Policy(param_dtype=torch.float32, compute_dtype=torch.float32)

# Production: bf16 weights + compute, fp32 islands.
BF16 = Policy(param_dtype=torch.bfloat16, compute_dtype=torch.bfloat16)


def policy_from_name(name: str) -> Policy:
    return {"fp32": FP32, "float32": FP32, "bf16": BF16, "bfloat16": BF16}[name]


@contextlib.contextmanager
def exact_bf16_reductions():
    """cuBLAS bf16 products with fp32 reductions throughout (a reference
    setting, as TF32 off is): the setting in which a kernel's bf16 output is
    compared with its plain version's."""
    prev = torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = prev


@contextlib.contextmanager
def exact_fp32_products():
    """fp32 convolutions and matmuls in full fp32 (TF32 off for cuDNN's convs
    and cuBLAS's matmuls) by algorithms cuDNN picks by its heuristics, not by
    timing (`cudnn.benchmark` off): MAGVIT-v2's codes are the signs of its
    latents, so a TF32 product, or an algorithm that differs from one call to
    the next, flips codes. The caller's settings are restored on exit."""
    cudnn, matmul = torch.backends.cudnn, torch.backends.cuda.matmul
    saved = cudnn.conv.fp32_precision, matmul.fp32_precision, cudnn.benchmark
    cudnn.conv.fp32_precision = matmul.fp32_precision = "ieee"
    cudnn.benchmark = False
    try:
        yield
    finally:
        cudnn.conv.fp32_precision, matmul.fp32_precision, cudnn.benchmark = saved
