"""Precision policy: bf16 matmuls with fp32 islands (torch dtypes).

Counterpart of `mmada_tpu/core/precision.py`: RMSNorm, attention softmax,
RoPE and the vocab head's output run in fp32; weights and activations in the
policy's compute dtype. Two contexts fix how cuBLAS and cuDNN compute, whatever
the caller's flags: `exact_bf16_reductions` (bf16 products with fp32 sums)
and `exact_fp32_products` (fp32 products without TF32, MAGVIT-v2's).
`policy_products` is the one the model's forwards and train steps run
under: a policy that computes in fp32 computes every product in full fp32
on the card too (its attention in the fp32 kernels B7 / B8), so that the
card meets the CPU's answers.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import inspect

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


def policy_products(policy: Policy):
    """The context a model computes under: `exact_fp32_products` for a
    policy whose compute dtype is fp32 (no TF32 in any cuBLAS or cuDNN
    product, whatever the caller's flags), else none."""
    if policy.compute_dtype == torch.float32:
        return exact_fp32_products()
    return contextlib.nullcontext()


def under_policy(fn):
    """`fn`, a function with a `policy` argument, run under
    `policy_products(policy)`."""
    params = inspect.signature(fn).parameters
    index, default = list(params).index("policy"), params["policy"].default

    @functools.wraps(fn)
    def run(*args, **kwargs):
        policy = kwargs.get("policy", args[index] if len(args) > index else default)
        with policy_products(policy):
            return fn(*args, **kwargs)

    return run
