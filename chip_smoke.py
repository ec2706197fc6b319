#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (`mmada_tpu_torch`) on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from `mmada_tpu_torch/ops/csrc` (nvcc, cold),
checks that the wgmma kernels B1, B2, B3 (dq and dkv), B4, B4-bias, B5-dq
and B5-dkv (the last two unbiased and biased) hold `wgmma` (HGMMA) and TMA
load (UTMALDG) instructions in their SASS and that ptxas spilled nothing of
theirs, holds each kernel against its plain PyTorch version (B1 and B2
also by the share of their outputs that differ, B2 with a zero bias against
B1 bit for bit) at the shapes the serving and training paths give it: the
one-pass tier (B1, B2 with a bias, dq and dkv without and with a bias) and
the long tier past
4096 tokens (B4, B5-dq and B5-dkv, without and with a bias, at 8,192 tokens,
at 16,384, under GQA and rectangular), the one-pass tier on an unaligned
length past 4096, and the int4 matmul (B6) at the shapes of the int4
model's matmuls. It runs
and trains a small model through the kernels against the fp32 CPU path
(without and with attention masks; an int4 forward through B6; a W8A8
straight-through train step), builds the full-width 8B (random weights, made
on the card from a seed), answers text and t2i requests through the port's
entry points, answers a text request whose frame is 8,192 tokens, quantizes
the same 8B on the card (`entry.quantize`) to int4 and answers the text and
t2i requests through B6, then to SmoothQuant W8A8 (text and t2i), int8 and
W8A8 (a text batch each), freeing each quantized model before the next,
takes stage-1 train steps of the bf16 8B through `entry.train`, then train
steps on 8,192-token frames, then turns attention masks on
(`attention_bias_enabled=True`, the same weights) and answers t2i requests
and takes stage-1 train steps with `t2i_masks` again, and one masked step
on 8,192-token frames. It checks that the kernels really ran on each path
(launch counters, set to 0 just before the path and read just after: on
each path exactly the kernels of its tier, unbiased or biased, and B6 on
the int4 paths only), and that the masked paths' biases reached the
kernels without a copy (`bias_copies` 0).
Each phase prints lines with the elapsed seconds; any failure ends the run
with a non-zero exit. The last three lines are the kernels' JSON record, the
card's name and power limit as nvidia-smi reports them, and
`{"ok": true, "device": {...}}`.

It writes nothing into the repository except the kernels' build directory
(`mmada_tpu_torch/_kernels_build/`, gitignored).
"""

from __future__ import annotations

import dataclasses
import gc
import json
import math
import re
import subprocess
import sys
import time

T0 = time.perf_counter()

PEAK_BF16_FLOPS = 989e12   # H100 SXM dense bf16 tensor-core peak (data sheet)
PEAK_HBM_BYTES = 3.35e12   # H100 SXM HBM3 bytes/s (data sheet)
KERNEL_ATOL = 3e-2         # bf16 output: a few bf16 ulps at |out| ~ 1
KERNEL_RTOL = 3e-2
# B1 normalises p in fp32 before its bf16 cast, as its plain version does, so
# few bf16 outputs differ (sums in another order, exp2 and a reciprocal
# multiply for exp and the division); an online softmax that divided at the
# end would pass the atol/rtol bar but move about half of them
B1_DIFFER_SHARE = 0.05
SMALL_MODEL_REL_L2 = 5e-2  # bf16 weights/activations vs the fp32 reference
# backward kernels: p and ds enter the tensor cores rounded to bf16 (2^-9
# relative per term) and dq/dk/dv are bf16, so each is held normwise, and
# elementwise against its largest entry (a per-element relative bar means
# nothing where cancellation leaves an entry near 0)
GRAD_REL_L2 = 1e-2
GRAD_MAX_REL = 2e-2
LSE_ATOL = 1e-3            # fp32 row logsumexp, summed in another order
# a bf16 train step against the fp32 CPU step: the forward's bar, doubled for
# gradients, which carry the roundings of the forward and of the backward
SMALL_TRAIN_LOSS_REL = 5e-2
SMALL_TRAIN_GRAD_REL_L2 = 1e-1

TEXT_PROMPTS = [            # equal byte lengths: one batch
    "What is the capital of France?",
    "Why is the sky blue at midday?",
    "Name three colors of a rainbow",
]
T2I_PROMPTS = ["a photo of a red fox in the snow", "an oil painting of a lighthouse"]
TEXT_SETTINGS = dict(gen_length=128, steps=32, block_length=32, temperature=0.0)
T2I_SETTINGS = dict(num_vq_tokens=1024, max_text_len=128, timesteps=12,
                    guidance_scale=3.5, temperature=1.0, seed=0)
# the served frames: BOS + prompt bytes + answer; padded prompt + <|soi|> +
# image + <|eoi|>
TEXT_FRAME = 1 + len(TEXT_PROMPTS[0].encode()) + TEXT_SETTINGS["gen_length"]
T2I_FRAME = T2I_SETTINGS["max_text_len"] + 1 + T2I_SETTINGS["num_vq_tokens"] + 2
# stage 1 (configs/mmada_pretraining_stage1.yaml): 7 t2i + 2 lm + 6 mmu rows,
# 256 image codes, max_seq_length 128; AdamW and the cosine schedule with its
# 5000 warmup steps; here accumulation 1, full remat and the chunked vocab
# head (the card holds weights, gradients and moments). The config's clip of
# 1.0 stands under `training:`, where no Trainer reads it; the smoke run
# trains with it, so it goes in `optimizer.params`, where the optimizer does
TRAIN_STEPS = 3
MASKED_TRAIN_STEPS = 2
TRAIN_SETTINGS = dict(
    max_text_len=128,
    training=dict(batch_size_t2i=7, batch_size_lm=2, batch_size_mmu=6, loss_chunk=128,
                  gradient_accumulation_steps=1),
    optimizer=dict(name="adamw", params=dict(beta1=0.9, beta2=0.999, weight_decay=0.01,
                                             epsilon=1e-8, max_grad_norm=1.0)),
    lr_scheduler=dict(scheduler="cosine", params=dict(learning_rate=1e-4, warmup_steps=5000,
                                                      total_steps=500000)),
    seed=0,
)
TRAIN_IMAGE_TOKENS = 256
# the t2i frame the trainer builds: padded caption (BOS + max_text_len) +
# <|soi|> + image codes + <|eoi|>; the lm and mmu rows are padded to it
TRAIN_FRAME = TRAIN_SETTINGS["max_text_len"] + 1 + TRAIN_IMAGE_TOKENS + 2
TRAIN_ROWS = sum(TRAIN_SETTINGS["training"][f"batch_size_{k}"] for k in ("t2i", "lm", "mmu"))

# past 4096 tokens (the long tier, B4 and B5): one text request whose frame
# is 8,192 tokens (BOS + prompt + answer); train steps on 8,192-token frames,
# one t2i row (caption padded to 7,933 + <|soi|> + 256 codes + <|eoi|>) and
# one lm row, the stage-1 optimizer and schedule, full remat
LONG_FRAME = 8192
LONG_TEXT_SETTINGS = dict(gen_length=64, steps=8, block_length=64, temperature=0.0)
LONG_PROMPT_BYTES = LONG_FRAME - 1 - LONG_TEXT_SETTINGS["gen_length"]
LONG_TRAIN_STEPS = 2
MASKED_LONG_TRAIN_STEPS = 1
LONG_TRAIN_SETTINGS = dict(
    TRAIN_SETTINGS, max_text_len=LONG_FRAME - 1 - TRAIN_IMAGE_TOKENS - 2,
    training=dict(TRAIN_SETTINGS["training"], batch_size_t2i=1, batch_size_lm=1,
                  batch_size_mmu=0))
LONG_TRAIN_ROWS = 2
# the two trained configurations: settings, (rows, frame) of a batch, and the
# words of an lm row (the long one fills its frame with text)
STAGE1 = dict(settings=TRAIN_SETTINGS, rows=TRAIN_ROWS, frame=TRAIN_FRAME, lm_words=60)
LONG = dict(settings=LONG_TRAIN_SETTINGS, rows=LONG_TRAIN_ROWS, frame=LONG_FRAME,
            lm_words=1650)
# the long tier keeps p in fp32 and enters it into the tensor cores as two
# bf16 halves (a relative error of at most 2^-18 per term against the plain
# version's fp32 products). So each bf16 output is within one bf16 ulp of the
# plain version's, plus 2^-14 absolute where cancellation leaves an entry
# small (four times the 2^-18 x max|v| the split can add); gradients within
# 1e-3 normwise and one bf16 ulp of their largest entry elementwise (2^-7 x
# max|ref|); lse as the one-pass tier's
LONG_ABS_FLOOR = 2.0 ** -14
LONG_GRAD_REL_L2 = 1e-3
LONG_GRAD_MAX_REL = 2.0 ** -7
# the long tier's lse: fp32 m + log(l) summed in another order, at the card
# test's bar (tests/test_torch_cuda.py); the one-pass tier keeps LSE_ATOL
LONG_LSE_ATOL = 1e-4
# B6 (int4 matmul): its dequantised bf16 weight is bit for bit the plain
# version's and both sum in fp32, in another order, so each bf16 output is
# within one bf16 ulp of the plain version's plus LONG_ABS_FLOOR (2^-14),
# the bar of `within_one_ulp`; the plain version's cuBLAS product is held to
# full fp32 reductions for the comparison. The int4 8B against the bf16 8B
# whose weights are the int4 weights dequantised (the same function through
# torch.matmul): every matmul output may differ by one bf16 ulp where the
# fp32 sums straddle a rounding, and that spreads through 32 layers of bf16
# activations, so one t2i forward's logits are held normwise
INT4_MODEL_REL_L2 = 2e-2
# the library's grouped-int4 matmul (B6's library time) rounds the scales to
# bf16 (a relative change of at most 2^-9 per weight); it is held to the
# plain version normwise, which a wrong nibble order or sign would miss by
# orders of magnitude
INT4_LIBRARY_REL_L2 = 1e-2


def log(phase: str, msg: str) -> None:
    print(f"[{time.perf_counter() - T0:8.1f}s] {phase}: {msg}", flush=True)


def cuda_ms(fn, iters: int, warmup: int = 2) -> float:
    """Mean device time of `fn` in ms, by CUDA events over `iters` calls."""
    import torch

    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def attention_case(b, h, kvh, lq, lk, rope, seed):
    """Inputs of one kernel case on the card. q is scaled up so the softmax
    is peaked: a wrong score or probability then moves the output by O(1)."""
    import torch

    from mmada_tpu_torch.models.llada import rope_sin_cos

    g = torch.Generator("cuda").manual_seed(seed)

    def randn(*shape):
        return torch.randn(shape, generator=g, device="cuda").to(torch.bfloat16)

    q, k, v = randn(b, h, lq, 128) * 3.0, randn(b, kvh, lk, 128), randn(b, kvh, lk, 128)
    sin = cos = None
    if rope:
        sin, cos = rope_sin_cos(lq, 128, 500000.0, device="cuda")
    return q, k, v, sin, cos


def _mask_bias(masks):
    """The (B, 1, L, L) fp32 bias the model builds from (B, L) keep-masks."""
    import torch

    from mmada_tpu_torch.models.llada import prepare_attention_bias

    return prepare_attention_bias(torch.as_tensor(masks, dtype=torch.long, device="cuda"))


def t2i_mask_bias(cfg_batch: bool):
    """The mask bias of the frames `serve_t2i` builds for T2I_PROMPTS
    (`t2i_masks`)."""
    return _mask_bias(t2i_masks(cfg_batch))


def t2i_masks(cfg_batch: bool):
    """The (B, 1,155) keep-masks of the frames `serve_t2i` builds for
    T2I_PROMPTS: the prompts' frames, then (CFG) the empty-prompt frames, as
    the sampler batches them."""
    import numpy as np

    from mmada_tpu_torch.core.vocab import MMADA_8B
    from mmada_tpu_torch.prompting.universal import ByteTokenizer, SpecialIds, UniversalPrompting

    up = UniversalPrompting(ByteTokenizer(), SpecialIds.from_vocab(MMADA_8B),
                            max_text_len=T2I_SETTINGS["max_text_len"])
    n, mask_id = T2I_SETTINGS["num_vq_tokens"], MMADA_8B.mask_token_id
    _, masks = up.t2i_gen(T2I_PROMPTS, np.full((len(T2I_PROMPTS), n), mask_id))
    if cfg_batch:
        _, uncond = up.t2i_gen_uncond(len(T2I_PROMPTS), n, mask_id)
        masks = np.concatenate([masks, uncond])
    return masks


def train_mask_bias(plan=STAGE1):
    """The mask bias of one batch of `plan` (STAGE1 or LONG): the t2i rows'
    t2i_masks as the trainer's prompting builds them (captions padded), then
    the lm and mmu rows, which attend everywhere."""
    import numpy as np

    from mmada_tpu_torch.core.vocab import MMADA_8B
    from mmada_tpu_torch.prompting.universal import ByteTokenizer, SpecialIds, UniversalPrompting

    up = UniversalPrompting(ByteTokenizer(), SpecialIds.from_vocab(MMADA_8B),
                            max_text_len=plan["settings"]["max_text_len"])
    flow = train_flows(0, plan)["t2i_flow"]
    image_ids = np.asarray(flow["image_codes"]) + MMADA_8B.image_offset
    _, masks, _ = up((flow["input_ids"], image_ids, image_ids), "t2i")
    rest = np.ones((plan["rows"] - masks.shape[0], masks.shape[1]), masks.dtype)
    return _mask_bias(np.concatenate([masks, rest]))


def random_bias(b, h, lq, lk, seed):
    """A per-head random fp32 bias, some entries at the finite min."""
    import torch

    g = torch.Generator("cuda").manual_seed(seed)
    bias = torch.randn((b, h, lq, lk), generator=g, device="cuda") * 2.0
    drop = torch.rand((b, h, lq, lk), generator=g, device="cuda") < 0.1
    return bias.masked_fill(drop, torch.finfo(torch.float32).min)


def live_rows(bias, shape):
    """(B, H, Lq, 1) True where a query row has an allowed key: the model's
    cotangent is 0 on the others (no real row attends to a pad key, and no
    loss reads a pad row), so the backward cases give them 0 too."""
    import torch

    return (bias > torch.finfo(torch.float32).min).any(-1, keepdim=True).expand(
        *shape[:3], 1)


def sdpa_mask(bias, dtype):
    """The bias as the library's attention takes it (its dtype), with the
    finite fp32 min clamped to a finite number of that dtype."""
    return None if bias is None else bias.clamp_min(-1e30).to(dtype)


def bound(flops, nbytes):
    """(bound_ms, bound_by): least time for these flops and bytes."""
    t_ops, t_bytes = flops / PEAK_BF16_FLOPS, nbytes / PEAK_HBM_BYTES
    return max(t_ops, t_bytes) * 1e3, "operations" if t_ops >= t_bytes else "bytes"


def bias_bytes(bias):
    """The fp32 bias, read once at its own (broadcast) shape."""
    return 0 if bias is None else 4 * bias.numel()


def attention_bound(b, h, kvh, lq, lk, rope, bias=None):
    """Forward: 4 B H Lq Lk D flops; q, k, v, o (+ the fp32 rope tables,
    + the fp32 bias)."""
    d = 128
    nbytes = 2 * d * (2 * b * h * lq + 2 * b * kvh * lk) + (2 * 4 * lq * d if rope else 0)
    return bound(4 * b * h * lq * lk * d, nbytes + bias_bytes(bias))


def bwd_bounds(b, h, kvh, lq, lk, bias=None):
    """dq: 6 B H Lq Lk D flops; reads q, k, v, dO, delta (+ bias), writes dq,
    lse. dkv: 8 B H Lq Lk D flops; reads q, k, v, dO, lse, delta (+ bias),
    writes dk, dv."""
    d = 128
    rows_q, rows_k = b * h * lq, b * kvh * lk
    extra = bias_bytes(bias)
    dq = bound(6 * b * h * lq * lk * d, 2 * d * (3 * rows_q + 2 * rows_k) + 8 * rows_q + extra)
    dkv = bound(8 * b * h * lq * lk * d,
                2 * d * (2 * rows_q + 4 * rows_k) + 8 * rows_q + extra)
    return dq, dkv


def kernel_cases(h: int):
    """(tag, B, H, KVH, Lq, Lk, rope, bias) at the shapes the served requests
    give the kernel: the text frame (BOS + prompt bytes + answer) and the t2i
    frame (padded prompt + <|soi|> + image + <|eoi|>, 1155 tokens); and the
    stage-1 training frame. `bias` is None (kernel B1) or a function that
    makes the fp32 bias on the card (kernel B2): the masks of the served t2i
    frames and of a stage-1 batch, and a per-head random bias."""
    text_len, t2i_len = TEXT_FRAME, T2I_FRAME
    return [
        ("text B1", 1, h, h, text_len, text_len, True, None),
        ("text B3 (served batch)", 3, h, h, text_len, text_len, True, None),
        ("t2i B2", 2, h, h, t2i_len, t2i_len, True, None),
        ("t2i B4 (served CFG batch)", 4, h, h, t2i_len, t2i_len, True, None),
        ("rectangular no-rope", 2, h, h, 256, t2i_len, False, None),
        ("gqa 32/8", 2, h, 8, t2i_len, t2i_len, True, None),
        ("train B15 (stage-1 batch)", TRAIN_ROWS, h, h, TRAIN_FRAME, TRAIN_FRAME, True, None),
        ("masked t2i B4 (served CFG batch)", 4, h, h, t2i_len, t2i_len, True,
         lambda: t2i_mask_bias(cfg_batch=True)),
        ("masked train B15 (stage-1 batch)", TRAIN_ROWS, h, h, TRAIN_FRAME, TRAIN_FRAME, True,
         train_mask_bias),
        ("per-head bias L333", 1, h, h, 333, 333, True, lambda: random_bias(1, h, 333, 333, 7)),
        ("masked gqa 32/8", 2, h, 8, t2i_len, t2i_len, True,
         lambda: t2i_mask_bias(cfg_batch=False)),
    ]


def check_kernel(cases):
    """B1 and B2 against their plain version; returns per-case records."""
    import torch
    import torch.nn.functional as F

    from mmada_tpu_torch.ops.attention import apply_rope
    from mmada_tpu_torch.ops.flash_attention import (
        flash_attention,
        flash_attention_reference,
    )

    records = []
    for i, (tag, b, h, kvh, lq, lk, rope, make_bias) in enumerate(cases):
        q, k, v, sin, cos = attention_case(b, h, kvh, lq, lk, rope, seed=100 + i)
        bias = make_bias() if make_bias else None
        kw = dict(rope_sin=sin, rope_cos=cos, bias=bias)
        out = flash_attention(q, k, v, **kw)
        ref = flash_attention_reference(q, k, v, **kw)
        torch.cuda.synchronize()
        err = (out.float() - ref.float()).abs()
        share = differing_share(out, ref)
        ok = bool(torch.isfinite(out).all()) and bool(
            (err <= KERNEL_ATOL + KERNEL_RTOL * ref.float().abs()).all())
        ok = ok and share <= B1_DIFFER_SHARE
        max_err = float(err.max())
        ms = cuda_ms(lambda: flash_attention(q, k, v, **kw), 10)
        plain_ms = cuda_ms(lambda: flash_attention_reference(q, k, v, **kw), 3, 1)
        # yardstick only: one library call on the same (pre-rotated) inputs
        qr, kr = apply_rope(q, k, sin, cos) if rope else (q, k)
        gqa = {"enable_gqa": True} if kvh != h else {}
        mask = sdpa_mask(bias, q.dtype)
        library_ms = cuda_ms(
            lambda: F.scaled_dot_product_attention(qr, kr, v, attn_mask=mask, **gqa), 10)
        bound_ms, bound_by = attention_bound(b, h, kvh, lq, lk, rope, bias)
        rec = dict(tag=tag, shape=[b, h, kvh, lq, lk], rope=rope,
                   bias=None if bias is None else list(bias.shape), max_abs_err=max_err,
                   differing_share=share, ms=ms, plain_ms=plain_ms, library_ms=library_ms,
                   bound_ms=bound_ms, bound_by=bound_by)
        if bias is not None:
            rec["rows_without_an_allowed_key"] = int(
                (~live_rows(bias, (b, bias.shape[1], lq))).sum())
        log("kernel", json.dumps(rec))
        if not ok:
            raise AssertionError(
                f"flash_attention disagrees with its plain version on {tag}: "
                f"max abs err {max_err} (atol {KERNEL_ATOL}, rtol {KERNEL_RTOL}), differing "
                f"share {share} (at most {B1_DIFFER_SHARE})")
        records.append(rec)
    return records


def differing_share(got, want) -> float:
    """The share of output elements that differ from the plain version's."""
    return float((got != want).float().mean())


def check_zero_bias(h: int) -> None:
    """At the served t2i CFG shape: B2 with a zero bias against B1, bit for
    bit (B2 adds the bias in log2 units to B1's exponent, and adding 0.0f
    changes nothing), with a (B, 1, L, L) and a (1, 1, L, L) zero bias (a
    broadcast axis only changes the bias's tensor map)."""
    import torch

    from mmada_tpu_torch.ops.flash_attention import flash_attention

    t2i_len = T2I_FRAME
    q, k, v, sin, cos = attention_case(4, h, h, t2i_len, t2i_len, True, seed=99)
    zero = torch.zeros((4, 1, t2i_len, t2i_len), device="cuda")
    b2 = flash_attention(q, k, v, rope_sin=sin, rope_cos=cos, bias=zero)
    b2_row = flash_attention(q, k, v, rope_sin=sin, rope_cos=cos, bias=zero[:1])
    b1 = flash_attention(q, k, v, rope_sin=sin, rope_cos=cos)
    same, same_row = bool(torch.equal(b2, b1)), bool(torch.equal(b2_row, b1))
    log("kernel", f"zero bias at (4, {h}, {h}, {t2i_len}, {t2i_len}): B2 vs B1 bit for bit "
        f"{same} ((4, 1, L, L) bias), {same_row} ((1, 1, L, L) bias); differing share "
        f"{differing_share(b2, b1)}")
    if not (same and same_row):
        raise AssertionError("B2 with a zero bias differs from B1")


# the wgmma kernels by library, as the start of their mangled names: B1, B2;
# B3's dq and dkv (the backward bodies with ONE_PASS); B4, B4-bias, B5-dq and
# B5-dkv unbiased and biased; each at D 64 and 128
WGMMA_KERNELS = {
    "flash_attention_fwd": [f"{k}ILi{d}E" for d in (64, 128)
                            for k in ("attn_fwd_wgmma_kernel", "attn_fwd_bias_wgmma_kernel")],
    "flash_attention_bwd": [f"{k}ILi{d}ELb0ELb1E" for d in (64, 128)
                            for k in ("attn_bwd_dq_wgmma_kernel", "attn_bwd_dkv_wgmma_kernel")],
    "flash_attention_long": (
        [f"{k}ILi{d}E" for d in (64, 128)
         for k in ("attn_long_fwd_wgmma_kernel", "attn_long_fwd_bias_wgmma_kernel")]
        + [f"{k}ILi{d}ELb{bias}ELb0E" for d in (64, 128) for bias in (0, 1)
           for k in ("attn_bwd_dq_wgmma_kernel", "attn_bwd_dkv_wgmma_kernel")]),
}


def check_sass() -> dict:
    """Per wgmma kernel of the built one-pass, one-pass backward and
    long-tier libraries (WGMMA_KERNELS: B1, B2, B3-dq, B3-dkv, B4, B4-bias,
    B5-dq, B5-dkv, B5-dq-bias, B5-dkv-bias at D 64 and 128), the count of
    HGMMA (wgmma), UTMALDG (TMA load) and UTMASTG (TMA store) instructions in
    its SASS (`cuobjdump -sass`) and, after a cold build, its ptxas lines;
    fails if HGMMA or UTMALDG is missing, if ptxas spilled any register of
    one of them, or if it serialised the wgmma of any kernel (C7510-C7520 in
    a build log)."""
    import os

    from mmada_tpu_torch.ops import _build

    cuobjdump = os.path.join(os.path.dirname(_build.find_nvcc()), "cuobjdump")
    counts = {}  # library -> kernel -> counts
    for name in WGMMA_KERNELS:
        sass = subprocess.run([cuobjdump, "-sass", _build.library_path(name)], check=True,
                              capture_output=True, text=True, timeout=300).stdout
        lib = counts[name] = {}
        func = None
        for line in sass.splitlines():
            if "Function :" in line:
                func = line.split("Function :")[1].strip()
                func = func if "wgmma_kernel" in func else None
                if func:
                    lib[func] = {"HGMMA": 0, "UTMALDG": 0, "UTMASTG": 0}
            elif func:
                for op in lib[func]:
                    lib[func][op] += op in line
        func = None
        for line in _build.build_logs.get(name, "").splitlines():  # ptxas -v of a cold build
            if "Compiling entry function" in line:
                func = line.split("'")[1]
            elif func in lib and ("registers" in line or "spill" in line):
                lib[func]["ptxas"] = lib[func].get("ptxas", "") + line.strip() + "; "
        for func, c in lib.items():
            log("sass", f"{name}: {func}: {c}")
    for name, wanted in WGMMA_KERNELS.items():
        for want in wanted:
            found = [c for f, c in counts[name].items() if want in f]
            if len(found) != 1 or not (found[0]["HGMMA"] and found[0]["UTMALDG"]):
                raise AssertionError(f"{name}: {want}: no HGMMA or no UTMALDG in its SASS "
                                     f"({found})")
            spilled = re.search(r"(\d+) bytes spill stores", found[0].get("ptxas", ""))
            if spilled and int(spilled.group(1)):
                raise AssertionError(f"{want}: ptxas spilled registers ({found[0]['ptxas']})")
    serialised = [line for text in _build.build_logs.values() for line in text.splitlines()
                  if any(f"C75{n}" in line for n in range(10, 21))]
    if serialised:
        raise AssertionError(f"ptxas serialised wgmma: {serialised}")
    return counts


def check_small_model(masked: bool):
    """A small model with the kernel's head_dim, run through the kernel in
    bf16 on the card, against the port's fp32 CPU path on the same weights;
    `masked`: with attention masks on and rows padded (kernel B2)."""
    import torch

    from mmada_tpu_torch.core.precision import BF16, FP32
    from mmada_tpu_torch.core.vocab import tiny_layout
    from mmada_tpu_torch.models import llada

    vocab = tiny_layout()
    cfg = dataclasses.replace(
        llada.tiny_config(vocab_size=vocab.total_vocab_size, d_model=256, n_heads=2,
                          n_layers=2, mlp_hidden_size=512),
        attention_bias_enabled=masked)
    params = llada.init_params(cfg, device="cpu", dtype=torch.bfloat16,
                               generator=torch.Generator().manual_seed(1))
    ids = torch.randint(0, vocab.total_vocab_size, (2, 200),
                        generator=torch.Generator().manual_seed(2))
    mask = torch.ones_like(ids)
    mask[0, :20] = 0
    mask[1, :45] = 0

    ref = llada.forward(move_params(params, dtype=torch.float32), cfg, ids, attention_mask=mask,
                        policy=FP32)
    got = llada.forward(move_params(params, device="cuda"), cfg, ids.cuda(),
                        attention_mask=mask.cuda(), policy=BF16).cpu()
    rel = float((got - ref).norm() / ref.norm())
    log("small model", f"{'masked ' if masked else ''}bf16 kernel path vs fp32 plain path: "
        f"rel L2 {rel:.3e} (limit {SMALL_MODEL_REL_L2}), logits {tuple(got.shape)}")
    if not (torch.isfinite(got).all() and rel <= SMALL_MODEL_REL_L2):
        raise AssertionError(f"small model disagrees with the reference: rel L2 {rel}")


def bwd_cases(h: int):
    """(tag, B, H, KVH, Lq, Lk, rope, through_function, bias): the stage-1
    training frame at its batch (through the autograd Function, RoPE pulled
    back), half that batch, GQA and rectangular shapes at the t2i frame, and
    the short text frame; then with a bias (dq-bias, dkv-bias): the stage-1
    batch's masks (through the Function), the served t2i CFG frames' masks,
    a per-head random bias, and GQA with the served frames' masks."""
    return [
        ("train B15 (stage-1 batch, Function)", TRAIN_ROWS, h, h, TRAIN_FRAME, TRAIN_FRAME,
         True, True, None),
        ("train B7", 7, h, h, TRAIN_FRAME, TRAIN_FRAME, False, False, None),
        ("gqa 32/8", 2, h, 8, 1155, 1155, False, False, None),
        ("rectangular no-rope", 2, h, h, 256, 1155, False, False, None),
        ("tiny L", 1, h, h, 159, 159, False, False, None),
        ("masked train B15 (stage-1 batch, Function)", TRAIN_ROWS, h, h, TRAIN_FRAME,
         TRAIN_FRAME, True, True, train_mask_bias),
        ("masked t2i B4 (CFG batch)", 4, h, h, 1155, 1155, False, False,
         lambda: t2i_mask_bias(cfg_batch=True)),
        ("per-head bias L333", 1, h, h, 333, 333, False, False,
         lambda: random_bias(1, h, 333, 333, 8)),
        ("masked gqa 32/8", 2, h, 8, 1155, 1155, False, False,
         lambda: t2i_mask_bias(cfg_batch=False)),
    ]


def grad_error(got, want):
    """(max abs err, rel L2, passes) of a bf16 gradient against its plain
    version."""
    import torch

    got, want = got.float(), want.float()
    err = (got - want).abs()
    max_err = float(err.max())
    rel = float((got - want).norm() / want.norm())
    ok = (bool(torch.isfinite(got).all()) and rel <= GRAD_REL_L2
          and max_err <= GRAD_MAX_REL * float(want.abs().max()))
    return max_err, rel, ok


def check_backward(cases):
    """The dq and dkv kernels, unbiased and biased, against their plain
    versions; returns per-case records. A Function case goes through
    `KernelAttention` (forward kernel, backward kernels, RoPE pulled back)
    against the same backward on the plain versions. With a bias, rows that
    have no allowed key get a zero cotangent, as in the model; a second run
    with a cotangent there too must stay finite."""
    import torch
    import torch.nn.functional as F

    from mmada_tpu_torch.ops.attention import KernelAttention, apply_rope, attention_backward
    from mmada_tpu_torch.ops.flash_attention import (
        attention_bwd_dkv,
        attention_bwd_dkv_reference,
        attention_bwd_dq,
        attention_bwd_dq_reference,
        attention_delta,
        flash_attention,
        flash_attention_bwd,
        flash_attention_bwd_reference,
    )

    records = []
    for i, (tag, b, h, kvh, lq, lk, rope, function, make_bias) in enumerate(cases):
        q, k, v, sin, cos = attention_case(b, h, kvh, lq, lk, rope, seed=200 + i)
        bias = make_bias() if make_bias else None
        g = torch.Generator("cuda").manual_seed(300 + i)
        dout_all = torch.randn((b, h, lq, 128), generator=g, device="cuda").to(torch.bfloat16)
        dout = dout_all if bias is None else dout_all * live_rows(bias, dout_all.shape)
        errors = {}
        if function:
            ins = [t.detach().requires_grad_() for t in (q, k, v)]
            out = KernelAttention.apply(*ins, bias, sin, cos)
            got = torch.autograd.grad(out, ins, dout)
            want = attention_backward(q, k, v, out.detach(), dout, sin, cos, bias,
                                      bwd=flash_attention_bwd_reference)
            for name, a, w in zip(("dq", "dk", "dv"), got, want):
                errors[f"function {name}"] = grad_error(a, w)
        qr, kr = apply_rope(q, k, sin, cos) if rope else (q, k)
        out = flash_attention(qr, kr, v, bias=bias)
        delta = attention_delta(out, dout)
        dq, lse = attention_bwd_dq(qr, kr, v, dout, delta, bias)
        dk, dv = attention_bwd_dkv(qr, kr, v, dout, lse, delta, bias)
        want_dq, want_lse = attention_bwd_dq_reference(qr, kr, v, dout, delta, bias)
        want_dk, want_dv = attention_bwd_dkv_reference(qr, kr, v, dout, want_lse, delta, bias)
        torch.cuda.synchronize()
        errors["dq"] = grad_error(dq, want_dq)
        errors["dk"] = grad_error(dk, want_dk)
        errors["dv"] = grad_error(dv, want_dv)
        lse_err = float((lse - want_lse).abs().max())
        finite = True
        if bias is not None:  # a cotangent on the rows with no allowed key too
            finite = all(bool(torch.isfinite(t).all())
                         for t in flash_attention_bwd(qr, kr, v, out, dout_all, bias))

        (dq_bound, dq_by), (dkv_bound, dkv_by) = bwd_bounds(b, h, kvh, lq, lk, bias)
        dq_rec = dict(
            ms=cuda_ms(lambda: attention_bwd_dq(qr, kr, v, dout, delta, bias), 10),
            plain_ms=cuda_ms(
                lambda: attention_bwd_dq_reference(qr, kr, v, dout, delta, bias), 3, 1),
            bound_ms=dq_bound, bound_by=dq_by, max_abs_err=errors["dq"][0],
            rel_l2=errors["dq"][1])
        dkv_rec = dict(
            ms=cuda_ms(lambda: attention_bwd_dkv(qr, kr, v, dout, lse, delta, bias), 10),
            plain_ms=cuda_ms(
                lambda: attention_bwd_dkv_reference(qr, kr, v, dout, lse, delta, bias), 3, 1),
            bound_ms=dkv_bound, bound_by=dkv_by,
            max_abs_err=max(errors["dk"][0], errors["dv"][0]),
            rel_l2=max(errors["dk"][1], errors["dv"][1]))
        # yardstick only: the library's attention backward (dq, dk and dv in
        # one call) on the same rotated inputs and bias
        lib_in = [t.detach().requires_grad_() for t in (qr, kr, v)]
        gqa = {"enable_gqa": True} if kvh != h else {}
        lib_out = F.scaled_dot_product_attention(*lib_in, attn_mask=sdpa_mask(bias, q.dtype),
                                                 **gqa)
        library_ms = cuda_ms(
            lambda: torch.autograd.grad(lib_out, lib_in, dout, retain_graph=True), 10)
        rec = dict(tag=tag, shape=[b, h, kvh, lq, lk], rope=rope, function=function,
                   bias=None if bias is None else list(bias.shape),
                   dq=dq_rec, dkv=dkv_rec, library_ms=library_ms, lse_max_abs_err=lse_err,
                   errors={k: [e[0], e[1]] for k, e in errors.items()},
                   finite_with_cotangent_on_dead_rows=finite)
        log("backward", json.dumps(rec))
        bad = [k for k, e in errors.items() if not e[2]]
        if bad or lse_err > LSE_ATOL or not finite:
            raise AssertionError(
                f"backward kernels disagree with their plain versions on {tag}: {bad} "
                f"(rel L2 <= {GRAD_REL_L2}, max abs <= {GRAD_MAX_REL} x max|ref|), "
                f"lse err {lse_err} (atol {LSE_ATOL}), finite {finite}")
        records.append(rec)
    return records


def by_heads(fn, h, kvh, *args, heads=4):
    """`fn(*args)` computed over chunks of `heads` query heads (a multiple of
    the GQA group) and concatenated along the head axis: the plain versions
    materialise (B, H, Lq, Lk) fp32, 8.6 GB per row at 32 heads and 8,192
    tokens. An argument of 3 or more dims is cut on axis 1 where that is
    its head axis (H, or KVH for k and v); a bias broadcast over heads and
    the rope tables go whole."""
    import torch

    group = h // kvh
    c = min(h, max(heads, group))
    outs = []
    for i in range(h // c):
        def part(t):
            if not torch.is_tensor(t) or t.dim() < 3 or t.shape[1] not in (h, kvh):
                return t
            n = c if t.shape[1] == h else c // group
            return t[:, i * n:(i + 1) * n]

        outs.append(fn(*(part(a) for a in args)))
    if torch.is_tensor(outs[0]):
        return torch.cat(outs, 1)
    return tuple(torch.cat(parts, 1) for parts in zip(*outs))


def within_one_ulp(got, want):
    """(max abs err, passes): each bf16 entry within one bf16 ulp of the
    plain version's (at the larger magnitude of the two) plus
    LONG_ABS_FLOOR."""
    import torch

    got, want = got.float(), want.float()
    _, exp = torch.frexp(torch.maximum(got.abs(), want.abs()))
    err = (got - want).abs()
    excess = err - torch.ldexp(torch.ones_like(got), exp - 8)
    return float(err.max()), bool(torch.isfinite(got).all()) and float(
        excess.max()) <= LONG_ABS_FLOOR


def long_grad_error(got, want):
    """(max abs err, rel L2, passes) of a long-tier gradient."""
    import torch

    got, want = got.float(), want.float()
    err = (got - want).abs()
    max_err = float(err.max())
    rel = float((got - want).norm() / want.norm())
    ok = (bool(torch.isfinite(got).all()) and rel <= LONG_GRAD_REL_L2
          and max_err <= LONG_GRAD_MAX_REL * float(want.abs().max()))
    return max_err, rel, ok


def long_cases(h: int):
    """(tag, B, H, KVH, L, bias) of B4 / B4-bias: the served 8,192-token
    text frame, the long training batch (one t2i and one lm row) without and
    with its masks, one row's mask at the served shape, GQA just past the
    one-pass range, and 16,384 tokens at 2 heads (the JAX staged range)
    without and with a per-head bias."""
    f = LONG_FRAME
    return [
        ("long text B1 (served frame)", 1, h, h, f, None),
        ("long train B2 (batch)", LONG_TRAIN_ROWS, h, h, f, None),
        ("gqa 32/8 L4224", 1, h, 8, 4224, None),
        ("L16384, 2 heads", 1, 2, 2, 16384, None),
        ("masked long train B2 (batch)", LONG_TRAIN_ROWS, h, h, f,
         lambda: train_mask_bias(LONG)),
        ("one row's mask, served shape", 1, h, h, f, lambda: train_mask_bias(LONG)[:1]),
        ("per-head bias L16384, 2 heads", 1, 2, 2, 16384,
         lambda: random_bias(1, 2, 16384, 16384, 9)),
    ]


def check_long_kernel(cases):
    """B4 and B4-bias against their plain version (by head chunks) at every
    head; returns per-case records."""
    import torch
    import torch.nn.functional as F

    from mmada_tpu_torch.ops.flash_attention_long import (
        flash_attention_long,
        flash_attention_long_reference,
    )

    records = []
    for i, (tag, b, h, kvh, l, make_bias) in enumerate(cases):
        q, k, v, _, _ = attention_case(b, h, kvh, l, l, False, seed=400 + i)
        bias = make_bias() if make_bias else None
        out = flash_attention_long(q, k, v, bias)
        ref = by_heads(flash_attention_long_reference, h, kvh, q, k, v, bias)
        torch.cuda.synchronize()
        max_err, ok = within_one_ulp(out, ref)
        ms = cuda_ms(lambda: flash_attention_long(q, k, v, bias), 10)
        plain_ms = cuda_ms(
            lambda: by_heads(flash_attention_long_reference, h, kvh, q, k, v, bias), 3, 1)
        gqa = {"enable_gqa": True} if kvh != h else {}
        mask = sdpa_mask(bias, q.dtype)
        library_ms = cuda_ms(
            lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=mask, **gqa), 10)
        bound_ms, bound_by = attention_bound(b, h, kvh, l, l, False, bias)
        rec = dict(tag=tag, shape=[b, h, kvh, l, l],
                   bias=None if bias is None else list(bias.shape), max_abs_err=max_err,
                   ms=ms, plain_ms=plain_ms, library_ms=library_ms,
                   bound_ms=bound_ms, bound_by=bound_by)
        if bias is not None:
            rec["rows_without_an_allowed_key"] = int(
                (~live_rows(bias, (b, bias.shape[1], l))).sum())
        log("long kernel", json.dumps(rec))
        if not ok:
            raise AssertionError(
                f"flash_attention_long disagrees with its plain version on {tag}: max abs "
                f"err {max_err} (one bf16 ulp + {LONG_ABS_FLOOR})")
        records.append(rec)
        del q, k, v, bias, out, ref
        free_memory()
    return records


def long_bwd_cases(h: int):
    """(tag, B, H, KVH, Lq, Lk, rope, through_function, bias) of B5-dq and
    B5-dkv: the long training batch (through the autograd Function, RoPE
    pulled back), the served frame, GQA and rectangular GQA just past the
    one-pass range (4224 x 4352, as the JAX test), 16,384 tokens at 2 heads;
    then with a bias: the long training batch's masks (through the
    Function), one row's mask, and a per-head bias at 16,384 tokens."""
    f = LONG_FRAME
    return [
        ("long train B2 (batch, Function)", LONG_TRAIN_ROWS, h, h, f, f, True, True, None),
        ("long text B1 (served frame)", 1, h, h, f, f, False, False, None),
        ("gqa 32/8 L4224", 1, h, 8, 4224, 4224, False, False, None),
        ("rectangular gqa 32/8 4224 x 4352", 1, h, 8, 4224, 4352, False, False, None),
        ("L16384, 2 heads", 1, 2, 2, 16384, 16384, False, False, None),
        ("masked long train B2 (batch, Function)", LONG_TRAIN_ROWS, h, h, f, f, True, True,
         lambda: train_mask_bias(LONG)),
        ("one row's mask, served shape", 1, h, h, f, f, False, False,
         lambda: train_mask_bias(LONG)[:1]),
        ("per-head bias L16384, 2 heads", 1, 2, 2, 16384, 16384, False, False,
         lambda: random_bias(1, 2, 16384, 16384, 10)),
    ]


def check_long_backward(cases):
    """B5-dq and B5-dkv, unbiased and biased, against their plain versions
    (by head chunks); returns per-case records. A Function case goes through
    `KernelAttention` in the long tier (B4, B5, RoPE pulled back) against
    the same backward on the plain versions. With a bias, rows that have no
    allowed key get a zero cotangent, as in the model; a second run with a
    cotangent there too must stay finite."""
    import torch
    import torch.nn.functional as F

    from mmada_tpu_torch.ops.attention import KernelAttention, apply_rope, attention_backward
    from mmada_tpu_torch.ops.flash_attention import attention_delta
    from mmada_tpu_torch.ops.flash_attention_long import (
        attention_bwd_dkv_long,
        attention_bwd_dkv_long_reference,
        attention_bwd_dq_long,
        attention_bwd_dq_long_reference,
        flash_attention_bwd_long,
        flash_attention_bwd_long_reference,
        flash_attention_long,
    )

    records = []
    for i, (tag, b, h, kvh, lq, lk, rope, function, make_bias) in enumerate(cases):
        q, k, v, sin, cos = attention_case(b, h, kvh, lq, lk, rope, seed=500 + i)
        bias = make_bias() if make_bias else None
        g = torch.Generator("cuda").manual_seed(600 + i)
        dout_all = torch.randn((b, h, lq, 128), generator=g, device="cuda").to(torch.bfloat16)
        dout = dout_all if bias is None else dout_all * live_rows(bias, dout_all.shape)

        def plain_bwd(*args):
            return by_heads(flash_attention_bwd_long_reference, h, kvh, *args)

        errors = {}
        if function:
            ins = [t.detach().requires_grad_() for t in (q, k, v)]
            out = KernelAttention.apply(*ins, bias, sin, cos, True)
            got = torch.autograd.grad(out, ins, dout)
            want = attention_backward(q, k, v, out.detach(), dout, sin, cos, bias, bwd=plain_bwd)
            for name, a, w in zip(("dq", "dk", "dv"), got, want):
                errors[f"function {name}"] = long_grad_error(a, w)
            del ins, out, got, want
        qr, kr = apply_rope(q, k, sin, cos) if rope else (q, k)
        out = flash_attention_long(qr, kr, v, bias)
        delta = attention_delta(out, dout)
        dq, lse = attention_bwd_dq_long(qr, kr, v, dout, delta, bias)
        dk, dv = attention_bwd_dkv_long(qr, kr, v, dout, lse, delta, bias)
        want_dq, want_lse = by_heads(attention_bwd_dq_long_reference, h, kvh, qr, kr, v, dout,
                                     delta, bias)
        want_dk, want_dv = by_heads(attention_bwd_dkv_long_reference, h, kvh, qr, kr, v, dout,
                                    want_lse, delta, bias)
        torch.cuda.synchronize()
        errors["dq"] = long_grad_error(dq, want_dq)
        errors["dk"] = long_grad_error(dk, want_dk)
        errors["dv"] = long_grad_error(dv, want_dv)
        lse_err = float((lse - want_lse).abs().max())
        del want_dq, want_dk, want_dv, want_lse, dq, dk, dv
        finite = True
        if bias is not None:  # a cotangent on the rows with no allowed key too
            finite = all(bool(torch.isfinite(t).all())
                         for t in flash_attention_bwd_long(qr, kr, v, out, dout_all, bias))

        (dq_bound, dq_by), (dkv_bound, dkv_by) = bwd_bounds(b, h, kvh, lq, lk, bias)
        dq_rec = dict(
            ms=cuda_ms(lambda: attention_bwd_dq_long(qr, kr, v, dout, delta, bias), 10),
            plain_ms=cuda_ms(lambda: by_heads(attention_bwd_dq_long_reference, h, kvh, qr, kr,
                                              v, dout, delta, bias), 3, 1),
            bound_ms=dq_bound, bound_by=dq_by, max_abs_err=errors["dq"][0],
            rel_l2=errors["dq"][1])
        dkv_rec = dict(
            ms=cuda_ms(lambda: attention_bwd_dkv_long(qr, kr, v, dout, lse, delta, bias), 10),
            plain_ms=cuda_ms(lambda: by_heads(attention_bwd_dkv_long_reference, h, kvh, qr, kr,
                                              v, dout, lse, delta, bias), 3, 1),
            bound_ms=dkv_bound, bound_by=dkv_by,
            max_abs_err=max(errors["dk"][0], errors["dv"][0]),
            rel_l2=max(errors["dk"][1], errors["dv"][1]))
        # yardstick only: the library's attention backward (dq, dk and dv in
        # one call) on the same rotated inputs and bias
        lib_in = [t.detach().requires_grad_() for t in (qr, kr, v)]
        gqa = {"enable_gqa": True} if kvh != h else {}
        lib_out = F.scaled_dot_product_attention(*lib_in, attn_mask=sdpa_mask(bias, q.dtype),
                                                 **gqa)
        library_ms = cuda_ms(
            lambda: torch.autograd.grad(lib_out, lib_in, dout, retain_graph=True), 10)
        rec = dict(tag=tag, shape=[b, h, kvh, lq, lk], rope=rope, function=function,
                   bias=None if bias is None else list(bias.shape),
                   dq=dq_rec, dkv=dkv_rec, library_ms=library_ms, lse_max_abs_err=lse_err,
                   errors={k: [e[0], e[1]] for k, e in errors.items()},
                   finite_with_cotangent_on_dead_rows=finite)
        log("long backward", json.dumps(rec))
        bad = [k for k, e in errors.items() if not e[2]]
        if bad or lse_err > LONG_LSE_ATOL or not finite:
            raise AssertionError(
                f"long backward kernels disagree with their plain versions on {tag}: {bad} "
                f"(rel L2 <= {LONG_GRAD_REL_L2}, max abs <= {LONG_GRAD_MAX_REL} x max|ref|), "
                f"lse err {lse_err} (atol {LONG_LSE_ATOL}), finite {finite}")
        records.append(rec)
        del q, k, v, qr, kr, bias, out, dout, dout_all, lib_in, lib_out
        free_memory()
    return records


def check_unaligned_long(h: int):
    """The unaligned route past 4096: `bidirectional_attention` at L = 6000
    with RoPE takes the one-pass tier (B1 forward, B3 dq and dkv: JAX's XLA
    function there) and no long-tier kernel; output and gradients against
    the plain versions at B1's and B3's bars. Returns {"fwd": record,
    "bwd": record} for B1's and B3's entries."""
    import torch

    from mmada_tpu_torch.ops.attention import attention_backward, bidirectional_attention
    from mmada_tpu_torch.ops.flash_attention import (
        attention_bwd_dkv,
        attention_bwd_dq,
        flash_attention,
        flash_attention_bwd_reference,
        flash_attention_reference,
    )
    from mmada_tpu_torch.ops.flash_attention_long import (
        attention_bwd_dkv_long,
        attention_bwd_dq_long,
        flash_attention_long,
    )

    l = 6000
    kernels = (flash_attention, attention_bwd_dq, attention_bwd_dkv, flash_attention_long,
               attention_bwd_dq_long, attention_bwd_dkv_long)
    q, k, v, sin, cos = attention_case(1, h, h, l, l, True, seed=700)
    dout = torch.randn((1, h, l, 128), generator=torch.Generator("cuda").manual_seed(701),
                       device="cuda").to(torch.bfloat16)
    before = [f.launches for f in kernels]
    ins = [t.detach().requires_grad_() for t in (q, k, v)]
    out = bidirectional_attention(*ins, rope_sin=sin, rope_cos=cos)
    grads = torch.autograd.grad(out, ins, dout)
    out = out.detach()
    torch.cuda.synchronize()
    launched = tuple(f.launches - c for f, c in zip(kernels, before))
    want = by_heads(flash_attention_reference, h, h, q, k, v, sin, cos)
    err = (out.float() - want.float()).abs()
    share = differing_share(out, want)
    fwd_ok = bool(torch.isfinite(out).all()) and bool(
        (err <= KERNEL_ATOL + KERNEL_RTOL * want.float().abs()).all()) and (
        share <= B1_DIFFER_SHARE)
    want_grads = attention_backward(
        q, k, v, out, dout, sin, cos, None,
        bwd=lambda *a: by_heads(flash_attention_bwd_reference, h, h, *a))
    errors = {name: grad_error(a, w) for name, a, w in zip(("dq", "dk", "dv"), grads,
                                                           want_grads)}
    rec = dict(tag=f"unaligned L{l} (B1, B3)", shape=[1, h, h, l, l],
               launches_b1_dq_dkv_b4_b5dq_b5dkv=launched, fwd_max_abs_err=float(err.max()),
               fwd_differing_share=share,
               errors={k: [e[0], e[1]] for k, e in errors.items()})
    log("unaligned", json.dumps(rec))
    if launched != (1, 1, 1, 0, 0, 0) or not fwd_ok or not all(e[2] for e in errors.values()):
        raise AssertionError(f"the unaligned route past 4096 failed: {rec}")
    del q, k, v, ins, out, grads, want, want_grads
    free_memory()
    return {"fwd": {"max_abs_err": rec["fwd_max_abs_err"]},
            "bwd": {"dq": {"max_abs_err": errors["dq"][0]},
                    "dkv": {"max_abs_err": max(errors["dk"][0], errors["dv"][0])},
                    "library_ms": None}}


def int4_cases(cfg):
    """(tag, M, K, N, view) of B6 at the int4 8B's matmuls: the served text
    batch (3 x 159 rows) at q/k/v/attn_out, ff_proj/up_proj and ff_out, its
    head over one block's positions (3 x 32 rows, the whole vocab), the t2i
    CFG batch (4 x 1,155) at ff_proj/up_proj, the t2i head's column window
    (4 x 1,024 rows, the 8,192 image ids of the packed head, read in place),
    a bytes-bound case (16 rows), ragged rows (1, 17, 130), one group (K
    128), and one layer of a stacked weight (`packed[i]`). `view` is
    "window", "layer" or None."""
    from mmada_tpu_torch.core.vocab import MMADA_8B

    d, f, v = cfg.d_model, cfg.hidden_size, cfg.effective_vocab_size
    text = len(TEXT_PROMPTS) * TEXT_FRAME
    t2i = 2 * len(T2I_PROMPTS) * T2I_FRAME
    lo, hi = MMADA_8B.image_window
    return [
        ("text q/k/v/attn_out", text, d, d, None),
        ("text ff_proj/up_proj", text, d, f, None),
        ("text ff_out", text, f, d, None),
        ("text head", len(TEXT_PROMPTS) * TEXT_SETTINGS["block_length"], d, v, None),
        ("t2i CFG ff_proj/up_proj", t2i, d, f, None),
        ("t2i head window", 2 * len(T2I_PROMPTS) * T2I_SETTINGS["num_vq_tokens"], d, hi - lo,
         "window"),
        ("bytes-bound 16 rows", 16, d, v, None),
        ("ragged M 1", 1, d, d, None),
        ("ragged M 17", 17, d, d, None),
        ("ragged M 130", 130, d, d, None),
        ("one group K 128", 130, 128, d, None),
        ("layer view packed[1]", text, d, d, "layer"),
    ]


def int4_operands(m, k, n, view, seed):
    """x (M, K) bf16 and (packed, scales) of a normal(0, 0.02) weight, made on
    the card: for "window" the image-id columns of a (K, 134,656) head, for
    "layer" layer 1 of a 3-layer stack, both strided views."""
    import torch

    from mmada_tpu_torch.core.vocab import MMADA_8B
    from mmada_tpu_torch.ops.int4_matmul import pack_int4

    g = torch.Generator("cuda").manual_seed(seed)
    x = torch.randn((m, k), generator=g, device="cuda").to(torch.bfloat16)
    shape = {"layer": (3, k, n), "window": (k, MMADA_8B.total_vocab_size)}.get(view, (k, n))
    packed, scales = pack_int4(torch.randn(shape, generator=g, device="cuda") * 0.02)
    if view == "layer":
        packed, scales = packed[1], scales[1]
    elif view == "window":
        lo, hi = MMADA_8B.image_window
        packed, scales = packed[:, lo:hi], scales[:, lo:hi]
    if tuple(packed.shape) != (k // 2, n):
        raise AssertionError(f"int4 case operands {tuple(packed.shape)}, want {(k // 2, n)}")
    return x, packed, scales


def int4_bound(m, k, n):
    """2 M K N flops; x (bf16) + packed (0.5 byte a weight) + fp32 group
    scales + out (bf16), each moved once."""
    return bound(2 * m * k * n, 2 * m * k + k * n // 2 + 4 * (k // 128) * n + 2 * m * n)


def tinygemm_operands(packed, scales):
    """The same int4 weight in the layout of PyTorch's own grouped-int4
    matmul, `torch._weight_int4pack_mm` (tinygemm, the library yardstick of
    B6; the port never calls it): the nibbles biased to [0, 15], packed two
    to a byte along K (even k in the high nibble) of an (N, K/2) uint8 weight
    and converted by `torch._convert_weight_to_int4pack`; one bf16 (scale,
    zero 0) pair per (group, column). It computes (q - 8) * scale + zero, so
    its weight is B6's with the scales rounded to bf16."""
    import torch

    from mmada_tpu_torch.ops.int4_matmul import GROUP, _unpack_i32

    half_k, n = packed.shape
    lo, hi = _unpack_i32(packed.reshape(half_k * 2 // GROUP, GROUP // 2, n))
    codes = (torch.cat([lo, hi], dim=1).reshape(2 * half_k, n) + 8).t().contiguous()
    weight = torch._convert_weight_to_int4pack(
        ((codes[:, ::2] << 4) | codes[:, 1::2]).to(torch.uint8), 8)
    del codes
    bf16_scales = scales.to(torch.bfloat16)
    return weight, torch.stack([bf16_scales, torch.zeros_like(bf16_scales)], dim=-1).contiguous()


def check_int4_kernel(cases):
    """B6 against its plain version at every case; returns per-case records
    with kernel, plain and library ms (`tinygemm_operands`: the library call
    is held to the plain version normwise first, so that its time is that of
    the same function)."""
    import torch

    from mmada_tpu_torch.core.precision import exact_bf16_reductions
    from mmada_tpu_torch.ops.int4_matmul import GROUP, int4_matmul, int4_matmul_reference

    records = []
    with exact_bf16_reductions():
        for i, (tag, m, k, n, view) in enumerate(cases):
            x, packed, scales = int4_operands(m, k, n, view, seed=800 + i)
            out = int4_matmul(x, packed, scales)
            ref = int4_matmul_reference(x, packed, scales)
            weight, scales_and_zeros = tinygemm_operands(packed, scales)
            lib = torch._weight_int4pack_mm(x, weight, GROUP, scales_and_zeros)
            torch.cuda.synchronize()
            max_err, ok = within_one_ulp(out, ref)
            lib_rel = float((lib.float() - ref.float()).norm() / ref.float().norm())
            bound_ms, bound_by = int4_bound(m, k, n)
            rec = dict(tag=tag, shape=[m, k, n], view=view, max_abs_err=max_err,
                       ms=cuda_ms(lambda: int4_matmul(x, packed, scales), 10),
                       plain_ms=cuda_ms(lambda: int4_matmul_reference(x, packed, scales), 3, 1),
                       library_ms=cuda_ms(
                           lambda: torch._weight_int4pack_mm(x, weight, GROUP, scales_and_zeros),
                           10),
                       library_rel_l2=lib_rel, bound_ms=bound_ms, bound_by=bound_by)
            log("int4 kernel", json.dumps(rec))
            if not ok:
                raise AssertionError(
                    f"int4_matmul disagrees with its plain version on {tag}: max abs err "
                    f"{max_err} (one bf16 ulp + {LONG_ABS_FLOOR})")
            if not lib_rel <= INT4_LIBRARY_REL_L2:
                raise AssertionError(
                    f"the library int4 matmul computes another function on {tag}: rel L2 "
                    f"{lib_rel} (limit {INT4_LIBRARY_REL_L2})")
            records.append(rec)
            del x, packed, scales, out, ref, weight, scales_and_zeros, lib
    free_memory()
    return records


def move_params(tree, device=None, dtype=None):
    """`tree` with every tensor moved to `device` and cast to `dtype`;
    quantized leaves are moved field by field and keep their dtypes."""
    import torch

    if isinstance(tree, dict):
        return {k: move_params(t, device, dtype) for k, t in tree.items()}
    if isinstance(tree, torch.Tensor):
        return tree.to(device=device, dtype=dtype)
    return type(tree)(**{f.name: getattr(tree, f.name).to(device=device)
                         for f in dataclasses.fields(tree)})


def check_small_int4_model():
    """A 2-layer model with head_dim 128 and a vocab that is a 128 multiple
    (384): its int4 weights (quantized once, on the CPU) on the card in bf16
    through B6, against the same weights on the CPU in fp32 (the plain
    version); B6 launched once per block matmul and for the head."""
    import torch

    from mmada_tpu_torch.core.precision import BF16, FP32
    from mmada_tpu_torch.core.vocab import tiny_layout
    from mmada_tpu_torch.models import llada
    from mmada_tpu_torch.ops.int4_matmul import int4_matmul
    from mmada_tpu_torch.ops.quantization import quantize_llada_params

    vocab = tiny_layout()
    cfg = llada.tiny_config(vocab_size=384, d_model=256, n_heads=2, n_layers=2,
                            mlp_hidden_size=512)
    params = llada.init_params(cfg, device="cpu", dtype=torch.bfloat16,
                               generator=torch.Generator().manual_seed(5))
    qparams = quantize_llada_params(params, bits=4)
    ids = torch.randint(0, vocab.total_vocab_size, (2, 200),
                        generator=torch.Generator().manual_seed(6))
    ref = llada.forward(move_params(qparams, dtype=torch.float32), cfg, ids, policy=FP32)
    before = int4_matmul.launches
    got = llada.forward(move_params(qparams, device="cuda"), cfg, ids.cuda(), policy=BF16).cpu()
    launched = int4_matmul.launches - before
    rel = float((got - ref).norm() / ref.norm())
    want = 7 * cfg.n_layers + 1
    log("small int4 model", f"bf16 B6 path vs fp32 plain path: rel L2 {rel:.3e} (limit "
        f"{SMALL_MODEL_REL_L2}), logits {tuple(got.shape)}, B6 launches {launched} "
        f"(expected {want})")
    if launched != want:
        raise AssertionError(f"small int4 forward launched B6 {launched} times, want {want}")
    if not (torch.isfinite(got).all() and rel <= SMALL_MODEL_REL_L2):
        raise AssertionError(f"small int4 model disagrees with the reference: rel L2 {rel}")


def small_train_batch(vocab, sc, generator):
    """Clean [t2i | lm | mmu] frames of 200 tokens, made from a seed; the
    t2i rows' captions padded (t2i_masks 0) by 10 and 25 positions."""
    import torch

    n, l = sc.batch_size_t2i, 200

    def ids(rows):
        return torch.randint(3, vocab.text_vocab_size - 30, (rows, l), generator=generator)

    t2i = ids(n)
    t2i[:, sc.max_seq_length + 1:-1] = vocab.image_offset + torch.randint(
        0, vocab.image_codebook_size, (n, l - sc.max_seq_length - 2), generator=generator)
    lm, mmu = ids(sc.batch_size_lm), ids(sc.batch_size_mmu)
    prompt = torch.zeros_like(mmu)
    prompt[:, :60] = 1
    t2i_masks = torch.ones_like(t2i)
    for row in range(n):
        t2i_masks[row, :10 + 15 * row] = 0
    return {"t2i_input_ids": t2i, "t2i_masks": t2i_masks,
            "lm_input_ids": lm, "lm_labels": lm.clone(),
            "mmu_input_ids": mmu, "mmu_prompt_masks": prompt,
            "mmu_labels": torch.where(prompt == 1, torch.full_like(mmu, -100), mmu)}


def check_small_model_training(masked: bool, forward_quantize: str = "none"):
    """A small model with the kernels' head_dim: one bf16 train step on the
    card (kernels, full remat) against the fp32 CPU step on the same weights
    and corrupted batch (loss and every weight's gradient); unmasked, then 30
    steps on that fixed batch, after which the loss is below 0.7 x the
    first; `masked`: attention masks on, the t2i rows' pads reaching the
    biased kernels; `forward_quantize="w8a8"`: the block matmuls' W8A8
    straight-through forward (the int8 product on each device), one step."""
    import torch

    from mmada_tpu_torch.core.precision import BF16, FP32
    from mmada_tpu_torch.core.vocab import tiny_layout
    from mmada_tpu_torch.models import llada
    from mmada_tpu_torch.models.mmada import MMadaModel
    from mmada_tpu_torch.ops.flash_attention import (
        attention_bwd_dkv,
        attention_bwd_dq,
        flash_attention,
    )
    from mmada_tpu_torch.training import optimizers
    from mmada_tpu_torch.training.lr_schedules import get_scheduler
    from mmada_tpu_torch.training.train_step import (
        StepConfig,
        TrainState,
        corrupt_batch,
        make_train_step,
    )

    vocab = tiny_layout()
    cfg = dataclasses.replace(
        llada.tiny_config(vocab_size=vocab.total_vocab_size, d_model=256, n_heads=2,
                          n_layers=2, mlp_hidden_size=512),
        mask_token_id=vocab.mask_token_id, attention_bias_enabled=masked)
    params = llada.init_params(cfg, device="cpu", dtype=torch.bfloat16,
                               generator=torch.Generator().manual_seed(3))

    sc = StepConfig(batch_size_t2i=2, batch_size_lm=2, batch_size_mmu=2, max_seq_length=40,
                    forward_quantize=forward_quantize)
    cpu = MMadaModel(cfg=cfg, params=move_params(params, dtype=torch.float32), vocab=vocab, policy=FP32)
    card = MMadaModel(cfg=cfg, params=move_params(params, device="cuda"), vocab=vocab, policy=BF16,
                      remat="full")
    g = torch.Generator().manual_seed(4)
    prepared = corrupt_batch(cpu, sc, small_train_batch(vocab, sc, g), g)
    prepared_card = {k: t.cuda() for k, t in prepared.items()}

    def loss_and_grads(model, batch):
        step = make_train_step(model, optimizers.AdamW(1e-3), sc)
        tree = llada.split_layers(model.params)
        loss, _ = step.loss(tree, batch)
        names, leaves = zip(*llada.named_leaves(tree))
        return loss, dict(zip(names, torch.autograd.grad(loss, leaves)))

    attr = "bias_launches" if masked else "launches"

    def counts():
        return tuple(getattr(f, attr) for f in (flash_attention, attention_bwd_dq,
                                                attention_bwd_dkv))

    counts0 = counts()
    loss_card, grads_card = loss_and_grads(card, prepared_card)
    torch.cuda.synchronize()
    launched = tuple(c - c0 for c, c0 in zip(counts(), counts0))
    loss_cpu, grads_cpu = loss_and_grads(cpu, prepared)
    loss_card, loss_cpu = float(loss_card), float(loss_cpu)
    loss_rel = abs(loss_card - loss_cpu) / abs(loss_cpu)
    grad_rel = {n: float((grads_card[n].float().cpu() - grads_cpu[n]).norm()
                         / grads_cpu[n].norm().clamp_min(1e-30)) for n in grads_cpu}
    worst = max(grad_rel, key=grad_rel.get)
    kind = ("masked " if masked else "") + ("w8a8 STE " if forward_quantize != "none" else "")
    log("small train", f"{kind}bf16 kernel step vs fp32 CPU step: "
        f"loss {loss_card:.5f} vs "
        f"{loss_cpu:.5f} (rel {loss_rel:.2e}, limit {SMALL_TRAIN_LOSS_REL}); worst "
        f"gradient rel L2 {grad_rel[worst]:.2e} ({worst}, limit {SMALL_TRAIN_GRAD_REL_L2}); "
        f"launches fwd/dq/dkv {launched}")
    want = (2 * cfg.n_layers, cfg.n_layers, cfg.n_layers)  # remat re-runs the forward
    if launched != want:
        raise AssertionError(f"small train step launched {launched}, expected {want}")
    if not (math.isfinite(loss_card) and loss_rel <= SMALL_TRAIN_LOSS_REL
            and grad_rel[worst] <= SMALL_TRAIN_GRAD_REL_L2):
        raise AssertionError("small model train step disagrees with the fp32 CPU step")
    if masked or forward_quantize != "none":
        return

    opt = optimizers.AdamW(get_scheduler("cosine", 5e-3, warmup_steps=2, total_steps=80))
    state = TrainState.create(card.params, opt)
    step = make_train_step(card, opt, sc)
    losses = []
    for _ in range(30):
        state, metrics = step.apply(state, prepared_card)   # fixed noise
        losses.append(metrics["loss"])
    losses = [float(x) for x in losses]
    log("small train", f"30 steps on one batch: loss {losses[0]:.4f} -> {losses[-1]:.4f} "
        f"(limit {0.7 * losses[0]:.4f}), step {int(state.step)}")
    if not (all(map(math.isfinite, losses)) and losses[-1] < 0.7 * losses[0]
            and int(state.step) == 30):
        raise AssertionError(f"small model did not learn its batch: {losses}")


def train_flows(seed: int, plan=STAGE1):
    """One raw batch of `plan` (STAGE1 or LONG): captions + VQ codes (t2i),
    text (lm), images + questions (mmu), made from a seed."""
    import numpy as np

    rng = np.random.default_rng(seed)
    n_codes = TRAIN_IMAGE_TOKENS
    bt, bl, bm = (plan["settings"]["training"][f"batch_size_{k}"] for k in ("t2i", "lm", "mmu"))
    words = ["a", "photo", "of", "red", "fox", "in", "the", "snow", "an", "oil", "painting",
             "lighthouse", "at", "dusk", "with", "waves", "and", "gulls", "over", "rocks"]

    def text(n_words):
        return " ".join(rng.choice(words, n_words))

    return {
        "t2i_flow": {"input_ids": [text(12) for _ in range(bt)],
                     "image_codes": rng.integers(0, 8192, (bt, n_codes))},
        "lm_flow": {"input_ids": [text(plan["lm_words"]) for _ in range(bl)]},
        "mmu_flow": {"input_ids": ["What is in this image? " + text(8) for _ in range(bm)],
                     "image_codes": rng.integers(0, 8192, (bm, n_codes))},
    }


def optimizer_ms(trainer) -> float:
    """Device time of one AdamW pass (clip, moments, decay, gated write-back)
    over the whole trained state, timed alone after the training path."""
    import torch

    from mmada_tpu_torch.models import llada

    params = dict(llada.named_leaves(trainer.state.params))
    grads = {n: torch.zeros_like(p) for n, p in params.items()}
    gate = torch.ones((), dtype=torch.bool, device=trainer.device)
    return cuda_ms(lambda: trainer.optimizer.apply(params, grads, trainer.state.opt_state, gate),
                   2, 1)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this run needs one GPU", file=sys.stderr)
        return 2

    import mmada_tpu_torch
    from mmada_tpu_torch.core.precision import BF16
    from mmada_tpu_torch.core.vocab import MMADA_8B
    from mmada_tpu_torch.entry import quantize, serve_t2i, serve_text, text_frames, train
    from mmada_tpu_torch.models import llada
    from mmada_tpu_torch.models.mmada import MMadaModel
    from mmada_tpu_torch.ops import _build
    from mmada_tpu_torch.ops.flash_attention import (
        attention_bwd_dkv,
        attention_bwd_dq,
        flash_attention,
    )
    from mmada_tpu_torch.ops.flash_attention_long import (
        attention_bwd_dkv_long,
        attention_bwd_dq_long,
        flash_attention_long,
    )
    from mmada_tpu_torch.ops.int4_matmul import int4_matmul

    # (wrapper, counter): B1, dq, dkv; B2, dq-bias, dkv-bias; B4, B5-dq,
    # B5-dkv; B4-bias, B5-dq-bias, B5-dkv-bias; B6
    counters = [(fn, attr) for tier in ((flash_attention, attention_bwd_dq, attention_bwd_dkv),
                                        (flash_attention_long, attention_bwd_dq_long,
                                         attention_bwd_dkv_long))
                for attr in ("launches", "bias_launches") for fn in tier]
    counters.append((int4_matmul, "launches"))
    # the wrappers that copy a bias no tensor map describes (B2, B4-bias,
    # B5-dq-bias, B5-dkv-bias): the model builds its bias so that none is
    # copied
    copiers = (flash_attention, flash_attention_long, attention_bwd_dq_long,
               attention_bwd_dkv_long)

    def reset_counts():
        for fn, attr in counters:
            setattr(fn, attr, 0)
        for fn in copiers:
            fn.bias_copies = 0

    def expect_no_bias_copies(phase):
        copies = {fn.__name__: fn.bias_copies for fn in copiers}
        log(phase, f"bias copies {copies}")
        if any(copies.values()):
            raise AssertionError(f"{phase} copied its bias before a kernel: {copies}")

    def counts():
        """(fwd, dq, dkv) of the one-pass tier unbiased and biased, then of
        the long tier unbiased and biased, then (B6,)."""
        c = tuple(getattr(fn, attr) for fn, attr in counters)
        return c[:3], c[3:6], c[6:9], c[9:12], c[12:]

    # 1. device
    kind = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    log("device", f"{kind} | {smi} | torch {torch.__version__} cuda {torch.version.cuda} "
        f"| port {mmada_tpu_torch.__version__}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # 2. build every kernel, cold
    built = _build.build_all()
    for name, seconds in built.items():
        log("build", f"{name}: {seconds:.1f}s")
        for line in _build.build_logs[name].splitlines():
            if "registers" in line or "spill" in line or "error" in line:
                log("build", f"  {line.strip()}")
    if not built:
        log("build", "libraries already present (not a cold build)")
    check_sass()

    # 3. the kernels against their plain versions at the paths' shapes; a
    # small model through them, served and trained, without and with masks
    cfg = llada.llada_8b()
    t = time.perf_counter()
    records = check_kernel(kernel_cases(cfg.n_heads))
    check_zero_bias(cfg.n_heads)
    check_small_model(masked=False)
    check_small_model(masked=True)
    bwd_records = check_backward(bwd_cases(cfg.n_heads))
    check_small_model_training(masked=False)
    check_small_model_training(masked=True)
    log("checks", f"kernel and small-model checks took {time.perf_counter() - t:.1f}s")
    t = time.perf_counter()
    long_records = check_long_kernel(long_cases(cfg.n_heads))
    long_bwd_records = check_long_backward(long_bwd_cases(cfg.n_heads))
    unaligned = check_unaligned_long(cfg.n_heads)
    log("checks", f"long-tier checks took {time.perf_counter() - t:.1f}s")
    t = time.perf_counter()
    int4_records = check_int4_kernel(int4_cases(cfg))
    check_small_int4_model()
    check_small_model_training(masked=False, forward_quantize="w8a8")
    log("checks", f"int4 and w8a8 checks took {time.perf_counter() - t:.1f}s")

    # 4. the full-width 8B, made on the card
    torch.cuda.reset_peak_memory_stats()
    t = time.perf_counter()
    model = MMadaModel.init(cfg, MMADA_8B, device="cuda", dtype=torch.bfloat16,
                            generator=torch.Generator("cuda").manual_seed(0),
                            policy=BF16)
    torch.cuda.synchronize()
    log("model", f"8B built on the card in {time.perf_counter() - t:.1f}s: "
        f"{llada.param_count(model.params) / 1e9:.3f}e9 params, "
        f"max_memory_allocated {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")

    # 5-6. the serving path: text then t2i requests, with the counters from 0
    reset_counts()
    t = time.perf_counter()
    answers = serve_text(model, TEXT_PROMPTS, **TEXT_SETTINGS)
    torch.cuda.synchronize()
    text_s = time.perf_counter() - t
    text_launches = flash_attention.launches
    n_batches = len({len(f) for f in text_frames(model, TEXT_PROMPTS)})
    check_answers(answers, MMADA_8B)
    log("text", f"{len(answers)} requests in {n_batches} batch(es), "
        f"{TEXT_SETTINGS}: {text_s:.2f}s, "
        f"{len(answers) * TEXT_SETTINGS['gen_length'] / text_s:.1f} tok/s; "
        f"first answer ids {answers[0][:12].tolist()}")

    t = time.perf_counter()
    codes = serve_t2i(model, T2I_PROMPTS, **T2I_SETTINGS)
    torch.cuda.synchronize()
    t2i_s = time.perf_counter() - t
    (launches, serve_dq, serve_dkv), serve_biased, *serve_long = counts()
    check_codes(codes, MMADA_8B)
    log("t2i", f"{len(T2I_PROMPTS)} requests, {T2I_SETTINGS}: {t2i_s:.2f}s, "
        f"{len(T2I_PROMPTS) / t2i_s:.3f} img/s; "
        f"{codes.unique().numel()} distinct codes")

    # 7. the kernel ran on the main path, once per layer per forward
    want_text = cfg.n_layers * TEXT_SETTINGS["steps"] * n_batches
    want_t2i = cfg.n_layers * T2I_SETTINGS["timesteps"]
    want = want_text + want_t2i
    log("launches", f"flash_attention {launches} (text {text_launches}, "
        f"t2i {launches - text_launches}); expected {want}; biased kernels {serve_biased}")
    if text_launches != want_text or launches != want:
        raise AssertionError(f"flash_attention launched {launches} times, expected {want}")
    if serve_dq or serve_dkv:
        raise AssertionError(f"serving launched backward kernels: {serve_dq}, {serve_dkv}")
    if any(serve_biased) or any(map(any, serve_long)):
        raise AssertionError(f"unmasked serving launched biased kernels {serve_biased} or "
                             f"long-tier kernels or B6 {serve_long}")

    # 7b. a text request whose frame is 8,192 tokens: the long tier (B4) only
    long_prompt = ("The quick brown fox jumps over the lazy dog. " * 200)[:LONG_PROMPT_BYTES]
    reset_counts()
    t = time.perf_counter()
    long_answer = serve_text(model, [long_prompt], **LONG_TEXT_SETTINGS)[0]
    torch.cuda.synchronize()
    long_text_s = time.perf_counter() - t
    long_text_launches = counts()
    # the frame: BOS + prompt, then the answer's positions
    frame = len(text_frames(model, [long_prompt])[0]) + LONG_TEXT_SETTINGS["gen_length"]
    log("long text", f"1 request, frame {frame} tokens, {LONG_TEXT_SETTINGS}: "
        f"{long_text_s:.2f}s, {LONG_TEXT_SETTINGS['gen_length'] / long_text_s:.1f} tok/s; "
        f"answer ids {long_answer[:12].tolist()}; launches {long_text_launches}")
    if frame != LONG_FRAME or long_answer.shape != (LONG_TEXT_SETTINGS["gen_length"],):
        raise AssertionError(f"long text frame {frame}, answer {tuple(long_answer.shape)}")
    if (long_answer == MMADA_8B.mask_token_id).any() or not (
            (long_answer >= 0) & (long_answer < MMADA_8B.total_vocab_size)).all():
        raise AssertionError("long text answer holds [MASK] tokens or ids out of the vocab")
    expect_launches("long text", long_text_launches,
                    {"long": (cfg.n_layers * LONG_TEXT_SETTINGS["steps"], 0, 0)})

    # 7c. quantized serving, before any trainer holds its moments: int4
    # (B6 at every block matmul and the head), then SmoothQuant W8A8 (text
    # and t2i), int8 and W8A8 (a text batch each); each quantized model is
    # freed before the next is made
    serving = dict(n_batches=n_batches, want_text=want_text, want_t2i=want_t2i,
                   bf16_text_s=text_s, bf16_t2i_s=t2i_s)
    int4_launches = serve_quantized(model, quantize, "int4", serving, reset_counts, counts,
                                    compare_t2i=True)
    serve_quantized(model, quantize, "w8a8_smooth", serving, reset_counts, counts)
    serve_quantized(model, quantize, "int8", serving, reset_counts, counts, t2i=False)
    serve_quantized(model, quantize, "w8a8", serving, reset_counts, counts, t2i=False)

    # 8. the training path: stage-1 train steps of the same 8B (its weights
    # are trained in place), full remat, counters from 0
    model = dataclasses.replace(model, remat="full")
    n = cfg.n_layers
    trainer, launched = train_phase("train", model, TRAIN_STEPS, train, reset_counts, counts)
    train_launches = launched[0]
    expect_launches("train", launched,
                    {"one-pass": (TRAIN_STEPS * 2 * n, TRAIN_STEPS * n, TRAIN_STEPS * n)})

    # where the step's time goes: the three kernels (ms x launches per step)
    # and the optimizer pass, against the steady step's wall time
    fwd_rec = next(r for r in records if r["tag"].startswith("train B15"))
    step_share("train", trainer, fwd_rec, bwd_records[0], n)
    opt_ms = optimizer_ms(trainer)
    step_ms = min(h["seconds"] for h in trainer.history) * 1e3
    log("train", f"AdamW pass {opt_ms:.1f} ms ({opt_ms / step_ms:.1%} of the steady step)")

    # 8b. train steps on 8,192-token frames (the long tier: B4, B5-dq,
    # B5-dkv). Each trainer's AdamW moments are freed before the next
    # trainer makes its own: a second set would not fit beside them.
    del trainer
    free_memory()
    long_trainer, long_train = train_phase("long train", model, LONG_TRAIN_STEPS, train,
                                           reset_counts, counts, plan=LONG)
    expect_launches("long train", long_train, {"long": (
        LONG_TRAIN_STEPS * 2 * n, LONG_TRAIN_STEPS * n, LONG_TRAIN_STEPS * n)})
    step_share("long train", long_trainer,
               next(r for r in long_records if r["tag"].startswith("long train")),
               long_bwd_records[0], n)
    del long_trainer
    free_memory()

    # 9. masks on: the same weights (no copy) with attention_bias_enabled
    masked = dataclasses.replace(model, cfg=dataclasses.replace(cfg, attention_bias_enabled=True))
    if masked.params is not model.params:
        raise AssertionError("the masked model must share the served weights")
    log("masked", f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated before the "
        "masked phases")
    reset_counts()
    t = time.perf_counter()
    codes = serve_t2i(masked, T2I_PROMPTS, **T2I_SETTINGS)
    torch.cuda.synchronize()
    masked_t2i_s = time.perf_counter() - t
    launched = counts()
    masked_serve = launched[1]
    check_codes(codes, MMADA_8B)
    prompt_lens = [len(p.encode()) for p in T2I_PROMPTS]
    log("masked t2i", f"{len(T2I_PROMPTS)} requests (prompts of {prompt_lens} bytes), "
        f"{T2I_SETTINGS}: {masked_t2i_s:.2f}s ({t2i_s:.2f}s unmasked), "
        f"{codes.unique().numel()} distinct codes; launches {launched}")
    expect_launches("masked t2i", launched, {"one-pass bias": (want_t2i, 0, 0)})
    expect_no_bias_copies("masked t2i")
    masked_trainer, launched = train_phase(
        "masked train", masked, MASKED_TRAIN_STEPS, train, reset_counts, counts)
    masked_train = launched[1]
    batch = masked_trainer.prepare_batch(train_flows(0))
    n_pad = int((batch["t2i_masks"] == 0).sum())
    log("masked train", f"t2i_masks of the first batch: {n_pad} padded positions")
    if n_pad == 0:
        raise AssertionError("the masked training batch has no padded position")
    expect_launches("masked train", launched, {"one-pass bias": (
        MASKED_TRAIN_STEPS * 2 * n, MASKED_TRAIN_STEPS * n, MASKED_TRAIN_STEPS * n)})
    expect_no_bias_copies("masked train")
    masked_fwd = next(r for r in records if r["tag"].startswith("masked train B15"))
    masked_bwd = next(r for r in bwd_records if r["tag"].startswith("masked train B15"))
    step_share("masked train", masked_trainer, masked_fwd, masked_bwd, n)
    del masked_trainer
    free_memory()

    # 9b. one masked train step on 8,192-token frames: the biased long tier
    masked_long_trainer, masked_long = train_phase(
        "masked long train", masked, MASKED_LONG_TRAIN_STEPS, train, reset_counts, counts,
        plan=LONG)
    batch = masked_long_trainer.prepare_batch(train_flows(0, LONG))
    n_pad = int((batch["t2i_masks"] == 0).sum())
    log("masked long train", f"t2i_masks of the batch: {n_pad} padded positions")
    if n_pad == 0:
        raise AssertionError("the masked long training batch has no padded position")
    expect_launches("masked long train", masked_long, {"long bias": (
        MASKED_LONG_TRAIN_STEPS * 2 * n, MASKED_LONG_TRAIN_STEPS * n,
        MASKED_LONG_TRAIN_STEPS * n)})
    expect_no_bias_copies("masked long train")
    step_share("masked long train", masked_long_trainer,
               next(r for r in long_records if r["tag"].startswith("masked long train")),
               next(r for r in long_bwd_records if r["tag"].startswith("masked long train")), n)

    main_rec = next(r for r in records if r["tag"].startswith("t2i B4"))
    masked_rec = next(r for r in records if r["tag"].startswith("masked t2i B4"))
    one_pass = [r for r in records if r["bias"] is None] + [unaligned["fwd"]]
    kernels = [kernel_record("flash_attention_fwd", "flash_attention_fwd.cu", "650",
                             launches + train_launches[0], one_pass, main_rec,
                             design=WGMMA_DESIGN),
               kernel_record("flash_attention_fwd_bias", "flash_attention_fwd.cu", "686",
                             masked_serve[0] + masked_train[0],
                             [r for r in records if r["bias"] is not None], masked_rec,
                             design=WGMMA_DESIGN)]
    plain_bwd = [r for r in bwd_records if r["bias"] is None] + [unaligned["bwd"]]
    biased_bwd = [r for r in bwd_records if r["bias"] is not None]
    long_fwd = [r for r in long_records if r["bias"] is None]
    long_fwd_bias = [r for r in long_records if r["bias"] is not None]
    long_bwd = [r for r in long_bwd_records if r["bias"] is None]
    long_bwd_bias = [r for r in long_bwd_records if r["bias"] is not None]
    int4_main = next(r for r in int4_records if r["tag"].startswith("t2i CFG"))
    kernels.append(kernel_record("int4_matmul", "int4_matmul.cu", "149", int4_launches,
                                 int4_records, int4_main, replaces="int4_matmul.py",
                                 design="mma.sync, W tile expanded in shared memory"))
    kernels += [
        kernel_record("flash_attention_long_fwd", "flash_attention_long.cu", "471,392",
                      long_text_launches[2][0] + long_train[2][0], long_fwd,
                      next(r for r in long_fwd if r["tag"].startswith("long text")),
                      design=WGMMA_DESIGN),
        kernel_record("flash_attention_long_fwd_bias", "flash_attention_long.cu", "497,418",
                      masked_long[3][0], long_fwd_bias,
                      next(r for r in long_fwd_bias if r["tag"].startswith("masked long")),
                      design=WGMMA_DESIGN),
    ]

    def bwd_record(name, source, line, key, count, recs, design):
        return kernel_record(name, source, line, count,
                             [dict(r[key], library_ms=r["library_ms"]) for r in recs],
                             dict(recs[0][key], library_ms=recs[0]["library_ms"]),
                             design=design)

    for name, source, key, line, count, recs, design in (
            ("flash_attention_bwd_dq", "flash_attention_bwd_wgmma.cuh", "dq", "895",
             train_launches[1], plain_bwd, WGMMA_DESIGN),
            ("flash_attention_bwd_dkv", "flash_attention_bwd_wgmma.cuh", "dkv", "963",
             train_launches[2], plain_bwd, WGMMA_DESIGN),
            ("flash_attention_bwd_dq_bias", "flash_attention_bwd.cu", "dq", "746",
             masked_train[1], biased_bwd, MMA_DESIGN),
            ("flash_attention_bwd_dkv_bias", "flash_attention_dkv.cuh", "dkv", "799",
             masked_train[2], biased_bwd, MMA_DESIGN),
            ("flash_attention_long_bwd_dq", "flash_attention_bwd_wgmma.cuh", "dq", "1185",
             long_train[2][1], long_bwd, WGMMA_DESIGN),
            ("flash_attention_long_bwd_dq_bias", "flash_attention_bwd_wgmma.cuh", "dq", "1185",
             masked_long[3][1], long_bwd_bias, WGMMA_DESIGN),
            ("flash_attention_long_bwd_dkv", "flash_attention_bwd_wgmma.cuh", "dkv", "1240",
             long_train[2][2], long_bwd, WGMMA_DESIGN),
            ("flash_attention_long_bwd_dkv_bias", "flash_attention_bwd_wgmma.cuh", "dkv",
             "1240", masked_long[3][2], long_bwd_bias, WGMMA_DESIGN)):
        kernels.append(bwd_record(name, source, line, key, count, recs, design))
    log("done", f"total {time.perf_counter() - T0:.1f}s")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}), flush=True)
    return 0


def free_memory() -> None:
    """Return what dropped objects held (a trainer's moments) to the card."""
    import torch

    gc.collect()
    torch.cuda.empty_cache()


def check_answers(answers, vocab) -> None:
    for ans in answers:
        if ans.shape != (TEXT_SETTINGS["gen_length"],):
            raise AssertionError(f"text answer shape {tuple(ans.shape)}")
        if (ans == vocab.mask_token_id).any():
            raise AssertionError("text answer still holds [MASK] tokens")
        if not ((ans >= 0) & (ans < vocab.total_vocab_size)).all():
            raise AssertionError("text answer ids out of the fused vocab")


def t2i_frames():
    """The (4, 1,155) token batch of the t2i sampler's first forward for
    T2I_PROMPTS: the prompts' frames, all image positions masked, then the
    empty-prompt (CFG) frames."""
    import numpy as np
    import torch

    from mmada_tpu_torch.core.vocab import MMADA_8B
    from mmada_tpu_torch.prompting.universal import ByteTokenizer, SpecialIds, UniversalPrompting

    up = UniversalPrompting(ByteTokenizer(), SpecialIds.from_vocab(MMADA_8B),
                            max_text_len=T2I_SETTINGS["max_text_len"])
    n, mask_id = T2I_SETTINGS["num_vq_tokens"], MMADA_8B.mask_token_id
    ids, _ = up.t2i_gen(T2I_PROMPTS, np.full((len(T2I_PROMPTS), n), mask_id))
    uncond, _ = up.t2i_gen_uncond(len(T2I_PROMPTS), n, mask_id)
    return torch.as_tensor(np.concatenate([ids, uncond]), dtype=torch.long, device="cuda")


def dequantized(params):
    """`params` with every int4 weight replaced by its bf16 dequantisation
    (one layer at a time), the other leaves shared."""
    import torch

    from mmada_tpu_torch.ops.quantization import Int4Tensor

    def deq(w):
        if not isinstance(w, Int4Tensor):
            return w
        if len(w.shape) == 2:
            return w.dequantize(torch.bfloat16)
        return torch.stack([w[i].dequantize(torch.bfloat16) for i in range(w.shape[0])])

    out = {k: deq(v) for k, v in params.items() if k != "blocks"}
    out["blocks"] = {k: deq(v) for k, v in params["blocks"].items()}
    return out


def compare_int4_t2i_forward(qmodel) -> None:
    """One t2i forward (the sampler's first, windowed head) of the int4 8B
    through B6 against the bf16 8B whose weights are the int4 weights
    dequantised, through torch.matmul: the same function."""
    import torch

    from mmada_tpu_torch.core.precision import exact_bf16_reductions
    from mmada_tpu_torch.core.vocab import MMADA_8B

    ids = t2i_frames()
    n = T2I_SETTINGS["num_vq_tokens"]
    kw = dict(logit_window=MMADA_8B.image_window, logit_positions=(ids.shape[1] - n - 1, n))
    with exact_bf16_reductions():
        got = qmodel.forward(ids, **kw)
        deq = dataclasses.replace(qmodel, params=dequantized(qmodel.params))
        want = deq.forward(ids, **kw)
        torch.cuda.synchronize()
    rel = float((got - want).norm() / want.norm())
    agree = float((got.argmax(-1) == want.argmax(-1)).float().mean())
    log("int4", f"one t2i forward {tuple(got.shape)} vs the dequantised bf16 8B: rel L2 "
        f"{rel:.3e} (limit {INT4_MODEL_REL_L2}), max abs {float((got - want).abs().max()):.3e}, "
        f"argmax agreement {agree:.4f}")
    del deq, want
    free_memory()
    if not (torch.isfinite(got).all() and rel <= INT4_MODEL_REL_L2):
        raise AssertionError(f"the int4 8B disagrees with its dequantised bf16 twin: rel {rel}")


def serve_quantized(model, quantize, scheme, serving, reset_counts, counts, t2i=True,
                    compare_t2i=False):
    """Quantize the 8B on the card (`entry.quantize`, timed, its bytes logged),
    answer TEXT_PROMPTS (and T2I_PROMPTS) with the counters from 0 and check
    the answers and the launches: the attention kernels as on the bf16
    phases, and B6 exactly 7 n_layers + 1 times a forward for int4, never
    for the others. Frees the quantized model; returns B6's launches."""
    import torch

    from mmada_tpu_torch.core.vocab import MMADA_8B
    from mmada_tpu_torch.entry import serve_t2i, serve_text
    from mmada_tpu_torch.ops.quantization import nbytes

    n = model.cfg.n_layers
    free_memory()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    t = time.perf_counter()
    qmodel = quantize(model, scheme)
    torch.cuda.synchronize()
    log(scheme, f"quantized on the card in {time.perf_counter() - t:.2f}s: params "
        f"{nbytes(qmodel.params) / 1e9:.3f} GB ({nbytes(model.params) / 1e9:.3f} GB in bf16, "
        f"{(torch.cuda.memory_allocated() - before) / 1e9:.3f} GB newly allocated); peak "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB allocated")
    reset_counts()
    t = time.perf_counter()
    answers = serve_text(qmodel, TEXT_PROMPTS, **TEXT_SETTINGS)
    torch.cuda.synchronize()
    text_s = time.perf_counter() - t
    text_launched = counts()
    check_answers(answers, MMADA_8B)
    log(scheme, f"text: {len(answers)} requests, {TEXT_SETTINGS}: {text_s:.2f}s "
        f"({serving['bf16_text_s']:.2f}s in bf16); first answer ids "
        f"{answers[0][:12].tolist()}; launches {text_launched}")
    per_forward = 7 * n + 1 if scheme == "int4" else 0
    text_forwards = TEXT_SETTINGS["steps"] * serving["n_batches"]
    expect_launches(f"{scheme} text", text_launched, {
        "one-pass": (serving["want_text"], 0, 0), "int4": (per_forward * text_forwards,)})
    b6 = text_launched[4][0]
    if t2i:
        reset_counts()
        t = time.perf_counter()
        codes = serve_t2i(qmodel, T2I_PROMPTS, **T2I_SETTINGS)
        torch.cuda.synchronize()
        t2i_s = time.perf_counter() - t
        launched = counts()
        check_codes(codes, MMADA_8B)
        log(scheme, f"t2i: {len(T2I_PROMPTS)} requests, {T2I_SETTINGS}: {t2i_s:.2f}s "
            f"({serving['bf16_t2i_s']:.2f}s in bf16); {codes.unique().numel()} distinct codes; "
            f"launches {launched}")
        # every step is CFG-batched: one forward a step
        expect_launches(f"{scheme} t2i", launched, {
            "one-pass": (serving["want_t2i"], 0, 0),
            "int4": (per_forward * T2I_SETTINGS["timesteps"],)})
        b6 += launched[4][0]
    if compare_t2i:
        compare_int4_t2i_forward(qmodel)
    del qmodel
    free_memory()
    return b6


def check_codes(codes, vocab) -> None:
    if codes.shape != (len(T2I_PROMPTS), T2I_SETTINGS["num_vq_tokens"]):
        raise AssertionError(f"t2i codes shape {tuple(codes.shape)}")
    if not ((codes >= 0) & (codes < vocab.image_codebook_size)).all():
        raise AssertionError("t2i codes outside [0, 8192)")


def train_phase(phase, model, steps, train, reset_counts, counts, plan=STAGE1):
    """`steps` train steps of `model` through `entry.train` on batches of
    `plan` (STAGE1 or LONG), with the counters from 0; checks the metrics and
    the trained frame, and returns (trainer, counts())."""
    import torch

    flows = [train_flows(seed, plan) for seed in range(steps)]
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t = time.perf_counter()
    trainer = train(model, flows, steps=steps, log_every=1, **plan["settings"])
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t
    launched = counts()
    peak = torch.cuda.max_memory_allocated() / 2**30
    peak_reserved = torch.cuda.max_memory_reserved() / 2**30
    # the frame the kernel cases of phase 3 were held at is the one trained
    frames = [t for k, t in trainer.prepare_batch(flows[0]).items() if k.endswith("input_ids")]
    trained_shape = (sum(t.shape[0] for t in frames), {t.shape[1] for t in frames})
    for h in trainer.history:
        log(phase, f"step {h['step']}: loss {h['loss']:.4f} (t2i {h['loss_t2i']:.4f} "
            f"lm {h['loss_lm']:.4f} mmu {h['loss_mmu']:.4f}) grad_norm {h['grad_norm']:.4f} "
            f"skipped {h['skipped_nonfinite']:.0f}; {h['seconds']:.3f}s, "
            f"{h['tokens_per_s']:.1f} tokens/s, max_memory_allocated "
            f"{h['max_memory_allocated_gib']:.2f} GiB")
    log(phase, f"{steps} steps of the {model.cfg.n_layers}-layer 8B in {train_s:.2f}s "
        f"(rows, frame lengths) {trained_shape}; peak {peak:.2f} GiB allocated, "
        f"{peak_reserved:.2f} GiB reserved; launches fwd/dq/dkv one-pass unbiased "
        f"{launched[0]}, biased {launched[1]}, long unbiased {launched[2]}, biased "
        f"{launched[3]} (the forward twice a step: remat); clip "
        f"{trainer.optimizer.max_grad_norm}")
    if trained_shape != (plan["rows"], {plan["frame"]}):
        raise AssertionError(f"trained (rows, frame) {trained_shape}, but the kernels were "
                             f"checked at ({plan['rows']}, {plan['frame']})")
    clip = plan["settings"]["optimizer"]["params"]["max_grad_norm"]
    if trainer.optimizer.max_grad_norm != clip:
        raise AssertionError("the optimizer block's max_grad_norm is not the clip")
    for h in trainer.history:
        if not all(map(math.isfinite, h.values())):
            raise AssertionError(f"non-finite train metrics: {h}")
        if h["grad_norm"] <= 0 or h["skipped_nonfinite"] != 0:
            raise AssertionError(f"bad train step: {h}")
    if int(trainer.state.step) != steps or len(trainer.history) != steps:
        raise AssertionError(f"train step count {int(trainer.state.step)}, want {steps}")
    return trainer, launched


def expect_launches(phase, launched, want) -> None:
    """`launched` (counts()) must equal `want`: a dict from the tier and kind
    ("one-pass", "one-pass bias", "long", "long bias") to (fwd, dq, dkv),
    and "int4" to (B6,); a tier and kind it does not name launched
    nothing."""
    kinds = ("one-pass", "one-pass bias", "long", "long bias", "int4")
    expected = tuple(want.get(kind, (0,) if kind == "int4" else (0, 0, 0)) for kind in kinds)
    if tuple(launched) != expected:
        raise AssertionError(f"{phase} launched {dict(zip(kinds, launched))}, expected "
                             f"{dict(zip(kinds, expected))}")


def step_share(phase, trainer, fwd_rec, bwd_rec, n_layers) -> None:
    """The attention kernels' share of the steady step: ms x launches a step
    (the forward twice: remat)."""
    step_ms = min(h["seconds"] for h in trainer.history) * 1e3
    attn_ms = {"fwd": fwd_rec["ms"] * 2 * n_layers, "dq": bwd_rec["dq"]["ms"] * n_layers,
               "dkv": bwd_rec["dkv"]["ms"] * n_layers}
    log(phase, f"steady step {step_ms:.1f} ms: attention kernels "
        f"{sum(attn_ms.values()):.1f} ms ({', '.join(f'{k} {v:.1f}' for k, v in attn_ms.items())}; "
        f"{sum(attn_ms.values()) / step_ms:.1%})")


# how each kernel of the JSON line is built: the wgmma kernels (B1, B2, B3,
# B4, B4-bias, B5-dq, B5-dkv, unbiased and biased) and those that keep the
# earlier warp-level design (B3-bias)
WGMMA_DESIGN = "wgmma + TMA, producer and two consumer warpgroups"
MMA_DESIGN = "mma.sync + cp.async, four warps"


def kernel_record(name, source, line, launches, recs, main_rec,
                  replaces="flash_attention.py", design=MMA_DESIGN) -> dict:
    """One kernel's entry of the JSON line: times at its main-path case, the
    largest error over all its cases. `source` is the file in `ops/csrc` that
    holds the kernel's body, `replaces` the file in `mmada_tpu/ops` of the
    TPU kernel and `line` its line(s), `design` how it is built."""
    return {
        "name": name,
        "design": design,
        "route": "cuda",
        "source": f"mmada_tpu_torch/ops/csrc/{source}",
        "replaces": f"mmada_tpu/ops/{replaces}:{line}",
        "launches": launches,
        "max_abs_err": max(r["max_abs_err"] for r in recs),
        "ms": main_rec["ms"],
        "plain_ms": main_rec["plain_ms"],
        "bound_ms": main_rec["bound_ms"],
        "bound_by": main_rec["bound_by"],
        "library_ms": main_rec["library_ms"],
    }


if __name__ == "__main__":
    sys.exit(main())
