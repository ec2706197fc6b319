#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (`mmada_tpu_torch`) on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from `mmada_tpu_torch/ops/csrc` (nvcc, cold),
checks that every kernel (B1, B2, B3 and B3-bias (dq and dkv), B4, B4-bias,
B5-dq and B5-dkv (unbiased and biased), B6) holds `wgmma` (HGMMA) and TMA
load (UTMALDG) instructions in its SASS and that ptxas spilled nothing of
theirs, holds each kernel against its plain PyTorch version (B1 and B2
also by the share of their outputs that differ, B2 with a zero bias against
B1 bit for bit) at the shapes the serving and training paths give it: the
one-pass tier (B1, B2 with a bias, dq and dkv without and with a bias) and
the long tier past
4096 tokens (B4, B5-dq and B5-dkv, without and with a bias, at 8,192 tokens,
at 16,384, under GQA and rectangular), the one-pass tier on an unaligned
length past 4096, and the int4 matmul (B6) at the shapes of the int4
model's matmuls (with its share of its bound at each). It runs
and trains a small model through the kernels against the fp32 CPU path
(without and with attention masks; an int4 forward through B6; a W8A8
straight-through train step), builds the full-width 8B (random weights, made
on the card from a seed), answers text and t2i requests through the port's
entry points, builds the flagship MAGVIT-v2 tokenizer (random fp32 weights
from a seed) and decodes the t2i request's codes to 512-px images
(`entry.decode_images`), encodes a 512-px image and holds its latents and
codes against the fp32 CPU encode of the same weights (and the codes bit for
bit under torch's default TF32 flags, TF32 on everywhere and a repeat),
answers an MMU request about that image (`entry.serve_mmu`, exact, then
early-stop at block 32 against the exact sampler at block 32), answers a
text request whose frame is 8,192 tokens, writes the 8B (bf16 shards with an
index, the reference key layout) and MAGVIT-v2 to safetensors files and
loads them back through the serve loader from dotted overrides (every leaf
equal to the in-memory one, the host's RSS growth under 4 GB), frees the
in-memory copies, answers the text, t2i and MMU requests (MMU also with the
fast_stack preset; text also int4, loaded and quantized by the loader)
through the three command lines' `run` on the loaded model, each equal to
the in-memory model's answer, answers the same requests through
the block-KV cached decode (the fast samplers: text with the bf16 and the
int8 cache, a refresh every 4 steps and tau 1.5, which must leave the
answers bit for bit; MMU with the cache and with the JAX loader's
fast_stack preset; t2i with the cache, its codes decoded; the 8,192-token
request, B4 capturing and B1 stepping), each beside the exact sampler on the
same batch, with B1's launches split into square captures and rectangular
steps, each run twice to the same answer bit for bit, and holds a fresh
capture's step, with the bf16 and with the int8 cache, against the exact
forward and the int8 cache's step against the bf16 cache's (also B1 at the
four step shapes in phase 3, and B6 at the steps' 96 and 128 rows),
quantizes the same 8B on the card (`entry.quantize`) to int4 and answers
the text and t2i requests through B6 (and the text and MMU requests cached,
B6's calls recorded by shape), then to SmoothQuant W8A8 (text and t2i),
int8 and W8A8 (a text batch each), freeing each quantized model before the
next, serves through the port's `ServingEngine` (phase 7d: four text
requests released together from a held dispatcher as one batch, bit for bit
`model.generate` on the batch, against the four one at a time and one
against `entry.serve_text`; two stochastic requests with their own seeds in
one batch, against the direct call and their solo runs; the MMU request as
chunks of 8 steps, alone against monolithic (the cost of a chunk boundary),
then overtaken by a short text request and joined mid-flight by a second
MMU request; the t2i requests as windows of 4 steps, one with a guidance
interval, each its monolithic run; a cancelled queued request and a drain;
a text batch on the int4 8B, B6 by recorded shape; the achieved rate of
the exact MMU forward, which the chunk guard divides by) and through
`app_torch`'s HTTP server on 127.0.0.1 over the checkpoint (phase 7e:
/health, /stats, /generate against the model on the app's frame,
/generate_stepwise streamed, /t2i and /mmu against the t2i and MMU command
lines' `run`, four concurrent /generate calls as one batch by /stats's
counters), takes stage-1 train steps of the bf16 8B through `entry.train`, one
stage-1 step whose flows carry 256-px images that MAGVIT-v2 encodes on the
card (its frames equal those of the same flows carrying the codes), then
train steps on 8,192-token frames, then turns attention masks on
(`attention_bias_enabled=True`, the same weights) and answers t2i requests
and takes stage-1 train steps with `t2i_masks` again, and one masked step
on 8,192-token frames. Then the training command line, `train_torch` (phase
10a: configs/proxy_160m.yaml, 4 steps with async saves, the EMA and the
validation hooks on the repo's fixtures, `auto` remat resolving to `dots`,
whose step's loss equals a `full` step's; a second invocation resuming every
leaf of the state and the EMA at step 4; rotation; a third run stopped by a
SIGTERM during step 2, leaving checkpoint-2; phase 10b: the stage-1 config
on the 8B and MAGVIT-v2 of the checkpoint, its data through the real
readers (an ImageNet folder, webdataset tars by the native streamer, a
parquet file) from shards the smoke writes, 3 steps with the hooks at step
2, `auto` resolving by the measured bytes, no save: the machine takes 45 GiB
of writes a run), and removes the checkpoint. Phase 11 is motion; phase 12
the mesh path at this machine's world (one rank, or one spawned rank a
card: NCCL's collectives probed exact, then 12a stage-1 steps of the 8B
through the Trainer over `make_mesh(fsdp=-1)` against the same steps
without a mesh, bit for bit on one card;
12b the loader's sharded and pipelined 8B answering the text and t2i
requests with the unsharded tokens; 12c B1, B2, a GQA shape and B4 on the
head shards of T = 2, 4, 8, joined equal to the full calls bit for bit;
12d `app_torch` and its engine over the one-rank mesh, through the control
channel, answering four concurrent /generate calls, /t2i, /mmu and a
streamed /generate_stepwise on the masked 8B (B1 and B2) as the same calls
without a mesh, bit for bit; with more than one card also the app over
fsdp and over tensor, int4 over tensor, a W8A8 step over (1, W/2, 2) and
C.8's witness, each rank's traceback in a file of its own).
Phase 8 also takes one step under `utils/profiling.trace` (CUDA kernels
inside its annotated span) and prints its model-FLOP share of 989 TFLOP/s.
Phase 13 is eval (A.13): t2i images of the 8B scored by CLIP ViT-L/14 and
ImageReward-v1.0 through `inference_t2i_torch`'s scoring (13a),
`eval_t2m_torch.run` on a HumanML3D-layout tree (13b), the motion VQ-VAE's
reconstruction eval in `train_motion_vq_torch` (13c) and the SMPL fit of a
generated clip (13d), each held against the fp32 CPU run of the same
weights (EVAL_REL and the SMPL bars).
Phase 14 is fp32 and every head width (A.17): the kernels B7 (forward,
both tiers), B8-dq, B8-dkv (each through its body: "wgmma" on the tensor
cores for bf16 (B7 at every width, its instance of 512 past 256; B8 up to
256), "ffma" on the CUDA cores for fp32 and B8's bf16 past 256, each case's
bodies asserted) and B6-f32 (int4 with fp32 x) against their plain versions
with their times (14a: fp32 at D 16-256, bf16 at D 16, 48, 96, 192, 256 and
512, biased, with RoPE, rectangular, 8,192 tokens, the t2i CFG frame; the
fp32 one-pass cases' outputs and gradients, and B6-f32's outputs, also
against float64, no further from it than GENERIC_F64_RATIO times the plain
version; B6-f32 at the 8B's shapes; no spill in their SASS), then
configs/tiny_test.yaml (fp32, 16-wide heads) through the command lines'
`load` / `run` on the card token-exact against the CPU and `train_torch`'s
trainer for 2 steps against the CPU's (14b), the full-width 8B under FP32
(one t2i forward and a text request through B7, against the plain
attention's fp32 logits) and its int4 form through B6-f32 (14c), and 256-wide
heads at the 8B's widths (a masked t2i forward and train step against fp32,
14d), and 512-wide heads the same way (14e: B7 through its instance of 512,
B8 through its ffma body); 14b-14c launch only the ffma bodies, 14d only the
wgmma bodies; B7, B8 and B6-f32 launch on none of phases 2-13.
It checks that the kernels really ran on each path
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

import atexit
import collections
import contextlib
import dataclasses
import gc
import io
import json
import logging
import math
import os
import re
import shutil
import subprocess
import sys
import tarfile
import tempfile
import time
import traceback

T0 = time.perf_counter()

PEAK_BF16_FLOPS = 989e12   # H100 SXM dense bf16 tensor-core peak (data sheet)
PEAK_HBM_BYTES = 3.35e12   # H100 SXM HBM3 bytes/s (data sheet)
PEAK_FP32_FLOPS = 67e12    # H100 SXM fp32 outside the tensor cores (data sheet)
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

# MAGVIT-v2: the flagship tokenizer (magvit2_default(), random fp32 weights
# from seed 0) on MMaDA's 512-px images (configs/mmada_demo.yaml:40-43):
# 32 x 32 = 1,024 codes. Its latents on the card are held against its fp32
# CPU latents at the JAX test's bar (tests/test_magvit_parity.py:36), its
# atol scaled by the largest |latent|; a code may differ only through a
# channel whose CPU latent is within the measured latent error of 0 (the
# card and the CPU sum the convs in other orders)
VQ_RESOLUTION = 512
LATENT_ATOL = 2e-4
LATENT_RTOL = 1e-3
# one MMU request at the bench's light point (bench.py:327-333): 128 new
# tokens, 64 steps, one block of 128, T = 0; the 38-byte question makes the
# frame (<|mmu|> <|soi|> 1,024 codes <|eoi|> <bos> question + answer) the
# bench's 1,194 tokens. Then the early-stop sampler at block 32, held
# against the exact sampler at block 32
MMU_QUESTION = "Describe this image in detail, please."
MMU_SETTINGS = dict(max_new_tokens=128, steps=64, block_length=128, temperature=0.0)
MMU_FAST_BLOCK = 32
MMU_FRAME = (2 + (VQ_RESOLUTION // 16) ** 2 + 2 + len(MMU_QUESTION.encode())
             + MMU_SETTINGS["max_new_tokens"])

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
# the block-KV cached decode (opt-in fast samplers) on the same requests:
# text with the bf16 cache, the int8 cache, a refresh every 4 steps, and
# tau 1.5 (never fires: bit for bit tau off); MMU with the cache and with
# the JAX loader's fast_stack MMU preset (mmada_tpu/serve/loader.py:42-49:
# int8, tau 0.9, warmup 2); t2i and the 8,192-token request with the cache
CACHED_REFRESH = 4
MMU_FAST_STACK = dict(block_kv_cache="int8", parallel_threshold=0.9, parallel_warmup_steps=2)
# a fresh capture's first step against the exact forward: both round one
# function in bf16, the step at other matmul heights (96 rows, not 477:
# cuBLAS may round an output one ulp, 2^-8, otherwise) and with RoPE outside
# the kernel, and on random weights a one-ulp difference grows through 32
# layers (on the H100, random weights: step vs exact rel L2 2.3e-2, argmax
# agreement 0.885). So each is held against the same logits in fp32
# (`fp32_block_logits`): the step may be at most 1.5 times as far from them
# as the exact forward is, with the bf16 cache and with the int8 cache (on
# the H100: 1.00x and 1.14x at text, 1.00x and 1.28x at MMU); a stale or
# misplaced K would leave them by O(1)
FRESH_STEP_FACTOR = 1.5
# the int8 cache's first step against the bf16 cache's: JAX's mean-error bar
# (tests/test_kv_cache.py::test_int8_cache_close_to_fp32_cache); its argmax
# bar (0.95) is held in the CPU tests and only reported here, since on the
# random 8B bf16 rounding alone moves 8% of the argmaxes (the exact forward
# against fp32: agreement 0.917 at text)
INT8_CACHE_MEAN_REL = 0.05
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
# the checkpoint phase: the served 8B written in the reference key layout in
# bf16 shards of at most 5 GB with an index, MAGVIT-v2 as one fused file,
# both loaded back through `serve.loader.load_all`; the host's peak RSS may
# grow by less than 4 GB while loading (the largest tensor, the embedding
# or the head, is 1.10 GB: a loader that stages the model on the host
# fails)
CKPT_SHARD_BYTES = 5 * 10**9
CKPT_RSS_GROWTH = 4 * 10**9
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
# phase 14 (A.17): B7, B8 and B6-f32 are fp32 FFMA kernels. In fp32 they sum
# in another order than their plain versions and nothing else: the forward
# within 1e-5 absolute (|out| ~ 1), the gradients within 1e-5 of their
# largest entry, B6-f32 within 1e-5 of its output's largest entry; in bf16
# they take phase 3's bars at D 128 (the one-pass tier: KERNEL_ATOL /
# KERNEL_RTOL and B1_DIFFER_SHARE, GRAD_REL_L2 / GRAD_MAX_REL; the long tier:
# within_one_ulp and long_grad_error)
GENERIC_FWD_ATOL = 1e-5
# that bar is about the plain version's own distance from float64 at the t2i
# frame (9.8e-6), so phase 14a also evaluates each fp32 one-pass case in
# float64 and holds B7 to no more than this multiple of the plain version's
# distance from it: as accurate as the plain version, up to a quarter
GENERIC_F64_RATIO = 1.25
GENERIC_GRAD_REL = 1e-5
GENERIC_INT4_REL = 1e-5
# the fp32 8B through B7 against the same weights' forward with the plain
# attention, and through B6-f32 against the dequantised weights in cuBLAS:
# one fp32 function, summed in other orders, through 32 layers
FP32_MODEL_REL_L2 = 1e-4
INT4_F32_DESIGN = ("fp32 FFMA on the CUDA cores: 128 x 128 output tiles, 64-row K stages in a "
                   "3-slot cp.async ring, W expanded once a stage into a double-buffered shared "
                   "tile, 8 x 8 outputs a thread from float4 reads, each 128-row group's "
                   "products summed apart, K split across blocks (summed in a fixed order) "
                   "where the tiles are few")
# B7's two bodies (`flash_attention.generic_body`): fp32 at every width on
# the CUDA cores; bf16 at every width on the tensor cores
FFMA_DESIGN = ("fp32 FFMA on the CUDA cores: 128-row tiles (64 past D 128), the whole width to "
               "256 in a block, register tiles fed by float4 reads, K and V staged by cp.async, "
               "one walk over K in fp32")
WIDE_DESIGN = ("wgmma + TMA at instances of 64, 128 and 256 columns, zero-filled past D; "
               "producer and two consumer warpgroups, 64-key stages")
WIDE512_DESIGN = ("wgmma + TMA, the instance of 512 columns (272-512 zero-filled): 64 query "
                  "rows a block, the two consumer warpgroups splitting q . k^T's contraction "
                  "and the output's columns, the score halves summed through shared memory, "
                  "K and V in 32-key tiles through rings of their own")
# B8's two bodies, by the same rule
FFMA_BWD_DESIGN = ("fp32 FFMA on the CUDA cores: B7's register tiles and cp.async ring, the "
                   "whole width to 256 in a block, dq's one-pass tier in two walks, its long "
                   "tier online")
WIDE_BWD_DESIGN = ("wgmma + TMA: B3's / B5's kernels zero-filled at instances 64 and 128; at "
                   "256 dq over 32-key stages, dkv's warpgroups splitting dk / dv's columns "
                   "and exchanging p^T, ds^T through shared memory")
TINY_CONFIG = "configs/tiny_test.yaml"
TINY_TEXT = dict(gen_length=16, steps=8, block_length=8)
TINY_MMU = dict(max_new_tokens=16, steps=8, block_length=16)
FP32_TEXT = dict(gen_length=32, steps=4, block_length=32, temperature=0.0)
WIDE_HEADS = 16   # 16 heads of 256 over the 8B's d_model of 4,096
WIDER_HEADS = 8   # 8 heads of 512 over the same
# the library's grouped-int4 matmul (B6's library time) rounds the scales to
# bf16 (a relative change of at most 2^-9 per weight); it is held to the
# plain version normwise, which a wrong nibble order or sign would miss by
# orders of magnitude
INT4_LIBRARY_REL_L2 = 1e-2

# the serving engine (phase 7d) on the full-width 8B: four text requests at
# TEXT_SETTINGS released together from a held dispatcher (one batch of 4);
# two stochastic requests (T 1, seeds 0 and 1) in one batch, each its solo
# run; the MMU request of phase 7a as chunks of ENGINE_SEGMENT steps (8 of its
# 64), overtaken by a short text request and joined mid-flight by a second
# MMU request of its key; the t2i requests as windows of ENGINE_WINDOW steps,
# and one with a guidance interval; a cancelled queued request and a drain;
# a text batch on the int4 8B (B6 by recorded shape)
ENGINE_PROMPTS = TEXT_PROMPTS + ["Tell me a fact about the moon."]
ENGINE_SEGMENT = 8
ENGINE_TIMING_ORDER = (0, ENGINE_SEGMENT, ENGINE_SEGMENT, 0, 0, ENGINE_SEGMENT)
ENGINE_TIMING_PAIRS = len(ENGINE_TIMING_ORDER) // 2
ENGINE_WINDOW = 4
ENGINE_INTERVAL = (0.0, 0.2)
ENGINE_SHORT = dict(gen_length=32, steps=8, block_length=32)
ENGINE_JOIN_QUESTION = "What objects does this photo show you?"   # MMU_QUESTION's length
# the HTTP phase (7e): app_torch's server on 127.0.0.1 over the checkpoint of
# phase 7b''; its free port is asked of the OS
HTTP_T2I_PROMPT = T2I_PROMPTS[0]
# the training command line (phases 10a and 10b), `train_torch.run` on the
# repo's configs. The validation hooks read the repo's fixtures by absolute
# path (the proxy config names no prompts file)
ROOT = os.path.dirname(os.path.abspath(__file__))
FIXTURES = [
    f"dataset.params.validation_prompts_file={ROOT}/validation_prompts/imagenet_prompts.txt",
    f"dataset.params.mmu_validation_dir={ROOT}/mmu_validation",
    f"dataset.params.lm_chat_validation_file={ROOT}/lm_chat_validation/questions.jsonl",
]
# 10a: configs/proxy_160m.yaml as written (full-size random MAGVIT-v2 at 512
# px, its structured flows, loss_chunk 64, async checkpointing), 4 steps,
# saves and hooks every 2, the EMA on; `auto` remat, which the config does
# not set, so that its resolution runs; one checkpoint kept, so that the
# save at step 4 rotates step 2's out; a line a step
PROXY_CLI = [f"config={ROOT}/configs/proxy_160m.yaml", "training.max_train_steps=4",
             "experiment.save_every=2", "experiment.generate_every=2",
             "training.ema.enabled=true", "model.gradient_checkpointing=auto",
             "experiment.checkpoints_total_limit=1", "experiment.log_every=1", *FIXTURES]
PROXY_LAYERS = 8
PROXY_ROWS, PROXY_FRAME = 12, 1091   # 4 + 4 + 4 rows; 64 + 1 + 1,024 + 2 tokens
PROXY_TIMED_STEPS = 3                # dots against full, each from the same state
# 10b: configs/mmada_pretraining_stage1.yaml with the 8B and MAGVIT-v2 of
# phase 7b''; its data from shards the smoke writes (STAGE1_DATA); each
# override for a reason: accumulation 1 (weights, gradients, two AdamW moments
# and an accumulator, 5 x 16 GB, do not fit in 80 GB), the chunked head
# (loss_chunk 128), the clip in the optimizer block (as phase 8), 3 steps
# with the hooks at step 2, a line a step, and a shuffle buffer below the
# shards' 24 samples (1,000 would decode each image ~40 times before the
# first batch). gradient_checkpointing stays `auto`, as written. No save
# (the fixed choice of this phase): the machine this smoke runs on accepts at
# most 45 GiB of disk writes a run, deleted files counted, and phase 7b''
# writes 16.5 GB; the 8B's train state is 48.5 GB. The save and resume checks
# are phase 10a's
STAGE1_CLI = [f"config={ROOT}/configs/mmada_pretraining_stage1.yaml",
              "training.gradient_accumulation_steps=1", "training.loss_chunk=128",
              "optimizer.params.max_grad_norm=1.0", "training.max_train_steps=3",
              "experiment.save_every=0", "experiment.generate_every=2",
              "experiment.log_every=1", "dataset.params.shuffle_buffer_size=16", *FIXTURES]
STAGE1_STEPS = 3
STAGE1_DATA = dict(classes=3, per_class=8, tars=2, per_tar=12, docs=40)

# phase 11, motion. 11a: the flagship motion VQ-VAE (MotionVQConfig(): pose
# 263, width 512, 512 codes of 512, down_t 2; random fp32 weights from seed
# 0, its EMA-reset codebook seeded by one `forward_train` on clip windows)
# encodes batches of `motion_clip`s, 64 frames (16 codes) and 220 frames (55
# codes): codes bit for bit against the fp32 CPU encode of the same weights
# under every TF32 flag; decoded features within MOTION_FEATURE_ATOL of the
# CPU's, scaled by the largest |feature| (the convs sum in other orders);
# then `train_motion_vq_torch` on configs/motion_soak.yaml's VQ stage
MOTION_CLIPS = ((8, 64), (4, 220))
MOTION_FEATURE_ATOL = 1e-4
MOTION_VQ_CLI = [f"config={ROOT}/configs/motion_soak.yaml", "training.max_train_steps=4",
                 "training.log_every=1"]
# 11b: t2m serving on the 8B with the t2m vocab (MMADA_8B_T2M, 135,170 rows).
# The frame of configs/t2m_instruct.yaml: max_seq_length 64 (65 text
# positions), <|som|>, max_motion_length 55, <|eom|>: 122 tokens; a caption
# of 32 bytes leaves 30 pads, which the masked model keeps out of attention
# (B2). 18 timesteps at T = 0 (the sampling stays categorical, from the seed)
T2M_CAPTION = "a person walks forward and waves"
T2M_SETTINGS = dict(num_motion_tokens=55, max_text_len=64, timesteps=18, temperature=0.0,
                    seed=0)
T2M_FRAME = T2M_SETTINGS["max_text_len"] + 1 + T2M_SETTINGS["num_motion_tokens"] + 2
T2M_SEGMENT = 4
T2M_LONG_TOKENS = 256          # the sampler's default motion length, for timing
T2M_LONG_FRAME = T2M_SETTINGS["max_text_len"] + 1 + T2M_LONG_TOKENS + 2
# 11c: `train_torch.run` with training.task=t2m on configs/t2m_instruct.yaml:
# the 8B at random init (the repo has no MMaDA t2m weights) with the frames'
# masks in attention, full remat (activations of 32 x 122 tokens beside the
# weights, gradients and two AdamW moments), a token bank the smoke writes,
# 3 steps of batch_size_t2m 32, a line a step; no save (the 8B's train state
# is 65 GB against the machine's 45 GiB of writes a run: the proxy run
# checks save and resume); then 3 LoRA steps (rank 32, alpha 64, the
# embedding and head trained, configs/t2m_instruct_lora.yaml)
T2M_BATCH = 32
T2M_TRAIN_STEPS = 3
T2M_TRAIN_CLI = [f"config={ROOT}/configs/t2m_instruct.yaml", "model.mmada.random_init=true",
                 "model.mmada.attention_bias_enabled=true", "training.gradient_checkpointing=full",
                 f"training.max_train_steps={T2M_TRAIN_STEPS}", "experiment.save_every=0",
                 "experiment.log_every=1"]
T2M_LORA = ["training.lora.rank=32", "training.lora.alpha=64",
            "training.lora.train_embeddings=true"]
# the proxy arch of configs/motion_soak.yaml (8 layers of 512, its t2m
# stage, no remat as written): 2 steps saving each, a resume to 3 that must
# land on the uninterrupted run's weights, and 2 LoRA steps
T2M_PROXY_CLI = [f"config={ROOT}/configs/motion_soak.yaml", "model.mmada.attention_bias_enabled=true",
                 "experiment.log_every=1"]

# phase 13, eval (A.13), on one 8B with the t2m vocab (random weights from seed
# 0). 13a: two t2i requests (T2I_SETTINGS, B1) decoded by the flagship
# MAGVIT-v2 and scored through `inference_t2i_torch.quantative` by CLIP
# ViT-L/14 and ImageReward-v1.0 at their published widths (random fp32 weights
# from seed 0) through `image_quality`'s own scorers: transformers' CLIP
# processor (resize, crop, normalization) and `blip_pixels` resize the decoded
# images to 224 px; the processor's tokenizer and BERT's read stand-in
# vocabularies the smoke writes, since no CLIP or BERT vocabulary is on the
# machine; the card's image and text embeddings and rewards against the fp32
# CPU run of the same weights, max |card - CPU| / max |CPU| within EVAL_REL
# (fp32 with TF32 off on both: only the order of the sums differs). 13b:
# `eval_t2m_torch.run` over a HumanML3D-layout tree of EVAL_TREE_CLIPS
# synthetic clips (batches of 32, 48 motion tokens, 18 timesteps) on the masked
# 8B (B2: the frames' pads), the flagship motion VQ-VAE and the T2M evaluators
# at Comp_v6_KLD005's widths (random weights written as `finest.tar`); the
# evaluator embeddings against the CPU's on the card's codes, FID(gt, gt) 0,
# R-precision in [0, 1]. 13c: `train_motion_vq_torch` with `eval.run_vq_eval`
# on the tree at the flagship widths (windows of 40 frames: `MotionVQDataset`
# draws a window from every clip, and the tree's shortest are 40), its
# `vq_eval/*` against the CPU eval of the trained weights (MPJPE within
# EVAL_REL). 13d: `joints2smpl` (20 camera + 150 body iterations) of a
# 196-frame clip recovered from a generated motion, on the card against the CPU
# fit, by the final loss (SMPL_LOSS_RTOL) and the joints (SMPL_JOINT_ATOL,
# metres), not bit for bit: the order of the sums differs, and the camera's
# first Adam step is the sign of a gradient that its init makes zero up to
# rounding (tests/test_torch_eval_smpl.py). The bars sit above the readings
# (loss 2.4e-7, joints 6.0e-5 m on the H100) with room for the order of the
# sums; a control fit on the card with TF32 on is logged beside them
EVAL_REL = 1e-4
EVAL_TREE_CLIPS = 64
EVAL_T2M = ["eval.batch_size=32", "eval.num_motion_tokens=48", "eval.timesteps=18"]
EVAL_VQ_STEPS = 3
SMPL_FRAMES = 196
SMPL_LOSS_RTOL = 1e-5
SMPL_JOINT_ATOL = 1e-3


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


def bound(flops, nbytes, peak=PEAK_BF16_FLOPS):
    """(bound_ms, bound_by): least time for these flops (at `peak` flop/s:
    the tensor cores' bf16 rate by default) and bytes."""
    t_ops, t_bytes = flops / peak, nbytes / PEAK_HBM_BYTES
    return max(t_ops, t_bytes) * 1e3, "operations" if t_ops >= t_bytes else "bytes"


def bias_bytes(bias):
    """The fp32 bias, read once at its own (broadcast) shape."""
    return 0 if bias is None else 4 * bias.numel()


def attention_bound(b, h, kvh, lq, lk, rope, bias=None, d=128, es=2, peak=PEAK_BF16_FLOPS):
    """Forward: 4 B H Lq Lk D flops; q, k, v, o of `es` bytes an element
    (+ the fp32 rope tables, + the fp32 bias)."""
    nbytes = es * d * (2 * b * h * lq + 2 * b * kvh * lk) + (2 * 4 * lq * d if rope else 0)
    return bound(4 * b * h * lq * lk * d, nbytes + bias_bytes(bias), peak)


def bwd_bounds(b, h, kvh, lq, lk, bias=None, d=128, es=2, peak=PEAK_BF16_FLOPS):
    """dq: 6 B H Lq Lk D flops; reads q, k, v, dO, delta (+ bias), writes dq,
    lse. dkv: 8 B H Lq Lk D flops; reads q, k, v, dO, lse, delta (+ bias),
    writes dk, dv. Operands of `es` bytes an element."""
    rows_q, rows_k = b * h * lq, b * kvh * lk
    extra = bias_bytes(bias)
    dq = bound(6 * b * h * lq * lk * d, es * d * (3 * rows_q + 2 * rows_k) + 8 * rows_q + extra,
               peak)
    dkv = bound(8 * b * h * lq * lk * d,
                es * d * (2 * rows_q + 4 * rows_k) + 8 * rows_q + extra, peak)
    return dq, dkv


def kernel_cases(h: int):
    """(tag, B, H, KVH, Lq, Lk, rope, bias) at the shapes the served requests
    give the kernel: the text frame (BOS + prompt bytes + answer), the MMU
    frame (1,194 tokens) and the t2i frame (padded prompt + <|soi|> + image +
    <|eoi|>, 1155 tokens); the cached decode's steps on those frames and on
    the 8,192-token one (rectangular, no RoPE); and the stage-1 training
    frame. `bias` is None (kernel B1) or a function that
    makes the fp32 bias on the card (kernel B2): the masks of the served t2i
    frames and of a stage-1 batch, and a per-head random bias."""
    text_len, t2i_len = TEXT_FRAME, T2I_FRAME
    return [
        ("text B1", 1, h, h, text_len, text_len, True, None),
        ("mmu B1", 1, h, h, MMU_FRAME, MMU_FRAME, True, None),
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
        # the block-KV decode's steps: a block's (or the image span's) queries
        # over the frame's keys, no RoPE
        ("cached text step", len(TEXT_PROMPTS), h, h, TEXT_SETTINGS["block_length"], text_len,
         False, None),
        ("cached mmu step", 1, h, h, MMU_SETTINGS["block_length"], MMU_FRAME, False, None),
        ("cached t2i step (CFG)", 2 * len(T2I_PROMPTS), h, h, T2I_SETTINGS["num_vq_tokens"],
         t2i_len, False, None),
        ("cached long step", 1, h, h, LONG_TEXT_SETTINGS["block_length"], LONG_FRAME, False,
         None),
        # the proxy config's training frame (phase 10a): 4 heads of 128
        ("proxy train B12 (H 4)", PROXY_ROWS, 4, 4, PROXY_FRAME, PROXY_FRAME, True, None),
        # text to motion (phase 11): the t2m frame exact (B1; B2 with its
        # pads masked), the cached step (the motion span over the frame),
        # the 256-token request, and a masked training batch
        ("t2m B1 (exact)", 1, h, h, T2M_FRAME, T2M_FRAME, True, None),
        ("t2m B2 (exact, frame mask)", 1, h, h, T2M_FRAME, T2M_FRAME, True, t2m_mask_bias),
        ("t2m cached step", 1, h, h, T2M_SETTINGS["num_motion_tokens"], T2M_FRAME, False, None),
        ("t2m 256 B1", 1, h, h, T2M_LONG_FRAME, T2M_LONG_FRAME, True, None),
        ("t2m train B32 (masked)", T2M_BATCH, h, h, T2M_FRAME, T2M_FRAME, True,
         t2m_train_mask_bias),
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


def check_rope_outside(h: int) -> None:
    """The cache's capture rotates q and k outside the kernel
    (`apply_rope`, fp32, cast to bf16) and keeps that K; the exact forward
    lets B1's C entry rotate them (unfused fp32 multiplies and adds, cast to
    bf16). At the text and MMU frames: B1 on the outside-rotated q and k,
    without tables, equals B1 with the tables bit for bit."""
    import torch

    from mmada_tpu_torch.ops.attention import apply_rope
    from mmada_tpu_torch.ops.flash_attention import flash_attention

    for i, (b, l) in enumerate(((len(TEXT_PROMPTS), TEXT_FRAME), (1, MMU_FRAME))):
        q, k, v, sin, cos = attention_case(b, h, h, l, l, True, seed=90 + i)
        inside = flash_attention(q, k, v, rope_sin=sin, rope_cos=cos)
        outside = flash_attention(*apply_rope(q, k, sin, cos), v)
        same = bool(torch.equal(inside, outside))
        log("kernel", f"rope outside vs inside B1's C entry at ({b}, {h}, {l}): bit for bit "
            f"{same}; differing share {differing_share(outside, inside)}")
        if not same:
            raise AssertionError("apply_rope and B1's C entry rotate q and k differently")


# the kernels by library, every one on wgmma, as the start of their mangled
# names: B1, B2; B3's and B3-bias's dq and dkv (the backward bodies with
# ONE_PASS, unbiased and biased); B4, B4-bias, B5-dq and B5-dkv unbiased and
# biased; each at D 64 and 128; B6 with tiles of 128 and 256 rows
# the libraries of the CUDA-core kernels (B7's and B8's ffma bodies; B6-f32):
# ptxas must spill no register in any of their kernels. B7's wgmma body
# (attention_wide: both tiers, unbiased and biased, at instances 64, 128,
# 256 and 512) and B8's at its instance of 256 (attention_wide_bwd: dq and dkv, both
# tiers, unbiased and biased; at 64 and 128 B8's wgmma body is B3's and B5's
# kernels) stand in WGMMA_KERNELS with the other wgmma kernels
GENERIC_LIBRARIES = ("attention_generic", "int4_matmul_f32")
WGMMA_KERNELS = {
    "flash_attention_fwd": [f"{k}ILi{d}E" for d in (64, 128)
                            for k in ("attn_fwd_wgmma_kernel", "attn_fwd_bias_wgmma_kernel")],
    "flash_attention_bwd": [f"{k}ILi{d}ELb{bias}ELb1E" for d in (64, 128) for bias in (0, 1)
                            for k in ("attn_bwd_dq_wgmma_kernel", "attn_bwd_dkv_wgmma_kernel")],
    "flash_attention_long": (
        [f"{k}ILi{d}E" for d in (64, 128)
         for k in ("attn_long_fwd_wgmma_kernel", "attn_long_fwd_bias_wgmma_kernel")]
        + [f"{k}ILi{d}ELb{bias}ELb0E" for d in (64, 128) for bias in (0, 1)
           for k in ("attn_bwd_dq_wgmma_kernel", "attn_bwd_dkv_wgmma_kernel")]),
    "int4_matmul": [f"int4_matmul_wgmma_kernelILi{mb}E" for mb in (1, 2)],
    "attention_wide": [f"attn_wide_wgmma_kernelILi{d}ELb{bias}ELb{long}E" for d in (64, 128, 256)
                       for bias in (0, 1) for long in (0, 1)]
    + [f"attn_wide512_wgmma_kernelILb{bias}ELb{long}E" for bias in (0, 1) for long in (0, 1)],
    "attention_wide_bwd": [f"attn_wide_{k}_wgmma_kernelILb{bias}ELb{one}E" for k in ("dq", "dkv")
                           for bias in (0, 1) for one in (0, 1)],
}


def check_sass() -> dict:
    """Per kernel of the built libraries (WGMMA_KERNELS: B1, B2, B3-dq,
    B3-dkv, B3-dq-bias, B3-dkv-bias, B4, B4-bias, B5-dq, B5-dkv, B5-dq-bias,
    B5-dkv-bias at D 64 and 128; B6 at both tile heights; B7's wgmma body
    at its 16 instances; B8's wgmma body at its 8 instances of 256), the
    count of
    HGMMA (wgmma), UTMALDG (TMA load) and UTMASTG (TMA store) instructions in
    its SASS (`cuobjdump -sass`) and, after a cold build, its ptxas lines;
    fails if HGMMA or UTMALDG is missing, if ptxas spilled any register of
    one of them or of the kernels of GENERIC_LIBRARIES (B7's and B8's ffma
    bodies, B6-f32;
    after a cold build), or if it serialised the wgmma of any kernel
    (C7510-C7520 in a build log)."""
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
    for name in GENERIC_LIBRARIES:   # B7 / B8 and B6-f32: no spill in any kernel
        func, spills = None, {}
        for line in _build.build_logs.get(name, "").splitlines():
            if "Compiling entry function" in line:
                func = line.split("'")[1]
            elif func and "spill" in line:
                spilled = re.search(r"(\d+) bytes spill stores", line)
                spills[func] = int(spilled.group(1)) if spilled else 0
        log("sass", f"{name}: {len(spills)} kernels, spill stores {sorted(set(spills.values()))}")
        if _build.build_logs.get(name) and (not spills or any(spills.values())):
            raise AssertionError(f"{name}: ptxas spilled registers or listed no kernel "
                                 f"({spills})")
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
        ("proxy train B12 (H 4, Function)", PROXY_ROWS, 4, 4, PROXY_FRAME, PROXY_FRAME, True,
         True, None),
        ("t2m train B32 (masked, Function)", T2M_BATCH, h, h, T2M_FRAME, T2M_FRAME, True, True,
         t2m_train_mask_bias),
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
    from mmada_tpu_torch.ops.flash_attention import attention_delta, generic_body
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
    CFG batch (4 x 1,155) at ff_proj/up_proj, q/k/v/attn_out and ff_out, the
    t2i head's column window (4 x 1,024 rows, the 8,192 image ids of the
    packed head, read in place), a bytes-bound case (16 rows), ragged rows
    (1, 17, 130), one group (K 128), and one layer of a stacked weight
    (`packed[i]`), then the cached decode's step heights (96 and 128 rows).
    `view` is "window", "layer" or None. The first eight are the exact
    main paths' shapes."""
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
        ("t2i CFG q/k/v/attn_out", t2i, d, d, None),
        ("t2i CFG ff_out", t2i, f, d, None),
        ("t2i head window", 2 * len(T2I_PROMPTS) * T2I_SETTINGS["num_vq_tokens"], d, hi - lo,
         "window"),
        ("bytes-bound 16 rows", 16, d, v, None),
        ("ragged M 1", 1, d, d, None),
        ("ragged M 17", 17, d, d, None),
        ("ragged M 130", 130, d, d, None),
        ("one group K 128", 130, 128, d, None),
        ("layer view packed[1]", text, d, d, "layer"),
    ] + [
        # the cached decode's steps: one block's rows (3 x 32 text, 1 x 128
        # MMU); the text step's head is "text head" above
        (f"cached {path} step {name}", m, k, n, None)
        for path, m in (("text", len(TEXT_PROMPTS) * TEXT_SETTINGS["block_length"]),
                        ("mmu", MMU_SETTINGS["block_length"]))
        for name, k, n in (("q/k/v/attn_out", d, d), ("ff_proj/up_proj", d, f), ("ff_out", f, d),
                           ("head", d, v))
        if (path, name) != ("text", "head")
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
            again = int4_matmul(x, packed, scales)
            rec = dict(tag=tag, shape=[m, k, n], view=view, max_abs_err=max_err,
                       repeat_bit_for_bit=bool(torch.equal(again, out)),
                       ms=cuda_ms(lambda: int4_matmul(x, packed, scales), 10),
                       plain_ms=cuda_ms(lambda: int4_matmul_reference(x, packed, scales), 3, 1),
                       library_ms=cuda_ms(
                           lambda: torch._weight_int4pack_mm(x, weight, GROUP, scales_and_zeros),
                           10),
                       library_rel_l2=lib_rel, bound_ms=bound_ms, bound_by=bound_by)
            rec["share_of_bound"] = bound_ms / rec["ms"]
            log("int4 kernel", json.dumps(rec))
            if not (ok and rec["repeat_bit_for_bit"]):
                raise AssertionError(
                    f"int4_matmul disagrees with its plain version on {tag}: max abs err "
                    f"{max_err} (one bf16 ulp + {LONG_ABS_FLOOR}); a repeated call the same "
                    f"bits: {rec['repeat_bit_for_bit']}")
            if not lib_rel <= INT4_LIBRARY_REL_L2:
                raise AssertionError(
                    f"the library int4 matmul computes another function on {tag}: rel L2 "
                    f"{lib_rel} (limit {INT4_LIBRARY_REL_L2})")
            records.append(rec)
            del x, packed, scales, out, again, ref, weight, scales_and_zeros, lib
    free_memory()
    return records


def move_params(tree, device=None, dtype=None):
    """`tree` with every tensor moved to `device` and cast to `dtype`;
    quantized leaves are moved field by field and keep their dtypes."""
    import torch

    if isinstance(tree, dict):
        return {k: move_params(t, device, dtype) for k, t in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(move_params(t, device, dtype) for t in tree)
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
    import numpy as np
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
    from mmada_tpu_torch.ops.flash_attention import flash_attention

    reset_counts, counts, expect_no_bias_copies = kernel_counters()

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
    check_rope_outside(cfg.n_heads)
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

    # 7a. MAGVIT-v2 (the flagship, on the card): the t2i request's codes
    # decoded to 512-px images, a 512-px image encoded (against the fp32 CPU,
    # under other TF32 flags, on a repeat); then an MMU request about that
    # image through `serve_mmu` on the 8B (B1 only), exact and early-stop
    vq, vq_cfg, image = magvit_phase(codes)
    mmu_launches = mmu_phase(model, vq, vq_cfg, image, reset_counts, counts)

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

    # 7b''. the checkpoint: the 8B and MAGVIT-v2 written to safetensors and
    # loaded back through the serve loader (leaves equal, host RSS bounded);
    # the in-memory copies are then freed and every later phase runs on the
    # loaded ones; the three command lines answer through their `run`. The
    # directory stays until the HTTP phase (7e) has served it
    ckpt_dir = tempfile.mkdtemp(prefix="mmada_ckpt_")
    atexit.register(shutil.rmtree, ckpt_dir, True)
    loaded, refs = checkpoint_load(ckpt_dir, model, vq, vq_cfg, image, reset_counts, counts)
    model, vq = loaded.model, loaded.vq
    free_memory()
    ckpt = checkpoint_answers(ckpt_dir, loaded, refs, image, answers, reset_counts, counts)

    # 7b'. the block-KV cached decode (the fast samplers) on the same 8B:
    # text, MMU, t2i and the 8,192-token request, each beside the exact
    # sampler on the same batch
    cached = cached_phase(model, vq, vq_cfg, image, reset_counts, counts)

    # 7c. quantized serving, before any trainer holds its moments: int4
    # (B6 at every block matmul and the head), then SmoothQuant W8A8 (text
    # and t2i), int8 and W8A8 (a text batch each); each quantized model is
    # freed before the next is made
    serving = dict(n_batches=n_batches, want_text=want_text, want_t2i=want_t2i,
                   bf16_text_s=text_s, bf16_t2i_s=t2i_s)
    int4_launches, int4_cached = serve_quantized(model, quantize, "int4", serving, reset_counts,
                                                 counts, compare_t2i=True,
                                                 cached=(vq, vq_cfg, image),
                                                 want_text=ckpt["int4_text"])
    serve_quantized(model, quantize, "w8a8_smooth", serving, reset_counts, counts)
    serve_quantized(model, quantize, "int8", serving, reset_counts, counts, t2i=False)
    serve_quantized(model, quantize, "w8a8", serving, reset_counts, counts, t2i=False)

    # 7d. the serving engine on the 8B: batches of held requests, per-row
    # seeds, a chunked MMU stream overtaken and joined, t2i windows, a
    # cancel and a drain, an int4 batch
    engine = engine_phase(model, vq, vq_cfg, image, quantize, reset_counts, counts)

    # 7e. the HTTP front end over the checkpoint of 7b''; then the directory
    # goes, before the weights are trained in place
    http = http_phase(ckpt_dir, loaded, image, reset_counts, counts)
    del loaded

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
    # one more step under utils/profiling.trace, its model-FLOP share
    traced = traced_step(trainer, reset_counts, counts, smi)
    train_launches = tuple(a + b for a, b in zip(train_launches, traced))

    del trainer
    free_memory()

    # 8a. one stage-1 step whose flows carry 256-px images, which the
    # flagship MAGVIT-v2 encodes on the card; the frames it trains on equal
    # those of the same flows carrying the codes (the caption dropout drawn
    # alike)
    pixel_flows, coded_flows = pixel_train_flows(vq, vq_cfg)
    pixel_trainer, pixel_train = train_phase("pixel train", model, 1, train, reset_counts, counts,
                                             flows=[pixel_flows], vq_params=vq, vq_cfg=vq_cfg)
    expect_launches("pixel train", pixel_train, {"one-pass": (2 * n, n, n)})
    batches = []
    for flows in (pixel_flows, coded_flows):
        pixel_trainer.prompting.rng = np.random.default_rng(0)
        batches.append(pixel_trainer.prepare_batch(flows))
    same = sorted(batches[0]) == sorted(batches[1]) and all(
        torch.equal(v, batches[1][k]) for k, v in batches[0].items())
    log("pixel train", f"frames from pixels equal the frames from their codes: {same} "
        f"({', '.join(f'{k} {tuple(v.shape)}' for k, v in batches[0].items())})")
    if not same:
        raise AssertionError("the pixel flows' frames differ from their codes' frames")
    del pixel_trainer, batches
    free_memory()

    # 8b. train steps on 8,192-token frames (the long tier: B4, B5-dq,
    # B5-dkv). Each trainer's AdamW moments are freed before the next
    # trainer makes its own: a second set would not fit beside them.
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

    # 10. the training command line (`train_torch`): the proxy config (10a),
    # then the stage-1 config on the 8B of phase 7b'' (10b). Only one 8B with
    # its training state fits on the card: the served 8B and every trainer
    # go first
    del masked_long_trainer, masked, model, vq
    free_memory()
    proxy_cli = proxy_cli_phase(reset_counts, counts)
    stage1_cli = stage1_cli_phase(ckpt_dir, os.path.join(ckpt_dir, "magvit2"), reset_counts,
                                  counts)
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    log("checkpoint", f"removed {ckpt_dir}")
    log("train cli", f"B1 {proxy_cli['b1']} + {stage1_cli['b1']}, dq {proxy_cli['dq']} + "
        f"{stage1_cli['dq']}, dkv {proxy_cli['dkv']} + {stage1_cli['dkv']} (proxy + stage 1, "
        "hooks and auto's measuring forward included)")

    # 11. motion: the flagship motion VQ-VAE (11a), t2m serving on the 8B
    # with the t2m vocab (11b: exact, masked, cached, segmented, the engine),
    # t2m training through `train_torch` (11c: the 8B full and LoRA, the
    # proxy's save and resume); the card holds nothing of earlier phases
    t = time.perf_counter()
    motion_vq_model, motion_vq_cfg, motion_vq_rec = motion_vq_phase(reset_counts, counts)
    t2m_serve = t2m_serving_phase(motion_vq_model, motion_vq_cfg, reset_counts, counts,
                                  expect_no_bias_copies)
    del motion_vq_model
    free_memory()
    t2m_train = t2m_train_phase(reset_counts, counts, expect_no_bias_copies)
    log("motion", f"phases 11a-11c took {time.perf_counter() - t:.1f}s; t2m launches: B1 "
        f"{t2m_serve['b1']} by (B, Lq, Lk) {dict(t2m_serve['b1_shapes'])}, B2 {t2m_serve['b2']} + "
        f"{t2m_train['b2']}, dq-bias {t2m_train['dq']}, dkv-bias {t2m_train['dkv']}")

    # 12. parallelism (the mesh path) at this machine's world: stage-1 steps
    # over make_mesh(fsdp=-1) on NCCL against the unsharded steps (12a), the
    # loader's sharded and pipelined models serving (12b), the kernels on
    # tensor parallelism's head shards (12c), the app and its engine over the
    # mesh through the control channel (12d)
    t = time.perf_counter()
    par = parallel_phase(train, reset_counts, counts)
    log("parallel", f"phases 12a-12d took {time.perf_counter() - t:.1f}s at world "
        f"{par['world']}")
    par_b1, par_dq, par_dkv = par["b1"], par["dq"], par["dkv"]

    # 13. eval: quantative t2i (13a: CLIP ViT-L/14 and ImageReward on the
    # 8B's t2i images), the t2m eval (13b: eval_t2m_torch on the masked 8B
    # over a HumanML3D-layout tree), the motion VQ-VAE's eval (13c) and the
    # SMPL fit of a generated clip (13d), each against the fp32 CPU
    ev = eval_phase(reset_counts, counts, expect_no_bias_copies)
    log("eval", f"phases 13a-13d took {ev['seconds']['phase 13']:.1f}s; launches: B1 "
        f"{ev['b1']}, B2 {ev['b2']}; seconds {ev['seconds']}")

    # 14. fp32 and every head width (A.17): B7, B8-dq, B8-dkv and B6-f32
    # against their plain versions with their times (14a), then paths with
    # the counters from 0 and every launch theirs: configs/tiny_test.yaml
    # through the command lines against the CPU (14b), the full-width 8B under
    # FP32 and its int4 form (14c), 256- and 512-wide heads at the 8B's widths
    # (14d, 14e)
    free_memory()
    generic = generic_phase(reset_counts, counts)

    main_rec = next(r for r in records if r["tag"].startswith("t2i B4"))
    masked_rec = next(r for r in records if r["tag"].startswith("masked t2i B4"))
    one_pass = [r for r in records if r["bias"] is None] + [unaligned["fwd"]]
    b1_parts = dict(serve=launches, mmu=mmu_launches, checkpoint=ckpt["b1"],
                    cached=cached["b1"], int4_cached=int4_cached["b1"], engine=engine["b1"],
                    http=http["b1"], train=train_launches[0], pixel_train=pixel_train[0][0],
                    train_cli=proxy_cli["b1"] + stage1_cli["b1"], t2m=t2m_serve["b1"],
                    parallel=par_b1, eval=ev["b1"])
    b6_parts = dict(int4=int4_launches, checkpoint=ckpt["b6"], engine=engine["b6"],
                    parallel=par["b6"])
    log("launches", f"B1 {sum(b1_parts.values())} by phase {b1_parts}; "
        f"B6 {sum(b6_parts.values())} by phase {b6_parts}")
    b1 = kernel_record("flash_attention_fwd", "flash_attention_fwd.cu", "650",
                       sum(b1_parts.values()), one_pass, main_rec)
    # the cached decode's step shapes: B1's time there, and its launches on
    # the bf16 8B's cached requests (the int4 8B's: `int4_cached`)
    b1["cached_step_shapes"] = [
        dict({k: r[k] for k in ("tag", "shape", "ms", "bound_ms", "bound_by", "plain_ms",
                                "library_ms")},
             launches=cached["rect"][(r["shape"][0], r["shape"][3], r["shape"][4])])
        for r in records if r["tag"].startswith("cached")]

    def t2m_shapes(recs, launched):
        """The t2m shapes' times, each with its launches in phase 11."""
        keys = ("tag", "shape", "ms", "bound_ms", "bound_by", "plain_ms", "library_ms")
        return [dict({k: r[k] for k in keys}, launches=launched(r)) for r in recs
                if r["tag"].startswith("t2m")]

    b1["t2m_shapes"] = t2m_shapes(
        [r for r in records if r["bias"] is None],
        lambda r: t2m_serve["b1_shapes"][(r["shape"][0], r["shape"][3], r["shape"][4])])
    b2 = kernel_record("flash_attention_fwd_bias", "flash_attention_fwd.cu", "686",
                       masked_serve[0] + masked_train[0] + t2m_serve["b2"] + t2m_train["b2"]
                       + t2m_train["proxy"][1][0] + ev["b2"] + par["b2"],
                       [r for r in records if r["bias"] is not None], masked_rec)
    b2["t2m_shapes"] = t2m_shapes(
        [r for r in records if r["bias"] is not None],
        lambda r: t2m_serve["b2"] if r["shape"][0] == 1 else t2m_train["b2"])
    kernels = [b1, b2]
    plain_bwd = [r for r in bwd_records if r["bias"] is None] + [unaligned["bwd"]]
    biased_bwd = [r for r in bwd_records if r["bias"] is not None]
    long_fwd = [r for r in long_records if r["bias"] is None]
    long_fwd_bias = [r for r in long_records if r["bias"] is not None]
    long_bwd = [r for r in long_bwd_records if r["bias"] is None]
    long_bwd_bias = [r for r in long_bwd_records if r["bias"] is not None]
    int4_main = next(r for r in int4_records if r["tag"].startswith("t2i CFG"))
    main_shapes = int4_records[:8]
    kernels.append(dict(
        kernel_record("int4_matmul", "int4_matmul.cu", "149", sum(b6_parts.values()),
                      int4_records, int4_main, replaces="int4_matmul.py"),
        main_path_shapes=[{k: r[k] for k in ("tag", "shape", "ms", "bound_ms", "share_of_bound",
                                             "plain_ms", "library_ms")} for r in main_shapes],
        cached_step_shapes=[dict({k: r[k] for k in ("tag", "shape", "ms", "bound_ms",
                                                    "share_of_bound", "plain_ms", "library_ms")},
                                 launches=int4_cached["b6_shapes"][tuple(r["shape"])])
                            for r in int4_records if r["tag"].startswith("cached")]))
    kernels += [
        kernel_record("flash_attention_long_fwd", "flash_attention_long.cu", "471,392",
                      long_text_launches[2][0] + cached["b4"] + long_train[2][0], long_fwd,
                      next(r for r in long_fwd if r["tag"].startswith("long text"))),
        kernel_record("flash_attention_long_fwd_bias", "flash_attention_long.cu", "497,418",
                      masked_long[3][0], long_fwd_bias,
                      next(r for r in long_fwd_bias if r["tag"].startswith("masked long"))),
    ]

    def bwd_record(name, key, line, count, recs):
        return kernel_record(name, "flash_attention_bwd_wgmma.cuh", line, count,
                             [dict(r[key], library_ms=r["library_ms"]) for r in recs],
                             dict(recs[0][key], library_ms=recs[0]["library_ms"]))

    for name, key, line, count, recs in (
            ("flash_attention_bwd_dq", "dq", "895", train_launches[1] + pixel_train[0][1]
             + proxy_cli["dq"] + stage1_cli["dq"] + par_dq, plain_bwd),
            ("flash_attention_bwd_dkv", "dkv", "963", train_launches[2] + pixel_train[0][2]
             + proxy_cli["dkv"] + stage1_cli["dkv"] + par_dkv, plain_bwd),
            ("flash_attention_bwd_dq_bias", "dq", "746",
             masked_train[1] + t2m_train["dq"] + t2m_train["proxy"][1][1], biased_bwd),
            ("flash_attention_bwd_dkv_bias", "dkv", "799",
             masked_train[2] + t2m_train["dkv"] + t2m_train["proxy"][1][2], biased_bwd),
            ("flash_attention_long_bwd_dq", "dq", "1185", long_train[2][1], long_bwd),
            ("flash_attention_long_bwd_dq_bias", "dq", "1185", masked_long[3][1], long_bwd_bias),
            ("flash_attention_long_bwd_dkv", "dkv", "1240", long_train[2][2], long_bwd),
            ("flash_attention_long_bwd_dkv_bias", "dkv", "1240", masked_long[3][2],
             long_bwd_bias)):
        kernels.append(bwd_record(name, key, line, count, recs))
        if name.endswith("_bias") and "long" not in name:
            t2m_rec = next(r for r in recs if r["tag"].startswith("t2m train"))
            kernels[-1]["t2m_shapes"] = [dict(
                {k: t2m_rec[key][k] for k in ("ms", "bound_ms", "bound_by", "plain_ms")},
                tag=t2m_rec["tag"], shape=t2m_rec["shape"], library_ms=t2m_rec["library_ms"],
                launches=t2m_train[key])]
    kernels += generic_kernel_records(generic)
    log("done", f"total {time.perf_counter() - T0:.1f}s")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}), flush=True)
    return 0


def kernel_counters():
    """(reset_counts, counts, expect_no_bias_copies) over the kernels'
    wrappers' launch counters."""
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
    # the wrappers that copy a bias no tensor map describes (B2, B3-bias,
    # B4-bias, B5-dq-bias, B5-dkv-bias): the model builds its bias so that
    # none is copied
    copiers = (flash_attention, attention_bwd_dq, attention_bwd_dkv, flash_attention_long,
               attention_bwd_dq_long, attention_bwd_dkv_long)

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

    return reset_counts, counts, expect_no_bias_copies


def free_memory() -> None:
    """Return what dropped objects held (a trainer's moments) to the card."""
    import torch

    gc.collect()
    torch.cuda.empty_cache()


def check_answers(answers, vocab) -> None:
    for ans in answers:
        check_answer_ids(ans, TEXT_SETTINGS["gen_length"], vocab)


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


def dequantized(params, dtype=None):
    """`params` with every int4 weight replaced by its dequantisation in
    `dtype` (bf16 by default; one layer at a time), the other leaves
    shared."""
    import torch

    from mmada_tpu_torch.ops.quantization import Int4Tensor

    dtype = dtype or torch.bfloat16

    def deq(w):
        if not isinstance(w, Int4Tensor):
            return w
        if len(w.shape) == 2:
            return w.dequantize(dtype)
        return torch.stack([w[i].dequantize(dtype) for i in range(w.shape[0])])

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
                    compare_t2i=False, cached=None, want_text=None):
    """Quantize the 8B on the card (`entry.quantize`, timed, its bytes logged),
    answer TEXT_PROMPTS (and T2I_PROMPTS) with the counters from 0 and check
    the answers and the launches: the attention kernels as on the bf16
    phases, and B6 exactly 7 n_layers + 1 times a forward for int4, never
    for the others. With `cached` ((vq, vq_cfg, image)) also the text
    request and an MMU request through the block-KV cache
    (`serve_quantized_cached`). Frees the quantized model; returns B6's
    launches, and those of the cached requests (None without `cached`).
    With `want_text`, the text answers must equal it bit for bit."""
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
    if want_text is not None:
        same = _same(answers, want_text)
        log(scheme, f"text answers equal those of the loaded checkpoint's CLI run: {same}")
        if not same:
            raise AssertionError(f"{scheme}: entry.quantize's answers differ from the loader's")
    per_forward = 7 * n + 1 if scheme == "int4" else 0
    text_forwards = TEXT_SETTINGS["steps"] * serving["n_batches"]
    expect_launches(f"{scheme} text", text_launched, {
        "one-pass": (serving["want_text"], 0, 0), "int4": (per_forward * text_forwards,)})
    b6 = text_launched[4][0]
    serving[f"{scheme}_text_s"] = text_s
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
    cached_launches = None
    if cached is not None:
        cached_launches = serve_quantized_cached(qmodel, scheme, serving, cached, reset_counts,
                                                 counts)
        b6 += cached_launches["b6"]
    if compare_t2i:
        compare_int4_t2i_forward(qmodel)
    del qmodel
    free_memory()
    return b6, cached_launches


def serve_quantized_cached(qmodel, scheme, serving, cached, reset_counts, counts) -> dict:
    """The quantized 8B's cached text request (4 captures, 32 steps of 3 x 32
    rows) and cached MMU request (1 capture, 64 steps of 128 rows) through
    `cached_request`: B1 n_layers times a capture or a step, B6 7 n_layers a
    capture and 7 n_layers + 1 a step, and B6's calls at a step's rows, as
    recorded at the int4 dispatch, 4 n_layers at (D, D) (q/k/v/attn_out), 2
    n_layers at (D, F) (ff_proj/up_proj), n_layers at (F, D) (ff_out) and one
    at (D, V) (the head) a step. Returns B1's and B6's launches and B6's by
    recorded (M, K, N)."""
    from mmada_tpu_torch.core.vocab import MMADA_8B
    from mmada_tpu_torch.entry import serve_mmu, serve_text

    cfg = qmodel.cfg
    n, d, f, v = cfg.n_layers, cfg.d_model, cfg.hidden_size, cfg.effective_vocab_size
    vq, vq_cfg, image = cached
    blocks = TEXT_SETTINGS["gen_length"] // TEXT_SETTINGS["block_length"]
    out = dict(b1=0, b6=0, b6_shapes=collections.Counter())
    for tag, fn, captures, steps, rows in (
            ("text", lambda: serve_text(qmodel, TEXT_PROMPTS, block_kv_cache=True,
                                        **TEXT_SETTINGS), blocks, TEXT_SETTINGS["steps"],
             len(TEXT_PROMPTS) * TEXT_SETTINGS["block_length"]),
            ("mmu", lambda: serve_mmu(qmodel, vq, vq_cfg, image, [MMU_QUESTION],
                                      block_kv_cache=True, **MMU_SETTINGS), 1,
             MMU_SETTINGS["steps"], MMU_SETTINGS["block_length"])):
        phase = f"{scheme} cached {tag}"
        answers, _, launched, shapes = cached_request(
            phase, fn, reset_counts, counts, n * captures, n * steps,
            serving.get(f"{scheme}_{tag}_s"), want={
                "one-pass": (n * (captures + steps), 0, 0),
                "int4": (7 * n * captures + steps * (7 * n + 1),)})
        for ans in answers:
            check_answer_ids(ans, ans.shape[0], MMADA_8B)
        by_shape = collections.Counter(shapes["b6"])
        want = {(rows, d, d): 4 * n * steps, (rows, d, f): 2 * n * steps,
                (rows, f, d): n * steps, (rows, d, v): steps}
        got = {shape: by_shape[shape] for shape in want}
        log(phase, f"B6 by (M, K, N) as recorded: {dict(by_shape)}")
        if got != want:
            raise AssertionError(f"{phase}: B6 at the step's {rows} rows {got}, expected {want}")
        out["b1"] += launched[0][0]
        out["b6"] += launched[4][0]
        out["b6_shapes"].update(by_shape)
    return out


def seeded_images(n, res, seed):
    """(n, res, res, 3) pixels in [-1, 1] on the card, made from a seed: a few
    smooth waves a channel and some noise."""
    import torch

    g = torch.Generator("cuda").manual_seed(seed)
    axis = torch.linspace(-1.0, 1.0, res, device="cuda")
    y, x = torch.meshgrid(axis, axis, indexing="ij")
    freq = torch.rand((n, 4, 3, 2), generator=g, device="cuda") * 8.0
    phase = torch.rand((n, 4, 3, 1, 1), generator=g, device="cuda") * 2 * math.pi
    waves = torch.sin(freq[..., 0, None, None] * x + freq[..., 1, None, None] * y + phase)
    noise = torch.randn((n, res, res, 3), generator=g, device="cuda")
    return (waves.mean(1).permute(0, 2, 3, 1) + 0.1 * noise).clamp(-1.0, 1.0)


def magvit_flops(vq, cfg, res):
    """(encode, decode) operations of one res-px image, counted by torch's
    FLOP counter over the convs and the attention products on meta tensors
    (no work done); the norms and activations are not counted."""
    import torch
    from torch.utils.flop_counter import FlopCounterMode

    from mmada_tpu_torch.models import magvit2

    meta = move_params(vq, "meta")
    counts = []
    for fn, part, shape in ((magvit2.encoder_forward, "encoder", (1, res, res, cfg.in_ch)),
                            (magvit2.decoder_forward, "decoder",
                             (1, res // cfg.downsample_factor, res // cfg.downsample_factor,
                              cfg.z_channels))):
        with FlopCounterMode(display=False) as counter:
            fn(meta[part], cfg, torch.empty(shape, device="meta"))
        counts.append(counter.get_total_flops())
    return tuple(counts)


def magvit_phase(t2i_codes):
    """The flagship MAGVIT-v2 on the card: decode the t2i request's codes to
    512-px images (`entry.decode_images`); encode a 512-px image and hold
    its latents and codes against the fp32 CPU encode of the same weights;
    encode it again with TF32 at torch's defaults, with TF32 on everywhere,
    and on a repeat: the same codes bit for bit each time. Returns (params,
    cfg, image)."""
    import torch

    from mmada_tpu_torch.entry import decode_images
    from mmada_tpu_torch.models import magvit2

    cfg = magvit2.magvit2_default()
    t = time.perf_counter()
    vq = magvit2.init_magvit2(cfg, device="cuda", generator=torch.Generator("cuda").manual_seed(0))
    torch.cuda.synchronize()
    n = magvit2.param_count(vq)
    log("magvit", f"magvit2_default() built on the card in {time.perf_counter() - t:.2f}s: "
        f"{n} params, {4 * n / 1e6:.1f} MB in fp32")

    # decode: the t2i request's codes to 512-px images
    codes = t2i_codes.cuda()
    pixels = magvit2.decode_code(vq, cfg, codes)
    images = decode_images(vq, cfg, codes)
    torch.cuda.synchronize()
    want = ((pixels + 1.0) * 127.5).clamp(0, 255).to(torch.uint8).cpu()
    shape = (codes.shape[0], VQ_RESOLUTION, VQ_RESOLUTION, 3)
    if tuple(pixels.shape) != shape or not bool(torch.isfinite(pixels).all()):
        raise AssertionError(f"decoded pixels {tuple(pixels.shape)}, finite "
                             f"{bool(torch.isfinite(pixels).all())}; want {shape}")
    if images.dtype != torch.uint8 or tuple(images.shape) != shape or not torch.equal(images, want):
        raise AssertionError("decode_images differs from (x + 1) * 127.5 clipped to uint8")
    decode_ms = cuda_ms(lambda: decode_images(vq, cfg, codes), 3, 1) / codes.shape[0]
    clipped = float(((pixels < -1) | (pixels > 1)).float().mean())
    encode_flops, decode_flops = magvit_flops(vq, cfg, VQ_RESOLUTION)
    log("magvit", f"decoded {tuple(codes.shape)} t2i codes to {tuple(images.shape)} uint8 images: "
        f"{decode_ms:.2f} ms an image ({rate(decode_flops, decode_ms)}); pixels in "
        f"[{float(pixels.min()):.3f}, {float(pixels.max()):.3f}], {clipped:.4f} of them clipped")
    del pixels

    # encode a 512-px image, against the fp32 CPU encode of the same weights
    image = seeded_images(1, VQ_RESOLUTION, seed=1)
    z = magvit2.encoder_forward(vq["encoder"], cfg, image)
    codes = magvit2.lfq_indices(z, cfg.z_channels)
    cpu_vq = move_params(vq, "cpu")
    t = time.perf_counter()
    z_cpu = magvit2.encoder_forward(cpu_vq["encoder"], cfg, image.cpu())
    cpu_s = time.perf_counter() - t
    del cpu_vq
    z = z.cpu()
    err = (z - z_cpu).abs()
    max_err, scale = float(err.max()), float(z_cpu.abs().max())
    within = bool((err <= LATENT_ATOL * scale + LATENT_RTOL * z_cpu.abs()).all())
    flipped = (z > 0) != (z_cpu > 0)
    differ = flipped.any(-1).reshape(codes.shape)
    if not torch.equal(differ, codes.cpu() != magvit2.lfq_indices(z_cpu, cfg.z_channels)):
        raise AssertionError("the differing codes are not those with a flipped channel")
    flip_z = float(z_cpu.abs()[flipped].max()) if bool(flipped.any()) else 0.0
    log("magvit", f"encoded a {VQ_RESOLUTION}-px image to {tuple(codes.shape)} codes: latents "
        f"{tuple(z.shape)}, max |z| {scale:.4f}, max abs err vs the fp32 CPU {max_err:.3e} "
        f"(bar atol {LATENT_ATOL} x {scale:.4f} + rtol {LATENT_RTOL}: {within}); codes that "
        f"differ {float(differ.float().mean()):.5f} ({int(differ.sum())}), largest CPU |z| of "
        f"a flipped channel {flip_z:.3e}; CPU encode {cpu_s:.1f}s")
    if not within or flip_z > max_err:
        raise AssertionError(f"MAGVIT-v2 on the card departs from its fp32 CPU encode: latents "
                             f"within the bar {within}, a flipped channel at |z| {flip_z} "
                             f"past the latent error {max_err}")

    # the same codes whatever the caller's TF32 flags, and on a repeat
    torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = True, False
    at_defaults = magvit2.get_code(vq, cfg, image)
    torch.backends.cuda.matmul.allow_tf32 = True
    tf32_on = magvit2.get_code(vq, cfg, image)
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    repeat = magvit2.get_code(vq, cfg, image)
    same = [bool(torch.equal(c, codes)) for c in (at_defaults, tf32_on, repeat)]
    encode_ms = cuda_ms(lambda: magvit2.get_code(vq, cfg, image), 3, 1)
    log("magvit", f"codes bit for bit with TF32 at torch's defaults {same[0]}, with TF32 on "
        f"everywhere {same[1]}, on a repeat {same[2]}; {encode_ms:.2f} ms an image "
        f"({rate(encode_flops, encode_ms)})")
    if not all(same):
        raise AssertionError(f"MAGVIT-v2's codes depend on the TF32 flags or the run: {same}")
    return vq, cfg, image


def rate(flops, ms) -> str:
    return (f"{flops / 1e12:.3f} TFLOP, {flops / ms / 1e9:.1f} TFLOP/s, "
            f"{flops / ms / 1e9 / (PEAK_FP32_FLOPS / 1e12):.1%} of the fp32 peak")


def mmu_phase(model, vq, vq_cfg, image, reset_counts, counts) -> int:
    """One MMU request on the 8B through `entry.serve_mmu` at the bench's
    light point (B1 only, once a layer a forward), then `fast=True` at block
    32 against the exact sampler at block 32: the same ids up to the block
    it stopped after, [MASK] past it. Returns B1's launches."""
    import torch

    from mmada_tpu_torch.core.vocab import MMADA_8B
    from mmada_tpu_torch.entry import serve_mmu

    n = model.cfg.n_layers

    def request(**kw):
        reset_counts()
        t = time.perf_counter()
        answer = serve_mmu(model, vq, vq_cfg, image, [MMU_QUESTION], **kw)[0]
        torch.cuda.synchronize()
        return answer, time.perf_counter() - t, counts()

    answer, mmu_s, launched = request(**MMU_SETTINGS)
    check_answer_ids(answer, MMU_SETTINGS["max_new_tokens"], MMADA_8B)
    log("mmu", f"1 request, frame {MMU_FRAME} tokens, {MMU_SETTINGS}: {mmu_s:.2f}s, "
        f"{MMU_SETTINGS['max_new_tokens'] / mmu_s:.1f} tok/s; answer ids "
        f"{answer[:12].tolist()}; launches {launched}")
    expect_launches("mmu", launched, {"one-pass": (n * MMU_SETTINGS["steps"], 0, 0)})
    b1 = launched[0][0]

    block = dict(MMU_SETTINGS, block_length=MMU_FAST_BLOCK)
    fast, fast_s, fast_launched = request(fast=True, **block)
    exact, exact_s, exact_launched = request(**block)
    spb = block["steps"] * MMU_FAST_BLOCK // block["max_new_tokens"]
    blocks = fast_launched[0][0] // (n * spb)
    stop = blocks * MMU_FAST_BLOCK
    log("mmu fast", f"block {MMU_FAST_BLOCK}: ran {blocks} of "
        f"{block['max_new_tokens'] // MMU_FAST_BLOCK} blocks in {fast_s:.2f}s (the exact sampler "
        f"{exact_s:.2f}s); ids equal the exact sampler's up to position {stop}: "
        f"{bool(torch.equal(fast[:stop], exact[:stop]))}; launches {fast_launched}")
    check_answer_ids(exact, block["max_new_tokens"], MMADA_8B)
    expect_launches("mmu fast", fast_launched, {"one-pass": (n * spb * blocks, 0, 0)})
    expect_launches("mmu exact block 32", exact_launched, {"one-pass": (n * block["steps"], 0, 0)})
    if not (torch.equal(fast[:stop], exact[:stop])
            and bool((fast[stop:] == MMADA_8B.mask_token_id).all())):
        raise AssertionError("mmu_generate_fast departs from the exact sampler")
    return b1 + fast_launched[0][0] + exact_launched[0][0]


@contextlib.contextmanager
def recording_shapes():
    """Record the shape of every call the model makes to B1's wrapper through
    the attention dispatch, (B, Lq, Lk), and to B6's through the int4
    dispatch, (M, K, N); each wrapper still counts its own launches. Yields
    {"b1": [...], "b6": [...]}."""
    from mmada_tpu_torch.ops import attention, quantization

    inner_b1, inner_b6 = attention.flash_attention, quantization.int4_matmul
    shapes = dict(b1=[], b6=[])

    def b1(q, k, v, **kw):
        shapes["b1"].append((q.shape[0], q.shape[2], k.shape[2]))
        return inner_b1(q, k, v, **kw)

    def b6(x, packed, scales):
        shapes["b6"].append((x.numel() // x.shape[-1], x.shape[-1], scales.shape[-1]))
        return inner_b6(x, packed, scales)

    attention.flash_attention, quantization.int4_matmul = b1, b6
    try:
        yield shapes
    finally:
        attention.flash_attention, quantization.int4_matmul = inner_b1, inner_b6


def timed_request(fn, reset_counts, counts):
    """Run one request with the counters from 0 and B1's and B6's shapes
    recorded: (result, seconds, counts(), shapes, peak GiB allocated)."""
    import torch

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    with recording_shapes() as shapes:
        t = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t
    return out, seconds, counts(), shapes, torch.cuda.max_memory_allocated() / 2**30


def rss_bytes() -> int:
    """The process's resident set now (VmRSS)."""
    with open("/proc/self/status") as f:
        for line in f:
            if line.startswith("VmRSS:"):
                return int(line.split()[1]) * 1024
    raise RuntimeError("/proc/self/status has no VmRSS")


@contextlib.contextmanager
def rss_growth():
    """The host RSS's growth over the block, by two measures: VmRSS sampled
    every 2 ms on a thread (peak minus the value before), and the growth of
    the process's peak (`ru_maxrss`, which moves only past every earlier
    peak). Yields a dict that holds both, and the larger, after the block."""
    import resource
    import threading

    out = {"before": rss_bytes()}
    peak = [out["before"]]
    maxrss = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024
    stop = threading.Event()

    def sample():
        while not stop.is_set():
            peak[0] = max(peak[0], rss_bytes())
            stop.wait(0.002)

    thread = threading.Thread(target=sample, daemon=True)
    thread.start()
    try:
        yield out
    finally:
        stop.set()
        thread.join()
        out["sampled"] = max(peak[0], rss_bytes()) - out["before"]
        out["maxrss"] = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024 - maxrss
        out["growth"] = max(out["sampled"], out["maxrss"])


def same_tree(a, b) -> bool:
    """Two parameter trees with the same structure and every leaf equal
    (`torch.equal`: shape, and values bit for bit, in one dtype)."""
    import torch

    if isinstance(a, torch.Tensor):
        return isinstance(b, torch.Tensor) and a.dtype == b.dtype and torch.equal(a, b)
    if isinstance(a, dict):
        return isinstance(b, dict) and sorted(a) == sorted(b) and all(
            same_tree(a[k], b[k]) for k in a)
    return len(a) == len(b) and all(same_tree(x, y) for x, y in zip(a, b))


def checkpoint_load(root, model, vq, vq_cfg, image, reset_counts, counts):
    """Write the served 8B (bf16, reference key layout, shards of at most 5
    GB with an index, `config.json` in LLaDA's field names) and MAGVIT-v2
    (one fused `encoder.*` / `decoder.*` file) under `root`; load both back
    through `serve.loader.load_all` from dotted overrides alone, timed and
    with the host's RSS watched; hold every leaf equal to the in-memory
    one's, the configs equal and the tokenizer the ByteTokenizer (`root` has
    no tokenizer files). Then, on the in-memory model, the references of the
    command lines' runs with the loader's special ids (ByteTokenizer's BOS
    and EOS, as JAX's `build_prompting` picks them; the exact phases used
    the vocab's): the t2i codes and pixels, and the MMU answers exact and
    with the fast_stack preset. Returns (the loaded `Loaded`, references)."""
    import torch

    from mmada_tpu_torch.checkpoints.hf_import import export_pretrained
    from mmada_tpu_torch.checkpoints.magvit_import import magvit2_state_dict
    from mmada_tpu_torch.checkpoints.safetensors_io import save_file
    from mmada_tpu_torch.core.config import load_config
    from mmada_tpu_torch.entry import decode_images, serve_mmu, serve_t2i
    from mmada_tpu_torch.prompting.universal import ByteTokenizer
    from mmada_tpu_torch.serve.loader import build_text_tokenizer, load_all

    n = model.cfg.n_layers
    free = shutil.disk_usage(root).free
    log("checkpoint", f"writing under {root}: {free / 1e9:.1f} GB free on its disk")
    torch.cuda.synchronize()
    t = time.perf_counter()
    shards = export_pretrained(root, model.params, model.cfg, model.vocab,
                               max_shard_bytes=CKPT_SHARD_BYTES)
    vq_dir = os.path.join(root, "magvit2")
    vq_bytes = save_file(magvit2_state_dict(vq), os.path.join(vq_dir, "model.safetensors"),
                         metadata={"format": "pt"})
    write_s = time.perf_counter() - t
    nbytes = sum(os.path.getsize(p) for p in shards)
    largest = max(t.numel() * t.element_size() for t in (model.params["wte"],
                                                          model.params["ff_out"]))
    log("checkpoint", f"wrote the 8B ({len(shards)} bf16 shards, {nbytes / 1e9:.3f} GB) and "
        f"MAGVIT-v2 (fp32, {vq_bytes / 1e9:.3f} GB) in {write_s:.2f}s "
        f"({(nbytes + vq_bytes) / write_s / 1e9:.2f} GB/s)")

    cfg = load_config(overrides=[f"model.mmada.pretrained_model_path={root}",
                                 f"model.vq_model.vq_model_path={vq_dir}",
                                 "training.mixed_precision=bf16"])
    # the tokenizer builder's first call imports `transformers` where it is
    # installed (seconds): timed apart, so that load_all's time is the weights'
    t = time.perf_counter()
    tokenizer = build_text_tokenizer(cfg)
    log("checkpoint", f"the tokenizer builder alone, first call: {time.perf_counter() - t:.2f}s "
        f"({type(tokenizer).__name__}: no tokenizer files in the checkpoint)")
    with rss_growth() as rss:
        t = time.perf_counter()
        loaded = load_all(cfg, device="cuda")
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t
    log("checkpoint", f"load_all in {load_s:.2f}s ({(nbytes + vq_bytes) / load_s / 1e9:.2f} "
        f"GB/s); host RSS {rss['before'] / 1e9:.3f} GB before, growth {rss['growth'] / 1e9:.3f} "
        f"GB (sampled {rss['sampled'] / 1e9:.3f}, ru_maxrss {rss['maxrss'] / 1e9:.3f}; limit "
        f"{CKPT_RSS_GROWTH / 1e9:.0f}, the largest tensor {largest / 1e9:.3f} GB)")
    if rss["growth"] >= CKPT_RSS_GROWTH:
        raise AssertionError(f"loading grew the host RSS by {rss['growth']} bytes")
    same = dict(config=loaded.model.cfg == model.cfg and loaded.vq_cfg == vq_cfg,
                llada=same_tree(loaded.model.params, model.params),
                magvit=same_tree(loaded.vq, vq),
                policy=loaded.model.policy == model.policy,
                byte_tokenizer=type(loaded.tokenizer) is ByteTokenizer)
    log("checkpoint", f"loaded equal to the in-memory model: {same}")
    if not all(same.values()):
        raise AssertionError(f"the loaded checkpoint differs from the in-memory one: {same}")

    sp = loaded.prompting.sp
    log("checkpoint", f"the loader's special ids: bos {sp.bos}, eos {sp.eos} (ByteTokenizer's; "
        f"the exact phases used the vocab's {model.vocab.bos_token_id}, "
        f"{model.vocab.eos_token_id})")
    refs = {}
    ref_kw = dict(tokenizer=ByteTokenizer(), special_ids=sp)
    for tag, fn, square, rect_steps in (
            ("t2i", lambda: serve_t2i(model, T2I_PROMPTS, **ref_kw, **T2I_SETTINGS),
             n * T2I_SETTINGS["timesteps"], None),
            ("mmu", lambda: serve_mmu(model, vq, vq_cfg, image, [MMU_QUESTION], **ref_kw,
                                      **MMU_SETTINGS)[0], n * MMU_SETTINGS["steps"], None),
            ("mmu fast_stack", lambda: serve_mmu(model, vq, vq_cfg, image, [MMU_QUESTION],
                                                 **ref_kw, **MMU_SETTINGS,
                                                 **MMU_FAST_STACK)[0], n,
             MMU_SETTINGS["steps"])):
        refs[tag], seconds, launched, shapes, _ = timed_request(fn, reset_counts, counts)
        sq, rc = expect_b1_shapes(f"checkpoint reference {tag}", launched, shapes["b1"], square,
                                  0 if rect_steps is None else n, rect_steps)
        expect_launches(f"checkpoint reference {tag}", launched, {"one-pass": (sq + rc, 0, 0)})
        refs["b1"] = refs.get("b1", 0) + sq + rc
        log("checkpoint", f"reference {tag} on the in-memory 8B: {seconds:.2f}s; B1 {sq} square "
            f"+ {rc} rectangular")
    check_codes(refs["t2i"], model.vocab)
    refs["pixels"] = decode_images(vq, vq_cfg, refs["t2i"])
    return loaded, refs


def checkpoint_answers(root, loaded, refs, image, text_answers, reset_counts, counts) -> dict:
    """The three command lines' `run` on the loaded 8B and MAGVIT-v2, each
    config built from dotted overrides at the smoke's settings: the text
    requests (ids equal the exact text phase's), the t2i requests (codes and
    pixels equal the references), the MMU request exact and with
    `serving.mmu.fast_stack=true` (answers equal the references), and the
    text requests with `model.mmada.quantize=int4`, loaded from `root` again
    and quantized by the loader (B6's calls by recorded shape equal phase
    7c's schedule). B1's launches equal the schedule's on every run.
    Returns B1's and B6's launches and the int4 answers."""
    import torch

    import generate_torch
    import inference_mmu_torch
    import inference_t2i_torch
    from mmada_tpu_torch.core.config import load_config

    model = loaded.model
    n, d, f, v = model.cfg.n_layers, model.cfg.d_model, model.cfg.hidden_size, \
        model.cfg.effective_vocab_size
    base = [f"model.mmada.pretrained_model_path={root}",
            f"model.vq_model.vq_model_path={os.path.join(root, 'magvit2')}",
            "training.mixed_precision=bf16"]
    text = base + [f"{k}={v}" for k, v in TEXT_SETTINGS.items()]
    t2i = base + ["batch_size=2", f"generation_timesteps={T2I_SETTINGS['timesteps']}",
                  f"guidance_scale={T2I_SETTINGS['guidance_scale']}",
                  f"generation_temperature={T2I_SETTINGS['temperature']}",
                  f"seed={T2I_SETTINGS['seed']}",
                  f"dataset.preprocessing.max_seq_length={T2I_SETTINGS['max_text_len']}",
                  f"model.mmada.num_vq_tokens={T2I_SETTINGS['num_vq_tokens']}"]
    mmu = base + [f"max_new_tokens={MMU_SETTINGS['max_new_tokens']}",
                  f"steps={MMU_SETTINGS['steps']}", f"question={MMU_QUESTION}",
                  f"dataset.preprocessing.resolution={VQ_RESOLUTION}"]
    out = dict(b1=refs["b1"], b6=0)
    runs = (
        ("generate_torch", text, lambda cfg: generate_torch.run(cfg, loaded, TEXT_PROMPTS),
         text_answers, n * TEXT_SETTINGS["steps"], 0, None),
        ("inference_t2i_torch", t2i,
         lambda cfg: inference_t2i_torch.run(cfg, loaded, T2I_PROMPTS),
         (refs["t2i"], refs["pixels"]), n * T2I_SETTINGS["timesteps"], 0, None),
        ("inference_mmu_torch", mmu, lambda cfg: inference_mmu_torch.run(cfg, loaded, image),
         [refs["mmu"]], n * MMU_SETTINGS["steps"], 0, None),
        ("inference_mmu_torch fast_stack", mmu + ["serving.mmu.fast_stack=true"],
         lambda cfg: inference_mmu_torch.run(cfg, loaded, image), [refs["mmu fast_stack"]],
         n, n, MMU_SETTINGS["steps"]),
    )
    for tag, argv, fn, want, square, rect, rect_steps in runs:
        cfg = load_config(overrides=argv)
        got, seconds, launched, shapes, _ = timed_request(lambda: fn(cfg), reset_counts, counts)
        sq, rc = expect_b1_shapes(f"checkpoint {tag}", launched, shapes["b1"], square, rect,
                                  rect_steps)
        expect_launches(f"checkpoint {tag}", launched, {"one-pass": (sq + rc, 0, 0)})
        out["b1"] += sq + rc
        same = _same(list(got), list(want))
        log("checkpoint", f"{tag}.run: {seconds:.2f}s; B1 {sq} square + {rc} rectangular; "
            f"equal to the in-memory model's: {same}")
        if not same:
            raise AssertionError(f"checkpoint {tag}: the command line's answer differs")

    # int4 through the loader: the checkpoint read again and quantized
    cfg = load_config(overrides=text + ["model.mmada.quantize=int4"])
    t = time.perf_counter()
    qloaded = generate_torch.load(cfg)
    torch.cuda.synchronize()
    log("checkpoint", f"generate_torch.load with model.mmada.quantize=int4: "
        f"{time.perf_counter() - t:.2f}s")
    got, seconds, launched, shapes, _ = timed_request(
        lambda: generate_torch.run(cfg, qloaded, TEXT_PROMPTS), reset_counts, counts)
    steps = TEXT_SETTINGS["steps"]
    rows = len(TEXT_PROMPTS) * TEXT_FRAME
    head_rows = len(TEXT_PROMPTS) * TEXT_SETTINGS["block_length"]
    expect_launches("checkpoint int4 generate_torch", launched, {
        "one-pass": (n * steps, 0, 0), "int4": ((7 * n + 1) * steps,)})
    by_shape = collections.Counter(shapes["b6"])
    want = {(rows, d, d): 4 * n * steps, (rows, d, f): 2 * n * steps,
            (rows, f, d): n * steps, (head_rows, d, v): steps}
    log("checkpoint", f"int4 generate_torch.run: {seconds:.2f}s; B6 by (M, K, N) as recorded "
        f"{dict(by_shape)}")
    if dict(by_shape) != want:
        raise AssertionError(f"checkpoint int4: B6 by shape {dict(by_shape)}, expected {want}")
    for ans in got:
        check_answer_ids(ans, TEXT_SETTINGS["gen_length"], model.vocab)
    out["b1"] += launched[0][0]
    out["b6"] = launched[4][0]
    out["int4_text"] = got
    del qloaded
    free_memory()
    return out


def cached_request(phase, fn, reset_counts, counts, square, rect, exact_s=None,
                   rect_steps=None, want=None):
    """Run a request twice with the counters from 0 (its host-bound time
    varies from call to call) and hold the first run: B1's launches split
    into `square` captures and `rect` steps (`expect_b1_shapes`), every
    kernel's launches (`want`; by default B1's alone), B6's recorded calls
    against its count; and the second answer bit for bit the first (T = 0,
    seeded generators). Returns (result, the lesser seconds, counts(),
    shapes)."""
    result, first, launched, shapes, peak = timed_request(fn, reset_counts, counts)
    sq, rc = expect_b1_shapes(phase, launched, shapes["b1"], square, rect, rect_steps)
    expect_launches(phase, launched, want or {"one-pass": (sq + rc, 0, 0)})
    if len(shapes["b6"]) != launched[4][0]:
        raise AssertionError(f"{phase}: {len(shapes['b6'])} calls to B6 recorded against "
                             f"{launched[4][0]} launches")
    again, second, *_ = timed_request(fn, reset_counts, counts)
    seconds = min(first, second)
    beside = "" if exact_s is None else f" (exact {exact_s:.2f}s, {exact_s / seconds:.2f}x)"
    log(phase, f"{first:.2f}s / {second:.2f}s{beside}; B1 {sq} square + {rc} rectangular "
        f"{sorted(set(shapes['b1']))}; launches {launched}; peak {peak:.2f} GiB allocated")
    if not _same(result, again):
        raise AssertionError(f"{phase}: the same request answered differently the second time")
    return result, seconds, launched, shapes


def expect_b1_shapes(phase, launched, shapes, square, rect, rect_steps=None):
    """B1's launches split by shape: `square` captures (Lq = Lk) and `rect`
    cached steps (Lq < Lk, the block's rows); with `rect_steps` (tau-parallel,
    a data-dependent step count) `rect` is the launches of one step and the
    count is a whole number of steps, at most `rect_steps` of them."""
    n_square = sum(1 for _, lq, lk in shapes if lq == lk)
    n_rect = sum(1 for _, lq, lk in shapes if lq < lk)
    if len(shapes) != launched[0][0] or n_square + n_rect != len(shapes):
        raise AssertionError(f"{phase}: B1 shapes {sorted(set(shapes))} against "
                             f"{launched[0][0]} launches")
    if rect_steps is None:
        ok = n_rect == rect
    else:
        ok = n_rect % rect == 0 and 1 <= n_rect // rect <= rect_steps
    if n_square != square or not ok:
        raise AssertionError(f"{phase}: B1 launched {n_square} square and {n_rect} rectangular "
                             f"times, expected {square} and {rect}"
                             + (f" x up to {rect_steps} steps" if rect_steps else ""))
    return n_square, n_rect


def fp32_block_logits(model, frame, block_start, block):
    """The exact forward's logits over [block_start, block_start + block) in
    fp32 on the card, the function both bf16 paths round: each layer's
    weights cast to fp32 in turn, attention by the kernels' plain version
    (a reference apart from every kernel), TF32 off."""
    import torch

    from mmada_tpu_torch.models import llada
    from mmada_tpu_torch.ops import attention
    from mmada_tpu_torch.ops.flash_attention import flash_attention_reference

    cfg, params = model.cfg, model.params
    x = params["wte"][frame].float()
    sin, cos = llada.rope_sin_cos(frame.shape[1], cfg.head_dim, cfg.rope_theta, device="cuda")
    inner = attention.flash_attention
    attention.flash_attention = flash_attention_reference
    try:
        for lp in llada.layer_params(params):
            x = llada._block(cfg, x, {k: v.float() for k, v in lp.items()}, None, sin, cos)
    finally:
        attention.flash_attention = inner
    x = llada._norm(cfg, x[:, block_start:block_start + block], params["ln_f"].float())
    return x @ params["ff_out"].float()


def check_fresh_step(model, frame, block_start, block, tag):
    """At a fresh capture of `frame` (B, L), the cached step's logits over
    [block_start, block_start + block) and the exact forward's there, each
    against the same logits in fp32: the step may be at most
    FRESH_STEP_FACTOR times as far from them as the exact forward is, with
    the bf16 cache and with the int8 cache; the int8 cache's step against
    the bf16 cache's also by JAX's mean-error bar. Returns the errors."""
    import torch

    from mmada_tpu_torch.models import llada

    cfg, params, policy = model.cfg, model.params, model.policy
    blk = frame[:, block_start:block_start + block]
    exact = model.forward(frame, logit_positions=(block_start, block)).float()
    kv = llada.forward_kv_capture(params, cfg, frame, policy=policy)
    got = llada.forward_kv_step(params, cfg, blk, kv, block_start, policy=policy).float()
    del kv
    kv8 = llada.forward_kv_capture(params, cfg, frame, policy=policy, cache_dtype="int8")
    got8 = llada.forward_kv_step(params, cfg, blk, kv8, block_start, policy=policy).float()
    del kv8
    ref = fp32_block_logits(model, frame, block_start, block)
    torch.cuda.synchronize()

    def rel(a, b):
        return float((a - b).norm() / b.norm())

    def agree(a, b):
        return float((a.argmax(-1) == b.argmax(-1)).float().mean())

    err = dict(exact_vs_fp32=rel(exact, ref), step_vs_fp32=rel(got, ref),
               step_vs_exact=rel(got, exact), int8_vs_fp32=rel(got8, ref),
               int8_mean_vs_bf16=float((got8 - got).abs().mean() / got.abs().mean()),
               argmax_exact_vs_fp32=agree(exact, ref), argmax_step_vs_exact=agree(got, exact),
               argmax_int8_vs_bf16=agree(got8, got))
    log("cached", f"{tag}: a fresh capture's step over {tuple(blk.shape)}: " + ", ".join(
        f"{k} {v:.4e}" for k, v in err.items()) + f" (limits: step_vs_fp32 and int8_vs_fp32 "
        f"at most {FRESH_STEP_FACTOR} x exact_vs_fp32; int8_mean_vs_bf16 under "
        f"{INT8_CACHE_MEAN_REL})")
    bar = FRESH_STEP_FACTOR * err["exact_vs_fp32"]
    if not (bool(torch.isfinite(got).all()) and bool(torch.isfinite(got8).all())
            and err["step_vs_fp32"] <= bar and err["int8_vs_fp32"] <= bar):
        raise AssertionError(f"{tag}: a fresh cached step (bf16 or int8 cache) departs from the "
                             f"fp32 function more than {FRESH_STEP_FACTOR} x the exact forward "
                             f"does: {err}")
    if not err["int8_mean_vs_bf16"] < INT8_CACHE_MEAN_REL:
        raise AssertionError(f"{tag}: the int8 cache departs from the bf16 cache: {err}")
    return err


def mmu_frame(model, codes):
    """The (1, MMU_FRAME) frame `serve_mmu` builds for MMU_QUESTION about an
    image of MAGVIT-v2 `codes` (1,024), its answer positions [MASK]."""
    import torch

    from mmada_tpu_torch.prompting.universal import ByteTokenizer, SpecialIds

    vocab = model.vocab
    sp = SpecialIds.from_vocab(vocab)
    codes = (codes + vocab.image_offset).tolist()
    question = ByteTokenizer()([MMU_QUESTION])["input_ids"][0]
    ids = [sp.mmu, sp.soi, *codes, sp.eoi, sp.bos, *question]
    ids += [vocab.mask_token_id] * MMU_SETTINGS["max_new_tokens"]
    if len(ids) != MMU_FRAME:
        raise AssertionError(f"mmu frame {len(ids)} tokens, want {MMU_FRAME}")
    return torch.tensor([ids], device="cuda")


def _same(a, b) -> bool:
    """Two requests' answers (a tensor or a list of them) equal bit for bit."""
    import torch

    if isinstance(a, list):
        return all(torch.equal(x, y) for x, y in zip(a, b))
    return bool(torch.equal(a, b))


def cached_phase(model, vq, vq_cfg, image, reset_counts, counts) -> dict:
    """The block-KV cached decode on the 8B through the entry points, each
    request beside the exact sampler on the same batch (run just before it):
    text (the bf16 cache, int8, a refresh every CACHED_REFRESH steps, tau
    1.5 bit for bit tau off), MMU (the cache, the fast_stack preset), t2i
    (the cache, its codes decoded by MAGVIT-v2) and the 8,192-token request
    (B4 for the capture, B1 for the steps). Each path's launches are
    asserted exactly, B1's split into square captures and rectangular steps;
    a fresh capture's step is held against the exact forward. Returns B1's
    and B4's launches by path, and the times."""
    import torch

    from mmada_tpu_torch.core.vocab import MMADA_8B
    from mmada_tpu_torch.entry import decode_images, serve_mmu, serve_t2i, serve_text, text_frames
    from mmada_tpu_torch.models import magvit2

    n = model.cfg.n_layers
    out = dict(b1=0, b4=0, rect=collections.Counter(), times={})

    def request(phase, fn, square, rect, exact_s=None, rect_steps=None, want=None):
        """`cached_request`, B1's and B4's launches added up, the
        rectangular ones by shape, as recorded."""
        result, seconds, launched, shapes = cached_request(
            phase, fn, reset_counts, counts, square, rect, exact_s, rect_steps, want)
        out["b1"] += launched[0][0]
        out["b4"] += launched[2][0]
        rect_shapes = [s for s in shapes["b1"] if s[1] < s[2]]
        out["rect"].update(rect_shapes)
        out["times"][phase] = seconds
        return result, seconds, len(rect_shapes)

    # text: 3 requests in one batch, 4 blocks of 8 steps
    spb = TEXT_SETTINGS["steps"] * TEXT_SETTINGS["block_length"] // TEXT_SETTINGS["gen_length"]
    blocks = TEXT_SETTINGS["gen_length"] // TEXT_SETTINGS["block_length"]
    steps = TEXT_SETTINGS["steps"]
    exact, exact_s, _ = request("exact text", lambda: serve_text(model, TEXT_PROMPTS,
                                                              **TEXT_SETTINGS), n * steps, 0)
    runs = {}
    for tag, knobs, captures in (
            ("cached text", dict(block_kv_cache=True), blocks),
            ("cached text int8", dict(block_kv_cache="int8"), blocks),
            (f"cached text refresh {CACHED_REFRESH}",
             dict(block_kv_cache=True, cache_refresh_every=CACHED_REFRESH),
             blocks * (1 + (spb - 1) // CACHED_REFRESH)),
            ("cached text tau 1.5", dict(block_kv_cache=True, parallel_threshold=1.5), blocks)):
        runs[tag], _, _ = request(tag, lambda: serve_text(model, TEXT_PROMPTS, **knobs,
                                                       **TEXT_SETTINGS),
                               n * captures, n * steps, exact_s)
        check_answers(runs[tag], MMADA_8B)
    agree = [float(torch.cat([(a == e).float() for a, e in zip(runs[tag], exact)]).mean())
             for tag in runs]
    same = all(torch.equal(a, b) for a, b in zip(runs["cached text tau 1.5"],
                                                 runs["cached text"]))
    log("cached", f"text: tokens equal to the exact sampler's {dict(zip(runs, agree))}; tau 1.5 "
        f"bit for bit tau off: {same}")
    if not same:
        raise AssertionError("tau 1.5 (which never fires) changed the cached text answers")
    frames = torch.tensor(text_frames(model, TEXT_PROMPTS), device="cuda")
    p = frames.shape[1]
    frame = torch.cat([frames, torch.full((len(TEXT_PROMPTS), TEXT_SETTINGS["gen_length"]),
                                          MMADA_8B.mask_token_id, device="cuda")], dim=1)
    out["fresh"] = {"text": check_fresh_step(model, frame, p, TEXT_SETTINGS["block_length"],
                                             "text")}

    # MMU at the bench's light point: one block of 64 steps
    mmu = dict(MMU_SETTINGS)
    _, exact_s, _ = request("exact mmu", lambda: serve_mmu(
        model, vq, vq_cfg, image, [MMU_QUESTION], **mmu), n * mmu["steps"], 0)
    answer, _, _ = request("cached mmu", lambda: serve_mmu(
        model, vq, vq_cfg, image, [MMU_QUESTION], block_kv_cache=True, **mmu),
        n, n * mmu["steps"], exact_s)
    check_answer_ids(answer[0], mmu["max_new_tokens"], MMADA_8B)
    answer, _, rect = request("mmu fast_stack", lambda: serve_mmu(
        model, vq, vq_cfg, image, [MMU_QUESTION], **MMU_FAST_STACK, **mmu),
        n, n, exact_s, rect_steps=mmu["steps"])
    check_answer_ids(answer[0], mmu["max_new_tokens"], MMADA_8B)
    log("cached", f"mmu fast_stack {MMU_FAST_STACK}: {rect // n} steps of {mmu['steps']}")
    frame = mmu_frame(model, magvit2.get_code(vq, vq_cfg, image)[0])
    p = MMU_FRAME - mmu["max_new_tokens"]
    out["fresh"]["mmu"] = check_fresh_step(model, frame, p, mmu["block_length"], "mmu")

    # t2i: 2 requests under CFG, 12 timesteps: one capture, 12 span steps
    t2i_steps = T2I_SETTINGS["timesteps"]
    exact_codes, exact_s, _ = request("exact t2i", lambda: serve_t2i(model, T2I_PROMPTS,
                                                                  **T2I_SETTINGS),
                                   n * t2i_steps, 0)
    codes, _, _ = request("cached t2i", lambda: serve_t2i(model, T2I_PROMPTS, block_kv_cache=True,
                                                       **T2I_SETTINGS),
                       n, n * t2i_steps, exact_s)
    check_codes(codes, MMADA_8B)
    images = decode_images(vq, vq_cfg, codes)
    if images.shape != (len(T2I_PROMPTS), VQ_RESOLUTION, VQ_RESOLUTION, 3):
        raise AssertionError(f"cached t2i images {tuple(images.shape)}")
    n_img = T2I_SETTINGS["num_vq_tokens"]
    log("cached", f"t2i: {codes.unique().numel()} distinct codes, "
        f"{float((codes == exact_codes).float().mean()):.4f} equal to the exact sampler's; "
        f"decoded to {tuple(images.shape)} uint8 images")

    # the 8,192-token request: B4 for the one capture, B1 for the 8 steps
    long_prompt = ("The quick brown fox jumps over the lazy dog. " * 200)[:LONG_PROMPT_BYTES]
    long_steps = LONG_TEXT_SETTINGS["steps"]
    _, exact_s, _ = request("exact long text", lambda: serve_text(model, [long_prompt],
                                                               **LONG_TEXT_SETTINGS),
                         0, 0, want={"long": (n * long_steps, 0, 0)})
    answer, _, _ = request("cached long text", lambda: serve_text(
        model, [long_prompt], block_kv_cache=True, **LONG_TEXT_SETTINGS), 0, n * long_steps,
        exact_s, want={"one-pass": (n * long_steps, 0, 0), "long": (n, 0, 0)})
    check_answer_ids(answer[0], LONG_TEXT_SETTINGS["gen_length"], MMADA_8B)
    return out


def pixel_train_flows(vq, vq_cfg):
    """STAGE1's first batch with its t2i and mmu images as 256-px pixels
    (configs/mmada_pretraining_stage1.yaml:22,41), and the same batch with
    the codes MAGVIT-v2 gives those pixels."""
    from mmada_tpu_torch.models import magvit2

    flows = train_flows(0)
    coded = {k: dict(v) for k, v in flows.items()}
    for i, key in enumerate(("t2i_flow", "mmu_flow")):
        n = len(flows[key]["input_ids"])
        images = seeded_images(n, VQ_RESOLUTION // 2, seed=10 + i)
        flows[key] = {"input_ids": flows[key]["input_ids"], "images": images.cpu().numpy()}
        coded[key]["image_codes"] = magvit2.get_code(vq, vq_cfg, images).cpu().numpy()
        if coded[key]["image_codes"].shape != (n, TRAIN_IMAGE_TOKENS):
            raise AssertionError(f"{key}: {coded[key]['image_codes'].shape} codes")
    return flows, coded


def check_answer_ids(ans, length, vocab) -> None:
    if ans.shape != (length,):
        raise AssertionError(f"answer shape {tuple(ans.shape)}, want ({length},)")
    if (ans == vocab.mask_token_id).any():
        raise AssertionError("answer still holds [MASK] tokens")
    if not ((ans >= 0) & (ans < vocab.total_vocab_size)).all():
        raise AssertionError("answer ids out of the fused vocab")


def check_codes(codes, vocab) -> None:
    if codes.shape != (len(T2I_PROMPTS), T2I_SETTINGS["num_vq_tokens"]):
        raise AssertionError(f"t2i codes shape {tuple(codes.shape)}")
    if not ((codes >= 0) & (codes < vocab.image_codebook_size)).all():
        raise AssertionError("t2i codes outside [0, 8192)")


def train_phase(phase, model, steps, train, reset_counts, counts, plan=STAGE1, flows=None,
                **train_kw):
    """`steps` train steps of `model` through `entry.train` on batches of
    `plan` (STAGE1 or LONG), made from seeds unless `flows` are given, with
    the counters from 0; checks the metrics and the trained frame, and
    returns (trainer, counts())."""
    import torch

    flows = flows or [train_flows(seed, plan) for seed in range(steps)]
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t = time.perf_counter()
    trainer = train(model, flows, steps=steps, log_every=1, **plan["settings"], **train_kw)
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


def traced_step(trainer, reset_counts, counts, smi) -> tuple:
    """Phase 8's profiled step: one more stage-1 step of `trainer` under
    `utils/profiling.trace` with the step inside an `annotate` span; the
    Chrome trace must hold the card's kernels (B1, dq, dkv among them)
    inside the span. Prints the step's model-FLOP share of 989 TFLOP/s
    (`utils/flops.train_step_flops`, full remat) at the steady step's time,
    on a line of its own beside the card's name and power limit. Returns
    the step's (B1, dq, dkv) launches."""
    import torch

    from mmada_tpu_torch.utils import flops, profiling

    batch = trainer.prepare_batch(train_flows(TRAIN_STEPS))
    generator = torch.Generator("cuda").manual_seed(TRAIN_STEPS)
    logdir = tempfile.mkdtemp(prefix="smoke_trace_")
    reset_counts()
    t0 = time.perf_counter()
    try:
        with profiling.trace(logdir):
            with profiling.annotate("stage1_step"):
                with profiling.step_timer() as timed:
                    trainer.state, metrics = trainer.train_step(trainer.state, batch, generator)
                    loss = float(metrics["loss"])
        window_s = time.perf_counter() - t0
        t1 = time.perf_counter()
        with open(os.path.join(logdir, "trace.json")) as f:
            events = json.load(f)["traceEvents"]
        parse_s = time.perf_counter() - t1
        trace_mb = os.path.getsize(os.path.join(logdir, "trace.json")) / 2**20
    finally:
        shutil.rmtree(logdir, ignore_errors=True)
    launched = counts()
    n = trainer.model.cfg.n_layers
    expect_launches("train traced", launched, {"one-pass": (2 * n, n, n)})
    spans = [(e["ts"], e["ts"] + e["dur"]) for e in events
             if e.get("name") == "stage1_step" and "dur" in e]
    kernels = [e for e in events if e.get("cat") == "kernel" and "dur" in e
               and any(lo <= e["ts"] and e["ts"] + e["dur"] <= hi for lo, hi in spans)]
    names = collections.Counter(e["name"] for e in kernels)
    attn = sum(c for k, c in names.items() if "attn" in k or "flash" in k)
    device_ms = sum(e["dur"] for e in kernels) / 1e3
    log("train traced", f"one stage-1 step under profiling.trace: {timed['seconds']:.3f}s, loss "
        f"{loss:.4f}; the window with the trace's export {window_s:.2f}s, {trace_mb:.1f} MB "
        f"read back in {parse_s:.2f}s ({len(events)} events); span 'stage1_step' "
        f"({len(spans)} events) holds {len(kernels)} CUDA kernels ({device_ms:.1f} ms of device "
        f"time), {attn} of them attention's; the most launched "
        f"{[(k[:48], c) for k, c in names.most_common(3)]}")
    if not spans or not kernels or attn < 4 * n:
        raise AssertionError(f"the trace's span holds {len(kernels)} kernels ({attn} attention)")
    sc = trainer.step_cfg
    rows = sc.batch_size_t2i + sc.batch_size_lm + sc.batch_size_mmu
    frame = next(t for k, t in batch.items() if k.endswith("input_ids")).shape[1]
    useful, hardware = flops.train_step_flops(trainer.model.cfg, rows, frame, remat="full")
    step_s = min(h["seconds"] for h in trainer.history)
    share = useful / step_s / flops.H100_BF16_PEAK
    print(f"train_step_flops: {rows} x {frame} tokens, {useful / 1e12:.1f} TFLOP useful "
          f"({hardware / 1e12:.1f} with full remat) in the steady step of {step_s:.3f}s: "
          f"{share:.1%} of {flops.H100_BF16_PEAK / 1e12:.0f} TFLOP/s (hardware "
          f"{hardware / step_s / flops.H100_BF16_PEAK:.1%}) | {smi}", flush=True)
    return launched[0]


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


def launch_delta(before, after):
    """counts() after minus counts() before, kind by kind."""
    return tuple(tuple(a - b for a, b in zip(x, y)) for x, y in zip(after, before))


def counted_hooks(trainer, counts) -> list:
    """Wrap `trainer.run_validation_hooks` so that each cadence records its
    seconds and the launches its generations made; returns that list."""
    import torch

    spent, inner = [], trainer.run_validation_hooks

    def run(raw=None):
        before = counts()
        t = time.perf_counter()
        inner(raw)
        torch.cuda.synchronize()
        spent.append((time.perf_counter() - t, launch_delta(before, counts())))

    trainer.run_validation_hooks = run
    return spent


def hook_files(out: str, step: int) -> list:
    path = os.path.join(out, "validation", f"step_{step}")
    return sorted(os.listdir(path)) if os.path.isdir(path) else []


HOOK_FILES = sorted(["chat.jsonl", "mmu_answers.jsonl", "t2i_prompts.jsonl"]
                    + [f"t2i_{i:03d}.png" for i in range(4)]
                    + [f"pred_{i:03d}_{k}.png" for i in range(2)
                       for k in ("model", "original", "recon")])


def fit_logged(phase, trainer, loader, counts, seed):
    """`trainer.fit(loader)` with the launches, the hooks' share of them,
    the host RSS growth and the peak device memory; logs each step's line.
    Returns (launches of the train steps, hooks' launches, fit seconds,
    RSS growth, peak GiB)."""
    import torch

    hooks = counted_hooks(trainer, counts)
    torch.cuda.reset_peak_memory_stats()
    before = counts()
    with rss_growth() as rss:
        t = time.perf_counter()
        trainer.fit(loader, rng_seed=seed)
        torch.cuda.synchronize()
        fit_s = time.perf_counter() - t
    launched = launch_delta(before, counts())
    hooked = tuple(tuple(sum(h[1][k][i] for h in hooks) for i in range(len(launched[k])))
                   for k in range(len(launched)))
    peak = torch.cuda.max_memory_allocated() / 2**30
    for h in trainer.history:
        log(phase, f"step {h['step']}: loss {h['loss']:.4f} (t2i {h['loss_t2i']:.4f} lm "
            f"{h['loss_lm']:.4f} mmu {h['loss_mmu']:.4f}) grad_norm {h['grad_norm']:.4f}; "
            f"{h['seconds']:.3f}s, {h['samples_per_sec']:.3f} samples/s, data time "
            f"{h['data_time']:.3f}s against batch time {h['batch_time']:.3f}s (meters' means)")
        if not all(map(math.isfinite, h.values())) or h["skipped_nonfinite"]:
            raise AssertionError(f"{phase}: bad train step {h}")
    for seconds, delta in hooks:
        log(phase, f"validation hooks at a cadence: {seconds:.2f}s, launches {delta}")
    for s in trainer.saves:
        log(phase, f"save at step {s['step']} ({'waited' if s['wait'] else 'async'}): "
            f"{s['bytes'] / 1e9:.3f} GB, host snapshot {s['snapshot_s']:.2f}s, write "
            f"{s['write_s']:.2f}s ({s['bytes'] / s['write_s'] / 1e9:.2f} GB/s, fsync'd)")
    log(phase, f"fit {fit_s:.2f}s; host RSS growth {rss['growth'] / 1e9:.3f} GB (before "
        f"{rss['before'] / 1e9:.3f}); peak {peak:.2f} GiB allocated; hook failures "
        f"{trainer.hook_failures}")
    if trainer.hook_failures:
        raise AssertionError(f"{phase}: validation hooks failed: {trainer.hook_failures}")
    return launch_delta(hooked, launched), hooked, fit_s, rss["growth"], peak


def differing_leaves(a: dict, b: dict) -> list:
    """Keys of two flattened states whose tensors differ in dtype, shape or
    bits, and the keys only one holds."""
    import torch

    diff = sorted(set(a) ^ set(b))
    for k in set(a) & set(b):
        x, y = a[k], b[k].to(a[k].device)
        if x.dtype != y.dtype or not torch.equal(x, y):
            diff.append(k)
    return diff


def _clone(tree, grad=False):
    if isinstance(tree, dict):
        return {k: _clone(v, grad) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_clone(v, grad) for v in tree]
    out = tree.detach().clone()
    return out.requires_grad_() if grad else out


def dots_against_full(trainer, loader) -> dict:
    """The resolved `dots` step against a `full` step from copies of the
    same state, on one batch with the same generators: their losses (bit for
    bit: the forwards are the same), and each mode's step time, in turns
    (full, dots, dots, full; the first step of each turn left out)."""
    import torch

    from mmada_tpu_torch.training.train_step import TrainState, make_train_step

    batch = trainer.prepare_batch(next(iter(loader)))
    base = trainer.state
    losses, times = {}, {"full": [], "dots": []}
    for mode in ("full", "dots", "dots", "full"):
        step = make_train_step(dataclasses.replace(trainer.model, remat=mode),
                               trainer.optimizer, trainer.step_cfg)
        state = TrainState(params=_clone(base.params, grad=True),
                           opt_state=_clone(base.opt_state), step=base.step.clone())
        run = []
        for i in range(PROXY_TIMED_STEPS):
            torch.cuda.synchronize()
            t = time.perf_counter()
            state, metrics = step(state, batch, torch.Generator("cuda").manual_seed(i))
            run.append(metrics["loss"].clone())
            torch.cuda.synchronize()
            if i:   # the first step of a turn warms the allocator
                times[mode].append(time.perf_counter() - t)
        losses.setdefault(mode, run)
        del state, step
    same = all(torch.equal(a, b) for a, b in zip(losses["full"], losses["dots"]))
    return {"losses": {m: [float(x) for x in v] for m, v in losses.items()},
            "first_equal": torch.equal(losses["full"][0], losses["dots"][0]),
            "all_equal": same,
            "ms": {m: 1e3 * sorted(v)[len(v) // 2] for m, v in times.items()}}


def proxy_cli_phase(reset_counts, counts) -> dict:
    """Phase 10a: `train_torch` on configs/proxy_160m.yaml (PROXY_CLI): 4
    steps with saves and hooks at 2 and 4, the EMA, `auto` resolving to
    dots; a second invocation resuming every leaf of the state and the EMA
    at step 4; the dots step against a full step; a third run stopped by
    a SIGTERM during step 2, leaving a complete checkpoint-2."""
    import signal

    import torch

    import train_torch
    from mmada_tpu_torch.checkpoints import manager

    n = PROXY_LAYERS
    root = tempfile.mkdtemp(prefix="mmada_proxy_")
    atexit.register(shutil.rmtree, root, True)
    out = os.path.join(root, "run")
    t = time.perf_counter()
    trainer, loader = train_torch.setup(train_torch.read_config(
        PROXY_CLI + [f"experiment.output_dir={out}"]))
    log("proxy cli", f"setup (random 160M + MAGVIT-v2, pattern bank at 512 px) "
        f"{time.perf_counter() - t:.2f}s")
    reset_counts()
    train, hooked, fit_s, _, _ = fit_logged("proxy cli", trainer, loader, counts, 0)
    mode, info = trainer.remat_resolved
    log("proxy cli", f"gradient_checkpointing=auto -> {mode}: {info}")
    if mode != "dots":
        raise AssertionError(f"auto resolved to {mode} on the proxy: {info}")
    steps = trainer.max_train_steps
    expect_launches("proxy cli", train, {"one-pass": (steps * 2 * n + 1, steps * n, steps * n)})
    expect_launches("proxy cli hooks", hooked, {"one-pass": (hooked[0][0], 0, 0)})
    for step in (2, 4):
        if hook_files(out, step) != HOOK_FILES:
            raise AssertionError(f"proxy hooks at step {step} wrote {hook_files(out, step)}")
    kept = [s for s, _ in manager.list_checkpoints(out)]
    log("proxy cli", f"checkpoints kept {kept} (limit 1: step 2's rotated out); saves "
        f"{[(s['step'], s['wait']) for s in trainer.saves]}")
    if kept != [4] or [s["step"] for s in trainer.saves] != [2, 4]:
        raise AssertionError(f"proxy checkpoints {kept}, saves {trainer.saves}")

    # a second invocation resumes the state and the EMA at step 4
    t = time.perf_counter()
    resumed, loader2 = train_torch.setup(train_torch.read_config(
        PROXY_CLI + [f"experiment.output_dir={out}", "experiment.resume_from_checkpoint=latest"]))
    diff = differing_leaves(manager.flatten(resumed._payload()),
                            manager.flatten(trainer._payload()))
    n_leaves = len(manager.flatten(resumed._payload()))
    log("proxy cli", f"resumed at step {resumed.global_step} in {time.perf_counter() - t:.2f}s "
        f"(setup included): {n_leaves} leaves (state, moments, EMA shadow and step), "
        f"{len(diff)} differ")
    if resumed.global_step != 4 or diff or resumed.ema_state is None:
        raise AssertionError(f"proxy resume: step {resumed.global_step}, differing {diff[:8]}")
    resumed.fit(loader2)
    if resumed.history:
        raise AssertionError("a run resumed at max_train_steps took steps")
    template = _clone(resumed._payload())
    nbytes = sum(t.numel() * t.element_size() for t in manager.flatten(template).values())
    t = time.perf_counter()
    manager.CheckpointManager(out).restore(template)
    torch.cuda.synchronize()
    restore_s = time.perf_counter() - t
    log("proxy cli", f"restore of checkpoint-4 alone: {nbytes / 1e9:.3f} GB in {restore_s:.2f}s "
        f"({nbytes / restore_s / 1e9:.2f} GB/s; the page cache warm from the write)")
    del resumed, loader2, template

    cmp = dots_against_full(trainer, loader)
    log("proxy cli", f"dots against full from one state, one batch: losses {cmp['losses']}; "
        f"first equal {cmp['first_equal']}, all equal {cmp['all_equal']}; step ms (median of "
        f"{2 * (PROXY_TIMED_STEPS - 1)}, in turns) full {cmp['ms']['full']:.1f}, dots "
        f"{cmp['ms']['dots']:.1f} ({cmp['ms']['full'] / cmp['ms']['dots'] - 1:+.1%} rate)")
    if not cmp["first_equal"]:
        raise AssertionError(f"the dots step's loss is not the full step's: {cmp['losses']}")
    del trainer, loader
    free_memory()

    # a third run, stopped by a SIGTERM during step 2
    stop_dir = os.path.join(root, "sigterm")
    stopped, loader3 = train_torch.setup(train_torch.read_config(
        PROXY_CLI + [f"experiment.output_dir={stop_dir}", "experiment.save_every=0",
                     "experiment.generate_every=0"]))
    previous = signal.getsignal(signal.SIGTERM)
    prepare, calls = stopped.prepare_batch, []

    def prepare_and_signal(raw):
        calls.append(1)
        if len(calls) == 2:
            os.kill(os.getpid(), signal.SIGTERM)
        return prepare(raw)

    stopped.prepare_batch = prepare_and_signal
    sig_train, _, _, _, _ = fit_logged("proxy sigterm", stopped, loader3, counts, 0)
    kept = manager.list_checkpoints(stop_dir)
    template = _clone(stopped._payload())
    manager.CheckpointManager(stop_dir).restore(template)
    diff = differing_leaves(manager.flatten(template), manager.flatten(stopped._payload()))
    log("proxy sigterm", f"stopped at step {stopped.global_step}; complete checkpoints "
        f"{[s for s, _ in kept]} ({'waited' if stopped.saves[-1]['wait'] else 'async'}), "
        f"{len(diff)} leaves differ from the state; the smoke's SIGTERM handler back: "
        f"{signal.getsignal(signal.SIGTERM) is previous}")
    if (stopped.global_step != 2 or [s for s, _ in kept] != [2] or diff
            or signal.getsignal(signal.SIGTERM) is not previous):
        raise AssertionError("the SIGTERM run did not save checkpoint-2 and stop")
    expect_launches("proxy sigterm", sig_train, {"one-pass": (2 * 2 * n + 1, 2 * n, 2 * n)})
    del stopped, loader3, template
    free_memory()
    shutil.rmtree(root, ignore_errors=True)
    total = [a + b + c for a, b, c in zip(train[0], hooked[0], sig_train[0])]
    return {"b1": total[0], "dq": total[1], "dkv": total[2], "fit_s": fit_s,
            "dots_ms": cmp["ms"]["dots"], "full_ms": cmp["ms"]["full"]}


def write_stage1_data(root: str) -> dict:
    """Shards of the stage-1 readers, written from seeds: an ImageNet-layout
    folder of PNGs (non-square, so the transform resizes and crops) with a
    label mapping, webdataset tars of PNG + caption samples (mmu), and a
    RefinedWeb-style parquet file (lm). Images through `train_torch.write_png`
    (PIL; the smoke imports none itself)."""
    import numpy as np
    import pyarrow as pa
    import pyarrow.parquet as pq

    import train_torch

    d = STAGE1_DATA
    rng = np.random.default_rng(0)

    def image(h, w):
        yy, xx = np.mgrid[0:h, 0:w]
        base = rng.integers(0, 256, 3)
        arr = (base + 40 * np.sin(xx[..., None] / rng.uniform(3, 30)) +
               40 * np.cos(yy[..., None] / rng.uniform(3, 30)))
        return np.clip(arr, 0, 255).astype(np.uint8)

    imagenet = os.path.join(root, "imagenet")
    with open(os.path.join(root, "labels.txt"), "w") as f:
        for c in range(d["classes"]):
            cls = f"n{c:08d}"
            f.write(f"{cls} class {c} of the smoke\n")
            os.makedirs(os.path.join(imagenet, cls))
            for i in range(d["per_class"]):
                train_torch.write_png(os.path.join(imagenet, cls, f"{i}.png"), image(256, 320))
    png = os.path.join(root, "tmp.png")
    for s in range(d["tars"]):
        with tarfile.open(os.path.join(root, f"mmu-{s:05d}.tar"), "w") as tar:
            for i in range(d["per_tar"]):
                train_torch.write_png(png, image(300, 260))
                with open(png, "rb") as f:
                    pixels = f.read()
                for name, data in ((f"{s:05d}{i:04d}.png", pixels),
                                   (f"{s:05d}{i:04d}.txt", f"a picture {s} {i}".encode())):
                    info = tarfile.TarInfo(name)
                    info.size = len(data)
                    tar.addfile(info, io.BytesIO(data))
    os.remove(png)
    words = ["the", "river", "stone", "cloud", "lantern", "engine", "garden", "of", "a"]
    docs = [" ".join(rng.choice(words, int(rng.integers(20, 400)))) for _ in range(d["docs"])]
    pq.write_table(pa.table({"content": docs}), os.path.join(root, "refinedweb.parquet"))
    return {"t2i": imagenet, "labels": os.path.join(root, "labels.txt"),
            "mmu": os.path.join(root, f"mmu-{{00000..{d['tars'] - 1:05d}}}.tar"),
            "lm": os.path.join(root, "*.parquet")}


class _Records(logging.Handler):
    def __init__(self):
        super().__init__()
        self.messages = []

    def emit(self, record):
        self.messages.append(record.getMessage())


def stage1_cli_phase(ckpt_dir: str, vq_dir: str, reset_counts, counts) -> dict:
    """Phase 10b: `train_torch` on configs/mmada_pretraining_stage1.yaml
    (STAGE1_CLI) with the 8B and MAGVIT-v2 of phase 7b'' and data through
    the real readers (the tars by the native streamer): 3 steps, the hooks
    at step 2, `auto` resolved by the measured bytes; no save (STAGE1_CLI's
    comment says why)."""
    import torch

    import train_torch

    n = 32
    data = tempfile.mkdtemp(prefix="mmada_stage1_data_")
    out = tempfile.mkdtemp(prefix="mmada_stage1_out_")
    for path in (data, out):
        atexit.register(shutil.rmtree, path, True)
    t = time.perf_counter()
    shards = write_stage1_data(data)
    log("stage1 cli", f"wrote the shards in {time.perf_counter() - t:.2f}s: {shards}")
    with open("/proc/meminfo") as f:
        avail = next(int(ln.split()[1]) * 1024 for ln in f if ln.startswith("MemAvailable"))
    log("stage1 cli", f"{shutil.disk_usage(out).free / 1e9:.1f} GB free under {out}; host "
        f"MemAvailable {avail / 1e9:.1f} GB; {torch.cuda.memory_allocated() / 2**30:.2f} GiB "
        "allocated on the card before the phase; fixed choice: no save of the 8B's state "
        "(the machine's 45 GiB of disk writes a run; save and resume are checked in 10a)")
    argv = STAGE1_CLI + [
        f"model.mmada.pretrained_model_path={ckpt_dir}", f"model.vq_model.vq_model_path={vq_dir}",
        f"dataset.params.train_t2i_shards_path_or_url={shards['t2i']}",
        f"dataset.params.imagenet_label_mapping={shards['labels']}",
        f"dataset.params.train_mmu_shards_path_or_url={shards['mmu']}",
        f"dataset.params.train_lm_shards_path_or_url={shards['lm']}",
        f"experiment.output_dir={out}"]
    readers = _Records()
    wds_log = logging.getLogger("mmada_tpu_torch.data.webdataset")
    wds_log.addHandler(readers)
    wds_log.setLevel(logging.INFO)
    t = time.perf_counter()
    trainer, loader = train_torch.setup(train_torch.read_config(argv))
    log("stage1 cli", f"setup (the 8B and MAGVIT-v2 loaded, AdamW moments made) "
        f"{time.perf_counter() - t:.2f}s; {torch.cuda.memory_allocated() / 2**30:.2f} GiB "
        "allocated")
    reset_counts()
    train, hooked, fit_s, rss, peak = fit_logged("stage1 cli", trainer, loader, counts, 10086)
    wds_log.removeHandler(readers)
    mode, info = trainer.remat_resolved
    log("stage1 cli", f"gradient_checkpointing=auto -> {mode}: dots would keep "
        f"{info['dots_layer_bytes'] / 1e6:.1f} MB a layer, {info['dots_saved_bytes'] / 1e9:.2f} "
        f"GB in all, beside {info['allocated_bytes'] / 1e9:.2f} GB allocated and "
        f"{info['grads_bytes'] / 1e9:.2f} GB of gradients: {info['total_bytes'] / 1e9:.2f} GB "
        f"against 0.92 x {info['budget_bytes'] / 1e9:.2f} GB ({info})")
    log("stage1 cli", f"tar readers: {readers.messages}")
    if not readers.messages or not all("native" in m for m in readers.messages):
        raise AssertionError(f"the mmu reader did not take the native tar streamer: "
                             f"{readers.messages}")
    expect_launches("stage1 cli", train, {"one-pass": (
        STAGE1_STEPS * 2 * n + 1, STAGE1_STEPS * n, STAGE1_STEPS * n)})
    expect_launches("stage1 cli hooks", hooked, {"one-pass": (hooked[0][0], 0, 0)})
    if hook_files(out, 2) != HOOK_FILES:
        raise AssertionError(f"stage-1 hooks wrote {hook_files(out, 2)}")
    if trainer.saves or len(trainer.history) != STAGE1_STEPS:
        raise AssertionError(f"stage-1: saves {trainer.saves}, {len(trainer.history)} steps")
    frames = [t for k, t in trainer.prepare_batch(next(iter(loader))).items()
              if k.endswith("input_ids")]
    shape = (sum(t.shape[0] for t in frames), {t.shape[1] for t in frames})
    log("stage1 cli", f"(rows, frame lengths) {shape}")
    if shape != (TRAIN_ROWS, {TRAIN_FRAME}):
        raise AssertionError(f"the stage-1 batches are {shape}, the kernels were checked at "
                             f"({TRAIN_ROWS}, {TRAIN_FRAME})")
    history = trainer.history
    del trainer, loader, frames
    free_memory()
    shutil.rmtree(out, ignore_errors=True)
    shutil.rmtree(data, ignore_errors=True)
    total = [a + b for a, b in zip(train[0], hooked[0])]
    return {"b1": total[0], "dq": total[1], "dkv": total[2], "fit_s": fit_s, "rss": rss,
            "peak": peak, "history": history, "remat": (mode, info)}


def engine_phase(model, vq, vq_cfg, image, quantize, reset_counts, counts) -> dict:
    """The serving engine on the 8B (phase 7d); every answer held bit for
    bit against the model's own call on the same batch (or the solo run of a
    request's seed). B1's and B6's launches are read around every call, the
    references' included, and each held against the schedule. Returns
    their totals and the numbers PERF.md reports."""
    import numpy as np
    import torch

    from mmada_tpu_torch.core.vocab import MMADA_8B
    from mmada_tpu_torch.entry import serve_text, text_frames
    from mmada_tpu_torch.models import magvit2
    from mmada_tpu_torch.serve import engine as E
    from mmada_tpu_torch.utils.flops import forward_matmul_flops_per_token

    n, d, f, v = (model.cfg.n_layers, model.cfg.d_model, model.cfg.hidden_size,
                  model.cfg.effective_vocab_size)
    out = dict(b1=0, b6=0)
    image_codes = magvit2.get_code(vq, vq_cfg, image)[0]
    frames = text_frames(model, ENGINE_PROMPTS)
    if len({len(x) for x in frames}) != 1:
        raise AssertionError("the engine phase's prompts must have one frame length")
    settings = E.TextSettings(**TEXT_SETTINGS)
    prompts = torch.tensor(frames, device="cuda")

    def sync():
        torch.cuda.synchronize()
        return time.perf_counter()

    def tally(launched):
        out["b1"] += launched[0][0]
        out["b6"] += launched[4][0]
        return launched

    def counted(phase, fn, b1, b6=0):
        """`fn()`, with B1's and B6's launches around it read, held against
        the schedule (`b1`, `b6`) and added to the totals."""
        reset_counts()
        result = fn()
        expect_launches(phase, tally(counts()), {"one-pass": (b1, 0, 0), "int4": (b6,)})
        return result

    def released(eng, submit):
        """Submit while the dispatcher is held, release, wait: (results,
        seconds from the release, counts(), shapes); the launches are added
        to the totals."""
        eng.pause()
        futs = submit()
        reset_counts()
        with recording_shapes() as shapes:
            t = sync()
            eng.resume()
            results = [fut.result(600) for fut in futs]
            seconds = sync() - t
        return results, seconds, tally(counts()), shapes

    eng = E.ServingEngine(model, max_wait_ms=1.0).start()
    try:
        # text: one batch of four against model.generate on the same batch;
        # released twice (the first call at a new batch height pays cuBLAS's
        # first use of its GEMMs), the second timed, both equal
        steps = TEXT_SETTINGS["steps"]
        warm, warm_s, launched, _ = released(
            eng, lambda: [eng.submit_text(np.asarray(x), settings) for x in frames])
        expect_launches("engine text, first release", launched, {"one-pass": (n * steps, 0, 0)})
        got, batch_s, launched, shapes = released(
            eng, lambda: [eng.submit_text(np.asarray(x), settings) for x in frames])
        want = counted("engine text reference",
                       lambda: model.generate(prompts, **TEXT_SETTINGS).cpu().numpy(), n * steps)
        if not all(np.array_equal(a, b) for a, b in zip(warm, got)):
            raise AssertionError("the engine's text batch differs between two releases")
        same = all(np.array_equal(g, w) for g, w in zip(got, want))
        by_shape = collections.Counter(shapes["b1"])
        log("engine", f"text: 4 requests released together, twice: {eng.stats['batches']} "
            f"batches of {eng.stats['batched_requests'] // 2}, {warm_s:.2f}s then {batch_s:.2f}s, "
            f"{4 * TEXT_SETTINGS['gen_length'] / batch_s:.1f} tok/s; equal to model.generate on "
            f"the batch: {same}; B1 by (B, Lq, Lk) {dict(by_shape)}")
        if not same or eng.stats["batches"] != 2 or eng.stats["batched_requests"] != 8:
            raise AssertionError(f"engine text batch: equal {same}, stats {eng.stats}")
        if dict(by_shape) != {(4, TEXT_FRAME, TEXT_FRAME): n * steps}:
            raise AssertionError(f"engine text batch: B1 by shape {dict(by_shape)}")
        expect_launches("engine text", launched, {"one-pass": (n * steps, 0, 0)})
        for a in got:
            check_answer_ids(torch.as_tensor(a[len(frames[0]):]), TEXT_SETTINGS["gen_length"],
                             MMADA_8B)
        # the same four one at a time, and one request against entry.serve_text
        t = sync()
        serial = counted("engine text one at a time", lambda: [
            eng.submit_text(np.asarray(x), settings).result(600) for x in frames], 4 * n * steps)
        serial_s = sync() - t
        t = sync()
        direct = counted("entry.serve_text",
                         lambda: serve_text(model, ENGINE_PROMPTS[:1], **TEXT_SETTINGS)[0],
                         n * steps)
        direct_s = sync() - t
        serial_same = all(np.array_equal(a, b) for a, b in zip(serial, got))
        if not np.array_equal(serial[0][len(frames[0]):], direct.numpy()):
            raise AssertionError("one request through the engine differs from entry.serve_text")
        out.update(batch_tok_s=4 * TEXT_SETTINGS["gen_length"] / batch_s,
                   serial_tok_s=4 * TEXT_SETTINGS["gen_length"] / serial_s,
                   single_s=serial_s / 4, serve_text_s=direct_s)
        log("engine", f"text one at a time: {serial_s:.2f}s for 4 "
            f"({out['serial_tok_s']:.1f} tok/s; batched {out['batch_tok_s']:.1f} tok/s, "
            f"{out['batch_tok_s'] / out['serial_tok_s']:.2f}x); one request through the engine "
            f"{serial_s / 4:.3f}s against entry.serve_text {direct_s:.3f}s "
            f"({serial_s / 4 - direct_s:+.3f}s); answers equal the batch's: {serial_same}")
        if not serial_same:
            raise AssertionError("a text row's answer depends on what shares its batch")

        # per-row seeds: two stochastic requests share a batch
        hot = E.TextSettings(**dict(TEXT_SETTINGS, temperature=1.0))
        got, _, launched, _ = released(
            eng, lambda: [eng.submit_text(np.asarray(frames[0]), hot, seed=s) for s in (0, 1)])
        solos = counted("per-row seeds, solo references", lambda: [
            model.generate(prompts[:1], **dict(TEXT_SETTINGS, temperature=1.0),
                           generator=torch.Generator("cuda").manual_seed(s))[0].cpu().numpy()
            for s in (0, 1)], 2 * n * steps)
        pair = counted("per-row seeds, pair reference", lambda: model.generate(
            prompts[:1].repeat(2, 1), **dict(TEXT_SETTINGS, temperature=1.0),
            generator=[torch.Generator("cuda").manual_seed(s) for s in (0, 1)]), n * steps)
        direct_same = all(np.array_equal(g, w) for g, w in zip(got, pair.cpu().numpy()))
        seeds_same = [bool(np.array_equal(g, w)) for g, w in zip(got, solos)]
        log("engine", f"per-row seeds: 2 requests (T 1, seeds 0 and 1) in one batch; equal to "
            f"the direct call with row generators: {direct_same}; each equal to its solo run: "
            f"{seeds_same}; the two answers differ: {not np.array_equal(got[0], got[1])}")
        if launched[0][0] != n * steps or not direct_same or not all(seeds_same):
            raise AssertionError(f"per-row seeds: B1 {launched[0][0]}, direct {direct_same}, "
                                 f"solo {seeds_same}")

        # chunked MMU: alone, monolithic and chunked; then overtaken and joined
        mmu = E.TextSettings(gen_length=MMU_SETTINGS["max_new_tokens"],
                             steps=MMU_SETTINGS["steps"], block_length=MMU_SETTINGS["block_length"],
                             segment_steps=ENGINE_SEGMENT)
        frame = mmu_frame(model, image_codes)[0, :-MMU_SETTINGS["max_new_tokens"]].cpu().numpy()
        join_frame = mmu_question_frame(model, image_codes, ENGINE_JOIN_QUESTION)
        if len(join_frame) != len(frame):
            raise AssertionError("the joining MMU request needs the frame length of the first")
        # alone, in turns (monolithic, chunked, chunked, monolithic, ...):
        # the medians' difference over the chunks is a boundary's cost
        n_chunks = MMU_SETTINGS["steps"] // ENGINE_SEGMENT
        runs = {0: [], ENGINE_SEGMENT: []}
        answers = []
        c0 = eng.stats["chunks"]

        def alone():
            for seg in ENGINE_TIMING_ORDER:
                t = sync()
                answers.append(eng.submit_mmu(frame, dataclasses.replace(
                    mmu, segment_steps=seg)).result(600))
                runs[seg].append(sync() - t)

        counted("chunked mmu alone", alone, len(ENGINE_TIMING_ORDER) * n * MMU_SETTINGS["steps"])
        ref = counted("mmu reference", lambda: model.mmu_generate(
            torch.as_tensor(frame, device="cuda")[None], **MMU_SETTINGS)[0].cpu().numpy(),
            n * MMU_SETTINGS["steps"])
        mono_s, chunked_s = (float(np.median(runs[k])) for k in (0, ENGINE_SEGMENT))
        out["chunk_s"] = (chunked_s - mono_s) / n_chunks
        same = all(np.array_equal(a, ref) for a in answers)
        chunks = eng.stats["chunks"] - c0
        log("engine", f"mmu alone, {ENGINE_TIMING_PAIRS} of each in turns: monolithic "
            f"{[round(x, 3) for x in runs[0]]}s, chunked ({n_chunks} chunks of {ENGINE_SEGMENT} "
            f"steps) {[round(x, 3) for x in runs[ENGINE_SEGMENT]]}s: medians "
            f"{mono_s:.3f} / {chunked_s:.3f}s, {out['chunk_s'] * 1e3:+.1f} ms a chunk boundary; "
            f"every answer equal to mmu_generate: {same}")
        if chunks != n_chunks * ENGINE_TIMING_PAIRS:
            raise AssertionError(f"chunked mmu: chunks {chunks}")
        if not same:
            raise AssertionError("the chunked MMU request differs from the monolithic one")
        order = []
        short = E.TextSettings(**dict(ENGINE_SHORT, temperature=0.0))
        joins0 = eng.stats["stream_joins"]
        c0 = eng.stats["chunks"]
        reset_counts()
        heavy = eng.submit_mmu(frame, mmu)
        heavy.add_done_callback(lambda _: order.append("heavy"))
        while eng.stats["chunks"] < c0 + 1:
            time.sleep(0.001)
        quick = eng.submit_text(np.asarray(frames[0]), short)
        quick.add_done_callback(lambda _: order.append("short"))
        while eng.stats["chunks"] < c0 + 2:
            time.sleep(0.001)
        eng.pause()
        joined = eng.submit_mmu(join_frame, mmu)
        eng.resume()
        heavy_ids, joined_ids = heavy.result(600), joined.result(600)
        quick.result(600)
        # the stream's chunks run ENGINE_SEGMENT forwards each, whatever
        # rows they hold; the short request runs apart, unchunked
        stream_chunks = eng.stats["chunks"] - c0
        launched = tally(counts())
        expect_launches("mmu chunked with company", launched, {"one-pass": (
            n * (ENGINE_SEGMENT * stream_chunks + ENGINE_SHORT["steps"]), 0, 0)})
        joined_ref = counted("joined mmu reference", lambda: model.mmu_generate(
            torch.as_tensor(join_frame, device="cuda")[None], **MMU_SETTINGS)[0].cpu().numpy(),
            n * MMU_SETTINGS["steps"])
        joins = eng.stats["stream_joins"] - joins0
        heavy_same = bool(np.array_equal(heavy_ids, ref))
        joined_same = bool(np.array_equal(joined_ids, joined_ref))
        log("engine", f"mmu chunked with company: finished in the order {order}; stream joins "
            f"{joins}; the heavy request equal to mmu_generate: {heavy_same}, the joined one "
            f"to its solo run: {joined_same}; {stream_chunks} stream chunks, launches {launched}")
        if order[0] != "short" or joins != 1 or not heavy_same or not joined_same or \
                stream_chunks <= n_chunks:
            raise AssertionError(f"chunked mmu: order {order}, joins {joins}, heavy equal "
                                 f"{heavy_same}, joined equal {joined_same}")

        # t2i: windows of ENGINE_WINDOW steps, and a guidance interval
        t2i_out = []
        for prompt, seed, interval in ((T2I_PROMPTS[0], 0, (0.0, 1.0)),
                                       (T2I_PROMPTS[1], 1, (0.0, 1.0)),
                                       (T2I_PROMPTS[0], 2, ENGINE_INTERVAL)):
            ids, attn, uncond, uattn = t2i_request(prompt)
            s = E.T2ISettings(timesteps=T2I_SETTINGS["timesteps"],
                              guidance_scale=T2I_SETTINGS["guidance_scale"],
                              temperature=T2I_SETTINGS["temperature"],
                              num_vq_tokens=T2I_SETTINGS["num_vq_tokens"],
                              segment_timesteps=ENGINE_WINDOW, cfg_interval=interval)
            c0 = eng.stats["chunks"]
            t = sync()
            codes = counted(f"engine t2i seed {seed}", lambda: eng.submit_t2i(
                ids, uncond, s, seed=seed, attention_mask=attn,
                uncond_attention_mask=uattn).result(600), n * T2I_SETTINGS["timesteps"])
            seconds = sync() - t
            windows = eng.stats["chunks"] - c0

            def dev(a):
                return torch.as_tensor(a, device="cuda")[None]

            want = counted(f"t2i reference seed {seed}", lambda: model.t2i_generate(
                dev(ids), uncond_input_ids=dev(uncond), attention_mask=dev(attn),
                uncond_attention_mask=dev(uattn), temperature=T2I_SETTINGS["temperature"],
                timesteps=T2I_SETTINGS["timesteps"], guidance_scale=T2I_SETTINGS["guidance_scale"],
                num_vq_tokens=T2I_SETTINGS["num_vq_tokens"], cfg_interval=interval,
                generator=torch.Generator("cuda").manual_seed(seed))[0].cpu().numpy(),
                n * T2I_SETTINGS["timesteps"])
            same = bool(np.array_equal(codes, want))
            t2i_out.append(same)
            log("engine", f"t2i {prompt!r} seed {seed}, cfg_interval {interval}: {windows} "
                f"windows, {seconds:.2f}s; equal to t2i_generate: {same}")
            if not same:
                raise AssertionError(f"engine t2i seed {seed} differs from t2i_generate")

        # lifecycle: a queued request cancelled; a drain finishes a stream
        reset_counts()
        eng.pause()
        keep = eng.submit_text(np.asarray(frames[1]), short)
        drop = eng.submit_text(np.asarray(frames[2]), short)
        cancelled0 = eng.stats["cancelled"]
        if not drop.cancel():
            raise AssertionError("a queued request could not be cancelled")
        eng.resume()
        keep.result(600)
        while eng.stats["cancelled"] < cancelled0 + 1:
            time.sleep(0.001)
        tail = eng.submit_mmu(frame, mmu)
        c0 = eng.stats["chunks"]
        while eng.stats["chunks"] < c0 + 1:
            time.sleep(0.001)
        eng.stop(drain=True)
        drained = bool(np.array_equal(tail.result(5), ref))
        launched = tally(counts())
        expect_launches("engine lifecycle", launched, {"one-pass": (
            n * (ENGINE_SHORT["steps"] + MMU_SETTINGS["steps"]), 0, 0)})
        late = eng.submit_text(np.asarray(frames[0]), short)
        log("engine", f"lifecycle: a queued request cancelled (cancelled "
            f"{eng.stats['cancelled'] - cancelled0}); the drain finished the stream in flight "
            f"({eng.stats['chunks'] - c0} chunks, equal to mmu_generate: {drained}); a request "
            f"after it refused: {type(late.exception(5)).__name__}")
        if not drained or late.exception(5) is None:
            raise AssertionError("the drain lost its stream or took a request after it")
        out["latency"] = eng.latency_stats()
        out["stats"] = dict(eng.stats)
        log("engine", f"stats {out['stats']}; latency_stats {out['latency']}")
    finally:
        eng.stop()

    # the chunk guard's rate: the exact forward of the MMU frame, by CUDA events
    x = torch.as_tensor(frame, device="cuda")[None]
    x = torch.cat([x, torch.full((1, MMU_SETTINGS["max_new_tokens"]), MMADA_8B.mask_token_id,
                                 device="cuda")], 1)
    span = (x.shape[1] - MMU_SETTINGS["max_new_tokens"], MMU_SETTINGS["block_length"])
    # cuda_ms: 2 warm-up calls and 5 timed
    ms = counted("the chunk guard's rate", lambda: cuda_ms(
        lambda: model.forward(x, logit_positions=span), iters=5), 7 * n)
    flops = x.shape[1] * forward_matmul_flops_per_token(model.cfg, x.shape[1],
                                                        MMU_SETTINGS["block_length"], v)
    out["rate"] = flops / (ms / 1e3)
    log("engine", f"the chunk guard's rate: the exact MMU forward ({x.shape[1]} tokens, "
        f"{flops / 1e12:.2f} TFLOP of matmuls) {ms:.2f} ms, {out['rate'] / 1e12:.1f} TFLOP/s "
        f"(engine.CARD_FLOPS_PER_S {E.CARD_FLOPS_PER_S / 1e12:.1f} TFLOP/s)")

    # int4: one text batch of four through the engine on the int4 8B
    qmodel = quantize(model, "int4")
    eng = E.ServingEngine(qmodel, max_wait_ms=1.0).start()
    try:
        got, seconds, launched, shapes = released(
            eng, lambda: [eng.submit_text(np.asarray(x), settings) for x in frames])
    finally:
        eng.stop()
    want = counted("engine int4 reference",
                   lambda: qmodel.generate(prompts, **TEXT_SETTINGS).cpu().numpy(), n * steps,
                   (7 * n + 1) * steps)
    rows, head_rows = 4 * len(frames[0]) + 4 * TEXT_SETTINGS["gen_length"], \
        4 * TEXT_SETTINGS["block_length"]
    by_shape = dict(collections.Counter(shapes["b6"]))
    wanted = {(rows, d, d): 4 * n * steps, (rows, d, f): 2 * n * steps,
              (rows, f, d): n * steps, (head_rows, d, v): steps}
    same = all(np.array_equal(g, w) for g, w in zip(got, want))
    log("engine", f"int4: 4 requests in {seconds:.2f}s, equal to the int4 model's generate on "
        f"the batch: {same}; B6 by (M, K, N) as recorded {by_shape}")
    expect_launches("engine int4", launched, {"one-pass": (n * steps, 0, 0),
                                              "int4": ((7 * n + 1) * steps,)})
    if not same or by_shape != wanted:
        raise AssertionError(f"engine int4: equal {same}, B6 by shape {by_shape}")
    log("engine", f"launches in the phase, every call and reference counted: B1 {out['b1']}, "
        f"B6 {out['b6']}")
    del qmodel
    free_memory()
    return out


def mmu_question_frame(model, codes, question):
    """The MMU frame (no answer positions) of `question` about an image of
    MAGVIT-v2 `codes`, as `serve_mmu` builds it."""
    import numpy as np

    from mmada_tpu_torch.prompting.universal import ByteTokenizer, SpecialIds

    sp = SpecialIds.from_vocab(model.vocab)
    ids = ByteTokenizer()([question])["input_ids"][0]
    return np.asarray([sp.mmu, sp.soi, *(codes + model.vocab.image_offset).tolist(), sp.eoi,
                       sp.bos, *ids])


def t2i_request(prompt):
    """(frame, mask, uncond frame, uncond mask) of one t2i request, as
    `serve_t2i` builds them."""
    import numpy as np

    from mmada_tpu_torch.core.vocab import MMADA_8B
    from mmada_tpu_torch.prompting.universal import ByteTokenizer, SpecialIds, UniversalPrompting

    up = UniversalPrompting(ByteTokenizer(), SpecialIds.from_vocab(MMADA_8B),
                            max_text_len=T2I_SETTINGS["max_text_len"])
    n, mask_id = T2I_SETTINGS["num_vq_tokens"], MMADA_8B.mask_token_id
    ids, attn = up.t2i_gen([prompt], np.full((1, n), mask_id))
    uncond, uattn = up.t2i_gen_uncond(1, n, mask_id)
    return (np.asarray(ids)[0], np.asarray(attn)[0], np.asarray(uncond)[0],
            np.asarray(uattn)[0])


def http_phase(root, loaded, image, reset_counts, counts) -> dict:
    """`app_torch`'s HTTP server over the checkpoint under `root` (the model
    already loaded from it), from a thread on 127.0.0.1 (phase 7e): /health
    and /stats answer; /generate answers as the model on the app's frame,
    /t2i and /mmu as the t2i and MMU command lines' `run` on the same weights
    (the PNG of the phase's image, decoded as the app decodes it: PIL is
    needed here, through `app_torch`'s PNG helpers, as by the app's image
    endpoints and JAX's `app.py`);
    /generate_stepwise streams states whose last is /generate's answer; four
    concurrent /generate calls released together run as one batch by
    /stats's counters. B1's launches are read around every call, the
    references' included, and each held against the schedule. Returns their
    total."""
    import threading
    import urllib.request

    import numpy as np
    import torch

    import app_torch
    import inference_mmu_torch
    import inference_t2i_torch
    from generate_torch import answer_text
    from mmada_tpu_torch.core.config import load_config
    from mmada_tpu_torch.serve.loader import build_prompting

    n = loaded.model.cfg.n_layers
    cfg = load_config(overrides=[
        f"model.mmada.pretrained_model_path={root}",
        f"model.vq_model.vq_model_path={os.path.join(root, 'magvit2')}",
        "training.mixed_precision=bf16", "batch_size=1",
        f"generation_timesteps={T2I_SETTINGS['timesteps']}",
        f"guidance_scale={T2I_SETTINGS['guidance_scale']}",
        f"generation_temperature={T2I_SETTINGS['temperature']}", "seed=0",
        f"dataset.preprocessing.max_seq_length={T2I_SETTINGS['max_text_len']}",
        f"model.mmada.num_vq_tokens={T2I_SETTINGS['num_vq_tokens']}",
        f"dataset.preprocessing.resolution={VQ_RESOLUTION}",
        f"max_new_tokens={MMU_SETTINGS['max_new_tokens']}", f"steps={MMU_SETTINGS['steps']}",
        f"question={MMU_QUESTION}"])
    # the app's prompting pads t2i prompts to this config's max_seq_length
    loaded = loaded._replace(prompting=build_prompting(cfg, loaded.tokenizer, loaded.vocab))
    state = app_torch.AppState(cfg, device="cuda", loaded=loaded)
    httpd = app_torch.make_server(state, 0, "127.0.0.1")
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    url = f"http://127.0.0.1:{httpd.server_address[1]}"
    out = dict(b1=0)

    def call(path, payload=None):
        data = None if payload is None else json.dumps(payload).encode()
        req = urllib.request.Request(url + path, data, {"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=600) as resp:
            if resp.headers.get("Content-Type") == "application/x-ndjson":
                return [json.loads(line) for line in resp if line.strip()]
            return json.loads(resp.read())

    def counted(phase, fn, b1):
        """`fn()`, with B1's launches around it read, held against the
        schedule and added to the total."""
        reset_counts()
        result = fn()
        launched = counts()
        expect_launches(phase, launched, {"one-pass": (b1, 0, 0)})
        out["b1"] += launched[0][0]
        return result

    def timed(path, payload, b1):
        t = time.perf_counter()
        got = counted(path, lambda: call(path, payload), b1)
        return got, time.perf_counter() - t

    try:
        health, stats = call("/health"), call("/stats")
        log("http", f"{url}: /health {health}; /stats model {stats['model']}, devices "
            f"{stats['devices']}, engine {stats['engine']}")
        if health != {"status": "ok"} or not stats["engine_running"]:
            raise AssertionError(f"/health {health}, /stats {stats}")

        prompt = TEXT_PROMPTS[0]
        text_req = dict(prompt=prompt, temperature=0.0, **{k: TEXT_SETTINGS[k] for k in (
            "gen_length", "steps", "block_length")})
        text_b1 = n * TEXT_SETTINGS["steps"]
        text, text_s = timed("/generate", text_req, text_b1)
        ids = state._text_ids(prompt)
        direct = counted("/generate reference", lambda: loaded.model.generate(
            torch.tensor(ids, device="cuda"), **TEXT_SETTINGS).cpu(), text_b1)
        want_text = state._answer(direct, len(ids[0]))
        steps, stream_s = timed("/generate_stepwise", dict(
            text_req, stream=True, segment_steps=ENGINE_SEGMENT), text_b1)
        want_last = state._token_states(direct[0, len(ids[0]):])
        log("http", f"/generate {text_s:.2f}s, equal to the model on the app's frame: "
            f"{text['text'] == want_text}; /generate_stepwise (streamed, chunks of "
            f"{ENGINE_SEGMENT}) {stream_s:.2f}s, {len(steps)} states, the last /generate's "
            f"answer: {steps[-1]['step'] == want_last}")
        if text["text"] != want_text or steps[-1]["step"] != want_last or \
                len(steps) != TEXT_SETTINGS["steps"]:
            raise AssertionError("/generate or /generate_stepwise departs from the model")

        t2i, t2i_s = timed("/t2i", dict(prompt=HTTP_T2I_PROMPT, seed=0,
                                        timesteps=T2I_SETTINGS["timesteps"],
                                        guidance_scale=T2I_SETTINGS["guidance_scale"],
                                        temperature=T2I_SETTINGS["temperature"]),
                           n * T2I_SETTINGS["timesteps"])
        got = np.asarray(app_torch.image_from_png_b64(t2i["image_png_b64"]))
        _, cli_images = counted("/t2i reference", lambda: inference_t2i_torch.run(
            cfg, loaded, [HTTP_T2I_PROMPT]), n * T2I_SETTINGS["timesteps"])
        t2i_same = bool(np.array_equal(got, np.asarray(cli_images[0])))
        log("http", f"/t2i {t2i_s:.2f}s: a {got.shape} image, equal to inference_t2i_torch.run: "
            f"{t2i_same}")

        u8 = ((image[0].float().cpu() + 1.0) * 127.5).clamp(0, 255).to(torch.uint8).numpy()
        png = app_torch.png_b64(u8)
        mmu, mmu_s = timed("/mmu", dict(
            image_png_b64=png, question=MMU_QUESTION,
            max_new_tokens=MMU_SETTINGS["max_new_tokens"], steps=MMU_SETTINGS["steps"],
            block_length=MMU_SETTINGS["block_length"], temperature=0.0),
            n * MMU_SETTINGS["steps"])
        pixels = inference_mmu_torch.image_transform(app_torch.image_from_png_b64(png),
                                                     VQ_RESOLUTION)[None]
        cli = answer_text(loaded, counted("/mmu reference", lambda: inference_mmu_torch.run(
            cfg, loaded, pixels)[0], n * MMU_SETTINGS["steps"]))
        log("http", f"/mmu {mmu_s:.2f}s, equal to inference_mmu_torch.run: {mmu['text'] == cli}")
        if not t2i_same or mmu["text"] != cli:
            raise AssertionError("/t2i or /mmu departs from its command line")

        before = call("/stats")["engine"]
        state.engine.pause()
        results = [None] * 4
        reset_counts()

        def worker(i):
            results[i] = call("/generate", text_req)["text"]

        threads = [threading.Thread(target=worker, args=(i,)) for i in range(4)]
        for th in threads:
            th.start()
        while call("/stats")["engine"]["requests"] < before["requests"] + 4:
            time.sleep(0.005)
        t = time.perf_counter()
        state.engine.resume()
        for th in threads:
            th.join()
        batch_s = time.perf_counter() - t
        launched = counts()
        out["b1"] += launched[0][0]
        expect_launches("4 concurrent /generate", launched, {"one-pass": (text_b1, 0, 0)})
        after = call("/stats")
        delta = {k: after["engine"][k] - before[k] for k in before}
        log("http", f"4 concurrent /generate released together: {batch_s:.2f}s, answers equal "
            f"the sequential one: {results == [want_text] * 4}; /stats deltas {delta}; latency "
            f"{after['latency']}")
        if results != [want_text] * 4 or delta["batches"] != 1 or \
                delta["batched_requests"] != 4:
            raise AssertionError(f"concurrent /generate: deltas {delta}")
        log("http", f"launches in the phase, every call and reference counted: B1 {out['b1']}")
    finally:
        httpd.shutdown()
        httpd.server_close()
        state.stop_engine()
        thread.join(timeout=30)
    return out


# how every kernel of the JSON line is built
WGMMA_DESIGN = "wgmma + TMA, producer and two consumer warpgroups"


def motion_windows(clips, frames, seed=0):
    """(clips, frames, 263) fp32 windows of `motion_clip`s on the card."""
    import numpy as np
    import torch

    from mmada_tpu_torch.data.synthetic import motion_clip

    rng = np.random.default_rng(seed)
    out = [motion_clip(int(k), length=frames + 32)[s:s + frames]
           for k, s in zip(rng.integers(0, 48, clips), rng.integers(0, 32, clips))]
    return torch.as_tensor(np.stack(out), device="cuda")


def motion_vq_phase(reset_counts, counts) -> dict:
    """11a: the flagship motion VQ-VAE on the card (see MOTION_CLIPS), then
    `train_motion_vq_torch` on the motion soak's VQ stage. Returns (vq, cfg)
    and the timings."""
    import copy

    import torch

    import train_motion_vq_torch
    import train_torch
    from mmada_tpu_torch.models import motion_vq

    cfg = motion_vq.MotionVQConfig()
    t = time.perf_counter()
    vq = motion_vq.init_motion_vq(cfg, device="cuda",
                                  generator=torch.Generator("cuda").manual_seed(0))
    # the EMA-reset codebook seeded from 512 latents of 32 windows (one
    # training-mode quantizer pass: no tiling noise at N = nb_code)
    seed_clips = motion_windows(32, 64, seed=5)
    state = motion_vq.CodebookState.create(cfg, device="cuda")
    _, _, _, codebook, state = motion_vq.forward_train(None, vq, state, cfg, seed_clips)
    with torch.no_grad():
        vq.codebook.copy_(codebook)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in vq.parameters())
    log("motion vq", f"MotionVQConfig() built and its codebook seeded on the card in "
        f"{time.perf_counter() - t:.2f}s: {n_params} params; {int(state.initialized)} "
        f"initialized, codes used by the seeding batch {int((state.code_count > 0.5).sum())}")
    cpu_vq = copy.deepcopy(vq).cpu()
    out = {}
    reset_counts()
    for clips, frames in MOTION_CLIPS:
        x = motion_windows(clips, frames)
        n = frames // 4
        flags = {}
        for name, (cudnn_tf32, matmul_tf32) in (("off", (False, False)), ("torch's defaults", (True, False)),
                                                 ("on", (True, True))):
            torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = (
                cudnn_tf32, matmul_tf32)
            flags[name] = motion_vq.encode(vq, cfg, x)
        torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
        codes = flags["off"]
        t = time.perf_counter()
        cpu_codes = motion_vq.encode(cpu_vq, cfg, x.cpu())
        cpu_s = time.perf_counter() - t
        same = {k: bool(torch.equal(v.cpu(), cpu_codes)) for k, v in flags.items()}
        # the margin the argmin had on the CPU: the gap between the nearest
        # and the second nearest code, against the latents' error
        z = motion_vq.encoder_forward(vq, cfg, x).detach()
        z_cpu = motion_vq.encoder_forward(cpu_vq, cfg, x.cpu()).detach()
        flat = z_cpu.reshape(-1, cfg.code_dim)
        dist = torch.cdist(flat, cpu_vq.codebook.detach()).topk(2, largest=False).values
        gap = float((dist[:, 1] - dist[:, 0]).min())
        z_err = float((z.cpu() - z_cpu).abs().max())
        feats = motion_vq.decode(vq, cfg, codes)
        feats_cpu = motion_vq.decode(cpu_vq, cfg, cpu_codes)
        f_err = float((feats.cpu() - feats_cpu).abs().max())
        f_scale = float(feats_cpu.abs().max())
        encode_ms = cuda_ms(lambda: motion_vq.encode(vq, cfg, x), 5, 1)
        decode_ms = cuda_ms(lambda: motion_vq.decode(vq, cfg, codes), 5, 1)
        rec = dict(clips=clips, frames=frames, codes=list(codes.shape),
                   distinct=int(codes.unique().numel()), same_as_cpu=same,
                   latent_max_abs_err=z_err, cpu_nearest_gap_min=gap,
                   feature_max_abs_err=f_err, feature_max_abs=f_scale,
                   encode_ms=encode_ms, decode_ms=decode_ms, cpu_encode_s=cpu_s)
        log("motion vq", json.dumps(rec))
        out[f"{clips}x{frames}"] = rec
        if tuple(codes.shape) != (clips, n) or tuple(feats.shape) != (clips, frames, cfg.pose_dim):
            raise AssertionError(f"motion VQ shapes: codes {tuple(codes.shape)}, features "
                                 f"{tuple(feats.shape)}")
        if not all(same.values()):
            raise AssertionError(f"motion VQ codes on the card differ from the fp32 CPU's: "
                                 f"{same} (latent error {z_err}, nearest-code gap {gap})")
        if not (bool(torch.isfinite(feats).all()) and f_err <= MOTION_FEATURE_ATOL * f_scale):
            raise AssertionError(f"motion VQ features depart from the CPU's: {f_err} against "
                                 f"{MOTION_FEATURE_ATOL} x {f_scale}")
    expect_launches("motion vq", counts(), {})
    del cpu_vq

    root = tempfile.mkdtemp(prefix="mmada_motion_vq_")
    atexit.register(shutil.rmtree, root, True)
    t = time.perf_counter()
    _, _, history = train_motion_vq_torch.train(train_torch.read_config(
        MOTION_VQ_CLI + [f"experiment.output_dir={root}"]))
    train_s = time.perf_counter() - t
    for h in history:
        log("motion vq cli", f"step {h['step']}: loss {h['loss']:.4f} (recon {h['recon']:.4f} "
            f"vel {h['vel']:.4f} commit {h['commit']:.4f}) perplexity {h['perplexity']:.1f}; "
            f"{h['seconds'] * 1e3:.1f} ms")
    if len(history) != 4 or not all(math.isfinite(h[k]) for h in history
                                    for k in ("loss", "perplexity")):
        raise AssertionError(f"train_motion_vq_torch: {history}")
    if not os.path.exists(os.path.join(root, "motion_vq", "model.safetensors.index.json")):
        raise AssertionError("train_motion_vq_torch saved no motion_vq/")
    log("motion vq cli", f"4 steps of batch 64 x 64 frames in {train_s:.2f}s (setup and save "
        "included)")
    shutil.rmtree(root, ignore_errors=True)
    out["cli_steps_ms"] = [h["seconds"] * 1e3 for h in history]
    return vq, cfg, out


def t2m_mask_bias(batch=1):
    """The mask bias of `batch` t2m frames of T2M_CAPTION, as `serve_t2m`
    builds them."""
    return _mask_bias(t2m_frames(batch)[1])


def t2m_frames(batch=1, caption=T2M_CAPTION, n=None):
    """(ids, masks) numpy t2m generation frames (MMADA_8B_T2M's specials)."""
    import numpy as np

    from mmada_tpu_torch.core.vocab import MMADA_8B_T2M
    from mmada_tpu_torch.prompting.universal import ByteTokenizer, SpecialIds, UniversalPrompting

    n = n or T2M_SETTINGS["num_motion_tokens"]
    up = UniversalPrompting(ByteTokenizer(), SpecialIds.from_vocab(MMADA_8B_T2M),
                            max_text_len=T2M_SETTINGS["max_text_len"])
    motion = np.full((batch, n), MMADA_8B_T2M.mask_token_id, np.int64)
    ids, masks, _ = up.t2m([caption] * batch, motion, motion, dropout=False)
    return ids, masks


def t2m_bank(root: str, rows: int = 64) -> str:
    """A token bank (`dataset.token_bank`) of `rows` captions with random
    motion codes, padded as `MotionTokenDataset` pads them: codes, EOM (512),
    PAD (513) up to 55."""
    import numpy as np

    from mmada_tpu_torch.data.synthetic import motion_caption

    rng = np.random.default_rng(0)
    n = T2M_SETTINGS["num_motion_tokens"]
    lengths = rng.integers(20, n - 1, rows)
    tokens = np.full((rows, n), 513, np.int64)
    for i, m in enumerate(lengths):
        tokens[i, :m] = rng.integers(0, 512, m)
        tokens[i, m] = 512
    path = os.path.join(root, "bank.npz")
    np.savez(path, captions=np.array([motion_caption(k) for k in range(rows)]), tokens=tokens,
             lengths=lengths)
    return path


def t2m_train_mask_bias():
    """The mask bias of a t2m training batch: T2M_BATCH frames of the bank's
    captions (`motion_caption`), their pads masked."""
    import numpy as np

    from mmada_tpu_torch.core.vocab import MMADA_8B_T2M
    from mmada_tpu_torch.data.synthetic import motion_caption
    from mmada_tpu_torch.prompting.universal import ByteTokenizer, SpecialIds, UniversalPrompting

    up = UniversalPrompting(ByteTokenizer(), SpecialIds.from_vocab(MMADA_8B_T2M),
                            max_text_len=T2M_SETTINGS["max_text_len"])
    codes = np.full((T2M_BATCH, T2M_SETTINGS["num_motion_tokens"]), MMADA_8B_T2M.motion_offset)
    _, masks, _ = up.t2m([motion_caption(k) for k in range(T2M_BATCH)], codes, codes,
                         dropout=False)
    return _mask_bias(masks)


def check_motion_codes(codes, rows, n) -> None:
    if tuple(codes.shape) != (rows, n) or not bool(((codes >= 0) & (codes < 512)).all()):
        raise AssertionError(f"t2m codes {tuple(codes.shape)} (want {(rows, n)}), in [0, 512): "
                             f"{bool(((codes >= 0) & (codes < 512)).all())}")


def check_fresh_span_step(model, frame, tag) -> dict:
    """The t2m cached decode's first step at a fresh (compact) capture, its
    motion-window logits and the exact forward's, each against the same
    logits in fp32: the step (bf16 and int8 cache) may be at most
    FRESH_STEP_FACTOR times as far from them as the exact forward is."""
    import torch

    n = T2M_SETTINGS["num_motion_tokens"]
    lo = frame.shape[1] - n - 1
    window = model._motion_window
    exact = model.forward(frame, logit_window=window, logit_positions=(lo, n)).float()
    errs = {}
    steps = {}
    for dtype in (None, "int8"):
        capture, step = model._span_cache_fns(window, n, dtype)
        kv = capture(frame)
        steps[dtype] = step(frame[:, lo:lo + n], kv, lo).float()
        del kv
    ref = fp32_block_logits(model, frame, lo, n)[..., window[0]:window[1]]
    torch.cuda.synchronize()

    def rel(a, b):
        return float((a - b).norm() / b.norm())

    def agree(a, b):
        return float((a.argmax(-1) == b.argmax(-1)).float().mean())

    errs = dict(exact_vs_fp32=rel(exact, ref), step_vs_fp32=rel(steps[None], ref),
                int8_vs_fp32=rel(steps["int8"], ref), step_vs_exact=rel(steps[None], exact),
                argmax_exact_vs_fp32=agree(exact, ref),
                argmax_step_vs_exact=agree(steps[None], exact))
    log("t2m", f"{tag}: a fresh capture's step over the motion span {(frame.shape[0], n)}: "
        + ", ".join(f"{k} {v:.4e}" for k, v in errs.items())
        + f" (limit: step and int8 at most {FRESH_STEP_FACTOR} x exact_vs_fp32)")
    bar = FRESH_STEP_FACTOR * errs["exact_vs_fp32"]
    if not (errs["step_vs_fp32"] <= bar and errs["int8_vs_fp32"] <= bar):
        raise AssertionError(f"{tag}: the fresh t2m cached step departs from the fp32 function: "
                             f"{errs}")
    return errs


def t2m_serving_phase(vq, vq_cfg, reset_counts, counts, expect_no_bias_copies) -> dict:
    """11b: the full-width 8B with the t2m vocab, through `serve_t2m`, the
    model's segmented run and the serving engine (see T2M_SETTINGS). Returns
    the launches by path and the timings."""
    import numpy as np
    import torch

    from mmada_tpu_torch.core.precision import BF16
    from mmada_tpu_torch.core.vocab import MMADA_8B_T2M
    from mmada_tpu_torch.entry import decode_motion, serve_t2m
    from mmada_tpu_torch.models import llada
    from mmada_tpu_torch.models.mmada import MMadaModel
    from mmada_tpu_torch.serve.engine import ServingEngine, T2MSettings

    cfg = llada.llada_8b(MMADA_8B_T2M.total_vocab_size)
    t = time.perf_counter()
    model = MMadaModel.init(cfg, MMADA_8B_T2M, device="cuda", dtype=torch.bfloat16,
                            generator=torch.Generator("cuda").manual_seed(0), policy=BF16)
    torch.cuda.synchronize()
    log("t2m", f"8B with the t2m vocab ({MMADA_8B_T2M.total_vocab_size} rows) built on the card "
        f"in {time.perf_counter() - t:.1f}s: {llada.param_count(model.params) / 1e9:.3f}e9 "
        f"params, {torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated")
    masked = dataclasses.replace(model, cfg=dataclasses.replace(cfg, attention_bias_enabled=True))
    n, steps = cfg.n_layers, T2M_SETTINGS["timesteps"]
    span = T2M_SETTINGS["num_motion_tokens"]
    ids, masks = t2m_frames()
    log("t2m", f"frame {ids.shape[1]} tokens ({int((masks == 0).sum())} pads before the "
        f"caption), {span} motion tokens, {steps} timesteps, T 0")
    if ids.shape[1] != T2M_FRAME:
        raise AssertionError(f"t2m frame {ids.shape[1]}, want {T2M_FRAME}")
    out = {"b1": 0, "b2": 0, "rect": 0, "b1_shapes": collections.Counter(), "seconds": {}}

    def request(tag, fn, want, square=None, rect=None):
        result, seconds, launched, shapes, peak = timed_request(fn, reset_counts, counts)
        expect_launches(tag, launched, want)
        if square is not None:
            expect_b1_shapes(tag, launched, shapes["b1"], square, rect)
        out["b1"] += launched[0][0]
        out["b2"] += launched[1][0]
        out["rect"] += sum(1 for _, lq, lk in shapes["b1"] if lq < lk)
        out["b1_shapes"].update(shapes["b1"])
        out["seconds"][tag] = seconds
        log("t2m", f"{tag}: {seconds:.3f}s; launches {launched}; B1 shapes "
            f"{sorted(set(shapes['b1']))}; peak {peak:.2f} GiB allocated")
        return result

    kw = dict(T2M_SETTINGS)
    exact = request("exact", lambda: serve_t2m(model, [T2M_CAPTION], **kw),
                    {"one-pass": (n * steps, 0, 0)}, n * steps, 0)
    check_motion_codes(exact, 1, span)
    again = request("exact again", lambda: serve_t2m(model, [T2M_CAPTION], **kw),
                    {"one-pass": (n * steps, 0, 0)})
    masked_codes = request("exact masked", lambda: serve_t2m(masked, [T2M_CAPTION], **kw),
                           {"one-pass bias": (n * steps, 0, 0)})
    expect_no_bias_copies("t2m exact masked")
    check_motion_codes(masked_codes, 1, span)
    segmented = request("segmented", lambda: serve_t2m(model, [T2M_CAPTION],
                                                       segment_timesteps=T2M_SEGMENT, **kw),
                        {"one-pass": (n * steps, 0, 0)})
    masked_segmented = request("segmented masked", lambda: serve_t2m(
        masked, [T2M_CAPTION], segment_timesteps=T2M_SEGMENT, **kw),
        {"one-pass bias": (n * steps, 0, 0)})
    same = dict(repeat=_same(exact, again), segmented=_same(segmented, exact),
                segmented_masked=_same(masked_segmented, masked_codes))
    log("t2m", f"bit for bit: {same}; {exact.unique().numel()} distinct codes; the mask moved "
        f"{float((masked_codes != exact).float().mean()):.3f} of them")
    if not all(same.values()):
        raise AssertionError(f"t2m: a repeat or a segmented run differs from the monolithic "
                             f"run: {same}")

    cached = request("cached", lambda: serve_t2m(model, [T2M_CAPTION], block_kv_cache=True, **kw),
                     {"one-pass": (n + n * steps, 0, 0)}, n, n * steps)
    cached8 = request("cached int8", lambda: serve_t2m(model, [T2M_CAPTION],
                                                       block_kv_cache="int8", **kw),
                      {"one-pass": (n + n * steps, 0, 0)}, n, n * steps)
    refresh1 = request("cached refresh 1", lambda: serve_t2m(
        model, [T2M_CAPTION], block_kv_cache=True, cache_refresh_every=1, **kw),
        {"one-pass": (2 * n * steps, 0, 0)}, n * steps, n * steps)
    one = dict(kw, timesteps=1)
    exact1 = serve_t2m(model, [T2M_CAPTION], **one)
    cached1 = serve_t2m(model, [T2M_CAPTION], block_kv_cache=True, **one)
    for c in (cached, cached8, refresh1, cached1):
        check_motion_codes(c, 1, span)
    agree = {k: float((c == e).float().mean()) for k, c, e in (
        ("cached", cached, exact), ("int8", cached8, exact), ("refresh 1", refresh1, exact),
        ("one step", cached1, exact1))}
    log("t2m", f"codes equal to the exact sampler's (share): {agree}; the bf16 step and "
        "capture round otherwise than the exact forward (held by the fresh step below; the CPU "
        "tests hold refresh 1 and one step token for token in fp32)")
    frame = torch.as_tensor(ids, device="cuda")
    out["fresh"] = check_fresh_span_step(model, frame, "t2m")

    # the engine: a monolithic and a chunked request (windows of T2M_SEGMENT)
    # on the masked 8B, released together, each against the direct call with
    # its seed (T 1, the engine's default)
    settings = [T2MSettings(timesteps=steps, num_motion_tokens=span),
                T2MSettings(timesteps=steps, num_motion_tokens=span,
                            segment_timesteps=T2M_SEGMENT)]
    eng = ServingEngine(masked, min_chunk_device_ms=0).start()
    try:
        reset_counts()
        eng.pause()
        t = time.perf_counter()
        futs = [eng.submit_t2m(ids[0], st, seed=7 + i, attention_mask=masks[0])
                for i, st in enumerate(settings)]
        eng.resume()
        got = [f.result(600) for f in futs]
        engine_s = time.perf_counter() - t
        launched = counts()
        stats = dict(eng.stats)
    finally:
        eng.stop()
    expect_launches("t2m engine", launched, {"one-pass bias": (2 * n * steps, 0, 0)})
    out["b2"] += launched[1][0]
    direct = [masked.t2m_generate(torch.as_tensor(ids, device="cuda"),
                                  attention_mask=torch.as_tensor(masks, device="cuda"),
                                  timesteps=steps, num_motion_tokens=span,
                                  generator=torch.Generator("cuda").manual_seed(7 + i))[0]
              for i in range(2)]
    engine_same = [bool(np.array_equal(g, d.cpu().numpy())) for g, d in zip(got, direct)]
    log("t2m", f"engine: 2 requests (monolithic, windows of {T2M_SEGMENT}) in {engine_s:.3f}s; "
        f"stats {stats}; equal to the direct call with the seed: {engine_same}")
    if not all(engine_same) or stats["chunks"] != -(-steps // T2M_SEGMENT):
        raise AssertionError(f"t2m engine: {engine_same}, chunks {stats['chunks']}")
    out["seconds"]["engine (2 requests)"] = engine_s

    # one request at the sampler's default of 256 motion tokens (B1, timing)
    long_kw = dict(kw, num_motion_tokens=T2M_LONG_TOKENS)
    long_codes = request(f"exact {T2M_LONG_TOKENS} tokens", lambda: serve_t2m(
        model, [T2M_CAPTION], **long_kw), {"one-pass": (n * steps, 0, 0)}, n * steps, 0)
    check_motion_codes(long_codes, 1, T2M_LONG_TOKENS)

    # the codes as motion: the flagship VQ's decode (4 frames a code)
    feats = decode_motion(vq, vq_cfg, torch.cat([exact, masked_codes]))
    log("t2m", f"decoded to {tuple(feats.shape)} features, finite "
        f"{bool(torch.isfinite(feats).all())}")
    if tuple(feats.shape) != (2, 4 * span, vq_cfg.pose_dim) or not bool(
            torch.isfinite(feats).all()):
        raise AssertionError(f"decoded t2m features {tuple(feats.shape)}")
    del model, masked
    free_memory()
    return out


def t2m_train_phase(reset_counts, counts, expect_no_bias_copies) -> dict:
    """11c: `train_torch.run` with training.task=t2m on the 8B (full
    fine-tuning, then LoRA; see T2M_TRAIN_CLI), then on the motion soak's
    proxy arch: save, resume, LoRA. Returns the launches and the steps."""
    import torch

    import train_torch
    from mmada_tpu_torch.checkpoints.manager import flatten

    root = tempfile.mkdtemp(prefix="mmada_t2m_")
    atexit.register(shutil.rmtree, root, True)
    bank = t2m_bank(root)
    n = 32
    out = {"b2": 0, "dq": 0, "dkv": 0}
    for tag, extra in (("t2m train", []), ("t2m lora", T2M_LORA)):
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        t = time.perf_counter()
        run = train_torch.run(train_torch.read_config(T2M_TRAIN_CLI + extra + [
            f"dataset.token_bank={bank}", f"training.batch_size_t2m={T2M_BATCH}",
            f"experiment.output_dir={os.path.join(root, tag.replace(' ', '_'))}"]))
        torch.cuda.synchronize()
        total_s = time.perf_counter() - t
        launched = counts()
        peak = torch.cuda.max_memory_allocated() / 2**30
        for h in run.history:
            log(tag, f"step {h['step']}: loss {h['loss']:.4f} grad_norm {h['grad_norm']:.4f} "
                f"mask_prob {h['mask_prob']:.3f}; {h['seconds'] * 1e3:.1f} ms")
        frames = run.next_batch()["input_ids"].shape
        log(tag, f"{len(run.history)} steps of {tuple(frames)} frames in {total_s:.2f}s (the 8B "
            f"built, the state made); launches {launched}; peak {peak:.2f} GiB allocated; "
            f"model cfg attention_bias_enabled {run.model.cfg.attention_bias_enabled}, remat "
            f"{run.model.remat}; lora {run.lora_cfg}")
        if tuple(frames) != (T2M_BATCH, T2M_FRAME):
            raise AssertionError(f"{tag}: frames {tuple(frames)}")
        if len(run.history) != T2M_TRAIN_STEPS or not all(
                math.isfinite(h["loss"]) and h["skipped_nonfinite"] == 0 for h in run.history):
            raise AssertionError(f"{tag}: {run.history}")
        k = T2M_TRAIN_STEPS
        expect_launches(tag, launched, {"one-pass bias": (2 * n * k, n * k, n * k)})
        expect_no_bias_copies(tag)
        out["b2"] += launched[1][0]
        out["dq"] += launched[1][1]
        out["dkv"] += launched[1][2]
        out[tag] = dict(steps_ms=[h["seconds"] * 1e3 for h in run.history],
                        loss=[h["loss"] for h in run.history],
                        grad_norm=[h["grad_norm"] for h in run.history], peak_gib=peak)
        del run
        free_memory()

    # the proxy arch: 2 steps saving each, a resume to 3 against 3 in one go,
    # then 2 LoRA steps; every step counted
    proxy = os.path.join(root, "proxy")

    def proxy_run(tag, *extra):
        t = time.perf_counter()
        run = train_torch.run(train_torch.read_config(T2M_PROXY_CLI + [
            f"dataset.token_bank={bank}", *extra]))
        log("t2m proxy", f"{tag}: steps {[h['step'] for h in run.history]}, losses "
            f"{[round(h['loss'], 4) for h in run.history]}, {time.perf_counter() - t:.2f}s")
        return run

    reset_counts()
    straight = proxy_run("3 steps", "training.max_train_steps=3", "experiment.save_every=0",
                         f"experiment.output_dir={proxy}_a")
    proxy_run("2 steps, saving each", "training.max_train_steps=2", "experiment.save_every=1",
              f"experiment.output_dir={proxy}_b")
    resumed = proxy_run("resumed to 3", "training.max_train_steps=3", "experiment.save_every=1",
                        "experiment.resume_from_checkpoint=latest",
                        f"experiment.output_dir={proxy}_b")
    lora = proxy_run("lora", "training.max_train_steps=2", "experiment.save_every=0",
                     f"experiment.output_dir={proxy}_c", *T2M_LORA)
    launched = counts()
    proxy_layers = 8
    steps = 3 + 2 + 1 + 2   # the config sets no remat: one forward a step
    expect_launches("t2m proxy", launched, {"one-pass bias": (
        proxy_layers * steps, proxy_layers * steps, proxy_layers * steps)})
    a, b = flatten(straight._payload()), flatten(resumed._payload())
    differ = [k for k in a if not torch.equal(a[k], b[k])]
    log("t2m proxy", f"resumed at step 2 onto the uninterrupted run: {len(a)} tensors, "
        f"{len(differ)} differ; checkpoints {sorted(os.listdir(proxy + '_b'))}; lora trains "
        f"{sum(t.numel() for t in flatten(lora.state.params).values())} values")
    if differ or sorted(a) != sorted(b) or [h["step"] for h in resumed.history] != [3]:
        raise AssertionError(f"t2m proxy resume: {differ[:5]}")
    out["proxy"] = launched
    del straight, resumed, lora
    free_memory()
    shutil.rmtree(root, ignore_errors=True)
    return out


# phase 12, parallelism on the port at the world of this machine's cards. On
# one card every collective over a group of one is skipped, so the mesh
# path must compute the single-card function bit for bit; over more, one
# spawned rank a card (`parallel_ranks`). 12a: stage-1 steps of the
# full-width 8B through the Trainer over make_mesh(fsdp=-1) on NCCL against
# the same steps without a mesh, on the same weights (each 8B made from
# seed 0 on the card) and batches; 12b: the loader's sharded and pipelined
# models serving the text and t2i requests of phases 5-6; 12c: the
# attention kernels on the head shards tensor parallelism gives each rank,
# at T = 2, 4 and 8
PARALLEL_TRAIN_STEPS = 2
RANKS_TRAIN_STEPS = 3       # over several cards: two steady steps after the first
TP_SIZES = (2, 4, 8)
# over several cards (one spawned rank a card): the rows split over the ranks
# change the matmuls' heights and the fp32 loss sums' order, and each rank's
# bf16 gradient is rounded before the reduce-scatter sums the ranks' in fp32,
# so the sharded steps are held to the one-card steps within these bars, and
# the served logits normwise at the small model's bf16 bar
RANKS_LOSS_RTOL = 2e-3
# with a tensor axis each block's row-parallel output is the fp32 sum of the
# ranks' fp32 partial products, rounded once (ROADMAP C.8; the bar dates from
# when the partials were rounded and summed in bf16)
RANKS_TP_LOSS_RTOL = 1e-2
RANKS_GRAD_NORM_RTOL = 2e-2
# W8A8 over (1, W/2, 2): the forward over tensor is the unsharded one bit for
# bit (exact int32 sums), so the first loss moves only with the fp32 loss
# sums' order (the bf16 steps over fsdp alone: 7e-8), and the grad norm, a
# bf16 value, by at most one bf16 ulp
RANKS_W8A8_LOSS_RTOL = 1e-4
RANKS_W8A8_GRAD_NORM_RTOL = 2.0 ** -7
RANKS_LOGITS_REL_L2 = SMALL_MODEL_REL_L2
PARALLEL_RANKS_TIMEOUT_S = 900
# seconds a spawned rank's process group waits at a collective (the
# rendezvous store's timeout): a rank that failed is seen by the parent, which
# ends the others, long before
RANKS_STORE_TIMEOUT_S = 120
# phase 12d: app_torch over the mesh, on the masked 8B (B1 for text and MMU,
# B2 for t2i): four concurrent /generate calls (one batch), /t2i, /mmu about
# a 16-px image (the tiny MAGVIT-v2 of 12b: 64 codes), /generate_stepwise
# streamed in chunks of APP_SEGMENT steps
APP_TEXT = dict(gen_length=64, steps=16, block_length=32, temperature=0.0)
APP_T2I = dict(timesteps=8, guidance_scale=3.5, temperature=1.0, seed=0)
APP_MMU = dict(max_new_tokens=32, steps=16, block_length=32, temperature=0.0)
APP_SEGMENT = 4
APP_RESOLUTION = 16


def sample_leaves(trainer) -> dict:
    """A few slices of the trained weights, on the host: the embedding, the
    first and last layers' projections, the head, a norm (over several
    ranks each leaf is gathered whole first: every rank takes part)."""
    from mmada_tpu_torch.models import llada
    from mmada_tpu_torch.parallel import sharding

    leaves = dict(llada.named_leaves(trainer.state.params))
    n = len(trainer.state.params["layers"]) - 1
    picks = {"wte": (slice(0, 64), slice(0, 64)), "layers.0.q_proj": (slice(0, 64), slice(0, 64)),
             f"layers.{n}.ff_out": (slice(0, 64), slice(0, 64)),
             "layers.0.attn_out": (slice(4000, 4096), slice(0, 96)),
             "ff_out": (slice(0, 32), slice(-64, None)), f"layers.{n}.ff_norm": (slice(0, 256),)}

    def whole(name):
        t = leaves[name].detach()
        if trainer.layout is None:
            return t
        return sharding.gather_tensor(t, trainer.layout.specs[name], trainer.mesh)

    return {k: whole(k)[idx].cpu().clone() for k, idx in picks.items()}


def probe_nccl(mesh) -> str:
    """The process group's collectives on the card at this world size: an
    all-reduce, all-gather, reduce-scatter and broadcast of a known tensor,
    each held to its exact result."""
    import torch
    import torch.distributed as dist

    world = dist.get_world_size()
    x = torch.arange(world * 8, dtype=torch.float32, device="cuda") + dist.get_rank()
    summed = x.clone()
    dist.all_reduce(summed)
    gathered = torch.empty(world * x.numel(), device="cuda")
    dist.all_gather_into_tensor(gathered, x)
    scattered = torch.empty(x.numel() // world, device="cuda")
    dist.reduce_scatter_tensor(scattered, x)
    sent = x.clone()
    dist.broadcast(sent, src=0)
    torch.cuda.synchronize()
    want = torch.arange(world * 8, dtype=torch.float32, device="cuda")
    ok = (torch.equal(summed, world * want + sum(range(world)))
          and torch.equal(sent, want) and gathered.numel() == world * x.numel()
          and torch.equal(scattered, (world * want + sum(range(world))).chunk(world)[
              dist.get_rank()]))
    if not ok:
        raise AssertionError("the NCCL collectives disagree with their exact results")
    return (f"{dist.get_backend()} world {world}, mesh {tuple(mesh.shape)} "
            f"{mesh.mesh_dim_names}: all-reduce, all-gather, reduce-scatter, broadcast exact")


def parallel_phase(train, reset_counts, counts) -> dict:
    """Phase 12 at the world of this machine's cards: in this process on one
    card, else one spawned rank a card (`parallel_ranks`). Returns the world
    and rank 0's B1 / dq / dkv launches on the phase's main paths."""
    import torch

    world = torch.cuda.device_count()
    if world > 1:
        return parallel_ranks(world)
    train_rec = parallel_train_phase(train, reset_counts, counts)
    serve_rec = parallel_serving_phase(reset_counts, counts)
    local_heads_phase()
    torch.distributed.destroy_process_group()   # the NCCL group of 12a-12b
    return dict(world=1, b1=sum(c[0] for c in train_rec["launched"]) + serve_rec["b1"]
                + serve_rec["b1_unsharded"], b2=serve_rec["b2"], b6=0,
                dq=sum(c[1] for c in train_rec["launched"]),
                dkv=sum(c[2] for c in train_rec["launched"]))


def parallel_ranks(world: int) -> dict:
    """Phase 12 over `world` cards: one spawned process a card, joined over
    NCCL through a rendezvous file; every rank runs `_parallel_rank`, rank 0
    reports. A rank that fails ends the phase at once: each rank writes its
    traceback to a file of its own, which is printed here before the others
    are ended; a rank that outlives the deadline fails it too."""
    import multiprocessing as mp

    tmp = tempfile.mkdtemp(prefix="mmada_ranks_")
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=_parallel_rank, args=(rank, world, tmp))
             for rank in range(world)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + PARALLEL_RANKS_TIMEOUT_S
    while any(p.is_alive() for p in procs) and time.monotonic() < deadline:
        if any(p.exitcode not in (None, 0) for p in procs):
            time.sleep(5)   # the others' own errors reach their files
            break
        time.sleep(0.5)
    hung = [r for r, p in enumerate(procs) if p.is_alive()]
    for p in procs:
        if p.is_alive():
            p.kill()
        p.join(30)
    codes = [p.exitcode for p in procs]
    for rank in range(world):
        path = os.path.join(tmp, f"rank{rank}.txt")
        if os.path.exists(path):
            with open(path) as f:
                print(f"--- phase 12 rank {rank} failed:\n{f.read()}", file=sys.stderr,
                      flush=True)
    if hung or any(codes):
        raise AssertionError(f"phase 12 ranks: still running {hung}, exit codes {codes}")
    with open(os.path.join(tmp, "rank0.json")) as f:
        out = json.load(f)
    shutil.rmtree(tmp, ignore_errors=True)
    return out


def _parallel_rank(rank: int, world: int, tmp: str) -> None:
    """One rank of phase 12 over several cards (`_ranks_phase`); its
    traceback, if it fails, goes to `tmp/rank<r>.txt`."""
    try:
        _ranks_phase(rank, world, tmp)
    except BaseException:
        with open(os.path.join(tmp, f"rank{rank}.txt"), "w") as f:
            f.write(traceback.format_exc())
        raise


def _ranks_phase(rank: int, world: int, tmp: str) -> None:
    """12a (the unsharded steps on rank 0's card, then the sharded ones over
    every card, and W8A8 steps over (1, W/2, 2) against one on rank 0's
    card), 12b (the loader's sharded and pipelined models; the app over fsdp
    and over tensor; C.8's witness), int4 over tensor, W8A8 served over
    tensor, 12c on rank 0."""
    import torch
    import torch.distributed as dist

    from mmada_tpu_torch.core.mesh import initialize_distributed, make_mesh
    from mmada_tpu_torch.entry import train

    initialize_distributed(f"file://{tmp}/rendezvous", world, rank,
                           timeout_s=RANKS_STORE_TIMEOUT_S)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    reset_counts, counts, _ = kernel_counters()
    mesh = make_mesh(fsdp=-1)
    log(f"12 rank {rank}", probe_nccl(mesh))
    tr = ranks_train_phase(rank, world, train, reset_counts, counts)
    sv = ranks_serving_phase(rank, world, reset_counts, counts)
    q4 = ranks_int4_phase(rank, world, reset_counts, counts)
    w8 = ranks_w8a8_serving(rank, world)
    if rank == 0:
        local_heads_phase()
        with open(os.path.join(tmp, "rank0.json"), "w") as f:
            json.dump(dict(world=world, b1=tr["b1"] + sv["b1"] + q4["b1"], b2=sv["b2"],
                           b6=q4["b6"], dq=tr["dq"], dkv=tr["dkv"], train=tr, serve=sv,
                           int4=q4, w8a8=w8), f)
    dist.barrier()
    dist.destroy_process_group()


def ranks_train_phase(rank, world, train, reset_counts, counts) -> dict:
    """12a over `world` cards: a stage-1 batch of 2W t2i + W lm + W mmu rows
    (the parts divide over the ranks) trained RANKS_TRAIN_STEPS steps on
    rank 0's card alone, then over make_mesh(fsdp=-1), each rank its rows,
    and, on four cards or more, over (1, W/2, 2): fsdp and tensor
    parallelism. The losses (fp32 sums in another order; the row-parallel
    partials summed over the tensor ranks in fp32), the bf16 grad norms (each
    rank's bf16 gradient summed in fp32 by the reduce-scatter) and the
    sampled weights are held to the
    unsharded run within RANKS_LOSS_RTOL (RANKS_TP_LOSS_RTOL with a tensor
    axis), RANKS_GRAD_NORM_RTOL and one bf16 ulp."""
    import torch
    import torch.distributed as dist

    from mmada_tpu_torch.core.mesh import make_mesh, process_local_batch_slice
    from mmada_tpu_torch.core.precision import BF16
    from mmada_tpu_torch.core.vocab import MMADA_8B
    from mmada_tpu_torch.models import llada
    from mmada_tpu_torch.models.mmada import MMadaModel
    from mmada_tpu_torch.parallel import sharding

    cfg = llada.llada_8b()
    settings = dict(TRAIN_SETTINGS, training=dict(
        TRAIN_SETTINGS["training"], batch_size_t2i=2 * world, batch_size_lm=world,
        batch_size_mmu=world))
    plan = dict(STAGE1, settings=settings, rows=4 * world)
    flows = [train_flows(seed, plan) for seed in range(RANKS_TRAIN_STEPS)]
    n = cfg.n_layers * RANKS_TRAIN_STEPS

    def fresh():
        return MMadaModel.init(cfg, MMADA_8B, device="cuda", dtype=torch.bfloat16,
                               generator=torch.Generator("cuda").manual_seed(0), policy=BF16,
                               remat="full")

    keys = ("loss", "loss_t2i", "loss_lm", "loss_mmu", "grad_norm")
    ref = None
    out = dict(b1=0, dq=0, dkv=0)
    if rank == 0:
        trainer, launched = train_phase("12a unsharded", fresh(), RANKS_TRAIN_STEPS, train,
                                        reset_counts, counts, plan=plan, flows=flows)
        ref = dict(history=[{k: h[k] for k in keys + ("seconds",)} for h in trainer.history],
                   leaves=sample_leaves(trainer), launched=launched[0],
                   peak_gib=torch.cuda.max_memory_allocated() / 2**30)
        out.update(b1=launched[0][0], dq=launched[0][1], dkv=launched[0][2],
                   unsharded_step_ms=min(h["seconds"] for h in ref["history"]) * 1e3,
                   unsharded_peak_gib=ref["peak_gib"],
                   unsharded_losses=[h["loss"] for h in ref["history"]])
        del trainer
        free_memory()
    dist.barrier()
    shapes = [(1, world, 1)] + ([(1, world // 2, 2)] if world >= 4 and world % 2 == 0 else [])
    for shape in shapes:
        mesh = make_mesh(*shape)
        model = fresh()
        specs = sharding.model_specs(cfg, mesh, model.params)
        model = dataclasses.replace(model, mesh=mesh,
                                    params=sharding.shard_params(model.params, specs, mesh))
        free_memory()   # the whole weights go; each rank keeps its shards
        local = [{name: {k: v[process_local_batch_slice(len(flow["input_ids"]), mesh)]
                         for k, v in flow.items()} for name, flow in raw.items()}
                 for raw in flows]
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        trainer = train(model, local, steps=RANKS_TRAIN_STEPS, log_every=1, mesh=mesh,
                        **settings)
        torch.cuda.synchronize()
        launched = counts()
        peak = torch.cuda.max_memory_allocated() / 2**30
        expect_launches(f"12a {shape} rank {rank}", launched, {"one-pass": (2 * n, n, n)})
        leaves = sample_leaves(trainer)   # every rank: the leaves are gathered
        history = [{k: h[k] for k in keys + ("seconds",)} for h in trainer.history]
        for h in history:
            log(f"12a {shape} rank {rank}", f"sharded step: loss {h['loss']:.4f} grad_norm "
                f"{h['grad_norm']:.4f}; {h['seconds']:.3f}s")
        for k, v in zip(("b1", "dq", "dkv"), launched[0]):
            out[k] += v
        rec = dict(peak_gib=peak, step_ms=[h["seconds"] * 1e3 for h in history],
                   losses=[h["loss"] for h in history])
        out[str(shape)] = rec
        if rank == 0:
            loss_rtol = RANKS_TP_LOSS_RTOL if shape[2] > 1 else RANKS_LOSS_RTOL
            for h, w in zip(history, ref["history"]):
                for k in keys:
                    rtol = RANKS_GRAD_NORM_RTOL if k == "grad_norm" else loss_rtol
                    if not math.isclose(h[k], w[k], rel_tol=rtol):
                        raise AssertionError(f"12a over mesh {shape}: {k} {h[k]} against "
                                             f"{w[k]} unsharded (rtol {rtol})")
            close = {k: bool(torch.allclose(leaves[k].float(), ref["leaves"][k].float(),
                                            rtol=2.0 ** -7, atol=1e-6)) for k in leaves}
            if not all(close.values()):
                raise AssertionError(f"12a over mesh {shape}: sampled weights {close}")
            log("12a", f"mesh {shape}, {plan['rows']} rows of {plan['frame']}: losses "
                f"{rec['losses']} against {out['unsharded_losses']} unsharded; sampled "
                f"weights within one bf16 ulp; steps {[round(t, 1) for t in rec['step_ms']]} "
                f"ms against {out['unsharded_step_ms']:.1f} ms on one card; peak {peak:.2f} GiB "
                f"a card against {ref['peak_gib']:.2f} GiB")
        del trainer, model
        free_memory()
    if world >= 4 and world % 2 == 0:
        out["w8a8"] = ranks_w8a8_step(rank, world, train, settings, plan, flows, reset_counts,
                                      counts)
        for k, v in zip(("b1", "dq", "dkv"), out["w8a8"]["launched"]):
            out[k] += v
    return out


def ranks_w8a8_step(rank, world, train, settings, plan, flows, reset_counts, counts) -> dict:
    """Stage-1 steps of the 8B with `forward_quantize: w8a8` (the block
    matmuls' W8A8 forward, straight-through gradients): one on rank 0's card
    alone, then two over (1, W/2, 2) on the first batch twice (the second
    step's time is the steady one), where the row-parallel products take
    their scales over the whole row and sum int32 partials, so the forward
    over tensor is the unsharded one bit for bit. The sharded first loss is
    held to the unsharded step's within RANKS_W8A8_LOSS_RTOL (the fp32 loss
    sums run in another order) and its grad norm within
    RANKS_W8A8_GRAD_NORM_RTOL (each rank's bf16 gradient summed in fp32 by
    the reduce-scatter)."""
    import torch
    import torch.distributed as dist

    from mmada_tpu_torch.core.mesh import make_mesh, process_local_batch_slice
    from mmada_tpu_torch.core.precision import BF16
    from mmada_tpu_torch.core.vocab import MMADA_8B
    from mmada_tpu_torch.models import llada
    from mmada_tpu_torch.models.mmada import MMadaModel
    from mmada_tpu_torch.parallel import collectives, sharding

    cfg = llada.llada_8b()
    shape = (1, world // 2, 2)
    w8 = dict(settings, training=dict(settings["training"], forward_quantize="w8a8"))

    def fresh():
        return MMadaModel.init(cfg, MMADA_8B, device="cuda", dtype=torch.bfloat16,
                               generator=torch.Generator("cuda").manual_seed(0), policy=BF16,
                               remat="full")

    ref = None
    if rank == 0:
        trainer, _ = train_phase("12a w8a8 unsharded", fresh(), 1, train, reset_counts, counts,
                                 plan=dict(plan, settings=w8), flows=flows[:1])
        ref = {k: trainer.history[0][k] for k in ("loss", "grad_norm", "seconds")}
        del trainer
        free_memory()
    dist.barrier()
    mesh = make_mesh(*shape)
    model = fresh()
    model = dataclasses.replace(model, mesh=mesh, params=sharding.shard_params(
        model.params, sharding.model_specs(cfg, mesh, model.params), mesh))
    free_memory()
    local = [{name: {k: v[process_local_batch_slice(len(flow["input_ids"]), mesh)]
                     for k, v in flow.items()} for name, flow in flows[0].items()}]
    reset_counts()
    before = collectives.counts.copy()
    trainer = train(model, local * 2, steps=2, log_every=1, mesh=mesh, **w8)
    torch.cuda.synchronize()
    launched = counts()
    maxes = (collectives.counts - before)["all_reduce_max"]
    n = cfg.n_layers
    expect_launches(f"12a w8a8 {shape} rank {rank}", launched,
                    {"one-pass": (4 * n, 2 * n, 2 * n)})
    h = trainer.history[0]
    rec = dict(loss=h["loss"], grad_norm=h["grad_norm"],
               seconds=[x["seconds"] for x in trainer.history], unsharded=ref,
               all_reduce_max=maxes, launched=list(launched[0]))
    log(f"12a w8a8 rank {rank}", f"two W8A8 stage-1 steps over {shape} (the first batch "
        f"twice): first loss {h['loss']:.6f}, grad_norm {h['grad_norm']:.4f} (unsharded "
        f"{ref}); {[round(x, 3) for x in rec['seconds']]}s; {maxes} MAX all-reduces (the "
        f"row-parallel scales); launches {launched[0]}")
    if not (math.isfinite(h["loss"]) and h["grad_norm"] > 0 and maxes > 0):
        raise AssertionError(f"12a w8a8: {rec}")
    if rank == 0:
        for k, rtol in (("loss", RANKS_W8A8_LOSS_RTOL), ("grad_norm", RANKS_W8A8_GRAD_NORM_RTOL)):
            if not math.isclose(h[k], ref[k], rel_tol=rtol):
                raise AssertionError(f"12a w8a8 over {shape}: {k} {h[k]} against {ref[k]} "
                                     f"unsharded (rtol {rtol})")
    del trainer, model
    free_memory()
    return rec


def ranks_serving_phase(rank, world, reset_counts, counts) -> dict:
    """12b over `world` cards: the 8B of `load_all`, whole on rank 0 first
    (parallel.serving none), then served by the loader over every rank
    (auto over fsdp, pipeline, auto over tensor: each rank its heads and
    MLP hidden, the blocks' outputs summed from fp32 partials and rounded
    once). Every rank must end on
    the same tokens; rank 0
    holds the first t2i forward's logits (image window and span) within
    RANKS_LOGITS_REL_L2 of the whole model's (the rows split over the
    ranks change the matmuls' heights, and cuBLAS may then round otherwise)
    and reports how many tokens equal the whole model's. C.8's witness: the
    whole model's and tensor's first t2i logits each against the fp32
    forward of the same weights, and tensor's forward time. The app
    (`ranks_app`) over fsdp and over tensor."""
    import torch
    import torch.distributed as dist

    import app_torch
    from mmada_tpu_torch.entry import serve_t2i, serve_text
    from mmada_tpu_torch.models import llada
    from mmada_tpu_torch.parallel import pipeline
    from mmada_tpu_torch.serve.loader import build_prompting, load_all

    n_layers = llada.llada_8b().n_layers

    config, first_logits = serving_config, t2i_first_logits
    ref = ref_app = exact = None
    png = app_png()
    out = dict(b1=0, b2=0)
    if rank == 0:
        loaded = load_all(config("none"))
        model = loaded.model
        ref = (torch.stack(serve_text(model, TEXT_PROMPTS, **TEXT_SETTINGS)),
               serve_t2i(model, T2I_PROMPTS, **T2I_SETTINGS), first_logits(model))
        exact = fp32_t2i_first_logits(model)
        out["whole_ms"] = cuda_ms(lambda: first_logits(model), 3, 1)
        out["whole_rel_fp32"] = float((ref[2] - exact).norm() / exact.norm())
        acfg = app_config("none")
        state = app_torch.AppState(acfg, device="cuda", loaded=loaded._replace(
            model=with_masks(model), prompting=build_prompting(acfg, loaded.tokenizer,
                                                               loaded.vocab)))
        try:
            reset_counts()
            ref_app = app_calls(state, png)
            launched = counts()
        finally:
            state.stop_engine()
        expect_launches("12d app one card", launched, app_launches(n_layers))
        out["b1"] += launched[0][0]
        out["b2"] += launched[1][0]
        out["app one card seconds"] = ref_app["seconds"]
        del model, loaded, state
        free_memory()
    dist.barrier()
    failures = []
    for mode, kw in (("auto", {}), ("pipeline", {}), ("tensor", dict(fsdp=1, tensor=-1))):
        loaded = load_all(config("auto" if mode == "tensor" else mode, **kw))
        model = loaded.model
        if model.mesh is None or (mode == "pipeline") != (model.pipeline_axis == "fsdp"):
            raise AssertionError(f"12b: the loader did not serve {mode} over the ranks")
        reset_counts()
        t = time.perf_counter()
        text = torch.stack(serve_text(model, TEXT_PROMPTS, **TEXT_SETTINGS))
        codes = serve_t2i(model, T2I_PROMPTS, **T2I_SETTINGS)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t
        launched = counts()
        per = (n_layers // world, pipeline.microbatches(len(TEXT_PROMPTS), world),
               pipeline.microbatches(2 * len(T2I_PROMPTS), world)) if mode == "pipeline" \
            else (n_layers, 1, 1)
        expect_launches(f"12b {mode} rank {rank}", launched, {"one-pass": (per[0] * (
            per[1] * TEXT_SETTINGS["steps"] + per[2] * T2I_SETTINGS["timesteps"]), 0, 0)})
        out["b1"] += launched[0][0]
        logits = first_logits(model)
        for name, t_ in (("text", text), ("t2i", codes)):
            t_ = t_.to("cuda").contiguous()   # the answers come back on the host
            every = [torch.empty_like(t_) for _ in range(world)]
            dist.all_gather(every, t_)
            if not all(torch.equal(e, t_) for e in every):
                raise AssertionError(f"12b {mode}: the ranks' {name} tokens differ")
        forward_ms = cuda_ms(lambda: first_logits(model), 3, 1) if mode == "tensor" else None
        if rank == 0:
            rel = float((logits - ref[2]).norm() / ref[2].norm())
            agree = {"text": float((text.cpu() == ref[0].cpu()).float().mean()),
                     "t2i": float((codes.cpu() == ref[1].cpu()).float().mean())}
            out[mode] = dict(seconds=seconds, logits_rel_l2=rel, agreement=agree,
                             rel_fp32=float((logits - exact).norm() / exact.norm()),
                             forward_ms=forward_ms)
            log("12b", f"{mode} over {world} ranks: text + t2i in {seconds:.2f}s, every rank "
                f"the same tokens; first t2i forward rel L2 {rel:.3e} against the whole "
                f"model (limit {RANKS_LOGITS_REL_L2}); tokens equal to its {agree}")
            if not rel <= RANKS_LOGITS_REL_L2:
                raise AssertionError(f"12b {mode}: logits rel L2 {rel} against the whole model")
            if mode == "tensor":
                whole, tens = out["whole_rel_fp32"], out[mode]["rel_fp32"]
                log("12b", f"C.8 witness: the first t2i forward (4 x {T2I_FRAME}) against the "
                    f"fp32 forward of the same weights: whole model {whole:.4e}, tensor "
                    f"{world} {tens:.4e} ({tens / whole:.3f}x; a fault past sqrt 2 x); tensor "
                    f"{world}'s forward {forward_ms:.2f} ms against {out['whole_ms']:.2f} ms "
                    f"on one card")
                if tens > math.sqrt(2) * whole:
                    failures.append(f"C.8 witness: tensor {world} {tens} from fp32 against "
                                    f"the whole model's {whole}")
        if mode in ("auto", "tensor"):
            app = ranks_app(rank, mode, loaded, ref_app, png, reset_counts, counts, failures)
            out["b1"] += app["b1"]
            out["b2"] += app["b2"]
            if rank == 0:
                out[mode]["app_seconds"] = app["seconds"]
        del model, logits, loaded
        free_memory()
    if failures:
        raise AssertionError("12b: " + "; ".join(failures))
    return out


def ranks_app(rank, mode, loaded, ref_app, png, reset_counts, counts, failures) -> dict:
    """The app over the loader's model of 12b (masks on: B2 for t2i): every
    rank builds `AppState`, rank 0 serves `app_calls` over HTTP and the
    others follow its engine over the control channel. Over fsdp rank 0's
    answers are held to the app's on one card (`ref_app`); over tensor to
    the same mesh's calls on the same model, every rank (the model on the
    app's text frames, `inference_t2i_torch.run`, `inference_mmu_torch.run`),
    bit for bit. Every rank's launches are the schedule's."""
    import torch

    import app_torch
    import generate_torch
    import inference_mmu_torch
    import inference_t2i_torch
    from mmada_tpu_torch.serve.loader import build_prompting

    n = loaded.model.cfg.n_layers
    cfg = app_config("auto", **({} if mode == "auto" else dict(fsdp=1, tensor=-1)))
    masked = loaded._replace(model=with_masks(loaded.model),
                             prompting=build_prompting(cfg, loaded.tokenizer, loaded.vocab))
    state = app_torch.AppState(cfg, device="cuda", loaded=masked)
    cli = None
    if mode == "tensor":
        # the app's text frame starts with the tokenizer's BOS, the text
        # command line's with the vocab's (as in JAX's app and generate.py),
        # so /generate is held to the model on the app's frame (phase 7e's
        # rule), /t2i and /mmu to their command lines
        pixels = inference_mmu_torch.image_transform(app_torch.image_from_png_b64(png),
                                                     APP_RESOLUTION)[None]
        _, images = inference_t2i_torch.run(cfg, masked, [T2I_PROMPTS[0]])
        ids = state._text_ids(TEXT_PROMPTS[0])
        direct = masked.model.generate(torch.tensor(ids * 4, device="cuda"), **APP_TEXT).cpu()
        cli = dict(generate=[state._answer(direct[i:i + 1], len(ids[0])) for i in range(4)],
                   t2i=app_torch.png_b64(images[0].numpy()),
                   mmu=generate_torch.answer_text(masked, inference_mmu_torch.run(
                       cfg, masked, pixels)[0]))
    reset_counts()
    if state.leader:
        try:
            got = app_calls(state, png)
        finally:
            state.stop_engine()
    else:
        code = state.follow()
        if code:
            raise AssertionError(f"12d {mode}: rank {rank} followed to a fault ({code})")
    launched = counts()
    expect_launches(f"12d app {mode} rank {rank}", launched, app_launches(n))
    out = dict(b1=launched[0][0], b2=launched[1][0])
    if rank == 0:
        out["seconds"] = got["seconds"]
        if mode == "auto":
            same = app_answers_equal(got, ref_app)
            against = "the app on one card"
        else:
            # the batch's rows as a multiset: which request took which row
            # is the order of arrival
            same = {k: (sorted(got[k]) == sorted(cli[k]) if k == "generate" else got[k] == cli[k])
                    for k in ("generate", "t2i", "mmu")}
            against = "the model on the app's frame and the command lines over the same mesh"
        log("12d", f"app_torch over {mode} {got['mesh']}: 4 concurrent /generate, /t2i, /mmu, "
            f"/generate_stepwise streamed in {got['seconds']:.2f}s (one card "
            f"{ref_app['seconds']:.2f}s); /stats deltas {got['deltas']}; answers equal to "
            f"{against}: {same}; every rank's launches {launched[:2]}")
        if not all(same.values()):
            failures.append(f"12d app over {mode}: answers against {against} {same}")
    return out


def ranks_int4_phase(rank, world, reset_counts, counts) -> dict:
    """int4 over tensor: every rank quantizes the 8B to int4 (B6) and the
    loader's rule shards it over tensor = every rank (row-parallel weights
    in whole 128-row groups); the app's engine serves a text and a t2i
    request from rank 0, the others following. Every rank's B6 launches
    equal and are the schedule's (every block matmul of every forward and
    the head); the answers are valid ids."""
    import numpy as np
    import torch
    import torch.distributed as dist

    import app_torch
    from mmada_tpu_torch.core.mesh import make_mesh
    from mmada_tpu_torch.entry import quantize
    from mmada_tpu_torch.serve.engine import TextSettings
    from mmada_tpu_torch.serve.loader import build_prompting, load_all, shard_for_serving

    loaded = load_all(serving_config("none"))
    qmodel = quantize(loaded.model, "int4")
    loaded = loaded._replace(model=None)
    free_memory()
    cfg = app_config("auto", fsdp=1, tensor=-1)
    mesh = make_mesh(fsdp=1, tensor=-1)
    qmodel = shard_for_serving(cfg, qmodel, mesh)
    free_memory()
    n = qmodel.cfg.n_layers
    state = app_torch.AppState(cfg, device="cuda", loaded=loaded._replace(
        model=qmodel, prompting=build_prompting(cfg, loaded.tokenizer, loaded.vocab)))
    reset_counts()
    t = time.perf_counter()
    if state.leader:
        try:
            ids = np.asarray(state._text_ids(TEXT_PROMPTS[0])[0])
            text = state.engine.submit_text(ids, TextSettings(**APP_TEXT)).result()[len(ids):]
            image = state.t2i(T2I_PROMPTS[0], **APP_T2I)
        finally:
            state.stop_engine()
    elif state.follow():
        raise AssertionError(f"12 int4: rank {rank} followed to a fault")
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t
    launched = counts()
    forwards = APP_TEXT["steps"] + APP_T2I["timesteps"]
    expect_launches(f"12 int4 tensor rank {rank}", launched, {
        "one-pass": (n * forwards, 0, 0), "int4": ((7 * n + 1) * forwards,)})
    b6 = torch.tensor([launched[4][0]], device="cuda")
    every = [torch.empty_like(b6) for _ in range(world)]
    dist.all_gather(every, b6)
    out = dict(b1=launched[0][0], b6=launched[4][0], seconds=seconds)
    if rank == 0:
        log("12 int4", f"the int4 8B over tensor {world} {tuple(mesh.shape)}: a text and a t2i "
            f"request through the app's engine in {seconds:.2f}s; B6 launches by rank "
            f"{[int(e) for e in every]}; answer ids {text[:12].tolist()}, image {image.shape}")
        check_answer_ids(torch.as_tensor(text), APP_TEXT["gen_length"], qmodel.vocab)
        if image.shape[-1] != 3 or len({int(e) for e in every}) != 1:
            raise AssertionError(f"12 int4: image {image.shape}, B6 by rank {every}")
    del state, qmodel, loaded
    free_memory()
    return out


def ranks_w8a8_serving(rank, world) -> dict:
    """W8A8 served over tensor: every rank quantizes the 8B to W8A8, rank 0
    takes the first t2i forward of the whole W8A8 model on its card, and
    the loader's rule then shards it over (1, 1, W) and, on four cards or
    more, (1, W/2, 2): each rank its heads, its MLP hidden and its K-shards
    of the row-parallel weights, whose products take their scales over the
    whole row and sum int32 partials. Rank 0's logits must equal the whole
    W8A8 model's bit for bit."""
    import torch

    from mmada_tpu_torch.core.mesh import make_mesh
    from mmada_tpu_torch.entry import quantize
    from mmada_tpu_torch.serve.loader import load_all, shard_for_serving

    qmodel = quantize(load_all(serving_config("none")).model, "w8a8")
    free_memory()
    whole = t2i_first_logits(qmodel) if rank == 0 else None
    out = {}
    meshes = [(1, world)] + ([(world // 2, 2)] if world >= 4 and world % 2 == 0 else [])
    for fsdp, tensor in meshes:
        mesh = make_mesh(fsdp=fsdp, tensor=tensor)
        sharded = shard_for_serving(serving_config("auto", fsdp, tensor), qmodel, mesh)
        logits = t2i_first_logits(sharded)
        if rank == 0:
            equal = bool(torch.equal(logits, whole))
            out[str(tuple(mesh.shape))] = dict(
                equal=equal, max_abs_diff=float((logits - whole).abs().max()))
            log("12 w8a8", f"the W8A8 8B served over {tuple(mesh.shape)}: the first t2i "
                f"forward's logits {tuple(logits.shape)} equal to the whole W8A8 model's on one "
                f"card: {equal} (max |diff| {out[str(tuple(mesh.shape))]['max_abs_diff']:.3e})")
            if not equal:
                raise AssertionError(f"12 w8a8 over {tuple(mesh.shape)}: logits differ from "
                                     f"the whole W8A8 model's")
        del sharded, logits
        free_memory()
    del qmodel, whole
    free_memory()
    return out


def serving_config(mode, fsdp=-1, tensor=1):
    """Phase 12b's config: the random-init 8B in bf16 from seed 0, a tiny
    MAGVIT-v2, the mesh `parallel.*` and `parallel.serving` `mode`."""
    from mmada_tpu_torch.core.config import Config

    return Config({"model": {"mmada": {"random_init": True}, "vq_model": {"tiny": True}},
                   "training": {"mixed_precision": "bf16", "seed": 0},
                   "parallel": {"data": 1, "fsdp": fsdp, "tensor": tensor, "serving": mode}})


def t2i_first_logits(model):
    """The t2i sampler's first forward (T2I_PROMPTS' CFG batch, the image
    window over the image span), in fp32."""
    from mmada_tpu_torch.core.vocab import MMADA_8B

    ids = t2i_frames()
    n = T2I_SETTINGS["num_vq_tokens"]
    return model.forward(ids, logit_window=MMADA_8B.image_window,
                         logit_positions=(ids.shape[1] - n - 1, n)).float()


def fp32_t2i_first_logits(model):
    """`t2i_first_logits`' forward in fp32 on the card, the function the bf16
    logits round (C.8's witness), by the probe script's fp32 forward."""
    from mmada_tpu_torch.core.vocab import MMADA_8B
    from scripts.tensor_sums_probe_torch import fp32_logits

    ids = t2i_frames()
    n = T2I_SETTINGS["num_vq_tokens"]
    return fp32_logits(model, ids, dict(logit_window=MMADA_8B.image_window,
                                        logit_positions=(ids.shape[1] - n - 1, n)))


def app_config(mode, fsdp=-1, tensor=1):
    """12d's config: `serving_config`'s with the app's t2i prompt length,
    image size and the command lines' keys for APP_* (for the CLIs held
    against the app over tensor)."""
    return serving_config(mode, fsdp, tensor).merge({
        "dataset": {"preprocessing": {"max_seq_length": T2I_SETTINGS["max_text_len"],
                                      "resolution": APP_RESOLUTION}},
        "model": {"mmada": {"num_vq_tokens": T2I_SETTINGS["num_vq_tokens"]}},
        "batch_size": 1, "generation_timesteps": APP_T2I["timesteps"],
        "guidance_scale": APP_T2I["guidance_scale"],
        "generation_temperature": APP_T2I["temperature"], "seed": APP_T2I["seed"],
        "max_new_tokens": APP_MMU["max_new_tokens"], "steps": APP_MMU["steps"],
        "block_length": APP_MMU["block_length"], "question": MMU_QUESTION,
        "gen_length": APP_TEXT["gen_length"], "temperature": APP_TEXT["temperature"],
        "chat": False})


def with_masks(model):
    """The same weights with the frames' masks reaching attention (B2)."""
    return dataclasses.replace(model, cfg=dataclasses.replace(model.cfg,
                                                              attention_bias_enabled=True))


def app_png() -> str:
    """12d's /mmu image: APP_RESOLUTION px of seeded noise, as a PNG."""
    import numpy as np

    import app_torch

    pixels = np.random.default_rng(12).integers(0, 256, (APP_RESOLUTION, APP_RESOLUTION, 3))
    return app_torch.png_b64(pixels.astype(np.uint8))


def app_calls(state, png) -> dict:
    """`app_torch`'s HTTP server over `state` on 127.0.0.1 (a free port):
    four concurrent /generate calls released together from a held
    dispatcher (one batch by /stats), /t2i, /mmu and /generate_stepwise
    streamed; the answers, the /stats deltas and the seconds. The engine is
    left running."""
    import threading
    import urllib.request

    import torch

    import app_torch

    httpd = app_torch.make_server(state, 0, "127.0.0.1")
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    url = f"http://127.0.0.1:{httpd.server_address[1]}"

    def call(path, payload=None):
        data = None if payload is None else json.dumps(payload).encode()
        req = urllib.request.Request(url + path, data, {"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=600) as resp:
            if resp.headers.get("Content-Type") == "application/x-ndjson":
                return [json.loads(line) for line in resp if line.strip()]
            return json.loads(resp.read())

    text = dict(prompt=TEXT_PROMPTS[0], **APP_TEXT)
    out = {}
    t0 = time.perf_counter()
    try:
        before = call("/stats")["engine"]
        state.engine.pause()
        answers = [None] * 4

        def worker(i):
            answers[i] = call("/generate", text)["text"]

        threads = [threading.Thread(target=worker, args=(i,)) for i in range(4)]
        for th in threads:
            th.start()
        while call("/stats")["engine"]["requests"] < before["requests"] + 4:
            time.sleep(0.005)
        state.engine.resume()
        for th in threads:
            th.join()
        out["generate"] = answers
        after = call("/stats")
        out["deltas"] = {k: after["engine"][k] - before[k] for k in before}
        out["mesh"] = after["mesh"]
        out["t2i"] = call("/t2i", dict(prompt=T2I_PROMPTS[0], **APP_T2I))["image_png_b64"]
        out["mmu"] = call("/mmu", dict(image_png_b64=png, question=MMU_QUESTION,
                                       **APP_MMU))["text"]
        out["stepwise"] = [s["step"] for s in call("/generate_stepwise", dict(
            text, stream=True, segment_steps=APP_SEGMENT))]
        torch.cuda.synchronize()
        out["seconds"] = time.perf_counter() - t0
    finally:
        httpd.shutdown()
        httpd.server_close()
        thread.join(timeout=30)
    # the four rows are one batch; their answers need not be equal over
    # tensor: NCCL's ring sums each chunk of a buffer in its own rank order,
    # so identical rows at other offsets may round otherwise (the batch is
    # held to the command line's batch of the same rows instead)
    if out["deltas"]["batches"] != 1 or out["deltas"]["batched_requests"] != 4:
        raise AssertionError(f"12d: four concurrent /generate calls: {out['deltas']}")
    if len(out["stepwise"]) != APP_TEXT["steps"]:
        raise AssertionError(f"12d: {len(out['stepwise'])} streamed states")
    return out


def app_launches(n_layers) -> dict:
    """What `app_calls` launches on the masked 8B: B1 for the batch of four,
    MMU and the stepwise stream, B2 for t2i (its frames' masks)."""
    return {"one-pass": (n_layers * (2 * APP_TEXT["steps"] + APP_MMU["steps"]), 0, 0),
            "one-pass bias": (n_layers * APP_T2I["timesteps"], 0, 0)}


def app_answers_equal(a: dict, b: dict) -> dict:
    return {k: a[k] == b[k] for k in ("generate", "t2i", "mmu", "stepwise")}


def parallel_app_phase(loaded, mesh, reset_counts, counts) -> dict:
    """12d: `app_torch.AppState` (its engine) on the masked 8B of 12b, first
    without a mesh, then over `mesh` of one rank through the control channel
    (every model call an event; no follower): `app_calls`' answers equal bit
    for bit, the launches the schedule's on both. Returns the launches and
    the seconds."""
    import app_torch
    from mmada_tpu_torch.serve.loader import build_prompting, shard_for_serving

    cfg = app_config("auto")
    n = loaded.model.cfg.n_layers
    masked = with_masks(loaded.model)
    base = loaded._replace(prompting=build_prompting(cfg, loaded.tokenizer, loaded.vocab))
    png = app_png()
    out = dict(b1=0, b2=0)
    got = {}
    for name, model in (("no mesh", masked), ("mesh", shard_for_serving(cfg, masked, mesh))):
        state = app_torch.AppState(cfg, device="cuda", loaded=base._replace(model=model))
        try:
            reset_counts()
            got[name] = app_calls(state, png)
            launched = counts()
        finally:
            state.stop_engine()
        expect_launches(f"12d app {name}", launched, app_launches(n))
        out["b1"] += launched[0][0]
        out["b2"] += launched[1][0]
        events = state.engine.channel.seq if state.engine.channel is not None else None
        log("12d", f"app_torch {name} (mesh {got[name]['mesh']}): 4 concurrent /generate, /t2i, "
            f"/mmu, /generate_stepwise streamed in {got[name]['seconds']:.2f}s; /stats deltas "
            f"{got[name]['deltas']}; control-channel events {events}; launches {launched}")
        if (name == "mesh") != (events is not None and events > 0):
            raise AssertionError(f"12d {name}: control-channel events {events}")
        out[f"{name} seconds"] = got[name]["seconds"]
    same = app_answers_equal(got["mesh"], got["no mesh"])
    log("12d", f"the app over the one-rank mesh answers as without a mesh: {same}")
    if not all(same.values()):
        raise AssertionError(f"12d: answers over the mesh differ: {same}")
    return out


def parallel_train_phase(train, reset_counts, counts) -> dict:
    """12a: PARALLEL_TRAIN_STEPS stage-1 steps without a mesh, then the same
    steps over make_mesh(fsdp=-1) on a fresh 8B of the same seed: losses,
    grad norms and the sampled weights bit for bit; each trainer's
    moments freed before the other is built."""
    import torch

    from mmada_tpu_torch.core.mesh import make_mesh
    from mmada_tpu_torch.core.precision import BF16
    from mmada_tpu_torch.core.vocab import MMADA_8B
    from mmada_tpu_torch.models import llada
    from mmada_tpu_torch.models.mmada import MMadaModel

    cfg = llada.llada_8b()
    flows = [train_flows(seed) for seed in range(PARALLEL_TRAIN_STEPS)]

    def fresh():
        return MMadaModel.init(cfg, MMADA_8B, device="cuda", dtype=torch.bfloat16,
                               generator=torch.Generator("cuda").manual_seed(0), policy=BF16,
                               remat="full")

    mesh = make_mesh(fsdp=-1)
    log("12a", probe_nccl(mesh))
    runs = {}
    for name, kw in (("unsharded", {}), ("sharded", {"mesh": mesh})):
        trainer, launched = train_phase(f"12a {name}", fresh(), PARALLEL_TRAIN_STEPS, train,
                                        reset_counts, counts, flows=flows, **kw)
        n = cfg.n_layers * PARALLEL_TRAIN_STEPS
        expect_launches(f"12a {name}", launched, {"one-pass": (2 * n, n, n)})
        runs[name] = dict(
            history=[{k: h[k] for k in ("loss", "loss_t2i", "loss_lm", "loss_mmu",
                                        "grad_norm", "seconds", "max_memory_allocated_gib")}
                     for h in trainer.history],
            leaves=sample_leaves(trainer), launched=launched,
            peak_gib=torch.cuda.max_memory_allocated() / 2**30,
            mesh=None if trainer.mesh is None else tuple(trainer.mesh.shape))
        del trainer
        free_memory()
    a, b = runs["unsharded"], runs["sharded"]
    for k in ("loss", "loss_t2i", "loss_lm", "loss_mmu", "grad_norm"):
        got, want = [h[k] for h in b["history"]], [h[k] for h in a["history"]]
        if got != want:
            raise AssertionError(f"12a: sharded {k} {got} != unsharded {want}")
    same = {k: torch.equal(a["leaves"][k], b["leaves"][k]) for k in a["leaves"]}
    if not all(same.values()):
        raise AssertionError(f"12a: sampled weights differ after the steps: {same}")
    step_ms = {name: min(h["seconds"] for h in r["history"]) * 1e3 for name, r in runs.items()}
    log("12a", f"mesh {b['mesh']}: losses {[h['loss'] for h in b['history']]} and grad norms "
        f"{[h['grad_norm'] for h in b['history']]} bit for bit the unsharded steps'; sampled "
        f"weights equal {same}; steady step {step_ms['sharded']:.1f} ms vs "
        f"{step_ms['unsharded']:.1f} ms unsharded; peak {b['peak_gib']:.2f} vs "
        f"{a['peak_gib']:.2f} GiB allocated; B1/dq/dkv {b['launched'][0]} (B3: dq "
        f"{b['launched'][0][1]}, dkv {b['launched'][0][2]})")
    return dict(step_ms=step_ms, peak_gib={k: r["peak_gib"] for k, r in runs.items()},
                launched=[runs[k]["launched"][0] for k in runs])


def parallel_serving_phase(reset_counts, counts) -> dict:
    """12b: the 8B of `serve.loader.load_all` (random init from seed 0),
    then the same weights over the one-rank mesh through the loader's
    `shard_for_serving` with parallel.serving auto and pipeline (with one
    rank the loader itself serves the model whole, as JAX's with one
    device): each answers the text and t2i requests of phases 5-6 with the
    unsharded model's tokens."""
    import torch

    from mmada_tpu_torch.core.mesh import make_mesh
    from mmada_tpu_torch.entry import serve_t2i, serve_text
    from mmada_tpu_torch.models import llada
    from mmada_tpu_torch.parallel import pipeline
    from mmada_tpu_torch.serve.loader import load_all, shard_for_serving

    n_layers = llada.llada_8b().n_layers
    config = serving_config
    loaded = load_all(config("auto"))
    mesh = make_mesh(fsdp=-1)
    models = {"unsharded": loaded.model,
              "auto": shard_for_serving(config("auto"), loaded.model, mesh),
              "pipeline": shard_for_serving(config("pipeline"), loaded.model, mesh)}
    if models["auto"].mesh is None or models["pipeline"].pipeline_axis != "fsdp":
        raise AssertionError("12b: the loader did not shard or pipeline the model")
    out, launches = {}, {}
    for name, model in models.items():
        reset_counts()
        t = time.perf_counter()
        text = serve_text(model, TEXT_PROMPTS, **TEXT_SETTINGS)
        codes = serve_t2i(model, T2I_PROMPTS, **T2I_SETTINGS)
        torch.cuda.synchronize()
        launches[name] = counts()
        out[name] = (torch.stack(text).cpu(), codes.cpu(), time.perf_counter() - t)
        log("12b", f"{name}: text + t2i in {out[name][2]:.2f}s; launches {launches[name]}")
        # the pipeline runs each forward's microbatches through every layer
        # (JAX's rule: min(B, 2 stages), cut to divide B): the text batch of
        # 3 one, the t2i CFG batch of 4 two
        per_text, per_t2i = ((pipeline.microbatches(len(TEXT_PROMPTS), 1),
                              pipeline.microbatches(2 * len(T2I_PROMPTS), 1))
                             if name == "pipeline" else (1, 1))
        expect_launches(f"12b {name}", launches[name], {"one-pass": (n_layers * (
            per_text * TEXT_SETTINGS["steps"] + per_t2i * T2I_SETTINGS["timesteps"]), 0, 0)})
    for name in ("auto", "pipeline"):
        if not (torch.equal(out[name][0], out["unsharded"][0])
                and torch.equal(out[name][1], out["unsharded"][1])):
            raise AssertionError(f"12b: {name} answers differ from the unsharded model's")
    log("12b", "sharded and pipelined text and t2i answers equal the unsharded model's")
    del models
    t = time.perf_counter()
    app = parallel_app_phase(loaded, mesh, reset_counts, counts)
    log("12d", f"took {time.perf_counter() - t:.1f}s")
    del loaded
    free_memory()
    return dict(b1=sum(launches[k][0][0] for k in ("auto", "pipeline")) + app["b1"],
                b1_unsharded=launches["unsharded"][0][0], b2=app["b2"],
                seconds={k: v[2] for k, v in out.items()})


def local_heads_phase() -> dict:
    """12c: `tp_attention`'s local body on each head shard of T = 2, 4, 8 at
    the 8B's t2i CFG frame (B1 with RoPE, B2 with the frames' mask), at one
    GQA shape (32 heads over 8 kv heads) and at the 8,192-token frame (B4,
    T = 4): the shards' outputs joined equal the full call bit for bit."""
    import torch

    from mmada_tpu_torch.models import llada
    from mmada_tpu_torch.ops.attention import bidirectional_attention
    from mmada_tpu_torch.parallel.tp_attention import local_attention, shard_heads

    h = llada.llada_8b().n_heads
    cases = [("t2i CFG B1", 4, h, h, T2I_FRAME, True, None, TP_SIZES),
             ("t2i CFG B2 (frame mask)", 4, h, h, T2I_FRAME, True,
              lambda: t2i_mask_bias(cfg_batch=True), TP_SIZES),
             ("gqa 32/8 B1", 2, h, 8, T2I_FRAME, True, None, TP_SIZES),
             ("long 8192 B4", 1, h, h, LONG_FRAME, True, None, (4,))]
    out = {}
    for i, (tag, b, nh, kvh, length, rope, make_bias, sizes) in enumerate(cases):
        q, k, v, sin, cos = attention_case(b, nh, kvh, length, length, rope, seed=900 + i)
        bias = make_bias() if make_bias else None
        full = bidirectional_attention(q, k, v, bias=bias, rope_sin=sin, rope_cos=cos)
        for t in sizes:
            parts = [local_attention(shard_heads(q, r, t), shard_heads(k, r, t),
                                     shard_heads(v, r, t), None, bias=bias, rope_sin=sin,
                                     rope_cos=cos) for r in range(t)]
            joined = torch.cat(parts, dim=1)
            if not torch.equal(joined, full):
                raise AssertionError(f"12c {tag}: {t} head shards joined differ from the full "
                                     f"call (max abs {float((joined - full).abs().max())})")
            out[f"{tag} T={t}"] = list(parts[0].shape)
        del q, k, v, full, parts, joined
    log("12c", f"head shards joined equal the full calls bit for bit: {out}")
    return out


def rel_err(got, want) -> float:
    """max |got - want| / max |want| of two arrays or tensors (numpy, fp64)."""
    import numpy as np

    got, want = (np.asarray(x.detach().cpu() if hasattr(x, "detach") else x, np.float64)
                 for x in (got, want))
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def tree_leaves(tree):
    """The tensors of a nested dict / list / tuple."""
    if isinstance(tree, dict):
        tree = list(tree.values())
    if isinstance(tree, (list, tuple)):
        return [leaf for sub in tree for leaf in tree_leaves(sub)]
    return [tree]


def stand_in_processors(path):
    """transformers' processors over stand-in vocabularies written to
    `path`: CLIP's (the `openai/clip-vit-large-patch14` image processor:
    224 px, bicubic, center crop, CLIP's normalization; a letters-only BPE
    vocab of 49,408 ids with <|startoftext|> 49406 and <|endoftext|> 49407,
    the largest id, as the legacy pooling expects) and BERT's (the five specials and the
    words of T2I_PROMPTS)."""
    import json

    from transformers import BertTokenizer, CLIPImageProcessor, CLIPProcessor, CLIPTokenizer

    os.makedirs(path, exist_ok=True)
    letters = "abcdefghijklmnopqrstuvwxyz"
    vocab = {c: i for i, c in enumerate(letters)}
    vocab.update({c + "</w>": 26 + i for i, c in enumerate(letters)})
    vocab.update({f"<|unused{i}|>": i for i in range(52, 49406)})   # no holes
    vocab.update({"<|startoftext|>": 49406, "<|endoftext|>": 49407})
    with open(os.path.join(path, "vocab.json"), "w") as f:
        json.dump(vocab, f)
    with open(os.path.join(path, "merges.txt"), "w") as f:
        f.write("#version: 0.2\n")
    tok = CLIPTokenizer(os.path.join(path, "vocab.json"), os.path.join(path, "merges.txt"),
                        model_max_length=77)
    CLIPProcessor(image_processor=CLIPImageProcessor(), tokenizer=tok).save_pretrained(path)
    words = ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]"] + sorted(
        {w for p in T2I_PROMPTS for w in p.lower().split()})
    bert = os.path.join(path, "bert")
    os.makedirs(bert, exist_ok=True)
    with open(os.path.join(bert, "vocab.txt"), "w") as f:
        f.write("\n".join(words) + "\n")
    return (CLIPProcessor.from_pretrained(path, local_files_only=True),
            BertTokenizer.from_pretrained(bert, local_files_only=True))


def eval_phase(reset_counts, counts, expect_no_bias_copies) -> dict:
    """Phase 13 (see EVAL_REL): 13a quantative t2i, 13b the t2m eval, 13c
    the motion VQ-VAE's eval, 13d the SMPL fit. Returns the B1 / B2
    launches and the timings."""
    import copy

    import numpy as np
    import torch

    import eval_t2m_torch
    import inference_t2i_torch
    import train_motion_vq_torch
    import train_torch
    from mmada_tpu_torch.core.precision import BF16, exact_fp32_products
    from mmada_tpu_torch.core.vocab import MMADA_8B_T2M
    from mmada_tpu_torch.data.synthetic import write_humanml3d_tree
    from mmada_tpu_torch.entry import decode_images, decode_motion, serve_t2i, serve_t2m
    from mmada_tpu_torch.eval import clip, components, image_quality, smpl_fit
    from mmada_tpu_torch.eval import image_reward as IR
    from mmada_tpu_torch.eval import t2m_metrics as M
    from mmada_tpu_torch.eval.motion_math import recover_from_ric
    from mmada_tpu_torch.eval.t2m_eval import evaluate_motion_vq
    from mmada_tpu_torch.eval.t2m_evaluator import EvaluatorWrapper
    from mmada_tpu_torch.models import llada, magvit2, motion_vq
    from mmada_tpu_torch.models.mmada import MMadaModel
    from mmada_tpu_torch.prompting.universal import ByteTokenizer, SpecialIds, UniversalPrompting

    out = {"b1": 0, "b2": 0, "seconds": {}}
    t_phase = time.perf_counter()
    cfg = llada.llada_8b(MMADA_8B_T2M.total_vocab_size)
    n = cfg.n_layers
    model = MMadaModel.init(cfg, MMADA_8B_T2M, device="cuda", dtype=torch.bfloat16,
                            generator=torch.Generator("cuda").manual_seed(0), policy=BF16)
    masked = dataclasses.replace(model, cfg=dataclasses.replace(cfg, attention_bias_enabled=True))

    # 13a: two t2i requests, decoded and scored
    codes, seconds, launched, _, _ = timed_request(
        lambda: serve_t2i(model, T2I_PROMPTS, **T2I_SETTINGS), reset_counts, counts)
    expect_launches("13a t2i", launched, {"one-pass": (n * T2I_SETTINGS["timesteps"], 0, 0)})
    out["b1"] += launched[0][0]
    out["seconds"]["13a t2i"] = seconds
    vq_cfg = magvit2.magvit2_default()
    vq = magvit2.init_magvit2(vq_cfg, device="cuda",
                              generator=torch.Generator("cuda").manual_seed(0))
    images = decode_images(vq, vq_cfg, codes)
    del vq
    t = time.perf_counter()
    ccfg, rcfg = clip.clip_vit_l14(), IR.image_reward_v1()
    cparams = clip.init_clip(ccfg, seed=0, device="cuda")
    rparams = IR.init_image_reward(rcfg, seed=0, device="cuda")
    tmp = tempfile.mkdtemp(prefix="smoke_processors_")
    try:
        processor, bert = stand_in_processors(tmp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    def scorer(cp, rp):
        towers = image_quality.clip_towers_scorer(cp, ccfg, processor)
        towers.reward_fn = image_quality.blip_reward_fn(rp, rcfg, bert)
        return towers

    card = scorer(cparams, rparams)
    cpu = scorer(move_params(cparams, "cpu"), move_params(rparams, "cpu"))
    n_clip, n_reward = (sum(x.numel() for x in tree_leaves(p)) for p in (cparams, rparams))
    if images.shape[1:3] == (ccfg.image_size, ccfg.image_size):
        raise AssertionError(f"13a: decoded images {tuple(images.shape)} need no resize")
    log("13a", f"{len(T2I_PROMPTS)} t2i requests {seconds:.2f}s, decoded to "
        f"{tuple(images.shape)} (resized to 224 px by the scorers); CLIP ViT-L/14 "
        f"({n_clip / 1e6:.1f}M) and ImageReward-v1.0 ({n_reward / 1e6:.1f}M) made in "
        f"{time.perf_counter() - t:.1f}s")
    results = inference_t2i_torch.quantative(card, images, T2I_PROMPTS)
    pixels = images.numpy().astype(np.float32) / 127.5 - 1.0
    got = dict(image=card.image_embed_fn(pixels), text=card.text_embed_fn(T2I_PROMPTS),
               reward=card.reward_fn(pixels, T2I_PROMPTS))
    t = time.perf_counter()
    want = dict(image=cpu.image_embed_fn(pixels), text=cpu.text_embed_fn(T2I_PROMPTS),
                reward=cpu.reward_fn(pixels, T2I_PROMPTS))
    cpu_s = time.perf_counter() - t
    errs = {k: rel_err(got[k], want[k]) for k in got}
    cpu_results = inference_t2i_torch.quantative(cpu, images, T2I_PROMPTS)
    clip_ms = cuda_ms(lambda: (card.image_embed_fn(pixels), card.text_embed_fn(T2I_PROMPTS)),
                      3, 1) / len(T2I_PROMPTS)
    reward_ms = cuda_ms(lambda: card.reward_fn(pixels, T2I_PROMPTS), 3, 1) / len(T2I_PROMPTS)
    out["clip_ms"], out["reward_ms"] = clip_ms, reward_ms
    log("13a", f"quantative {results}; CPU {cpu_results}; max |card - CPU| / max |CPU|: "
        f"{ {k: f'{v:.2e}' for k, v in errs.items()} } (bar {EVAL_REL:g}); CLIP {clip_ms:.2f} "
        f"ms an image (image + text towers), ImageReward {reward_ms:.2f} ms an image; the CPU "
        f"run {cpu_s:.1f}s")
    if set(results) != {"clip_score_mean", "clip_score", "image_reward_mean"} or not all(
            0 <= c <= 100 for c in results["clip_score"]) or not np.isfinite(
            results["image_reward_mean"]):
        raise AssertionError(f"13a: quantative summary {results}")
    if max(errs.values()) > EVAL_REL:
        raise AssertionError(f"13a: the card's scorers against the CPU's: {errs}")
    del cparams, rparams, card, cpu
    free_memory()

    # 13b: eval_t2m_torch on a HumanML3D-layout tree, the masked 8B
    tmp = tempfile.mkdtemp(prefix="smoke_eval_")
    try:
        root = os.path.join(tmp, "hml")
        split = write_humanml3d_tree(root, EVAL_TREE_CLIPS)
        os.makedirs(os.path.join(tmp, "ev"))
        ev_state = components.random_evaluator_state()
        torch.save(ev_state, os.path.join(tmp, "ev", "finest.tar"))
        data = [f"dataset.motion_root={root}", f"dataset.split_file={split}",
                f"eval.evaluator_dir={os.path.join(tmp, 'ev')}"]
        ecfg = eval_t2m_torch.read_config(data + EVAL_T2M)
        mcfg = motion_vq.MotionVQConfig()
        mvq = motion_vq.init_motion_vq(mcfg, device="cuda",
                                       generator=torch.Generator("cuda").manual_seed(0))
        state = motion_vq.CodebookState.create(mcfg, device="cuda")
        _, _, _, codebook, _ = motion_vq.forward_train(None, mvq, state, mcfg,
                                                      motion_windows(32, 64, seed=5))
        with torch.no_grad():
            mvq.codebook.copy_(codebook)
        evaluator = components.build_evaluator(ecfg, "cuda")
        prompting = UniversalPrompting(ByteTokenizer(), SpecialIds.from_vocab(MMADA_8B_T2M),
                                       max_text_len=T2M_SETTINGS["max_text_len"])
        loaded = eval_t2m_torch.EvalLoaded(masked, mvq, mcfg, evaluator, prompting,
                                           components.build_word_vectorizer(ecfg))
        emb: dict = {}
        metrics, seconds, launched, _, peak = timed_request(
            lambda: eval_t2m_torch.run(ecfg, loaded, embeddings=emb), reset_counts, counts)
        batches = list(components.build_eval_batches(ecfg, loaded.word_vectorizer))
        n_batches, steps = len(batches), int(ecfg.get_path("eval.timesteps"))
        expect_launches("13b t2m eval", launched, {"one-pass bias": (n * steps * n_batches, 0, 0)})
        expect_no_bias_copies("13b t2m eval")
        out["b2"] += launched[1][0]
        out["seconds"]["13b a batch"] = seconds / n_batches
        # the same embeddings on the CPU: the evaluators and the VQ decode of
        # the card's codes, fp32
        cpu_ev = EvaluatorWrapper.from_torch_checkpoint(
            ev_state["text_encoder"], ev_state["motion_encoder"], ev_state["movement_encoder"],
            device="cpu")
        cpu_vq = copy.deepcopy(mvq).cpu()
        rows = int(ecfg.get_path("eval.batch_size"))
        cpu_emb = {"text": [], "gt": [], "gen": []}
        for i, b in enumerate(batches):
            text, gt = cpu_ev.get_co_embeddings(b["word_embs"], b["pos_onehot"], b["cap_lens"],
                                                b["motion"], b["m_lens"])
            gen = motion_vq.decode(cpu_vq, mcfg, torch.as_tensor(emb["codes"][i * rows:(i + 1) *
                                                                              rows]))
            t_len = b["motion"].shape[1]
            gen = torch.nn.functional.pad(gen, (0, 0, 0, max(0, t_len - gen.shape[1])))[:, :t_len]
            frames = min(4 * emb["codes"].shape[1], t_len)
            cpu_emb["gen"].append(cpu_ev.get_motion_embeddings(gen, np.full(len(gen), frames)))
            cpu_emb["text"].append(text)
            cpu_emb["gt"].append(gt)
        errs = {k: rel_err(emb[k], torch.cat(v)) for k, v in cpu_emb.items()}
        mu, sigma = M.calculate_activation_statistics(emb["gt"])
        fid_self = M.calculate_frechet_distance(mu, sigma, mu, sigma)
        log("13b", f"eval_t2m_torch.run: {n_batches} batches of {rows} ({EVAL_TREE_CLIPS} clips), "
            f"{emb['codes'].shape[1]} motion tokens, {steps} steps on the masked 8B: "
            f"{seconds:.2f}s "
            f"({seconds / n_batches:.2f}s a batch); launches {launched}; peak {peak:.2f} GiB; "
            f"metrics { {k: round(float(v), 5) for k, v in metrics.items()} }; FID(gt, gt) "
            f"{fid_self:.3e} (trace {np.trace(sigma):.1f}); embeddings max |card - CPU| / max "
            f"|CPU| { {k: f'{v:.2e}' for k, v in errs.items()} }")
        if max(errs.values()) > EVAL_REL:
            raise AssertionError(f"13b: the evaluator embeddings against the CPU's: {errs}")
        if abs(fid_self) > 1e-6 * np.trace(sigma) or not all(
                0 <= metrics[f"r_precision_top{k}"] <= 1 for k in (1, 2, 3)) or not all(
                np.isfinite(float(v)) for v in metrics.values()):
            raise AssertionError(f"13b: FID(gt, gt) {fid_self}, metrics {metrics}")
        out["t2m_metrics"] = {k: float(v) for k, v in metrics.items()}

        # 13c: train_motion_vq_torch with the reconstruction eval
        argv = data + [EVAL_T2M[0], "eval.run_vq_eval=true",
                       f"training.max_train_steps={EVAL_VQ_STEPS}", "training.batch_size=32",
                       "training.log_every=1", "dataset.window_size=40",
                       f"experiment.output_dir={os.path.join(tmp, 'vq')}"]
        t = time.perf_counter()
        trained, tcfg, history = train_motion_vq_torch.train(train_torch.read_config(argv))
        vq_s = time.perf_counter() - t
        got = {k[len("vq_eval/"):]: v for k, v in history[-1].items() if k.startswith("vq_eval/")}
        vcfg = train_torch.read_config(argv)
        t = time.perf_counter()
        want = evaluate_motion_vq(copy.deepcopy(trained).cpu(), tcfg, cpu_ev,
                                  components.build_eval_batches(
                                      vcfg, components.build_word_vectorizer(vcfg)))
        cpu_vq_s = time.perf_counter() - t
        errs = {k: abs(got[k] - float(v)) / max(abs(float(v)), 1e-12) for k, v in want.items()}
        log("13c", f"train_motion_vq_torch at MotionVQConfig() ({tcfg == mcfg}): "
            f"{EVAL_VQ_STEPS} steps and the eval in {vq_s:.1f}s; vq_eval "
            f"{ {k: round(v, 5) for k, v in got.items()} }; relative to the CPU eval of the "
            f"trained weights ({cpu_vq_s:.1f}s) { {k: f'{v:.1e}' for k, v in errs.items()} }")
        if not np.isfinite(got.get("mpjpe", np.nan)) or errs["mpjpe"] > EVAL_REL:
            raise AssertionError(f"13c: MPJPE {got.get('mpjpe')} against the CPU's "
                                 f"{want['mpjpe']}")
        out["vq_eval"] = got
        mean, std = np.load(os.path.join(root, "Mean.npy")), np.load(os.path.join(root, "Std.npy"))
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    del masked, evaluator, loaded

    # 13d: the SMPL fit of a 196-frame generated clip
    tokens = SMPL_FRAMES // 4
    kw = dict(T2M_SETTINGS, num_motion_tokens=tokens)
    codes, seconds, launched, _, _ = timed_request(
        lambda: serve_t2m(model, [T2M_CAPTION], **kw), reset_counts, counts)
    expect_launches("13d t2m", launched, {"one-pass": (n * kw["timesteps"], 0, 0)})
    out["b1"] += launched[0][0]
    feats = decode_motion(mvq, mcfg, codes)[0].cpu().numpy() * (std + 1e-8) + mean
    joints = np.asarray(recover_from_ric(feats, 22))
    del model
    free_memory()
    info, cpu_info = {}, {}
    t = time.perf_counter()
    smpl_fit.joints2smpl(joints, device="cuda", info=info)
    torch.cuda.synchronize()
    card_s = time.perf_counter() - t
    t = time.perf_counter()
    _, verts, _ = smpl_fit.joints2smpl(joints, device="cpu", info=cpu_info)
    cpu_fit_s = time.perf_counter() - t
    # the control: the same fit on the card with TF32 products
    matmul, tf32_info = torch.backends.cuda.matmul, {}
    saved, matmul.fp32_precision = matmul.fp32_precision, "tf32"
    try:
        smpl_fit.joints2smpl(joints, device="cuda", info=tf32_info)
    finally:
        matmul.fp32_precision = saved

    def loss_and_joints(fit):
        return (abs(fit["loss"] - cpu_info["loss"]) / abs(cpu_info["loss"]),
                float(np.abs(fit["joints"] - cpu_info["joints"]).max()))

    (loss_rel, joint_err), (tf32_loss, tf32_joints) = map(loss_and_joints, (info, tf32_info))
    fit_rmse = float(np.sqrt(np.mean((info["joints"][:, :22] + info["cam"].reshape(-1, 1, 3)
                                      - joints) ** 2)))
    out["seconds"]["13d smpl card"], out["seconds"]["13d smpl cpu"] = card_s, cpu_fit_s
    log("13d", f"joints2smpl of {joints.shape} joints (SMPLifyConfig(): 20 + 150 Adam steps): "
        f"card {card_s:.2f}s, CPU {cpu_fit_s:.2f}s; final loss {info['loss']:.2f} (CPU "
        f"{cpu_info['loss']:.2f}, rel {loss_rel:.1e}, bar {SMPL_LOSS_RTOL:g}); joints max "
        f"|card - CPU| {joint_err:.2e} m (bar {SMPL_JOINT_ATOL:g}); the control with TF32: "
        f"loss rel {tf32_loss:.1e}, joints {tf32_joints:.2e} m; fit RMSE {fit_rmse:.4f} m; "
        f"vertices {verts.shape}")
    if loss_rel > SMPL_LOSS_RTOL or joint_err > SMPL_JOINT_ATOL or not np.isfinite(fit_rmse):
        raise AssertionError(f"13d: the card's fit against the CPU's: loss rel {loss_rel}, "
                             f"joints {joint_err}")
    del mvq
    free_memory()
    out["seconds"]["phase 13"] = time.perf_counter() - t_phase
    return out


# --------------------------------------------------------------------------
# phase 14 (A.17): fp32 operands and every head width on the card
# --------------------------------------------------------------------------

def generic_counters():
    """(reset, read) of the launch counters of B7 (`.generic_launches` and
    `.generic_bias_launches` of the forward wrappers, both tiers; and by
    body, `.wgmma_body_launches` and `.ffma_body_launches`: "b7_wgmma",
    "b7_ffma"), B8-dq and B8-dkv (the same, by body: "dq_wgmma",
    "dq_ffma", "dkv_wgmma", "dkv_ffma") and B6-f32 (`int4_matmul.f32_launches`);
    `reset_counts` leaves them alone, so that phase 14 can show phases 2-13
    launched none."""
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

    wrappers = {"b7": (flash_attention, flash_attention_long),
                "dq": (attention_bwd_dq, attention_bwd_dq_long),
                "dkv": (attention_bwd_dkv, attention_bwd_dkv_long)}
    counters = [(f"{kind}{suffix}", fn, attr) for kind, fns in wrappers.items()
                for suffix, attr in (("", "generic_launches"), ("_bias", "generic_bias_launches"))
                for fn in fns] + [("b6_f32", int4_matmul, "f32_launches")] + [
        (f"{kind}_{body}", fn, f"{body}_body_launches") for kind, fns in wrappers.items()
        for body in ("wgmma", "ffma") for fn in fns]

    def reset():
        for _, fn, attr in counters:
            setattr(fn, attr, 0)

    def read() -> dict:
        out = collections.Counter()
        for key, fn, attr in counters:
            out[key] += getattr(fn, attr)
        return {k: out[k] for k in ("b7", "b7_bias", "dq", "dq_bias", "dkv", "dkv_bias",
                                    "b6_f32", "b7_wgmma", "b7_ffma", "dq_wgmma", "dq_ffma",
                                    "dkv_wgmma", "dkv_ffma")}

    return reset, read


def expect_generic(phase, launched, want) -> None:
    """B7 / B8 / B6-f32 launches (`generic_counters` read) must equal `want`
    (keys it leaves out: 0)."""
    expected = {k: want.get(k, 0) for k in launched}
    if launched != expected:
        raise AssertionError(f"{phase} launched {launched}, expected {expected}")


def generic_bounds(dtype, b, h, kvh, lq, lk, d, rope, bias):
    """(forward, dq, dkv) bounds of B7 / B8: `attention_bound`'s and
    `bwd_bounds`' counts at head width d, at the card's rate for `dtype`
    operands (bf16 on the tensor cores, fp32 on the CUDA cores: TF32
    cannot meet fp32's bar)."""
    import torch

    es, peak = (2, PEAK_BF16_FLOPS) if dtype == torch.bfloat16 else (4, PEAK_FP32_FLOPS)
    return (attention_bound(b, h, kvh, lq, lk, rope, bias, d, es, peak),
            *bwd_bounds(b, h, kvh, lq, lk, bias, d, es, peak))


def generic_case(dtype, b, h, kvh, lq, lk, d, rope, seed):
    """Inputs of one B7 / B8 case: `attention_case`'s at head width d in
    `dtype`."""
    import torch

    from mmada_tpu_torch.models.llada import rope_sin_cos

    g = torch.Generator("cuda").manual_seed(seed)

    def randn(*shape):
        return torch.randn(shape, generator=g, device="cuda").to(dtype)

    q, k, v = randn(b, h, lq, d) * 3.0, randn(b, kvh, lk, d), randn(b, kvh, lk, d)
    sin, cos = rope_sin_cos(lq, d, 500000.0, device="cuda") if rope else (None, None)
    return q, k, v, sin, cos


def padded_rows_bias(b, l):
    """The mask bias of b frames of length l whose first 10 + 15 row
    positions are pads (those query rows have no allowed key)."""
    import numpy as np

    keep = np.ones((b, l), np.int64)
    for row in range(b):
        keep[row, :10 + 15 * row] = 0
    return _mask_bias(keep)


def generic_cases():
    """(tag, dtype, B, H, KVH, Lq, Lk, D, rope, bias maker) of B7 and B8: fp32
    at D 16, 64, 128 and 256, bf16 at D 16, 48, 96, 192, 256 and 512 (B7's
    wgmma body, zero-filled to its instances 64, 128, 256 and 512; B8's
    wgmma body up to 256, its ffma body at 512), unbiased and biased, with
    RoPE, rectangular, GQA; then the paths' shapes: the t2i CFG frame in
    fp32 at D 128 (the fp32 8B) and in bf16 at D 256 and 512 (256- and
    512-wide heads)."""
    import torch

    f32, b16, t2i = torch.float32, torch.bfloat16, T2I_FRAME
    return [
        ("fp32 D16 gqa rope", f32, 2, 8, 2, 387, 387, 16, True, None),
        ("fp32 D64 rope mask", f32, 2, 8, 8, 387, 387, 64, True,
         lambda: padded_rows_bias(2, 387)),
        ("fp32 D128 rectangular", f32, 2, 32, 32, 256, t2i, 128, False, None),
        ("fp32 D256 rope per-head bias", f32, 1, 4, 4, 333, 333, 256, True,
         lambda: random_bias(1, 4, 333, 333, 11)),
        ("bf16 D16 gqa", b16, 2, 8, 2, 387, 387, 16, False, None),
        ("bf16 D48 rope mask", b16, 2, 8, 8, 387, 387, 48, True,
         lambda: padded_rows_bias(2, 387)),
        ("bf16 D96 gqa rope mask", b16, 2, 8, 2, 387, 387, 96, True,
         lambda: padded_rows_bias(2, 387)),
        ("bf16 D192 rope per-head bias", b16, 1, 8, 8, 333, 333, 192, True,
         lambda: random_bias(1, 8, 333, 333, 13)),
        ("bf16 D256 rope", b16, 1, 16, 16, 640, 640, 256, True, None),
        ("bf16 D512 rectangular per-head bias", b16, 1, 4, 4, 200, 500, 512, False,
         lambda: random_bias(1, 4, 200, 500, 12)),
        ("t2i CFG fp32 D128", f32, 4, 32, 32, t2i, t2i, 128, True, None),
        ("masked t2i CFG fp32 D128", f32, 4, 32, 32, t2i, t2i, 128, True,
         lambda: t2i_mask_bias(cfg_batch=True)),
        ("t2i CFG bf16 D256", b16, 4, 16, 16, t2i, t2i, 256, True, None),
        ("t2i CFG bf16 D512", b16, 4, WIDER_HEADS, WIDER_HEADS, t2i, t2i, 512, True, None),
    ]


def float64_attention(q, k, v, rope_sin, rope_cos, bias):
    """The one-pass function in float64 on the rotated operands, a batch at
    a time (the t2i frame's scores take 1.4 GB in float64 for all four)."""
    import torch

    from mmada_tpu_torch.ops.attention import apply_rope
    from mmada_tpu_torch.ops.flash_attention import _heads_like_q, bias_as_float

    if rope_sin is not None:
        q, k = apply_rope(q, k, rope_sin, rope_cos)
    h, d = q.shape[1], q.shape[3]
    k, v = _heads_like_q(k, h).double(), _heads_like_q(v, h).double()
    bias = bias_as_float(bias)
    out = []
    for i in range(q.shape[0]):
        s = torch.matmul(q[i:i + 1].double(), k[i:i + 1].transpose(-1, -2)) / d ** 0.5
        if bias is not None:
            s = s + bias[i if bias.shape[0] > 1 else 0:][:1].double()
        out.append(torch.matmul(torch.softmax(s, dim=-1), v[i:i + 1]))
    return torch.cat(out)


def float64_attention_bwd(q, k, v, dout, bias):
    """(dq, dk, dv) of the one-pass function in float64 on the rotated
    operands, delta from the float64 output, a batch at a time (dk and dv
    summed over each kv head's query heads)."""
    import torch

    from mmada_tpu_torch.ops.flash_attention import _heads_like_q, bias_as_float

    h, kvh, d = q.shape[1], k.shape[1], q.shape[3]
    bias = bias_as_float(bias)
    grads = []
    for i in range(q.shape[0]):
        qi, do = q[i:i + 1].double(), dout[i:i + 1].double()
        ki, vi = _heads_like_q(k[i:i + 1], h).double(), _heads_like_q(v[i:i + 1], h).double()
        s = torch.matmul(qi, ki.transpose(-1, -2)) / d ** 0.5
        if bias is not None:
            s = s + bias[i if bias.shape[0] > 1 else 0:][:1].double()
        p = torch.softmax(s, dim=-1)
        del s
        o = torch.matmul(p, vi)
        ds = p * (torch.matmul(do, vi.transpose(-1, -2)) - (do * o).sum(-1, keepdim=True))
        lk = ki.shape[2]
        dk = torch.matmul(ds.transpose(-1, -2), qi) / d ** 0.5
        dv = torch.matmul(p.transpose(-1, -2), do)
        grads.append((torch.matmul(ds, ki) / d ** 0.5,
                      dk.view(1, kvh, h // kvh, lk, d).sum(2),
                      dv.view(1, kvh, h // kvh, lk, d).sum(2)))
        del p, ds, o
    return tuple(torch.cat(parts) for parts in zip(*grads))


def generic_fwd_ok(got, want, long=False):
    """(max abs err, passes) of a B7 output: fp32 within GENERIC_FWD_ATOL;
    bf16 at phase 3's bars (the one-pass tier's atol / rtol and differing
    share; the long tier within one bf16 ulp)."""
    import torch

    err = float((got.float() - want.float()).abs().max())
    if got.dtype == torch.float32:
        return err, bool(torch.isfinite(got).all()) and err <= GENERIC_FWD_ATOL
    if long:
        return within_one_ulp(got, want)
    close = bool(((got.float() - want.float()).abs()
                  <= KERNEL_ATOL + KERNEL_RTOL * want.float().abs()).all())
    return err, bool(torch.isfinite(got).all()) and close and (
        differing_share(got, want) <= B1_DIFFER_SHARE)


def generic_grad_error(got, want, long=False):
    """(max abs err, rel L2, passes) of a B8 gradient: fp32 within
    GENERIC_GRAD_REL of its largest entry; bf16 at phase 3's bars."""
    import torch

    if got.dtype != torch.float32:
        return long_grad_error(got, want) if long else grad_error(got, want)
    err = (got - want).abs()
    max_err, rel = float(err.max()), float((got - want).norm() / want.norm())
    return max_err, rel, bool(torch.isfinite(got).all()) and (
        max_err <= GENERIC_GRAD_REL * float(want.abs().max()))


def b8_body_launched(tag, dq_fn, dkv_fn, body, run):
    """Run `run()` (one B8-dq and one B8-dkv call through `dq_fn` and
    `dkv_fn`) and fail unless each moved its `body` counter by one and its
    other body's by none; returns what `run` returns."""
    other = "ffma" if body == "wgmma" else "wgmma"
    fns = (dq_fn, dkv_fn)
    before = [(getattr(f, f"{body}_body_launches"), getattr(f, f"{other}_body_launches"))
              for f in fns]
    out = run()
    after = [(getattr(f, f"{body}_body_launches"), getattr(f, f"{other}_body_launches"))
             for f in fns]
    if after != [(a + 1, o) for a, o in before]:
        raise AssertionError(f"{tag}: B8's {body} body did not launch once each "
                             f"({before} -> {after})")
    return out


def check_generic_kernels(cases):
    """B7 and B8 against their plain versions (the backward as a pair: B8-dq's
    lse goes into B8-dkv, the plain dq's into the plain dkv), with their
    times, each case's B7 and B8 bodies asserted; each fp32 case also
    against the float64 function (forward and gradients), no further from it
    than GENERIC_F64_RATIO times the plain version; returns per-case
    records."""
    import torch
    import torch.nn.functional as F

    from mmada_tpu_torch.ops.attention import apply_rope
    from mmada_tpu_torch.ops.flash_attention import (
        attention_bwd_dkv,
        attention_bwd_dkv_reference,
        attention_bwd_dq,
        attention_bwd_dq_reference,
        attention_delta,
        flash_attention,
        flash_attention_reference,
        generic_body,
        kernel_for,
    )

    records = []
    for i, (tag, dtype, b, h, kvh, lq, lk, d, rope, make_bias) in enumerate(cases):
        body, bwd_body = generic_body(dtype, d), generic_body(dtype, d, backward=True)
        launched = getattr(flash_attention, f"{body}_body_launches")
        if kernel_for(dtype, d) != "generic":
            raise AssertionError(f"{tag}: kernel_for routes {dtype} D {d} to the wgmma kernels")
        q, k, v, sin, cos = generic_case(dtype, b, h, kvh, lq, lk, d, rope, seed=1400 + i)
        bias = make_bias() if make_bias else None
        kw = dict(rope_sin=sin, rope_cos=cos, bias=bias)
        out = flash_attention(q, k, v, **kw)
        ref = flash_attention_reference(q, k, v, **kw)
        torch.cuda.synchronize()
        if getattr(flash_attention, f"{body}_body_launches") != launched + 1:
            raise AssertionError(f"{tag}: B7's {body} body did not launch")
        fwd_err, fwd_ok = generic_fwd_ok(out, ref)
        f64 = None
        if dtype == torch.float32:
            exact = float64_attention(q, k, v, sin, cos, bias)
            f64 = dict(kernel=float((out.double() - exact).abs().max()),
                       plain=float((ref.double() - exact).abs().max()))
            del exact
            free_memory()
        qr, kr = apply_rope(q, k, sin, cos) if rope else (q, k)
        g = torch.Generator("cuda").manual_seed(1500 + i)
        dout = torch.randn((b, h, lq, d), generator=g, device="cuda").to(dtype)
        if bias is not None:
            dout = dout * live_rows(bias, dout.shape)
        delta = attention_delta(ref, dout)

        def backward():
            dq, lse = attention_bwd_dq(qr, kr, v, dout, delta, bias)
            return (dq, lse, *attention_bwd_dkv(qr, kr, v, dout, lse, delta, bias))

        dq, lse, dk, dv = b8_body_launched(tag, attention_bwd_dq, attention_bwd_dkv, bwd_body,
                                           backward)
        want_dq, want_lse = attention_bwd_dq_reference(qr, kr, v, dout, delta, bias)
        want_dk, want_dv = attention_bwd_dkv_reference(qr, kr, v, dout, want_lse, delta, bias)
        torch.cuda.synchronize()
        errors = {name: generic_grad_error(a, w) for name, a, w in (
            ("dq", dq, want_dq), ("dk", dk, want_dk), ("dv", dv, want_dv))}
        lse_err = float((lse - want_lse).abs().max())
        if dtype == torch.float32:   # the gradients' distance from float64, kernel and plain
            exact = float64_attention_bwd(qr, kr, v, dout, bias)
            f64["grads"] = {name: dict(kernel=float((a.double() - e).abs().max()),
                                       plain=float((w.double() - e).abs().max()))
                            for name, a, w, e in zip(("dq", "dk", "dv"), (dq, dk, dv),
                                                     (want_dq, want_dk, want_dv), exact)}
            del exact
            free_memory()

        (fwd_b, fwd_by), (dq_b, dq_by), (dkv_b, dkv_by) = generic_bounds(
            dtype, b, h, kvh, lq, lk, d, rope, bias)
        gqa = {"enable_gqa": True} if kvh != h else {}
        mask = sdpa_mask(bias, dtype)
        lib_in = [t.detach().requires_grad_() for t in (qr, kr, v)]
        lib_out = F.scaled_dot_product_attention(*lib_in, attn_mask=mask, **gqa)
        rec = dict(
            tag=tag, dtype=str(dtype).split(".")[-1], shape=[b, h, kvh, lq, lk], d=d, rope=rope,
            body=body, bias=None if bias is None else list(bias.shape), max_abs_err=fwd_err,
            ms=cuda_ms(lambda: flash_attention(q, k, v, **kw), 5),
            plain_ms=cuda_ms(lambda: flash_attention_reference(q, k, v, **kw), 2, 1),
            library_ms=cuda_ms(lambda: F.scaled_dot_product_attention(
                qr, kr, v, attn_mask=mask, **gqa), 5),
            bound_ms=fwd_b, bound_by=fwd_by, lse_max_abs_err=lse_err, float64_max_abs_err=f64,
            errors={k: [e[0], e[1]] for k, e in errors.items()},
            dq=dict(body=bwd_body,
                    ms=cuda_ms(lambda: attention_bwd_dq(qr, kr, v, dout, delta, bias), 5),
                    plain_ms=cuda_ms(lambda: attention_bwd_dq_reference(
                        qr, kr, v, dout, delta, bias), 2, 1),
                    bound_ms=dq_b, bound_by=dq_by, max_abs_err=errors["dq"][0]),
            dkv=dict(body=bwd_body,
                     ms=cuda_ms(lambda: attention_bwd_dkv(qr, kr, v, dout, lse, delta, bias), 5),
                     plain_ms=cuda_ms(lambda: attention_bwd_dkv_reference(
                         qr, kr, v, dout, lse, delta, bias), 2, 1),
                     bound_ms=dkv_b, bound_by=dkv_by,
                     max_abs_err=max(errors["dk"][0], errors["dv"][0])),
            bwd_library_ms=cuda_ms(
                lambda: torch.autograd.grad(lib_out, lib_in, dout, retain_graph=True), 5))
        log("generic", json.dumps(rec))
        bad = [k for k, e in errors.items() if not e[2]]
        if not fwd_ok or bad or lse_err > LSE_ATOL:
            raise AssertionError(f"B7 / B8 disagree with their plain versions on {tag}: forward "
                                 f"{fwd_ok} (max abs {fwd_err}), gradients {bad}, lse {lse_err}")
        if f64 is not None and f64["kernel"] > GENERIC_F64_RATIO * f64["plain"]:
            raise AssertionError(f"B7 on {tag} lies {f64['kernel']} from float64, more than "
                                 f"{GENERIC_F64_RATIO} x the plain version's {f64['plain']}")
        far = {name: g for name, g in (f64 or {}).get("grads", {}).items()
               if g["kernel"] > GENERIC_F64_RATIO * g["plain"]}
        if far:
            raise AssertionError(f"B8 on {tag}: gradients further from float64 than "
                                 f"{GENERIC_F64_RATIO} x the plain version's: {far}")
        records.append(rec)
        del q, k, v, out, ref, qr, kr, dout, dq, dk, dv, want_dq, want_dk, want_dv, lib_in, lib_out
        free_memory()
    return records


def check_generic_long(cases):
    """B7-long, B8-dq-long and B8-dkv against their plain versions (by head
    chunks) at 8,192 tokens; returns per-case records."""
    import torch
    import torch.nn.functional as F

    from mmada_tpu_torch.ops.flash_attention import attention_delta, generic_body
    from mmada_tpu_torch.ops.flash_attention_long import (
        attention_bwd_dkv_long,
        attention_bwd_dkv_long_reference,
        attention_bwd_dq_long,
        attention_bwd_dq_long_reference,
        flash_attention_long,
        flash_attention_long_reference,
    )

    records = []
    for i, (tag, dtype, b, h, kvh, l, d) in enumerate(cases):
        q, k, v, _, _ = generic_case(dtype, b, h, kvh, l, l, d, False, seed=1600 + i)
        body, bwd_body = generic_body(dtype, d), generic_body(dtype, d, backward=True)
        launched = getattr(flash_attention_long, f"{body}_body_launches")
        out = flash_attention_long(q, k, v)
        ref = by_heads(flash_attention_long_reference, h, kvh, q, k, v)
        torch.cuda.synchronize()
        if getattr(flash_attention_long, f"{body}_body_launches") != launched + 1:
            raise AssertionError(f"{tag}: B7-long's {body} body did not launch")
        fwd_err, fwd_ok = generic_fwd_ok(out, ref, long=True)
        g = torch.Generator("cuda").manual_seed(1700 + i)
        dout = torch.randn((b, h, l, d), generator=g, device="cuda").to(dtype)
        delta = attention_delta(ref, dout)

        def backward():
            dq, lse = attention_bwd_dq_long(q, k, v, dout, delta)
            return (dq, lse, *attention_bwd_dkv_long(q, k, v, dout, lse, delta))

        dq, lse, dk, dv = b8_body_launched(tag, attention_bwd_dq_long, attention_bwd_dkv_long,
                                           bwd_body, backward)
        want_dq, want_lse = by_heads(attention_bwd_dq_long_reference, h, kvh, q, k, v, dout,
                                     delta, heads=2)
        want_dk, want_dv = by_heads(attention_bwd_dkv_long_reference, h, kvh, q, k, v, dout,
                                    want_lse, delta, heads=2)
        torch.cuda.synchronize()
        errors = {name: generic_grad_error(a, w, long=True) for name, a, w in (
            ("dq", dq, want_dq), ("dk", dk, want_dk), ("dv", dv, want_dv))}
        lse_err = float((lse - want_lse).abs().max())
        (fwd_b, fwd_by), (dq_b, dq_by), (dkv_b, dkv_by) = generic_bounds(
            dtype, b, h, kvh, l, l, d, False, None)
        lib_in = [t.detach().requires_grad_() for t in (q, k, v)]
        lib_out = F.scaled_dot_product_attention(*lib_in)
        rec = dict(
            tag=tag, dtype=str(dtype).split(".")[-1], shape=[b, h, kvh, l, l], d=d, rope=False,
            body=body, bias=None, max_abs_err=fwd_err,
            ms=cuda_ms(lambda: flash_attention_long(q, k, v), 2),
            plain_ms=cuda_ms(lambda: by_heads(flash_attention_long_reference, h, kvh, q, k, v),
                             1, 1),
            library_ms=cuda_ms(lambda: F.scaled_dot_product_attention(q, k, v), 3),
            bound_ms=fwd_b, bound_by=fwd_by, lse_max_abs_err=lse_err,
            errors={k: [e[0], e[1]] for k, e in errors.items()},
            dq=dict(body=bwd_body,
                    ms=cuda_ms(lambda: attention_bwd_dq_long(q, k, v, dout, delta), 2),
                    plain_ms=cuda_ms(lambda: by_heads(attention_bwd_dq_long_reference, h, kvh, q,
                                                      k, v, dout, delta, heads=2), 1, 1),
                    bound_ms=dq_b, bound_by=dq_by, max_abs_err=errors["dq"][0]),
            dkv=dict(body=bwd_body,
                     ms=cuda_ms(lambda: attention_bwd_dkv_long(q, k, v, dout, lse, delta), 2),
                     plain_ms=cuda_ms(lambda: by_heads(attention_bwd_dkv_long_reference, h, kvh,
                                                       q, k, v, dout, lse, delta, heads=2), 1, 1),
                     bound_ms=dkv_b, bound_by=dkv_by,
                     max_abs_err=max(errors["dk"][0], errors["dv"][0])),
            bwd_library_ms=cuda_ms(
                lambda: torch.autograd.grad(lib_out, lib_in, dout, retain_graph=True), 2))
        log("generic long", json.dumps(rec))
        bad = [k for k, e in errors.items() if not e[2]]
        if not fwd_ok or bad or lse_err > LONG_LSE_ATOL:
            raise AssertionError(f"B7-long / B8-long disagree with their plain versions on "
                                 f"{tag}: forward {fwd_ok} (max abs {fwd_err}), gradients {bad}, "
                                 f"lse {lse_err}")
        records.append(rec)
        del q, k, v, out, ref, dout, dq, dk, dv, want_dq, want_dk, want_dv, lib_in, lib_out
        free_memory()
    return records


# B6-f32's cases in phase 14a and in `attention_ab.py --only int4`: the int4
# fp32 8B's t2i CFG ff_proj / ff_up, the text batch's ff_out, and 14c's text
# request's q/k/v (63 rows: K split in four, `int4_matmul.f32_splits`)
INT4_F32_CASES = [("t2i CFG ff_proj", 4620, 4096, 12288), ("text ff_out", 477, 12288, 4096),
                  ("fp32 text q/k/v", 1 + len(TEXT_PROMPTS[0].encode()) + FP32_TEXT["gen_length"],
                   4096, 4096)]


def int4_f32_operands(m, k, n, seed):
    """(x, packed, scales) of a B6-f32 case on the card: x fp32 (m, k) and a
    random (k, n) weight packed to int4, from `seed`."""
    import torch

    from mmada_tpu_torch.ops.int4_matmul import pack_int4

    g = torch.Generator("cuda").manual_seed(seed)
    x = torch.randn((m, k), generator=g, device="cuda")
    return (x, *pack_int4(torch.randn((k, n), generator=g, device="cuda") * 0.02))


def check_int4_f32(cases):
    """B6-f32 against its plain version (fp32 x @ the fp32 dequantisation) at
    the 8B's shapes, and both against the same product in float64: the
    kernel no further from it than GENERIC_F64_RATIO times the plain
    version; returns per-case records."""
    import torch

    from mmada_tpu_torch.ops.int4_matmul import int4_matmul, int4_matmul_reference, unpack_int4

    records = []
    for i, (tag, m, k, n) in enumerate(cases):
        x, packed, scales = int4_f32_operands(m, k, n, seed=1800 + i)
        out = int4_matmul(x, packed, scales)
        ref = int4_matmul_reference(x, packed, scales)
        torch.cuda.synchronize()
        err = float((out - ref).abs().max())
        ok = out.dtype == torch.float32 and bool(torch.isfinite(out).all()) and (
            err <= GENERIC_INT4_REL * float(ref.abs().max()))
        w = unpack_int4(packed, scales, torch.float32)
        exact = x.double() @ w.double()
        f64 = dict(kernel=float((out.double() - exact).abs().max()),
                   plain=float((ref.double() - exact).abs().max()))
        del exact
        bound_ms, bound_by = bound(2 * m * k * n, 4 * m * k + k * n // 2 + 4 * (k // 128) * n
                                   + 4 * m * n, PEAK_FP32_FLOPS)
        rec = dict(tag=tag, shape=[m, k, n], max_abs_err=err, max_abs_out=float(ref.abs().max()),
                   float64_max_abs_err=f64,
                   ms=cuda_ms(lambda: int4_matmul(x, packed, scales), 5),
                   plain_ms=cuda_ms(lambda: int4_matmul_reference(x, packed, scales), 3, 1),
                   library_ms=cuda_ms(lambda: x @ w, 5), bound_ms=bound_ms, bound_by=bound_by)
        log("B6-f32", json.dumps(rec))
        if not ok:
            raise AssertionError(f"B6-f32 disagrees with its plain version on {tag}: {err}")
        if f64["kernel"] > GENERIC_F64_RATIO * f64["plain"]:
            raise AssertionError(f"B6-f32 on {tag} lies {f64['kernel']} from float64, more than "
                                 f"{GENERIC_F64_RATIO} x the plain version's {f64['plain']}")
        records.append(rec)
        del x, packed, scales, out, ref, w
        free_memory()
    return records


@contextlib.contextmanager
def greedy_t2i():
    """`MMadaModel.t2i_generate` made greedy: the card's and the CPU's
    categorical draws differ (their generators), argmax does not."""
    from mmada_tpu_torch.models.mmada import MMadaModel

    inner = MMadaModel.t2i_generate

    def greedy(self, *args, **kw):
        kw["greedy"] = True
        return inner(self, *args, **kw)

    MMadaModel.t2i_generate = greedy
    try:
        yield
    finally:
        MMadaModel.t2i_generate = inner


def tiny_cli_phase(reset_counts, counts, generic_reset, generic_read) -> dict:
    """14b: configs/tiny_test.yaml (the fp32 policy, 4 heads of 16) through
    the command lines' `load` / `run` on the card against the same calls on
    the CPU, the CPU's random weights moved to the card: text, t2i (greedy)
    and MMU token-exact at T = 0, and `train_torch.setup`'s trainer for 2
    steps, each step's corrupted batch also taken by the CPU trainer, losses
    within 1e-5 relative. Every launch is B7 / B8 (none of the wgmma
    kernels), counted by the schedule; returns them."""
    import numpy as np
    import torch

    import generate_torch
    import inference_mmu_torch
    import inference_t2i_torch
    import train_torch
    from mmada_tpu_torch.core.precision import FP32
    from mmada_tpu_torch.models import llada
    from mmada_tpu_torch.training.train_step import corrupt_batch

    base = [f"config={TINY_CONFIG}"]
    tmp = tempfile.mkdtemp(prefix="tiny_cli_")
    try:
        cpu = inference_t2i_torch.load(inference_t2i_torch.read_config(base + ["device=cpu"]))
        card = cpu._replace(model=dataclasses.replace(
            cpu.model, params=move_params(cpu.model.params, "cuda")),
            vq=move_params(cpu.vq, "cuda"))
        cfg = cpu.model.cfg
        if cpu.model.policy != FP32 or cfg.head_dim != 16:
            raise AssertionError(f"tiny_test.yaml builds {cpu.model.policy}, head_dim "
                                 f"{cfg.head_dim}: not the fp32 16-wide model")
        n = cfg.n_layers
        image = torch.as_tensor(np.random.default_rng(5).uniform(
            -1, 1, (1, 16, 16, 3)).astype(np.float32))
        text = [f"{k}={v}" for k, v in TINY_TEXT.items()]
        mmu = [f"{k}={v}" for k, v in TINY_MMU.items()]
        t2i = ["batch_size=2", "generation_temperature=0"]
        calls = [
            ("generate_torch", generate_torch, text,
             lambda c, ld: generate_torch.run(c, ld, [TEXT_PROMPTS[2]]),
             n * TINY_TEXT["steps"]),
            ("inference_t2i_torch", inference_t2i_torch, t2i,
             lambda c, ld: inference_t2i_torch.run(c, ld, T2I_PROMPTS),
             n * int(cpu_timesteps(inference_t2i_torch, base + t2i))),
            ("inference_mmu_torch", inference_mmu_torch, mmu,
             lambda c, ld: inference_mmu_torch.run(c, ld, image), n * TINY_MMU["steps"]),
        ]
        out = {}
        for name, cli, args, call, want_b7 in calls:
            with greedy_t2i():
                want = call(cli.read_config(base + args + ["device=cpu"]), cpu)
                reset_counts()
                generic_reset()
                t = time.perf_counter()
                got = call(cli.read_config(base + args), card)
                torch.cuda.synchronize()
                secs = time.perf_counter() - t
            launched = generic_read()
            expect_launches(f"14b {name}", counts(), {})
            expect_generic(f"14b {name}", launched, {"b7": want_b7, "b7_ffma": want_b7})
            if name == "inference_t2i_torch":   # (codes, images): codes exact, images one level
                same = bool(torch.equal(got[0], want[0])) and int(
                    (got[1].int() - want[1].int()).abs().max()) <= 1
            else:
                same = _same(got, want)
            log("tiny cli", f"{name} on the card: {secs:.2f}s, B7 {launched['b7']}; "
                f"equal to the CPU's: {same}")
            if not same:
                raise AssertionError(f"14b: {name} on the card differs from the CPU")
            out[name] = launched

        def setup(device):
            args = base + ["dataset.synthetic=true", "training.max_train_steps=2",
                           f"experiment.output_dir={os.path.join(tmp, device or 'cuda')}"]
            cfg = train_torch.read_config(args + ([f"device={device}"] if device else []))
            return cfg, *train_torch.setup(cfg)

        _, cpu_tr, _ = setup("cpu")
        card_cfg, card_tr, loader = setup(None)
        with torch.no_grad():
            cpu_leaves = dict(llada.named_leaves(cpu_tr.state.params))
            for name, leaf in llada.named_leaves(card_tr.state.params):
                leaf.copy_(cpu_leaves[name])
        step_card, step_cpu, losses = card_tr.train_step, cpu_tr.train_step, []

        def twin(state, batch, generator):
            prepared = corrupt_batch(step_card.model, step_card.sc, batch, generator)
            state, metrics = step_card.apply(state, prepared)
            cpu_tr.state, cpu_metrics = step_cpu.apply(cpu_tr.state, {
                k: v.cpu() if torch.is_tensor(v) else v for k, v in prepared.items()})
            losses.append((float(metrics["loss"]), float(cpu_metrics["loss"])))
            return state, metrics

        card_tr.train_step = twin
        reset_counts()
        generic_reset()
        t = time.perf_counter()
        card_tr.fit(loader, rng_seed=card_cfg.get_path("training.seed", 0))
        torch.cuda.synchronize()
        secs = time.perf_counter() - t
        launched = generic_read()
        expect_launches("14b train_torch", counts(), {})
        expect_generic("14b train_torch", launched,
                       {"b7": 2 * n, "dq": 2 * n, "dkv": 2 * n, "b7_ffma": 2 * n,
                        "dq_ffma": 2 * n, "dkv_ffma": 2 * n})
        rel = [abs(a - b) / abs(b) for a, b in losses]
        log("tiny cli", f"train_torch on the card: 2 steps in {secs:.2f}s, losses card/CPU "
            f"{losses} (rel {rel}, limit 1e-5); launches {launched}")
        if len(losses) != 2 or not all(math.isfinite(a) for a, _ in losses) or max(rel) > 1e-5:
            raise AssertionError(f"14b: train_torch's steps on the card differ from the CPU's")
        out["train_torch"] = launched
        return out
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def cpu_timesteps(cli, argv) -> int:
    """The t2i command line's timesteps for `argv`."""
    return cli.settings(cli.read_config(argv))["timesteps"]


def fp32_8b_phase(reset_counts, counts, generic_reset, generic_read) -> dict:
    """14c: the full-width 8B in fp32 (random weights, about 32 GB) under the
    FP32 policy: one t2i CFG forward and a short text request through B7,
    the forward's logits against the same weights' fp32 forward with the
    plain attention (`fp32_block_logits`); then quantized to int4, the same
    through B6-f32, against the dequantised fp32 weights in cuBLAS."""
    import torch

    from mmada_tpu_torch.core.precision import FP32
    from mmada_tpu_torch.core.vocab import MMADA_8B
    from mmada_tpu_torch.entry import quantize
    from mmada_tpu_torch.models import llada
    from mmada_tpu_torch.models.mmada import MMadaModel

    free_memory()
    torch.cuda.reset_peak_memory_stats()
    t = time.perf_counter()
    model = MMadaModel.init(llada.llada_8b(), MMADA_8B, device="cuda", dtype=torch.float32,
                            generator=torch.Generator("cuda").manual_seed(0), policy=FP32)
    torch.cuda.synchronize()
    log("fp32 8B", f"built in {time.perf_counter() - t:.1f}s: "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    counters = (reset_counts, counts, generic_reset, generic_read)
    out = {"fp32": fp32_8b_requests("fp32", model, counters,
                                    lambda ids, s, n: fp32_block_logits(model, ids, s, n))}
    qmodel = quantize(model, "int4")   # int4 weights, fp32 x: B6-f32 at every quantized matmul
    del model
    free_memory()

    def dequantised_logits(ids, s, n):
        deq = dataclasses.replace(qmodel, params=dequantized(qmodel.params, torch.float32))
        return deq.forward(ids, logit_positions=(s, n))

    out["int4"] = fp32_8b_requests("int4", qmodel, counters, dequantised_logits)
    del qmodel
    free_memory()
    return out


def fp32_8b_requests(tag, model, counters, reference) -> dict:
    """14c's requests on `model` (the fp32 8B, or its int4 form): one t2i CFG
    forward (timed, peak memory) and a text request of FP32_TEXT, their
    launches counted, and the forward's logits (the image span over the whole
    vocab) against `reference(ids, start, n)`."""
    import torch

    from mmada_tpu_torch.core.vocab import MMADA_8B
    from mmada_tpu_torch.entry import serve_text

    reset_counts, counts, generic_reset, generic_read = counters
    ids = t2i_frames()
    n, layers = T2I_SETTINGS["num_vq_tokens"], model.cfg.n_layers
    start = ids.shape[1] - n - 1
    free_memory()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    generic_reset()
    t = time.perf_counter()
    got = model.forward(ids, logit_positions=(start, n))
    torch.cuda.synchronize()
    fwd_s = time.perf_counter() - t
    peak = torch.cuda.max_memory_allocated() / 2**30
    t = time.perf_counter()
    answers = serve_text(model, [TEXT_PROMPTS[0]], **FP32_TEXT)
    torch.cuda.synchronize()
    text_s = time.perf_counter() - t
    launched = generic_read()
    for ans in answers:
        check_answer_ids(ans, FP32_TEXT["gen_length"], MMADA_8B)
    forwards = 1 + FP32_TEXT["steps"]
    expect_launches(f"14c {tag}", counts(), {})
    expect_generic(f"14c {tag}", launched, {
        "b7": layers * forwards, "b7_ffma": layers * forwards,
        "b6_f32": (7 * layers + 1) * forwards if tag == "int4" else 0})
    want = reference(ids, start, n)
    torch.cuda.synchronize()
    rel = float((got - want).norm() / want.norm())
    log("fp32 8B", f"{tag}: t2i CFG forward {tuple(ids.shape)} in {fwd_s:.2f}s, peak "
        f"{peak:.2f} GiB; text request {FP32_TEXT} in {text_s:.2f}s, first ids "
        f"{answers[0][:12].tolist()}; logits vs the reference: rel L2 {rel:.3e} (limit "
        f"{FP32_MODEL_REL_L2}); launches {launched}")
    if not (torch.isfinite(got).all() and rel <= FP32_MODEL_REL_L2):
        raise AssertionError(f"14c: the fp32 8B ({tag}) disagrees with its reference: {rel}")
    return dict(launched=launched, forward_s=fwd_s, text_s=text_s, peak_gib=peak, rel_l2=rel)


@contextlib.contextmanager
def plain_attention():
    """The model's attention by the kernels' plain versions (forward and
    backward, both tiers) on any device: the reference path."""
    from mmada_tpu_torch.ops import attention
    from mmada_tpu_torch.ops.flash_attention import (
        flash_attention_bwd_reference,
        flash_attention_reference,
    )
    from mmada_tpu_torch.ops.flash_attention_long import (
        flash_attention_bwd_long_reference,
        flash_attention_long_reference,
    )

    names = ("flash_attention", "flash_attention_bwd", "flash_attention_long",
             "flash_attention_bwd_long")
    saved = {k: getattr(attention, k) for k in names}
    for k, fn in zip(names, (flash_attention_reference, flash_attention_bwd_reference,
                             flash_attention_long_reference, flash_attention_bwd_long_reference)):
        setattr(attention, k, fn)
    try:
        yield
    finally:
        for k, fn in saved.items():
            setattr(attention, k, fn)


def wide_heads_phase(reset_counts, counts, generic_reset, generic_read, phase="14d",
                     heads=WIDE_HEADS) -> dict:
    """14d: 256-wide heads at the 8B's widths (d_model 4,096, 16 heads, 2
    layers, bf16, the frames' masks in attention): a masked t2i CFG forward
    (B7-bias) against the fp32 forward of the same weights, and a masked
    stage-1 train step (B7-bias, B8-dq-bias, B8-dkv-bias) against the fp32
    step, both references with the plain attention, at phase 3's bars
    (SMALL_MODEL_REL_L2; SMALL_TRAIN_LOSS_REL, SMALL_TRAIN_GRAD_REL_L2);
    14e (`heads` WIDER_HEADS) the same with 512-wide heads. Each path's
    bodies asserted (`generic_body`: B7's wgmma body at both widths, B8's
    wgmma body at 256 and ffma body at 512)."""
    import torch

    from mmada_tpu_torch.core.precision import BF16, FP32, policy_products
    from mmada_tpu_torch.core.vocab import MMADA_8B
    from mmada_tpu_torch.models import llada
    from mmada_tpu_torch.models.mmada import MMadaModel
    from mmada_tpu_torch.training import optimizers
    from mmada_tpu_torch.training.train_step import StepConfig, corrupt_batch, make_train_step

    free_memory()
    from mmada_tpu_torch.ops.flash_attention import generic_body

    cfg = dataclasses.replace(llada.llada_8b(), n_heads=heads, n_layers=2,
                              attention_bias_enabled=True, mask_token_id=MMADA_8B.mask_token_id)
    fwd_body = generic_body(torch.bfloat16, cfg.head_dim)
    bwd_body = generic_body(torch.bfloat16, cfg.head_dim, backward=True)
    model = MMadaModel.init(cfg, MMADA_8B, device="cuda", dtype=torch.bfloat16,
                            generator=torch.Generator("cuda").manual_seed(2), policy=BF16)
    model32 = dataclasses.replace(model, params=move_params(model.params, dtype=torch.float32),
                                  policy=FP32)
    ids = t2i_frames()
    mask = torch.as_tensor(t2i_masks(cfg_batch=True), dtype=torch.long, device="cuda")
    n = T2I_SETTINGS["num_vq_tokens"]
    kw = dict(attention_mask=mask, logit_positions=(ids.shape[1] - n - 1, n))
    reset_counts()
    generic_reset()
    t = time.perf_counter()
    got = model.forward(ids, **kw)
    torch.cuda.synchronize()
    fwd_s = time.perf_counter() - t
    fwd_launched = generic_read()
    expect_launches(f"{phase} forward", counts(), {})
    expect_generic(f"{phase} forward", fwd_launched, {"b7_bias": cfg.n_layers,
                                                      f"b7_{fwd_body}": cfg.n_layers})
    with plain_attention():
        want = model32.forward(ids, **kw)
    rel = float((got - want).norm() / want.norm())
    log(f"wide heads {phase}", f"masked t2i CFG forward, {cfg.n_heads} heads of {cfg.head_dim}, bf16: "
        f"{fwd_s:.4f}s; vs the fp32 forward: rel L2 {rel:.3e} (limit {SMALL_MODEL_REL_L2}); "
        f"launches {fwd_launched}")
    if not (torch.isfinite(got).all() and rel <= SMALL_MODEL_REL_L2):
        raise AssertionError(f"{phase}: the {cfg.head_dim}-wide-head forward disagrees with "
                             f"fp32: {rel}")
    del got, want

    sc = StepConfig(batch_size_t2i=2, batch_size_lm=2, batch_size_mmu=2, max_seq_length=40)
    g = torch.Generator().manual_seed(4)
    prepared = {k: v.cuda() for k, v in corrupt_batch(
        model, sc, small_train_batch(MMADA_8B, sc, g), g).items()}

    def loss_and_grads(m):
        step = make_train_step(m, optimizers.AdamW(1e-3), sc)
        tree = llada.split_layers(m.params)
        with policy_products(m.policy):
            loss, _ = step.loss(tree, prepared)
            names, leaves = zip(*llada.named_leaves(tree))
            grads = torch.autograd.grad(loss, leaves)
        return float(loss.detach()), dict(zip(names, grads))

    reset_counts()
    generic_reset()
    t = time.perf_counter()
    loss, grads = loss_and_grads(model)
    torch.cuda.synchronize()
    step_s = time.perf_counter() - t
    step_launched = generic_read()
    expect_launches(f"{phase} train step", counts(), {})
    expect_generic(f"{phase} train step", step_launched, {
        "b7_bias": cfg.n_layers, "dq_bias": cfg.n_layers, "dkv_bias": cfg.n_layers,
        f"b7_{fwd_body}": cfg.n_layers, f"dq_{bwd_body}": cfg.n_layers,
        f"dkv_{bwd_body}": cfg.n_layers})
    with plain_attention():
        loss32, grads32 = loss_and_grads(model32)
    loss_rel = abs(loss - loss32) / abs(loss32)
    grad_rel = {k: float((grads[k].float() - grads32[k]).norm()
                         / grads32[k].norm().clamp_min(1e-30)) for k in grads32}
    worst = max(grad_rel, key=grad_rel.get)
    log(f"wide heads {phase}", f"masked train step (6 rows of 200): {step_s:.4f}s; loss {loss:.5f} vs "
        f"fp32 {loss32:.5f} (rel {loss_rel:.2e}, limit {SMALL_TRAIN_LOSS_REL}); worst gradient "
        f"rel L2 {grad_rel[worst]:.2e} ({worst}, limit {SMALL_TRAIN_GRAD_REL_L2}); launches "
        f"{step_launched}")
    if not (math.isfinite(loss) and loss_rel <= SMALL_TRAIN_LOSS_REL
            and grad_rel[worst] <= SMALL_TRAIN_GRAD_REL_L2):
        raise AssertionError(f"{phase}: the {cfg.head_dim}-wide-head train step disagrees with "
                             "the fp32 step")
    del model, model32, grads, grads32
    free_memory()
    return dict(forward=fwd_launched, train=step_launched, forward_rel_l2=rel,
                loss_rel=loss_rel, grad_rel_l2=grad_rel[worst])


def generic_phase(reset_counts, counts) -> dict:
    """Phase 14: 14a the kernels, 14b-14e the paths (see main). Fails if
    phases 2-13 launched any of B7, B8 or B6-f32."""
    import torch

    generic_reset, generic_read = generic_counters()
    before = generic_read()
    log("generic", f"B7 / B8 / B6-f32 launches in phases 2-13: {before}")
    expect_generic("phases 2-13", before, {})
    t0 = time.perf_counter()
    records = check_generic_kernels(generic_cases())
    long_records = check_generic_long(
        [("long bf16 D256", torch.bfloat16, 1, 16, 16, LONG_FRAME, 256),
         ("long fp32 D128", torch.float32, 1, 16, 16, LONG_FRAME, 128),
         ("long bf16 D512", torch.bfloat16, 1, WIDER_HEADS, WIDER_HEADS, LONG_FRAME, 512)])
    int4_records = check_int4_f32(INT4_F32_CASES)
    seconds = {"14a": time.perf_counter() - t0}
    t = time.perf_counter()
    cli = tiny_cli_phase(reset_counts, counts, generic_reset, generic_read)
    seconds["14b"] = time.perf_counter() - t
    t = time.perf_counter()
    fp32 = fp32_8b_phase(reset_counts, counts, generic_reset, generic_read)
    seconds["14c"] = time.perf_counter() - t
    t = time.perf_counter()
    wide = wide_heads_phase(reset_counts, counts, generic_reset, generic_read)
    seconds["14d"] = time.perf_counter() - t
    t = time.perf_counter()
    wider = wide_heads_phase(reset_counts, counts, generic_reset, generic_read, "14e",
                             WIDER_HEADS)
    seconds["14e"] = time.perf_counter() - t
    paths = [*cli.values(), fp32["fp32"]["launched"], fp32["int4"]["launched"], wide["forward"],
             wide["train"], wider["forward"], wider["train"]]
    launches = {k: sum(p[k] for p in paths) for k in paths[0]}
    wide512 = wider["forward"]["b7_wgmma"] + wider["train"]["b7_wgmma"]
    log("generic", f"phase 14 took {time.perf_counter() - t0:.1f}s ({seconds}); main-path "
        f"launches {launches}, B7's instance of 512 {wide512} of b7_wgmma (14e)")
    return dict(records=records, long_records=long_records, int4_records=int4_records,
                launches=launches, wide512_launches=wide512, seconds=seconds)


def generic_kernel_records(gen) -> list:
    """The JSON line's entries of B7, B8-dq and B8-dkv, one a body (the ffma
    body at the fp32 8B's t2i CFG frame, the wgmma body at 256-wide heads'
    t2i CFG frame), B7's wgmma instance of 512 apart (at 512-wide heads' t2i
    CFG frame; its launches those of 14e, the others' wgmma entry those of
    the rest), and B6-f32 (at its ff_proj shape): the times at each's
    main-path case, the largest error over its cases, the launches of phase
    14's paths."""
    recs = gen["records"] + gen["long_records"]
    main = {"ffma": next(r for r in gen["records"] if r["tag"] == "t2i CFG fp32 D128"),
            "wgmma": next(r for r in gen["records"] if r["tag"] == "t2i CFG bf16 D256"),
            "wgmma512": next(r for r in gen["records"] if r["tag"] == "t2i CFG bf16 D512")}
    launches = dict(gen["launches"], b7_wgmma512=gen["wide512_launches"])
    launches["b7_wgmma"] -= gen["wide512_launches"]
    keys = ("tag", "dtype", "shape", "d", "ms", "bound_ms", "bound_by", "plain_ms")
    sources = {"ffma": "attention_generic.cu", "wgmma": "attention_wide_bwd.cu"}
    names = {"b7": ("attention_generic_fwd_ffma", "attention_wide_fwd_wgmma",
                    "attention_wide_fwd_wgmma_512"),
             "dq": ("attention_generic_bwd_dq_ffma", "attention_wide_bwd_dq_wgmma"),
             "dkv": ("attention_generic_bwd_dkv_ffma", "attention_wide_bwd_dkv_wgmma")}
    lines = {"b7": "650,686,471,497,392,418", "dq": "895,1185", "dkv": "963,1240"}
    designs = {"ffma": {"b7": FFMA_DESIGN, "dq": FFMA_BWD_DESIGN, "dkv": FFMA_BWD_DESIGN},
               "wgmma": {"b7": WIDE_DESIGN, "dq": WIDE_BWD_DESIGN, "dkv": WIDE_BWD_DESIGN},
               "wgmma512": {"b7": WIDE512_DESIGN}}
    out = []
    for kind in ("b7", "dq", "dkv"):
        bodies = ("ffma", "wgmma", "wgmma512") if kind == "b7" else ("ffma", "wgmma")
        for i, body in enumerate(bodies):
            if kind == "b7":
                rs = [r for r in recs if r["body"] == body[:5]
                      and (body == "ffma" or (r["d"] > 256) == (body == "wgmma512"))]
                errs, rec, lib = [r["max_abs_err"] for r in rs], main[body], "library_ms"
                part = lambda r: r  # noqa: E731
                source = "attention_generic.cu" if body == "ffma" else "attention_wide.cu"
            else:
                rs = [r for r in recs if r[kind]["body"] == body]
                errs = [r[kind]["max_abs_err"] for r in rs]
                rec = dict(main[body][kind], library_ms=main[body]["bwd_library_ms"])
                lib = "bwd_library_ms"
                part = lambda r, kind=kind: dict(r, **r[kind])  # noqa: E731
                source = sources[body]
            e = dict(kernel_record(names[kind][i], source, lines[kind],
                                   launches[f"{kind}_{body}"],
                                   [dict(max_abs_err=x) for x in errs], rec),
                     design=designs[body][kind])
            e["shapes"] = [dict({k: part(r).get(k) for k in keys}, library_ms=r[lib])
                           for r in rs]
            out.append(e)
    int4_main = gen["int4_records"][0]
    b6 = dict(kernel_record("int4_matmul_f32", "int4_matmul_f32.cu", "149", launches["b6_f32"],
                            gen["int4_records"], int4_main, replaces="int4_matmul.py"),
              design=INT4_F32_DESIGN)
    b6["shapes"] = [{k: r[k] for k in ("tag", "shape", "ms", "bound_ms", "bound_by", "plain_ms",
                                       "library_ms", "float64_max_abs_err")}
                    for r in gen["int4_records"]]
    return out + [b6]


def kernel_record(name, source, line, launches, recs, main_rec,
                  replaces="flash_attention.py") -> dict:
    """One kernel's entry of the JSON line: times at its main-path case, the
    largest error over all its cases. `source` is the file in `ops/csrc` that
    holds the kernel's body, `replaces` the file in `mmada_tpu/ops` of the
    TPU kernel and `line` its line(s)."""
    return {
        "name": name,
        "design": WGMMA_DESIGN,
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
