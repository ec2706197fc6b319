"""Entry points: answer text, t2i, MMU and t2m requests, decode images and
motions, and train.

Counterparts of the repo-root `generate.py`, `inference_t2i.py`,
`inference_mmu.py` (from pixel arrays: the PIL transforms stay with the
CLIs) and `train.py`, with keyword arguments instead of a yaml config:

  * `serve_text(model, prompts, ...)` builds each prompt's frame (BOS first,
    as `generate.py` does), batches requests of equal frame length, and runs
    the semi-AR sampler; it returns each request's generated ids.
  * `serve_t2i(model, prompts, ...)` builds the t2i frames and the
    empty-prompt CFG frames (`UniversalPrompting.t2i_gen` /
    `t2i_gen_uncond`) and runs the MaskGIT sampler; it returns the
    `(len(prompts), num_vq_tokens)` image codes.
  * `decode_images(vq, vq_cfg, codes)` turns image codes into uint8 NHWC
    images by MAGVIT-v2's decoder, as `inference_t2i.py` does.
  * `serve_mmu(model, vq, vq_cfg, images, questions, ...)` encodes each
    image by MAGVIT-v2, builds `inference_mmu.py`'s frame and runs
    `mmu_generate` (or `mmu_generate_fast`, stopping at EOT); it returns
    each request's generated ids.
  * `serve_t2m(model, prompts, ...)` builds the t2m frames
    (`UniversalPrompting.t2m`, the motion span masked) and runs the MotionGIT
    sampler; it returns the `(len(prompts), num_motion_tokens)` motion codes.
  * `decode_motion(vq, vq_cfg, codes)` turns motion codes into `(B, 4n, 263)`
    pose features by the motion VQ-VAE's decoder (frame -> `t2m_generate` ->
    decode is `examples/text_to_motion_generation.py:60-87`).
  * `train(model, flows, steps, ...)` builds the multi-task `Trainer` and
    takes `steps` optimizer steps over the raw batches in `flows` (cycled),
    updating the model's weights in place; flows may carry pixels, which
    the MAGVIT-v2 encoder (`vq_params`) turns into codes.
  * `quantize(model, scheme, ...)` is the quantize branch of the JAX loader
    (`mmada_tpu/serve/loader.py`, `model.mmada.quantize`): a model whose
    block weights and vocab head are int8 (`"int8"`, `"w8"`), W8A8
    (`"w8a8"`), SmoothQuant-migrated W8A8 (`"w8a8_smooth"`) or grouped int4
    (`"int4"`, whose matmuls run kernel B6 on the card). `serve_text` and
    `serve_t2i` take it as they take any model.

The samplers are the exact ones unless a request asks for the fast ones:
`serve_text`, `serve_mmu`, `serve_t2i` and `serve_t2m` take `block_kv_cache` (False,
True or "int8", also as a string, through the strict `parse_kv_cache`) and
`cache_refresh_every`; `serve_text` and `serve_mmu` also
`parallel_threshold` and `parallel_warmup_steps` (tau-parallel), `serve_t2i`
`cfg_interval`; all four the segmented runs' `segment_steps` /
`segment_timesteps` (the exact sampler in chunks, the same answers). The
serving engine (`serve/engine.py`) and the HTTP front end (`app_torch.py`)
serve concurrent requests.

All run on the card unless called with `device="cpu"`, and raise when the
model's weights are elsewhere.
"""

from __future__ import annotations

import dataclasses
import itertools
from typing import Mapping, Optional, Sequence

import numpy as np
import torch

from mmada_tpu_torch.core.config import parse_kv_cache
from mmada_tpu_torch.core.device import DeviceLike, resolve_device
from mmada_tpu_torch.models import magvit2, motion_vq
from mmada_tpu_torch.models.llada import calibration_stats
from mmada_tpu_torch.models.mmada import MMadaModel
from mmada_tpu_torch.ops.quantization import quantize_llada_params
from mmada_tpu_torch.ops.smoothquant import migrate_params
from mmada_tpu_torch.prompting.universal import (
    ByteTokenizer,
    SpecialIds,
    UniversalPrompting,
)
from mmada_tpu_torch.training.trainer import Trainer


def _check_device(model: MMadaModel, device: DeviceLike) -> torch.device:
    device = resolve_device(device)
    if model.device.type != device.type:
        raise ValueError(f"model weights are on {model.device}, serving asked for {device}")
    return model.device


def _check_vq_device(vq, device: DeviceLike) -> torch.device:
    device = resolve_device(device)
    vq_device = vq["encoder"]["conv_in"]["w"].device
    if vq_device.type != device.type:
        raise ValueError(f"MAGVIT-v2 weights are on {vq_device}, the call asked for {device}")
    return vq_device


def text_frames(model: MMadaModel, prompts: Sequence[str], tokenizer=None) -> list[list[int]]:
    """Token ids of each prompt, BOS first."""
    tokenizer = tokenizer or ByteTokenizer()
    bos = model.vocab.bos_token_id
    frames = []
    for ids in tokenizer(list(prompts))["input_ids"]:
        ids = list(ids)
        if not ids or ids[0] != bos:
            ids = [bos] + ids
        frames.append(ids)
    return frames


def serve_text(model: MMadaModel, prompts: Sequence[str], tokenizer=None,
               device: DeviceLike = None, gen_length: int = 128,
               steps: int = 128, block_length: int = 128,
               temperature: float = 0.0, cfg_scale: float = 0.0,
               remasking: str = "low_confidence", seed: int = 0, block_kv_cache=False,
               parallel_threshold: float = 0.0, parallel_warmup_steps: int = 0,
               cache_refresh_every: int = 0, segment_steps: int = 0) -> list[torch.Tensor]:
    """Each request's `gen_length` generated ids (fused vocab, on the CPU).
    Requests with frames of the same length share one batch, as the JAX
    serving engine groups them; a batch's rows never see each other."""
    device = _check_device(model, device)
    fast = dict(block_kv_cache=parse_kv_cache(block_kv_cache),
                parallel_threshold=parallel_threshold,
                parallel_warmup_steps=parallel_warmup_steps,
                cache_refresh_every=cache_refresh_every)
    frames = text_frames(model, prompts, tokenizer)
    stochastic = temperature > 0 or remasking == "random"
    generator = torch.Generator(device).manual_seed(seed) if stochastic else None
    groups: dict[int, list[int]] = {}
    for i, ids in enumerate(frames):
        groups.setdefault(len(ids), []).append(i)
    answers: list[Optional[torch.Tensor]] = [None] * len(frames)
    for length, rows in groups.items():
        prompt = torch.tensor([frames[i] for i in rows], dtype=torch.long, device=device)
        out = model.generate(
            prompt, gen_length=gen_length, steps=steps, block_length=block_length,
            temperature=temperature, cfg_scale=cfg_scale, remasking=remasking,
            generator=generator, segment_steps=segment_steps, **fast,
        )
        for row, i in enumerate(rows):
            answers[i] = out[row, length:].cpu()
    return answers


def serve_t2i(model: MMadaModel, prompts: Sequence[str], tokenizer=None,
              special_ids: Optional[SpecialIds] = None,
              device: DeviceLike = None, num_vq_tokens: int = 1024,
              max_text_len: int = 128, timesteps: int = 15,
              guidance_scale: float = 3.5, temperature: float = 1.0,
              greedy: bool = False, seed: int = 0, block_kv_cache=False,
              cache_refresh_every: int = 0, segment_timesteps: int = 0,
              cfg_interval=(0.0, 1.0)) -> torch.Tensor:
    """`(len(prompts), num_vq_tokens)` image codes in [0, codebook), on the
    CPU, from one batch of t2i frames (all frames have the same length).
    `special_ids` defaults to the vocab's reserved task tokens."""
    device = _check_device(model, device)
    vocab = model.vocab
    prompting = UniversalPrompting(
        tokenizer or ByteTokenizer(), special_ids or SpecialIds.from_vocab(vocab),
        max_text_len=max_text_len,
    )
    mask_id = vocab.mask_token_id
    image_ids = torch.full((len(prompts), num_vq_tokens), mask_id, dtype=torch.long)
    input_ids, attn = prompting.t2i_gen(list(prompts), image_ids.numpy())
    uncond_ids, uncond_attn = prompting.t2i_gen_uncond(len(prompts), num_vq_tokens, mask_id)

    def dev(a):
        return torch.as_tensor(a, dtype=torch.long).to(device)

    generator = None if greedy else torch.Generator(device).manual_seed(seed)
    codes = model.t2i_generate(
        dev(input_ids), uncond_input_ids=dev(uncond_ids),
        attention_mask=dev(attn), uncond_attention_mask=dev(uncond_attn),
        temperature=temperature, timesteps=timesteps,
        guidance_scale=guidance_scale, num_vq_tokens=num_vq_tokens,
        generator=generator, greedy=greedy,
        block_kv_cache=parse_kv_cache(block_kv_cache), cache_refresh_every=cache_refresh_every,
        segment_timesteps=segment_timesteps, cfg_interval=cfg_interval,
    )
    return codes.cpu()


def decode_images(vq, vq_cfg: magvit2.VQGANConfig, codes, device: DeviceLike = None
                  ) -> torch.Tensor:
    """`(B, H, W, 3)` uint8 images, on the CPU, from `(B, N)` raw image codes:
    MAGVIT-v2's decode, then `(x + 1) * 127.5` clipped to [0, 255] and cast
    (`inference_t2i.py`)."""
    device = _check_vq_device(vq, device)
    pixels = magvit2.decode_code(vq, vq_cfg, torch.as_tensor(codes, dtype=torch.long).to(device))
    return ((pixels + 1.0) * 127.5).clamp(0, 255).to(torch.uint8).cpu()


def serve_t2m(model: MMadaModel, prompts: Sequence[str], tokenizer=None,
              special_ids: Optional[SpecialIds] = None, device: DeviceLike = None,
              num_motion_tokens: int = 256, max_text_len: int = 64, timesteps: int = 18,
              temperature: float = 1.0, greedy: bool = False, seed: int = 0,
              block_kv_cache=False, cache_refresh_every: int = 0,
              segment_timesteps: int = 0) -> torch.Tensor:
    """`(len(prompts), num_motion_tokens)` raw motion codes, on the CPU, from
    one batch of t2m frames (every frame `max_text_len + 1 + n + 2` long; the
    pads before a short caption are masked out of the exact sampler's
    attention when the model's `attention_bias_enabled` is set). The model's
    vocab must have a motion window (`with_motion`)."""
    device = _check_device(model, device)
    vocab = model.vocab
    prompting = UniversalPrompting(
        tokenizer or ByteTokenizer(), special_ids or SpecialIds.from_vocab(vocab),
        max_text_len=max_text_len,
    )
    motion_ids = np.full((len(prompts), num_motion_tokens), vocab.mask_token_id, np.int64)
    input_ids, attn, _ = prompting.t2m(list(prompts), motion_ids, motion_ids, dropout=False)

    def dev(a):
        return torch.as_tensor(a, dtype=torch.long).to(device)

    generator = None if greedy else torch.Generator(device).manual_seed(seed)
    codes = model.t2m_generate(
        dev(input_ids), attention_mask=dev(attn), temperature=temperature,
        timesteps=timesteps, num_motion_tokens=num_motion_tokens, generator=generator,
        greedy=greedy, block_kv_cache=parse_kv_cache(block_kv_cache),
        cache_refresh_every=cache_refresh_every, segment_timesteps=segment_timesteps,
    )
    return codes.cpu()


def decode_motion(vq: motion_vq.MotionVQ, vq_cfg: motion_vq.MotionVQConfig, codes,
                  device: DeviceLike = None) -> torch.Tensor:
    """`(B, 2**down_t * n, pose_dim)` motion features, on the CPU, from
    `(B, n)` raw motion codes (the motion VQ-VAE's decode, in fp32)."""
    device = resolve_device(device)
    if vq.device.type != device.type:
        raise ValueError(f"motion VQ-VAE weights are on {vq.device}, the call asked for {device}")
    codes = torch.as_tensor(codes, dtype=torch.long).to(vq.device)
    return motion_vq.decode(vq, vq_cfg, codes).cpu()


def serve_mmu(model: MMadaModel, vq, vq_cfg: magvit2.VQGANConfig, images, questions: Sequence[str],
              tokenizer=None, special_ids: Optional[SpecialIds] = None,
              device: DeviceLike = None, max_new_tokens: int = 128, steps: int = 64,
              block_length: int = 128, temperature: float = 0.0, cfg_scale: float = 0.0,
              fast: bool = False, seed: int = 0, block_kv_cache=False,
              parallel_threshold: float = 0.0, parallel_warmup_steps: int = 0,
              cache_refresh_every: int = 0, segment_steps: int = 0) -> list[torch.Tensor]:
    """Each request's `max_new_tokens` generated ids (fused vocab, on the
    CPU) for an image and a question. `images` is `(B, H, W, 3)` pixels in
    [-1, 1] (an array, or a tensor on any device). Each frame is
    `inference_mmu.py`'s, `<|mmu|> <|soi|> codes <|eoi|> <bos> question`
    (the question's ids as the tokenizer gives them, no padding); frames of
    one length share a batch. `fast` stops a batch after the first block
    that ends in EOT in every row (its later blocks stay [MASK])."""
    device = _check_device(model, device)
    _check_vq_device(vq, device)
    sp = special_ids or SpecialIds.from_vocab(model.vocab)
    if not isinstance(images, torch.Tensor):
        images = np.ascontiguousarray(images)
    pixels = torch.as_tensor(images, dtype=torch.float32, device=device)
    codes = magvit2.get_code(vq, vq_cfg, pixels).cpu().numpy() + model.vocab.image_offset
    texts = (tokenizer or ByteTokenizer())(list(questions))["input_ids"]
    frames = [[sp.mmu, sp.soi, *c.tolist(), sp.eoi, sp.bos, *ids] for c, ids in zip(codes, texts)]
    generator = torch.Generator(device).manual_seed(seed) if temperature > 0 else None
    kw = dict(max_new_tokens=max_new_tokens, steps=steps, block_length=block_length,
              temperature=temperature, cfg_scale=cfg_scale, generator=generator,
              block_kv_cache=parse_kv_cache(block_kv_cache),
              parallel_threshold=parallel_threshold,
              parallel_warmup_steps=parallel_warmup_steps,
              cache_refresh_every=cache_refresh_every)
    groups: dict[int, list[int]] = {}
    for i, ids in enumerate(frames):
        groups.setdefault(len(ids), []).append(i)
    answers: list[Optional[torch.Tensor]] = [None] * len(frames)
    for length, rows in groups.items():
        prompt = torch.tensor([frames[i] for i in rows], dtype=torch.long, device=device)
        if fast:
            out = model.mmu_generate_fast(prompt, eot_token=sp.eos, **kw)
        else:
            out = model.mmu_generate(prompt, segment_steps=segment_steps, **kw)
        for row, i in enumerate(rows):
            answers[i] = out[row, length:].cpu()
    return answers


def train(model: MMadaModel, flows: Sequence[Mapping], steps: int,
          device: DeviceLike = None, tokenizer=None,
          special_ids: Optional[SpecialIds] = None, max_text_len: int = 128,
          training: Optional[Mapping] = None, optimizer: Optional[Mapping] = None,
          lr_scheduler: Optional[Mapping] = None, seed: int = 0,
          log_every: int = 1, vq_params=None,
          vq_cfg: Optional[magvit2.VQGANConfig] = None) -> Trainer:
    """Take `steps` train steps on the raw batches `flows` (each a dict of
    `t2i_flow` / `lm_flow` / `mmu_flow`, images as pixels, `images`, which
    MAGVIT-v2 (`vq_params`, `vq_cfg`) encodes, or as VQ codes,
    `image_codes`), cycling through them. `training` / `optimizer` /
    `lr_scheduler` are the reference config's blocks as dicts. The model's
    weights are updated in place; the returned Trainer holds the state and
    the logged metrics (`history`)."""
    _check_device(model, device)
    prompting = UniversalPrompting(
        tokenizer or ByteTokenizer(), special_ids or SpecialIds.from_vocab(model.vocab),
        max_text_len=max_text_len,
    )
    trainer = Trainer(model, prompting, training=dict(training or {}, max_train_steps=steps),
                      optimizer=optimizer, lr_scheduler=lr_scheduler, log_every=log_every,
                      vq_params=vq_params, vq_cfg=vq_cfg)
    trainer.fit(itertools.islice(itertools.cycle(flows), steps), rng_seed=seed)
    return trainer


QUANT_SCHEMES = ("int8", "w8", "w8a8", "w8a8_smooth", "int4")


def quantize(model: MMadaModel, scheme: str, smoothquant_calib=None,
             smoothquant_alpha: float = 0.5) -> MMadaModel:
    """`model` with its block matmul weights and vocab head quantized by
    `scheme` (QUANT_SCHEMES); the embedding and, but for "w8a8_smooth" (whose
    migration rescales them), the norms are shared with `model`, not copied.
    "w8a8_smooth" calibrates on `smoothquant_calib` ((N, L) token ids, or the
    path of an .npy of them) or on the synthetic batches of
    `calibration_batches`, in the model's own policy."""
    if scheme not in QUANT_SCHEMES:
        raise ValueError(f"unknown quantization scheme {scheme!r}; one of {QUANT_SCHEMES}")
    if scheme == "w8a8_smooth":
        # calibrate -> migrate -> quantize to W8A8 (the head included)
        stats = calibration_stats(model.params, model.cfg,
                                  calibration_batches(model.cfg, model.vocab, smoothquant_calib),
                                  policy=model.policy)
        params = quantize_llada_params(
            migrate_params(model.params, model.cfg, stats, alpha=float(smoothquant_alpha)),
            activations=True)
    else:
        params = quantize_llada_params(model.params, activations=scheme == "w8a8",
                                       bits=4 if scheme == "int4" else 8)
    return dataclasses.replace(model, params=params)


def calibration_batches(arch, vocab, calib=None) -> list[np.ndarray]:
    """SmoothQuant calibration ids (`loader._calibration_batches`): up to 16
    rows of `calib` in batches of 4, else two deterministic synthetic
    batches, a text batch and a t2i-shaped frame (text prefix, image-code
    span, masks)."""
    if calib is not None:
        ids = np.load(calib) if isinstance(calib, str) else np.asarray(calib)
        ids = ids.astype(np.int32)
        if ids.ndim != 2:
            raise ValueError(f"smoothquant_calib must be (N, L), got {ids.shape}")
        return [ids[i:i + 4] for i in range(0, min(len(ids), 16), 4)]
    rng = np.random.default_rng(0)
    text_hi = min(vocab.text_vocab_size, arch.vocab_size) - 1
    text = rng.integers(3, text_hi, (2, 128), dtype=np.int32)
    frame = rng.integers(3, text_hi, (2, 160), dtype=np.int32)
    img_lo = vocab.image_offset
    img_hi = min(img_lo + vocab.image_codebook_size, arch.vocab_size)
    if img_lo < img_hi:
        frame[:, 32:96] = rng.integers(img_lo, img_hi, (2, 64), dtype=np.int32)
    if vocab.mask_token_id < arch.vocab_size:
        frame[:, 96:] = vocab.mask_token_id
    return [text, frame]
