"""MMaDA: the unified multimodal masked-diffusion model: text, MMU and t2i.

Counterpart of `MMadaModel` in `mmada_tpu/models/mmada.py` (:164): the LLaDA
backbone plus the fused vocab layout plus the task entry points this slice
serves:

  * `forward`      - raw logits over the fused vocab (or a window of it),
                     without autograd (serving)
  * `forward_hidden` / `apply_head` - the differentiable training path: the
                     post-norm hidden states, and the vocab head on (a chunk
                     of) them
  * `generate`     - semi-AR text denoising, exact sampler
  * `mmu_generate` / `mmu_generate_fast` - the same denoiser on a prompt
                     that holds the <|mmu|> image frame; the fast one stops
                     after the first block that ends in EOT in every row
  * `t2i_generate` - MaskGIT image-token generation with CFG, exact sampler

Image generation evaluates the vocab head only over the 8k image window and
the image positions (`logit_window` + `logit_positions`); text steps only
over the active block's positions.

On the card the model computes in bf16: the attention kernels take bf16
operands only, so a model whose weights are on CUDA and whose policy's
compute dtype is not bf16 is refused when it is built (`init` and the
constructor), naming `BF16`. The CPU keeps the FP32 policy, which the parity
tests use. (JAX's Pallas kernels also take fp32; fp32 kernels on the card
are ROADMAP C.2.)
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

import torch

from mmada_tpu_torch.core.device import DeviceLike, resolve_device
from mmada_tpu_torch.core.precision import FP32, Policy
from mmada_tpu_torch.core.vocab import VocabLayout
from mmada_tpu_torch.models import llada
from mmada_tpu_torch.sampling import t2i as t2i_sampling
from mmada_tpu_torch.sampling import text as text_sampling
from mmada_tpu_torch.sampling.schedules import cosine_schedule


@dataclasses.dataclass
class MMadaModel:
    cfg: llada.LLaDAConfig
    params: Any
    vocab: VocabLayout
    policy: Policy = FP32
    remat: Any = False
    """Activation checkpointing of the training path: False | True | "full"
    (llada._check_remat)."""

    def __post_init__(self):
        if self.params is not None:  # a train step's template holds no weights
            _check_policy(self.policy, self.device)

    # ------------------------------------------------------------- factory
    @classmethod
    def init(cls, cfg: llada.LLaDAConfig, vocab: VocabLayout,
             device: DeviceLike = None, dtype: torch.dtype = torch.float32,
             generator: Optional[torch.Generator] = None,
             policy: Policy = FP32, remat=False) -> "MMadaModel":
        """Random weights made on `device` (the card unless told otherwise).
        On the card `policy` must compute in bf16 (`BF16`)."""
        device = resolve_device(device)
        _check_policy(policy, device)  # before 16 GB of weights are made
        params = llada.init_params(cfg, device=device, dtype=dtype, generator=generator)
        return cls(cfg=cfg, params=params, vocab=vocab, policy=policy, remat=remat)

    @property
    def device(self) -> torch.device:
        return self.params["wte"].device

    # ------------------------------------------------------------- forward
    @torch.no_grad()
    def forward(self, input_ids, attention_mask=None, attention_bias=None,
                logit_window=None, logit_positions=None):
        return llada.forward(
            self.params, self.cfg, input_ids,
            attention_mask=attention_mask, attention_bias=attention_bias,
            policy=self.policy, logit_window=logit_window,
            logit_positions=logit_positions,
        )

    def forward_hidden(self, input_ids, attention_mask=None):
        """Post-final-norm hidden states `(B, L, D)`, with autograd; the
        vocab head is NOT applied (the training loss path)."""
        return llada.forward(
            self.params, self.cfg, input_ids, attention_mask=attention_mask,
            policy=self.policy, remat=self.remat, return_normed_hidden=True,
        )

    def apply_head(self, normed_hidden, logit_window=None):
        """Vocab-head matmul on (a chunk of) normed hidden states."""
        return llada._head(self.params, self.cfg, normed_hidden, logit_window, self.policy)

    def _text_window_forward_fn(self, block_length: int):
        """Semi-AR block-windowed forward: the full-width vocab head (text
        steps may emit any fused id) over the active block's positions only."""

        def fn(tokens, start):
            return self.forward(tokens, logit_positions=(start, block_length))

        return fn

    def _window_forward_fn(self, num_tokens: int, window: tuple[int, int]):
        """Vocab AND position windows: the head runs only over the image span's
        hidden states and the image vocab slice."""

        def fn(tokens, attention_mask):
            seq_len = tokens.shape[1]
            return self.forward(
                tokens, attention_mask=attention_mask, logit_window=window,
                logit_positions=(seq_len - (num_tokens + 1), num_tokens),
            )

        return fn

    # ---------------------------------------------------------------- text
    def generate(self, prompt, gen_length=128, steps=128, block_length=128,
                 temperature=0.0, cfg_scale=0.0, remasking="low_confidence",
                 generator=None):
        """(B, P + gen_length) tokens from a (B, P) prompt, exact sampler."""
        scfg = text_sampling.SemiARConfig(
            gen_length=gen_length, steps=steps, block_length=block_length,
            temperature=temperature, cfg_scale=cfg_scale, remasking=remasking,
            mask_id=self.vocab.mask_token_id,
        )
        return text_sampling.generate(
            None, prompt, scfg, generator=generator,
            window_forward_fn=self._text_window_forward_fn(block_length),
        )

    # ----------------------------------------------------------------- mmu
    def mmu_generate(self, input_ids, max_new_tokens=128, steps=128, block_length=128,
                     temperature=0.0, cfg_scale=0.0, remasking="low_confidence",
                     generator=None, block_kv_cache=False, parallel_threshold=0.0,
                     parallel_warmup_steps=0, cache_refresh_every=0, segment_steps=0):
        """`generate` on a prompt that already holds the <|mmu|> image frame.
        The block-KV, tau-parallel and segmented knobs must stay at their
        defaults (the exact sampler)."""
        _exact_sampler_only(block_kv_cache=block_kv_cache, parallel_threshold=parallel_threshold,
                            parallel_warmup_steps=parallel_warmup_steps,
                            cache_refresh_every=cache_refresh_every, segment_steps=segment_steps)
        return self.generate(input_ids, gen_length=max_new_tokens, steps=steps,
                             block_length=block_length, temperature=temperature,
                             cfg_scale=cfg_scale, remasking=remasking, generator=generator)

    def mmu_generate_fast(self, input_ids, eot_token: int, max_new_tokens=128, steps=128,
                          block_length=128, temperature=0.0, cfg_scale=0.0, generator=None,
                          block_kv_cache=False, parallel_threshold=0.0,
                          parallel_warmup_steps=0, cache_refresh_every=0):
        """`mmu_generate` that stops after the first block whose last
        position holds `eot_token` in every row (the blocks not run stay
        masked)."""
        _exact_sampler_only(block_kv_cache=block_kv_cache, parallel_threshold=parallel_threshold,
                            parallel_warmup_steps=parallel_warmup_steps,
                            cache_refresh_every=cache_refresh_every)
        scfg = text_sampling.SemiARConfig(
            gen_length=max_new_tokens, steps=steps, block_length=block_length,
            temperature=temperature, cfg_scale=cfg_scale, mask_id=self.vocab.mask_token_id,
        )
        return text_sampling.generate_with_early_stop(
            None, input_ids, scfg, eot_token, generator=generator,
            window_forward_fn=self._text_window_forward_fn(block_length),
        )

    # ----------------------------------------------------------------- t2i
    def t2i_generate(self, input_ids, uncond_input_ids=None,
                     attention_mask=None, uncond_attention_mask=None,
                     temperature=1.0, timesteps=18, guidance_scale=0.0,
                     noise_schedule=cosine_schedule, num_vq_tokens=1024,
                     generator=None, greedy=False, cfg_interval=(0.0, 1.0)):
        """(B, num_vq_tokens) raw image codes, exact MaskGIT sampler."""
        mcfg = t2i_sampling.MaskGITConfig(
            timesteps=timesteps, temperature=temperature,
            guidance_scale=guidance_scale, noise_schedule=noise_schedule,
            mask_id=self.vocab.mask_token_id, num_vq_tokens=num_vq_tokens,
            codebook_size=self.vocab.image_codebook_size,
            text_vocab_size=self.vocab.image_offset, greedy=greedy,
            cfg_interval=tuple(cfg_interval),
        )
        fwd = self._window_forward_fn(num_vq_tokens, self.vocab.image_window)
        return t2i_sampling.t2i_generate(
            fwd, input_ids, mcfg, generator=generator,
            uncond_input_ids=uncond_input_ids, attention_mask=attention_mask,
            uncond_attention_mask=uncond_attention_mask,
        )


_EXACT_SAMPLER = dict(block_kv_cache=False, parallel_threshold=0.0, parallel_warmup_steps=0,
                      cache_refresh_every=0, segment_steps=0)


def _exact_sampler_only(**knobs) -> None:
    changed = sorted(k for k, v in knobs.items() if v != _EXACT_SAMPLER[k])
    if changed:
        raise NotImplementedError(
            f"{', '.join(changed)}: block-KV, tau-parallel and segmented sampling are not "
            "ported yet (ROADMAP A.3-A.5); the port runs the exact sampler")


def _check_policy(policy: Policy, device: torch.device) -> None:
    if device.type == "cuda" and policy.compute_dtype != torch.bfloat16:
        raise ValueError(
            f"a model on {device} computes in bf16: its attention kernels take bf16 "
            f"only, and this policy computes in {policy.compute_dtype}; pass "
            "policy=BF16 (mmada_tpu_torch.core.precision.BF16)")
