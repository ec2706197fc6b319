"""MMaDA: the unified multimodal masked-diffusion model: text, MMU, t2i, t2m.

Counterpart of `MMadaModel` in `mmada_tpu/models/mmada.py` (:164): the LLaDA
backbone plus the fused vocab layout plus the task entry points this slice
serves:

  * `init` / `from_pretrained` - random weights from a seed, or a local
                     checkpoint's (`checkpoints/hf_import.py`)
  * `forward`      - raw logits over the fused vocab (or a window of it),
                     without autograd (serving)
  * `forward_hidden` / `apply_head` - the differentiable training path: the
                     post-norm hidden states, and the vocab head on (a chunk
                     of) them
  * `generate` / `generate_stepwise` - semi-AR text denoising
  * `mmu_generate` / `mmu_generate_fast` - the same denoiser on a prompt
                     that holds the <|mmu|> image frame; the fast one stops
                     after the first block that ends in EOT in every row
  * `t2i_generate` - MaskGIT image-token generation with CFG
  * `t2m_generate` - MaskGIT motion-token generation over the motion window
                     (a vocab `with_motion`), no CFG

Every sampler runs the exact sampler by default. The fast samplers are
opt-in knobs, as in JAX: `block_kv_cache` (False, True or "int8": the
block-KV cached decode, `_text_cache_fns` / `_span_cache_fns` on
`llada.forward_kv_capture` / `forward_kv_step`), `cache_refresh_every`, and
for text and MMU `parallel_threshold` / `parallel_warmup_steps`
(tau-parallel). The segmented runs (`segment_steps` on `generate` and
`mmu_generate`, `segment_timesteps` on `t2i_generate` and `t2m_generate`;
the exact sampler only, as in JAX) run the sampler in chunks with the same
tokens; `segmented_run`, `segmented_stepwise_run`, `segmented_chunk_runner`,
`t2i_segmented_run` and `t2m_segmented_run` hand the chunks to the caller
(the serving engine, `serve/engine.py`, and the HTTP front end's streams).
Not ported: `with_pinned_fast_runner` (XLA layout pinning).

Over a mesh (`mesh`, `pipeline_axis`, `attn_impl`: the JAX model's fields)
the model's params are this rank's shards and every sampler runs over it:
sharded (FSDP and tensor parallelism, `llada._MeshPath`), in pipeline stages
(`parallel/pipeline.py`) or with the ring (`parallel/ring_attention.py`).

Image generation evaluates the vocab head only over the 8k image window and
the image positions (`logit_window` + `logit_positions`); text steps only
over the active block's positions.

On the card the model computes in bf16: the attention kernels take bf16
operands only, so a model whose weights are on CUDA and whose policy's
compute dtype is not bf16 is refused when it is built (`init` and the
constructor), naming `BF16`. The CPU keeps the FP32 policy, which the parity
tests use. (JAX's Pallas kernels also take fp32; fp32 kernels on the card
are ROADMAP A.17.)
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

import torch

from mmada_tpu_torch.checkpoints.hf_import import config_from_hf_json, load_pretrained
from mmada_tpu_torch.core.device import DeviceLike, resolve_device
from mmada_tpu_torch.core.precision import BF16, FP32, Policy
from mmada_tpu_torch.core.vocab import VocabLayout
from mmada_tpu_torch.core.mesh import axis_group
from mmada_tpu_torch.models import llada
from mmada_tpu_torch.parallel import pipeline
from mmada_tpu_torch.parallel.collectives import all_gather, chunk
from mmada_tpu_torch.parallel.tp_attention import best_batch_axes
from mmada_tpu_torch.sampling import motion as motion_sampling
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
    """Activation checkpointing of the training path: False | True | "full" |
    "dots" | "auto" (llada._check_remat)."""
    mesh: Any = None
    """A (data, fsdp, tensor) `DeviceMesh` (core/mesh.py) whose shards
    `params` hold (parallel/sharding.py). Serving (`forward`) takes every
    row on every rank, runs its rows over the batch axes that divide the
    batch (`tp_attention.best_batch_axes`) and gathers the logits, so every
    rank has them all; the training path (`forward_hidden`) takes this
    rank's rows."""
    pipeline_axis: Any = None
    """The mesh axis of GPipe serving (parallel/pipeline.py): `params` from
    `pipeline.shard_stage_params`, no attention bias; every sampler's
    forward then runs through the pipeline."""
    attn_impl: str = "auto"
    """"ring" with a mesh: attention's sequence sharded over fsdp
    (parallel/ring_attention.py) where there is no bias."""

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

    @classmethod
    def from_pretrained(cls, model_dir: str, vocab: VocabLayout, device: DeviceLike = None,
                        dtype: torch.dtype = torch.bfloat16, policy: Policy = BF16,
                        remat=False) -> "MMadaModel":
        """The model of a local checkpoint directory (`config.json` and
        safetensors or `pytorch_model.bin`), its weights streamed onto `device`
        (the card unless told otherwise) in `dtype`. On the card `policy` must
        compute in bf16; it is checked before any weight is read."""
        device = resolve_device(device)
        _check_policy(policy, device)
        cfg = config_from_hf_json(model_dir)
        params = load_pretrained(model_dir, cfg, device=device, dtype=dtype)
        return cls(cfg=cfg, params=params, vocab=vocab, policy=policy, remat=remat)

    @property
    def device(self) -> torch.device:
        return self.params["wte"].device

    # ------------------------------------------------------------- forward
    @torch.no_grad()
    def forward(self, input_ids, attention_mask=None, attention_bias=None,
                logit_window=None, logit_positions=None):
        if self.pipeline_axis is not None:
            if self.cfg.attention_bias_enabled and (
                    attention_mask is not None or attention_bias is not None):
                raise ValueError("pipeline serving supports only the no-bias attention "
                                 "path (attention_bias_enabled=False)")
            return pipeline.pipeline_forward(
                self.params, self.cfg, input_ids, self.mesh, axis_name=self.pipeline_axis,
                policy=self.policy, logit_window=logit_window,
                logit_positions=logit_positions)
        if self.mesh is None:
            return llada.forward(
                self.params, self.cfg, input_ids,
                attention_mask=attention_mask, attention_bias=attention_bias,
                policy=self.policy, logit_window=logit_window,
                logit_positions=logit_positions,
            )
        return self._mesh_forward(input_ids, attention_mask, attention_bias, logit_window,
                                  logit_positions)

    def _mesh_forward(self, input_ids, attention_mask, attention_bias, logit_window,
                      logit_positions):
        """Serving over the mesh: this rank's rows (over the batch axes that
        divide the batch), then the logits of every row gathered."""
        axes = best_batch_axes(input_ids.shape[0], self.mesh)
        group = axis_group(self.mesh, axes) if axes else None

        def rows(t):
            return t if t is None or t.shape[0] == 1 else chunk(t, 0, group)

        if logit_positions is not None and isinstance(logit_positions[0], torch.Tensor):
            logit_positions = (rows(logit_positions[0]), logit_positions[1])
        logits = llada.forward(
            self.params, self.cfg, rows(input_ids), attention_mask=rows(attention_mask),
            attention_bias=rows(attention_bias), policy=self.policy,
            logit_window=logit_window, logit_positions=logit_positions,
            mesh=self.mesh, attn_impl=self.attn_impl)
        return all_gather(logits, 0, group)

    def forward_hidden(self, input_ids, attention_mask=None):
        """Post-final-norm hidden states `(B, L, D)`, with autograd; the
        vocab head is NOT applied (the training loss path). Over a mesh,
        `input_ids` are this rank's rows."""
        if self.pipeline_axis is not None:
            raise ValueError("forward_hidden is a training path; pipeline sharding "
                             "is inference-only")
        return llada.forward(
            self.params, self.cfg, input_ids, attention_mask=attention_mask,
            policy=self.policy, remat=self.remat, return_normed_hidden=True,
            mesh=self.mesh, attn_impl=self.attn_impl,
        )

    def apply_head(self, normed_hidden, logit_window=None):
        """Vocab-head matmul on (a chunk of) normed hidden states."""
        return llada._head(self.params, self.cfg, normed_hidden, logit_window, self.policy,
                           self.mesh)

    def with_whole_head(self) -> "MMadaModel":
        """This model with its vocab head gathered once (autograd reaches the
        shards) for the chunked loss's many `apply_head` calls; itself
        without a mesh."""
        if self.mesh is None:
            return self
        params = llada._MeshPath(self.cfg, self.mesh, self.params).head_params(self.params)
        return dataclasses.replace(self, params=params, mesh=None)

    def _text_window_forward_fn(self, block_length: int):
        """Semi-AR block-windowed forward: the full-width vocab head (text
        steps may emit any fused id) over the active block's positions only."""

        def fn(tokens, start):
            return self.forward(tokens, logit_positions=(start, block_length))

        return fn

    def _validate_kv_cache_support(self) -> None:
        if self.pipeline_axis is not None:
            raise ValueError("block_kv_cache is not supported under pipeline serving")
        if self.cfg.attention_bias_enabled:
            raise ValueError(
                "block_kv_cache supports only the no-bias (checkpoint-faithful) "
                "attention path")

    def _text_cache_fns(self, cache_dtype=None):
        """Block-KV cached decode: capture the frame's per-layer K/V once a
        block, then forward only the block's tokens each step (approximate:
        out-of-block K/V are frozen within a block)."""
        self._validate_kv_cache_support()

        def capture(tokens):
            return llada.forward_kv_capture(self.params, self.cfg, tokens, policy=self.policy,
                                            cache_dtype=cache_dtype, mesh=self.mesh)

        def step(block_tokens, kv, block_start):
            return llada.forward_kv_step(self.params, self.cfg, block_tokens, kv, block_start,
                                         policy=self.policy, mesh=self.mesh)

        return capture, step

    def _span_cache_fns(self, window: tuple[int, int], num_tokens: int, cache_dtype=None):
        """Cache fns of the MaskGIT samplers: the span (`num_tokens` positions
        before the frame's last) is left out of the cache (compact form) and
        recomputed each step, with the head over `window` only."""
        self._validate_kv_cache_support()

        def capture(tokens):
            lo = tokens.shape[1] - (num_tokens + 1)
            return llada.forward_kv_capture(self.params, self.cfg, tokens, policy=self.policy,
                                            drop_span=(lo, lo + num_tokens),
                                            cache_dtype=cache_dtype, mesh=self.mesh)

        def step(span_tokens, kv, span_start):
            return llada.forward_kv_step(self.params, self.cfg, span_tokens, kv, span_start,
                                         policy=self.policy, logit_window=window,
                                         cache_is_compact=True, mesh=self.mesh)

        return capture, step

    def _window_forward_fn(self, num_tokens: int, window: tuple[int, int]):
        """Vocab AND position windows: the head runs only over the span's
        hidden states (the image or motion span before the frame's last
        position) and the `window` vocab slice."""

        def fn(tokens, attention_mask):
            seq_len = tokens.shape[1]
            return self.forward(
                tokens, attention_mask=attention_mask, logit_window=window,
                logit_positions=(seq_len - (num_tokens + 1), num_tokens),
            )

        return fn

    # ---------------------------------------------------------------- text
    def _semiar_config(self, gen_length, steps, block_length, temperature, cfg_scale,
                       remasking="low_confidence", parallel_threshold=0.0,
                       parallel_warmup_steps=0, cache_refresh_every=0):
        return text_sampling.SemiARConfig(
            gen_length=gen_length, steps=steps, block_length=block_length,
            temperature=temperature, cfg_scale=cfg_scale, remasking=remasking,
            mask_id=self.vocab.mask_token_id, parallel_threshold=parallel_threshold,
            parallel_warmup_steps=parallel_warmup_steps,
            cache_refresh_every=cache_refresh_every,
        )

    def _text_sources(self, block_length, block_kv_cache):
        """The sampler's logits source: `cache_fns` for the cached decode,
        else the block-windowed exact forward."""
        if block_kv_cache:
            return dict(cache_fns=self._text_cache_fns(_cache_dtype(block_kv_cache)))
        return dict(window_forward_fn=self._text_window_forward_fn(block_length))

    def generate(self, prompt, gen_length=128, steps=128, block_length=128,
                 temperature=0.0, cfg_scale=0.0, remasking="low_confidence",
                 generator=None, block_kv_cache=False, parallel_threshold=0.0,
                 parallel_warmup_steps=0, cache_refresh_every=0, segment_steps=0):
        """(B, P + gen_length) tokens from a (B, P) prompt. The exact sampler
        unless `block_kv_cache` (True / "int8": the cached decode, re-captured
        every `cache_refresh_every` steps within a block) or
        `parallel_threshold` (tau-parallel, from step `parallel_warmup_steps`
        of each block) is set. `segment_steps` (0 = off) runs the exact
        sampler in chunks of at most that many steps of a block, with the
        same tokens (`text_sampling.SegmentedRun`). `generator` may be a list
        of one generator a row (stochastic settings only): each row's tokens
        are then those of its batch-1 run with its generator."""
        scfg = self._semiar_config(gen_length, steps, block_length, temperature, cfg_scale,
                                   remasking, parallel_threshold, parallel_warmup_steps,
                                   cache_refresh_every)
        if segment_steps:
            _exact_only("segment_steps", block_kv_cache)
            return text_sampling.generate_segmented(
                None, prompt, scfg, generator=generator, segment_steps=segment_steps,
                window_forward_fn=self._text_window_forward_fn(block_length))
        return text_sampling.generate(None, prompt, scfg, generator=generator,
                                      **self._text_sources(block_length, block_kv_cache))

    def generate_stepwise(self, prompt, gen_length=128, steps=128, block_length=128,
                          temperature=0.0, cfg_scale=0.0, remasking="low_confidence",
                          generator=None, block_kv_cache=False, cache_refresh_every=0):
        """The denoising trajectory `(steps, B, P + gen_length)`: the tokens
        after every step (the last is `generate`'s)."""
        scfg = self._semiar_config(gen_length, steps, block_length, temperature, cfg_scale,
                                   remasking, cache_refresh_every=cache_refresh_every)
        return text_sampling.generate_stepwise(
            None, prompt, scfg, generator=generator,
            **self._text_sources(block_length, block_kv_cache))

    def _segmented_run(self, prompt, scfg, generator=None, segment_steps=64,
                       block_kv_cache=False, collect_states=False):
        """A `text_sampling.SegmentedRun` on the block-windowed forward."""
        _exact_only("segment_steps", block_kv_cache)
        return text_sampling.SegmentedRun(
            prompt, scfg, generator=generator, segment_steps=segment_steps,
            window_forward_fn=self._text_window_forward_fn(scfg.block_length),
            collect_states=collect_states)

    def segmented_run(self, prompt, gen_length=128, steps=128, block_length=128,
                      temperature=0.0, cfg_scale=0.0, remasking="low_confidence",
                      generator=None, segment_steps=64, parallel_threshold=0.0,
                      parallel_warmup_steps=0):
        """`generate`'s incremental form: a `SegmentedRun`; call `.step()`
        (one chunk each) until True, then read `.x`. `generator` may be a
        list of one generator a row."""
        scfg = self._semiar_config(gen_length, steps, block_length, temperature, cfg_scale,
                                   remasking, parallel_threshold, parallel_warmup_steps)
        return self._segmented_run(prompt, scfg, generator=generator,
                                   segment_steps=segment_steps)

    def segmented_stepwise_run(self, prompt, gen_length=128, steps=128, block_length=128,
                               temperature=0.0, cfg_scale=0.0, remasking="low_confidence",
                               generator=None, segment_steps=8):
        """Incremental stepwise generation: after each `.step()`,
        `.last_states` holds the chunk's `(W, B, L)` per-step tokens
        (concatenated: `generate_stepwise`'s trajectory)."""
        scfg = self._semiar_config(gen_length, steps, block_length, temperature, cfg_scale,
                                   remasking)
        return self._segmented_run(prompt, scfg, generator=generator,
                                   segment_steps=segment_steps, collect_states=True)

    def segmented_chunk_runner(self, steps_per_block, block_length, temperature=0.0,
                               cfg_scale=0.0, remasking="low_confidence",
                               parallel_threshold=0.0, parallel_warmup_steps=0):
        """`run(x, prompt_index, block_ends, transfers, step_offsets,
        generators=None)`: one chunk of the serving engine's continuous
        batching (`text_sampling.run_rows`), every row at its own block
        (`block_ends` `(B,)`) and in-block step (`step_offsets`), drawing
        from its own generator (`generators`, stochastic settings)."""
        block_cfg = self._semiar_config(block_length, steps_per_block, block_length,
                                        temperature, cfg_scale, remasking,
                                        parallel_threshold, parallel_warmup_steps)
        window = self._text_window_forward_fn(block_length)

        def run(x, prompt_index, block_ends, transfers, step_offsets, generators=None):
            return text_sampling.run_rows(block_cfg, x, prompt_index, block_ends, transfers,
                                          step_offsets, generators, window)

        return run

    # ----------------------------------------------------------------- mmu
    def mmu_generate(self, input_ids, max_new_tokens=128, steps=128, block_length=128,
                     temperature=0.0, cfg_scale=0.0, remasking="low_confidence",
                     generator=None, block_kv_cache=False, parallel_threshold=0.0,
                     parallel_warmup_steps=0, cache_refresh_every=0, segment_steps=0):
        """`generate` on a prompt that already holds the <|mmu|> image frame."""
        return self.generate(input_ids, gen_length=max_new_tokens, steps=steps,
                             block_length=block_length, temperature=temperature,
                             cfg_scale=cfg_scale, remasking=remasking, generator=generator,
                             block_kv_cache=block_kv_cache,
                             parallel_threshold=parallel_threshold,
                             parallel_warmup_steps=parallel_warmup_steps,
                             cache_refresh_every=cache_refresh_every,
                             segment_steps=segment_steps)

    def mmu_generate_fast(self, input_ids, eot_token: int, max_new_tokens=128, steps=128,
                          block_length=128, temperature=0.0, cfg_scale=0.0, generator=None,
                          block_kv_cache=False, parallel_threshold=0.0,
                          parallel_warmup_steps=0, cache_refresh_every=0):
        """`mmu_generate` that stops after the first block whose last
        position holds `eot_token` in every row (the blocks not run stay
        masked)."""
        scfg = self._semiar_config(max_new_tokens, steps, block_length, temperature, cfg_scale,
                                   parallel_threshold=parallel_threshold,
                                   parallel_warmup_steps=parallel_warmup_steps,
                                   cache_refresh_every=cache_refresh_every)
        return text_sampling.generate_with_early_stop(
            None, input_ids, scfg, eot_token, generator=generator,
            **self._text_sources(block_length, block_kv_cache))

    # ----------------------------------------------------------------- t2i
    def t2i_generate(self, input_ids, uncond_input_ids=None,
                     attention_mask=None, uncond_attention_mask=None,
                     temperature=1.0, timesteps=18, guidance_scale=0.0,
                     noise_schedule=cosine_schedule, num_vq_tokens=1024,
                     generator=None, greedy=False, stepwise=False,
                     block_kv_cache=False, cache_refresh_every=0,
                     segment_timesteps=0, cfg_interval=(0.0, 1.0)):
        """(B, num_vq_tokens) raw image codes, or with `stepwise` each step's
        `(timesteps, B, num_vq_tokens)`. `block_kv_cache` (True / "int8"):
        capture the K/V outside the image span once and forward only the
        span each step, re-captured every `cache_refresh_every` steps.
        `segment_timesteps` (0 = off) runs the exact sampler in windows of at
        most that many steps, with the same codes."""
        mcfg = self._maskgit_config(temperature, timesteps, guidance_scale, noise_schedule,
                                    num_vq_tokens, greedy, cfg_interval, cache_refresh_every)
        fwd = self._window_forward_fn(num_vq_tokens, self.vocab.image_window)
        if segment_timesteps:
            if stepwise:
                raise ValueError(
                    "stepwise + segment_timesteps: drive t2i_segmented_run and read "
                    ".last_window per chunk instead (true incremental streaming)")
            _exact_only("segment_timesteps", block_kv_cache)
            return t2i_sampling.t2i_generate_segmented(
                fwd, input_ids, mcfg, generator=generator, uncond_input_ids=uncond_input_ids,
                attention_mask=attention_mask, uncond_attention_mask=uncond_attention_mask,
                segment_timesteps=segment_timesteps)
        cache_fns = (self._span_cache_fns(self.vocab.image_window, num_vq_tokens,
                                          _cache_dtype(block_kv_cache))
                     if block_kv_cache else None)
        gen = t2i_sampling.t2i_generate_stepwise if stepwise else t2i_sampling.t2i_generate
        return gen(
            fwd, input_ids, mcfg, generator=generator,
            uncond_input_ids=uncond_input_ids, attention_mask=attention_mask,
            uncond_attention_mask=uncond_attention_mask, cache_fns=cache_fns,
        )

    def _maskgit_config(self, temperature, timesteps, guidance_scale, noise_schedule,
                        num_vq_tokens, greedy, cfg_interval, cache_refresh_every=0):
        return t2i_sampling.MaskGITConfig(
            timesteps=timesteps, temperature=temperature,
            guidance_scale=guidance_scale, noise_schedule=noise_schedule,
            mask_id=self.vocab.mask_token_id, num_vq_tokens=num_vq_tokens,
            codebook_size=self.vocab.image_codebook_size,
            text_vocab_size=self.vocab.image_offset, greedy=greedy,
            cfg_interval=tuple(cfg_interval), cache_refresh_every=cache_refresh_every,
        )

    def t2i_segmented_run(self, input_ids, uncond_input_ids=None, attention_mask=None,
                          uncond_attention_mask=None, temperature=1.0, timesteps=18,
                          guidance_scale=0.0, noise_schedule=cosine_schedule,
                          num_vq_tokens=1024, generator=None, greedy=False,
                          segment_timesteps=8, block_kv_cache=False, cfg_interval=(0.0, 1.0)):
        """`t2i_generate`'s incremental form: a `SegmentedT2IRun`; call
        `.step()` until True, then read `.codes` (`.last_window` after each
        window)."""
        mcfg = self._maskgit_config(temperature, timesteps, guidance_scale, noise_schedule,
                                    num_vq_tokens, greedy, cfg_interval)
        return self._t2i_segmented_run(
            input_ids, mcfg, generator=generator, uncond_input_ids=uncond_input_ids,
            attention_mask=attention_mask, uncond_attention_mask=uncond_attention_mask,
            segment_timesteps=segment_timesteps, block_kv_cache=block_kv_cache)

    def _t2i_segmented_run(self, input_ids, mcfg, generator=None, uncond_input_ids=None,
                           attention_mask=None, uncond_attention_mask=None,
                           segment_timesteps=8, block_kv_cache=False):
        _exact_only("segment_timesteps", block_kv_cache)
        return t2i_sampling.SegmentedT2IRun(
            self._window_forward_fn(mcfg.num_vq_tokens, self.vocab.image_window), input_ids,
            mcfg, generator=generator, uncond_input_ids=uncond_input_ids,
            attention_mask=attention_mask, uncond_attention_mask=uncond_attention_mask,
            segment_timesteps=segment_timesteps)

    # ----------------------------------------------------------------- t2m
    def _motion_config(self, temperature, timesteps, noise_schedule, num_motion_tokens,
                       greedy, cache_refresh_every=0) -> motion_sampling.MotionGITConfig:
        if self.vocab.motion_codebook_size == 0:
            raise ValueError("vocab has no motion window; use vocab.with_motion()")
        return motion_sampling.MotionGITConfig(
            timesteps=timesteps, temperature=temperature, noise_schedule=noise_schedule,
            mask_id=self.vocab.mask_token_id, num_motion_tokens=num_motion_tokens,
            motion_vocab_size=self.vocab.motion_codebook_size,
            motion_offset=self.vocab.motion_offset, greedy=greedy,
            cache_refresh_every=cache_refresh_every,
        )

    @property
    def _motion_window(self) -> tuple[int, int]:
        """The sampler's window: the motion codes without EOM / PAD."""
        lo = self.vocab.motion_offset
        return lo, lo + self.vocab.motion_codebook_size

    def t2m_generate(self, input_ids, attention_mask=None, temperature=1.0, timesteps=18,
                     noise_schedule=cosine_schedule, num_motion_tokens=256, generator=None,
                     greedy=False, block_kv_cache=False, cache_refresh_every=0,
                     segment_timesteps=0):
        """(B, num_motion_tokens) raw motion codes from (B, L) t2m frames.
        `block_kv_cache` (True / "int8"): the cached decode, re-captured every
        `cache_refresh_every` steps; it takes no mask, as JAX's (the exact
        sampler passes `attention_mask` to the forward). `segment_timesteps`
        (0 = off) runs the exact sampler in windows of at most that many
        steps, with the same codes. `generator` may be a list, one a row."""
        mcfg = self._motion_config(temperature, timesteps, noise_schedule, num_motion_tokens,
                                   greedy, cache_refresh_every)
        fwd = self._window_forward_fn(num_motion_tokens, self._motion_window)
        if segment_timesteps:
            _exact_only("segment_timesteps", block_kv_cache)
            return motion_sampling.t2m_generate_segmented(
                fwd, input_ids, mcfg, generator=generator, attention_mask=attention_mask,
                segment_timesteps=segment_timesteps)
        cache_fns = (self._span_cache_fns(self._motion_window, num_motion_tokens,
                                          _cache_dtype(block_kv_cache))
                     if block_kv_cache else None)
        return motion_sampling.t2m_generate(fwd, input_ids, mcfg, generator=generator,
                                            attention_mask=attention_mask, cache_fns=cache_fns)

    def t2m_segmented_run(self, input_ids, attention_mask=None, temperature=1.0, timesteps=18,
                          noise_schedule=cosine_schedule, num_motion_tokens=256, generator=None,
                          greedy=False, segment_timesteps=8):
        """`t2m_generate`'s incremental form: a `SegmentedT2MRun`; call
        `.step()` until True, then read `.codes` (the serving engine's
        chunked t2m)."""
        mcfg = self._motion_config(temperature, timesteps, noise_schedule, num_motion_tokens,
                                   greedy)
        return motion_sampling.SegmentedT2MRun(
            self._window_forward_fn(num_motion_tokens, self._motion_window), input_ids, mcfg,
            generator=generator, attention_mask=attention_mask,
            segment_timesteps=segment_timesteps)


def _exact_only(knob: str, block_kv_cache) -> None:
    """The segmented runs are the exact sampler's: a chunk or window that
    re-captured the block-KV cache would change its staleness (JAX's
    refusal)."""
    if block_kv_cache:
        raise ValueError(f"{knob} supports the exact sampler only (per-chunk K/V recapture "
                         "would change the block-cache staleness semantics)")


def _cache_dtype(block_kv_cache):
    """Sampler flag -> cache dtype: False / True = the compute dtype, "int8"
    = the quantized cache (`llada._quantize_kv`)."""
    return "int8" if block_kv_cache == "int8" else None


def _check_policy(policy: Policy, device: torch.device) -> None:
    if device.type == "cuda" and policy.compute_dtype != torch.bfloat16:
        raise ValueError(
            f"a model on {device} computes in bf16: its attention kernels take bf16 "
            f"only, and this policy computes in {policy.compute_dtype}; pass "
            "policy=BF16 (mmada_tpu_torch.core.precision.BF16)")
