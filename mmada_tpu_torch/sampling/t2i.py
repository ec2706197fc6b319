"""MaskGIT-style non-autoregressive image generation with CFG.

Counterpart of `mmada_tpu/sampling/t2i.py` (`MaskGITConfig`,
`cfg_interval_steps`, `_cfg_preamble`, `init_carry`, `_scan`, `_make_step`,
`t2i_generate`, `t2i_generate_stepwise`): all image positions start masked
inside the t2i frame `[pad* <|t2i|> <bos> text <eos> <|soi|> IMG <|eoi|>]`;
each of `timesteps` steps forwards the sequence (batch-doubled under CFG
with an empty-prompt uncond row sharing the current image tokens), reads
logits over the image window, samples a candidate at every position, keeps
committed tokens, and re-masks the lowest-confidence positions down to the
schedule's count.

Reference details kept: the CFG combine `(1 + s) * cond - s * uncond`; the
temperature compounds across steps (step t uses T0 * prod(1 - r_i)); the
mask count is clamped to [1, unknown - 1]. The step loop is a Python loop,
and the schedule's scalars are fp32 as in the JAX scan.

The block-KV cached decode (`cache_fns`, opt-in) captures the K/V of the
positions outside the image span once (their tokens never change; their
responses to the committed image tokens are what it freezes), on
`[x; uncond]` under CFG, and each step forwards only the `num_vq_tokens`
image positions (doubled under CFG) at offset `img_lo`.
`cache_refresh_every=N` re-captures before steps t > 0 with t % N == 0. A
`cfg_interval` narrower than every step is refused with the cache, as JAX
refuses it: the cache holds the CFG batch's rows.

The segmented run (`SegmentedT2IRun`, `t2i_generate_segmented`; the exact
sampler only) runs the same step loop window by window, at most
`segment_timesteps` steps a window, with the window list cut at the
`cfg_interval` boundaries as JAX cuts it (so a window is guided or not as a
whole); the carry and the draws are the monolithic run's.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Optional

import torch

from mmada_tpu_torch.sampling.gumbel import (
    confidence_of,
    gumbel_noise,
    mask_by_random_topk,
)
from mmada_tpu_torch.sampling.schedules import cosine_schedule

# (tokens (B, L), attention_mask (B, L) | None) -> (B, num_vq_tokens, codebook)
WindowForwardFn = Callable[[torch.Tensor, Optional[torch.Tensor]], torch.Tensor]


@dataclasses.dataclass(frozen=True)
class MaskGITConfig:
    timesteps: int = 18
    temperature: float = 1.0
    guidance_scale: float = 0.0
    noise_schedule: Callable = cosine_schedule
    mask_id: int = 126336
    num_vq_tokens: int = 1024
    codebook_size: int = 8192
    text_vocab_size: int = 126464   # fused-id offset of the image window
    greedy: bool = False            # argmax instead of categorical (parity/tests)
    cfg_interval: tuple = (0.0, 1.0)
    """Guidance interval (lo, hi) as step fractions: CFG runs only for steps
    t with lo <= t / timesteps < hi; other steps forward the single cond
    batch. (0.0, 1.0) = CFG every step."""
    cache_refresh_every: int = 0
    """KV-cached decode only: re-capture the out-of-span K/V every N steps
    (0 = one capture for all timesteps)."""


def cfg_interval_steps(cfg: MaskGITConfig) -> tuple[int, int]:
    """(lo_idx, hi_idx): step t uses guidance iff lo_idx <= t < hi_idx."""
    lo, hi = cfg.cfg_interval
    if not (0.0 <= lo <= hi <= 1.0):
        raise ValueError(f"cfg_interval must satisfy 0 <= lo <= hi <= 1, got {cfg.cfg_interval}")
    t = cfg.timesteps
    return math.ceil(lo * t - 1e-9), math.ceil(hi * t - 1e-9)


def _cfg_preamble(cfg, prompt_len, uncond_input_ids, attention_mask,
                  uncond_attention_mask):
    """(use_cfg, uncond_prefix, full_mask)."""
    use_cfg = uncond_input_ids is not None and cfg.guidance_scale > 0
    if not use_cfg:
        return False, None, attention_mask
    uncond_prefix = uncond_input_ids[:, :prompt_len].long()
    if attention_mask is not None and uncond_attention_mask is not None:
        full_mask = torch.cat([attention_mask, uncond_attention_mask], dim=0)
    else:
        full_mask = None
    return True, uncond_prefix, full_mask


def init_carry(input_ids: torch.Tensor, cfg: MaskGITConfig):
    """Initial (x, cur, temperature): the frame, its image span as raw codes
    (mask id where masked), and the fp32 temperature."""
    n = cfg.num_vq_tokens
    img_lo = input_ids.shape[1] - (n + 1)
    x = input_ids.long()
    cur = x[:, img_lo:-1]
    cur = torch.where(cur == cfg.mask_id, cfg.mask_id, cur - cfg.text_vocab_size)
    return x, cur, torch.tensor(cfg.temperature, dtype=torch.float32)


def _exact_logits(forward_fn, cfg, x, use_cfg, uncond_prefix, mask):
    """The image window's logits of the full-sequence forward (CFG rows
    batched after the cond rows), before the guidance combine."""
    if use_cfg:
        prompt_len = x.shape[1] - (cfg.num_vq_tokens + 2)
        uncond_x = torch.cat([uncond_prefix, x[:, prompt_len:]], dim=1)
        return forward_fn(torch.cat([x, uncond_x], dim=0), mask)
    return forward_fn(x, mask)


def _cached_logits(step_fn, cfg, x, kv, use_cfg):
    """The image span forwarded alone against the captured K/V; the cond
    and uncond rows share the span's tokens, so CFG doubles it."""
    n = cfg.num_vq_tokens
    img_lo = x.shape[1] - (n + 1)
    img_tok = x[:, img_lo:img_lo + n]
    span_in = torch.cat([img_tok, img_tok], dim=0) if use_cfg else img_tok
    return step_fn(span_in, kv, img_lo)


def _step(logits, cfg, x, cur, temperature, t, use_cfg, generator):
    """One MaskGIT timestep on the step's window logits (CFG rows batched
    after the cond rows); returns (x, cur, temperature, sampled)."""
    n = cfg.num_vq_tokens
    img_lo = x.shape[1] - (n + 1)
    if use_cfg:
        cond, uncond = logits.chunk(2, dim=0)
        logits = (1.0 + cfg.guidance_scale) * cond - cfg.guidance_scale * uncond
    logits = logits.float()                     # (B, n, codebook)

    if cfg.greedy:
        sampled = logits.argmax(dim=-1)
    else:
        sampled = (logits + gumbel_noise(logits.shape, generator, logits.device)).argmax(dim=-1)

    unknown = cur == cfg.mask_id
    sampled = torch.where(unknown, sampled, cur)

    ratio = (torch.tensor(t, dtype=torch.float32) + 1.0) / cfg.timesteps
    mask_ratio = cfg.noise_schedule(ratio)

    selected = confidence_of(logits, sampled)
    selected = torch.where(unknown, selected, torch.finfo(torch.float32).max)

    mask_len = torch.floor(n * mask_ratio).to(torch.long).to(x.device)
    unknown_count = unknown.sum(dim=-1, keepdim=True)
    mask_len = torch.clamp(torch.minimum(unknown_count - 1, mask_len), min=1)

    temperature = temperature * (1.0 - ratio)
    masking = mask_by_random_topk(
        mask_len, selected, temperature.to(x.device),
        None if cfg.temperature == 0.0 else generator,
    )

    new_cur = torch.where(masking, cfg.mask_id, sampled)
    new_img = torch.where(masking, cfg.mask_id, sampled + cfg.text_vocab_size)
    x = x.clone()
    x[:, img_lo:img_lo + n] = new_img
    return x, new_cur, temperature, sampled


def _scan(forward_fn, input_ids, cfg, generator, uncond_input_ids, attention_mask,
          uncond_attention_mask, cache_fns):
    """Run the MaskGIT loop; yields each step's sampled `(B, n)` grid."""
    if not cfg.greedy and generator is None:
        raise ValueError("categorical sampling requires a torch.Generator")
    n = cfg.num_vq_tokens
    prompt_len = input_ids.shape[1] - (n + 2)
    x, cur, temperature = init_carry(input_ids, cfg)
    use_cfg, uncond_prefix, full_mask = _cfg_preamble(
        cfg, prompt_len, uncond_input_ids, attention_mask, uncond_attention_mask
    )
    lo_idx, hi_idx = cfg_interval_steps(cfg)
    if cache_fns is not None:
        if use_cfg and (lo_idx > 0 or hi_idx < cfg.timesteps):
            raise ValueError(
                "cfg_interval + block_kv_cache is unsupported: the cached K/V is "
                "captured at CFG batch (2B rows) and the cond-only phases would need "
                "a different cache shape; run the exact sampler with cfg_interval")
        capture_fn, step_fn = cache_fns

        def capture(xc):
            if use_cfg:
                un = torch.cat([uncond_prefix, xc[:, prompt_len:]], dim=1)
                return capture_fn(torch.cat([xc, un], dim=0))
            return capture_fn(xc)

        kv = capture(x)
    refresh = cfg.cache_refresh_every
    for t in range(cfg.timesteps):
        guided = use_cfg and lo_idx <= t < hi_idx
        if cache_fns is None:
            logits = _exact_logits(forward_fn, cfg, x, guided, uncond_prefix,
                                   full_mask if guided else attention_mask)
        else:
            if refresh > 0 and t > 0 and t % refresh == 0:
                kv = capture(x)
            logits = _cached_logits(step_fn, cfg, x, kv, use_cfg)
        x, cur, temperature, sampled = _step(logits, cfg, x, cur, temperature, t, guided,
                                             generator)
        yield sampled


def t2i_generate(
    forward_fn: WindowForwardFn,
    input_ids: torch.Tensor,                          # (B, L) full t2i frame
    cfg: MaskGITConfig,
    generator: Optional[torch.Generator] = None,
    uncond_input_ids: Optional[torch.Tensor] = None,  # (B, L) empty-prompt frame
    attention_mask: Optional[torch.Tensor] = None,    # (B, L)
    uncond_attention_mask: Optional[torch.Tensor] = None,
    cache_fns=None,                                   # (capture_fn, step_fn)
) -> torch.Tensor:
    """Raw VQ codes `(B, num_vq_tokens)` in [0, codebook_size)."""
    for sampled in _scan(forward_fn, input_ids, cfg, generator, uncond_input_ids,
                         attention_mask, uncond_attention_mask, cache_fns):
        pass
    return sampled


def t2i_generate_stepwise(
    forward_fn: WindowForwardFn,
    input_ids: torch.Tensor,
    cfg: MaskGITConfig,
    generator: Optional[torch.Generator] = None,
    uncond_input_ids: Optional[torch.Tensor] = None,
    attention_mask: Optional[torch.Tensor] = None,
    uncond_attention_mask: Optional[torch.Tensor] = None,
    cache_fns=None,
) -> torch.Tensor:
    """`(timesteps, B, n)`: each step's sampled grid (the last is
    `t2i_generate`'s codes)."""
    return torch.stack(list(_scan(forward_fn, input_ids, cfg, generator, uncond_input_ids,
                                  attention_mask, uncond_attention_mask, cache_fns)))


class SegmentedT2IRun:
    """One segmented MaskGIT generation: `step()` runs ONE window of at most
    `segment_timesteps` steps and returns True after the last; `.last_window`
    holds the window's sampled grids `(W, B, n)` (incremental stepwise
    streaming) and, after the last window, `.codes` the `(B, n)` codes. The
    windows are cut at the `cfg_interval` boundaries, as in JAX
    (`mmada_tpu/sampling/t2i.py:363-388`)."""

    def __init__(self, forward_fn: WindowForwardFn, input_ids: torch.Tensor, cfg: MaskGITConfig,
                 generator: Optional[torch.Generator] = None,
                 uncond_input_ids: Optional[torch.Tensor] = None,
                 attention_mask: Optional[torch.Tensor] = None,
                 uncond_attention_mask: Optional[torch.Tensor] = None,
                 segment_timesteps: int = 8):
        if segment_timesteps < 1:
            raise ValueError(f"segment_timesteps must be >= 1, got {segment_timesteps}")
        if not cfg.greedy and generator is None:
            raise ValueError("categorical sampling requires a torch.Generator")
        self.cfg = cfg
        lo_idx, hi_idx = cfg_interval_steps(cfg)
        use_cfg = uncond_input_ids is not None and cfg.guidance_scale > 0
        cuts = {lo_idx, hi_idx} if use_cfg else set()
        self._windows = []
        for s in range(0, cfg.timesteps, segment_timesteps):
            e = min(s + segment_timesteps, cfg.timesteps)
            points = sorted({s, e} | {c for c in cuts if s < c < e})
            self._windows += list(zip(points[:-1], points[1:]))
        self._steps = _scan(forward_fn, input_ids, cfg, generator, uncond_input_ids,
                            attention_mask, uncond_attention_mask, None)
        self._i = 0
        self.done = False
        self.codes = None
        self.last_window = None

    @property
    def total_chunks(self) -> int:
        return len(self._windows)

    def step(self) -> bool:
        """Run ONE window; True once the last window has run."""
        if not self.done:
            s0, s1 = self._windows[self._i]
            self.last_window = torch.stack([next(self._steps) for _ in range(s1 - s0)])
            self._i += 1
            if self._i == len(self._windows):
                self.done = True
                self.codes = self.last_window[-1]
        return self.done


def t2i_generate_segmented(forward_fn: WindowForwardFn, input_ids: torch.Tensor,
                           cfg: MaskGITConfig, generator: Optional[torch.Generator] = None,
                           uncond_input_ids: Optional[torch.Tensor] = None,
                           attention_mask: Optional[torch.Tensor] = None,
                           uncond_attention_mask: Optional[torch.Tensor] = None,
                           segment_timesteps: int = 8) -> torch.Tensor:
    """`t2i_generate` as windows of at most `segment_timesteps` steps: the
    same codes."""
    run = SegmentedT2IRun(forward_fn, input_ids, cfg, generator=generator,
                          uncond_input_ids=uncond_input_ids, attention_mask=attention_mask,
                          uncond_attention_mask=uncond_attention_mask,
                          segment_timesteps=segment_timesteps)
    while not run.step():
        pass
    return run.codes
