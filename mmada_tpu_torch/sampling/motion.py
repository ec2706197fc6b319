"""MaskGIT text-to-motion generation over the motion vocab window.

Counterpart of `mmada_tpu/sampling/motion.py` (`MotionGITConfig`,
`t2m_generate`, `_make_step`, `init_carry`, `run_timestep_window`,
`SegmentedT2MRun`, `t2m_generate_segmented`; the reference `t2m_generate`,
models/modelling_ours.py:557-682). Where the loop differs from t2i's (and
the reference's, which JAX keeps):

  * no classifier-free guidance;
  * the temperature anneal is fresh each step, `T * (1 - ratio)`, where t2i
    compounds it;
  * the last step commits every position (no remask), where t2i keeps at
    least one masked;
  * `mask_len = max(1, min(unknown - 1, floor(n * ratio)))`; a committed
    position's confidence is the fp32 max;
  * the remasking draws no noise at temperature 0.

The frame is fixed-layout `[pad]* <|t2m|> <bos> cap <eos> <|som|> motion
<|eom|>` (prompting/universal.py t2m), so the motion span starts at the
static `span_lo = L - n - 1`. Positions hold fused ids (`motion_offset` +
code) or the mask id; the returned codes are raw, `(B, n)`.

Random numbers come from a `torch.Generator` (or one a row, a list: each
row then draws as its batch-1 run does), drawn in JAX's order within a
step: the categorical sample (Gumbel-max over the window's logits), then
the remasking noise. The draws differ from JAX's streams; at greedy (argmax)
and temperature 0 nothing is drawn and the codes are JAX's.

The cached decode (`cache_fns`, `MMadaModel._span_cache_fns`) captures the
K/V of the positions outside the motion span once (and before every step
t > 0 with t % cache_refresh_every == 0) and forwards only the span each
step. Its capture and step take no attention mask, as JAX's: left pads are
attended to. The segmented run is the exact sampler's.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch

from mmada_tpu_torch.sampling.gumbel import (
    Generators,
    confidence_of,
    gumbel_noise,
    mask_by_random_topk,
)
from mmada_tpu_torch.sampling.schedules import cosine_schedule

# (tokens (B, L), attention_mask (B, L) | None) -> (B, n, motion codebook)
WindowForwardFn = Callable[[torch.Tensor, Optional[torch.Tensor]], torch.Tensor]


@dataclasses.dataclass(frozen=True)
class MotionGITConfig:
    timesteps: int = 18
    temperature: float = 1.0
    noise_schedule: Callable = cosine_schedule
    mask_id: int = 126336
    num_motion_tokens: int = 256
    motion_vocab_size: int = 512
    motion_offset: int = 134656          # text_vocab + image codebook
    greedy: bool = False
    cache_refresh_every: int = 0         # cached decode: re-capture every N steps


def init_carry(input_ids: torch.Tensor, cfg: MotionGITConfig):
    """Initial (x, cur): the frame and its motion span (fused ids or the mask
    id), the carry the segmented run threads between windows."""
    span_lo = input_ids.shape[1] - (cfg.num_motion_tokens + 1)
    x = input_ids.long()
    return x, x[:, span_lo:-1]


def _step(logits, cfg: MotionGITConfig, x, cur, t: int, generator: Generators):
    """One MotionGIT timestep on the step's window logits `(B, n, M)`;
    returns (x, cur, sampled raw codes)."""
    n = cfg.num_motion_tokens
    span_lo = x.shape[1] - (n + 1)
    logits = logits.float()
    if cfg.greedy:
        sampled = logits.argmax(dim=-1)
    else:
        sampled = (logits + gumbel_noise(logits.shape, generator, logits.device)).argmax(dim=-1)

    unknown = cur == cfg.mask_id
    sampled_off = torch.where(unknown, sampled + cfg.motion_offset, cur)

    ratio = (torch.tensor(t, dtype=torch.float32) + 1.0) / cfg.timesteps
    mask_ratio = cfg.noise_schedule(ratio)
    sampled_vq = torch.where(unknown, sampled, (cur - cfg.motion_offset).clamp(min=0))
    selected = confidence_of(logits, sampled_vq)
    selected = torch.where(unknown, selected, torch.finfo(torch.float32).max)

    mask_len = torch.floor(n * mask_ratio).to(torch.long).to(x.device)
    unknown_count = unknown.sum(dim=-1, keepdim=True)
    mask_len = torch.clamp(torch.minimum(unknown_count - 1, mask_len), min=1)

    temperature_adj = (cfg.temperature * (1.0 - ratio)).to(x.device)
    masking = mask_by_random_topk(mask_len, selected, temperature_adj,
                                  None if cfg.temperature == 0.0 else generator)
    if t >= cfg.timesteps - 1:  # the last step commits everything
        masking = torch.zeros_like(masking)

    new_cur = torch.where(masking, cfg.mask_id, sampled_off)
    x = x.clone()
    x[:, span_lo:span_lo + n] = new_cur
    return x, new_cur, sampled_vq


def _steps(forward_fn, carry, ts, cfg, generator, attention_mask=None, cache_fns=None):
    """Run the timesteps `ts` from `carry`; yields ((x, cur), sampled) after
    each step."""
    if not cfg.greedy and generator is None:
        raise ValueError("categorical sampling requires a torch.Generator")
    x, cur = carry
    n = cfg.num_motion_tokens
    span_lo = x.shape[1] - (n + 1)
    if cache_fns is not None:
        capture_fn, step_fn = cache_fns
        kv = capture_fn(x)
    refresh = cfg.cache_refresh_every
    for t in ts:
        if cache_fns is None:
            logits = forward_fn(x, attention_mask)
        else:
            if refresh > 0 and t > 0 and t % refresh == 0:
                kv = capture_fn(x)
            logits = step_fn(x[:, span_lo:span_lo + n], kv, span_lo)
        x, cur, sampled = _step(logits, cfg, x, cur, t, generator)
        yield (x, cur), sampled


def t2m_generate(forward_fn: WindowForwardFn, input_ids: torch.Tensor, cfg: MotionGITConfig,
                 generator: Generators = None, attention_mask: Optional[torch.Tensor] = None,
                 cache_fns=None) -> torch.Tensor:
    """Raw motion VQ codes `(B, num_motion_tokens)` from `(B, L)` t2m frames.
    `cache_fns` ((capture_fn, step_fn)) runs the block-KV cached decode."""
    for _, sampled in _steps(forward_fn, init_carry(input_ids, cfg), range(cfg.timesteps), cfg,
                             generator, attention_mask, cache_fns):
        pass
    return sampled


def run_timestep_window(forward_fn: WindowForwardFn, carry, ts, cfg: MotionGITConfig,
                        generator: Generators = None,
                        attention_mask: Optional[torch.Tensor] = None):
    """One window of the exact loop from `carry`: the steps `ts` (absolute
    step indices: the schedule's ratio and the last-step rule ride them).
    Returns (carry, `(W, B, n)` sampled grids)."""
    grids = []
    for carry, sampled in _steps(forward_fn, carry, ts, cfg, generator, attention_mask):
        grids.append(sampled)
    return carry, torch.stack(grids)


class SegmentedT2MRun:
    """Incremental MotionGIT generation: `step()` runs ONE window of at most
    `segment_timesteps` steps and returns True after the last; `.last_window`
    holds the window's `(W, B, n)` grids and, once done, `.codes` the `(B, n)`
    codes (the monolithic run's: same carry, same draws). The cached decode
    is not offered (a per-window capture would change its staleness)."""

    def __init__(self, forward_fn: WindowForwardFn, input_ids: torch.Tensor,
                 cfg: MotionGITConfig, generator: Generators = None,
                 attention_mask: Optional[torch.Tensor] = None, segment_timesteps: int = 8):
        if segment_timesteps < 1:
            raise ValueError(f"segment_timesteps must be >= 1, got {segment_timesteps}")
        if not cfg.greedy and generator is None:
            raise ValueError("categorical sampling requires a torch.Generator")
        self.cfg = cfg
        self._forward_fn = forward_fn
        self._generator = generator
        self._mask = attention_mask
        self._carry = init_carry(input_ids, cfg)
        self._windows = [(s, min(s + segment_timesteps, cfg.timesteps))
                         for s in range(0, cfg.timesteps, segment_timesteps)]
        self._i = 0
        self.done = False
        self.codes = None
        self.last_window = None

    def step(self) -> bool:
        if not self.done:
            s0, s1 = self._windows[self._i]
            self._carry, self.last_window = run_timestep_window(
                self._forward_fn, self._carry, range(s0, s1), self.cfg, self._generator,
                self._mask)
            self._i += 1
            if self._i == len(self._windows):
                self.done = True
                self.codes = self.last_window[-1]
        return self.done


def t2m_generate_segmented(forward_fn: WindowForwardFn, input_ids: torch.Tensor,
                           cfg: MotionGITConfig, generator: Generators = None,
                           attention_mask: Optional[torch.Tensor] = None,
                           segment_timesteps: int = 8) -> torch.Tensor:
    """`t2m_generate` as windows of at most `segment_timesteps` steps: the
    same codes."""
    run = SegmentedT2MRun(forward_fn, input_ids, cfg, generator=generator,
                          attention_mask=attention_mask, segment_timesteps=segment_timesteps)
    while not run.step():
        pass
    return run.codes
