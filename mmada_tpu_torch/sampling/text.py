"""Semi-autoregressive masked-diffusion text generation.

Counterpart of `mmada_tpu/sampling/text.py` (`generate`, `generate_stepwise`,
`run_block_eager`, `generate_with_early_stop`, `_run_block_steps`,
`_denoise_step`): the answer span is split into blocks; within each block
every step computes the block's logits, Gumbel-argmaxes a candidate
everywhere, scores candidates by softmax confidence (or uniform noise for
'random' remasking), and commits exactly `num_transfer_tokens`
highest-confidence candidates per row. The block and step loops are Python
loops. Classifier-free guidance doubles the batch with the prompt re-masked
and combines `un + (s + 1)(c - un)`.

The block's logits come from one of two sources:
  * exact (the default): the full-sequence forward with the vocab head
    restricted to the block (`WindowForwardFn`);
  * block-KV cached (`cache_fns`, opt-in): the frame's K/V are captured once
    per block (`CaptureFn`), and each step forwards only the block's tokens
    against them (`CachedStepFn`). Out-of-block K/V stay frozen within the
    block, so this approximates the exact sampler; it equals it when every
    step sees a fresh cache (one step per block, or `cache_refresh_every=1`).
Two more opt-in knobs: `parallel_threshold` (tau-parallel: also commit every
candidate whose confidence clears tau, from step `parallel_warmup_steps` of
the block on, and leave the block once it has no [MASK]) and
`cache_refresh_every` (re-capture every N steps within a block).

`generate_with_early_stop` stops after the first block whose last position
holds EOT in every row. The segmented runs of the serving engine
(`SegmentedRun`, `generate_segmented`) come with the engine (ROADMAP A.9).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch

from mmada_tpu_torch.sampling.gumbel import (
    NEG_INF,
    confidence_of,
    gumbel_argmax,
    select_top_k_dynamic,
    uniform,
)

ForwardFn = Callable[[torch.Tensor], torch.Tensor]  # tokens (B, L) -> (B, L, V)
# (tokens (B, L), span_start int) -> logits (B, block_length, V): the model
# evaluates its vocab head only over the current block's positions
WindowForwardFn = Callable[[torch.Tensor, int], torch.Tensor]
# the block-KV cache: tokens (B, L) -> the per-layer K/V (run once per block,
# and at each refresh); (block tokens (B, blk), kv, block_start) -> (B, blk,
# V) logits (run each step)
CaptureFn = Callable[[torch.Tensor], object]
CachedStepFn = Callable[[torch.Tensor, object, int], torch.Tensor]
# (x (B, L), x_blk (B, blk), block_start) -> the block's CFG-combined logits
BlockLogitsFn = Callable[[torch.Tensor, torch.Tensor, int], torch.Tensor]


def as_window_forward_fn(forward_fn: ForwardFn, block_length: int) -> WindowForwardFn:
    """Adapt a full-logits forward to the windowed contract."""

    def wfn(tokens, start):
        return forward_fn(tokens)[:, start:start + block_length]

    return wfn


def num_transfer_schedule(mask_counts: torch.Tensor, steps: int) -> torch.Tensor:
    """(B,) masked counts -> (B, steps) per-step commit counts: uniform split
    with the remainder spread over the first steps."""
    base = mask_counts // steps
    rem = mask_counts % steps
    step_idx = torch.arange(steps, device=mask_counts.device)
    return base[:, None] + (step_idx[None, :] < rem[:, None]).to(base.dtype)


@dataclasses.dataclass(frozen=True)
class SemiARConfig:
    gen_length: int = 128
    steps: int = 128
    block_length: int = 128
    temperature: float = 0.0
    cfg_scale: float = 0.0
    remasking: str = "low_confidence"  # or 'random'
    mask_id: int = 126336
    parallel_threshold: float = 0.0
    """tau-parallel decoding (0 = off): each step also commits every masked
    candidate whose softmax confidence is at least tau, and a block ends as
    soon as it holds no [MASK]. tau > 1 never fires (exact)."""
    parallel_warmup_steps: int = 0
    """tau-parallel only: tau fires from this in-block step index on; the
    steps before it commit the scheduled top-k alone."""
    cache_refresh_every: int = 0
    """Block-KV cached decode only (0 = one capture a block): re-capture the
    frame's K/V before in-block steps s > 0 with s % N == 0. N = 1 makes the
    cached decode equal the exact sampler."""

    def __post_init__(self):
        if self.remasking not in ("low_confidence", "random"):
            raise ValueError(
                f"unknown remasking {self.remasking!r}; "
                "expected 'low_confidence' or 'random'"
            )
        if self.parallel_threshold > 0.0 and self.remasking != "low_confidence":
            raise ValueError(
                "parallel_threshold compares softmax confidences; with "
                f"remasking={self.remasking!r} the per-step score is uniform noise "
                "and the threshold would commit tokens by coin-flip")
        if self.gen_length % self.block_length:
            raise ValueError("gen_length must be divisible by block_length")
        if self.steps % self.num_blocks:
            raise ValueError("steps must be divisible by num_blocks")

    @property
    def num_blocks(self) -> int:
        return self.gen_length // self.block_length

    @property
    def steps_per_block(self) -> int:
        return self.steps // self.num_blocks


def _windowed_block_logits_fn(cfg: SemiARConfig, window_forward_fn: WindowForwardFn,
                              prompt_index: torch.Tensor) -> BlockLogitsFn:
    """Exact mode: the full-sequence forward with a block-windowed head; CFG
    doubles the batch with the prompt re-masked."""

    def fn(x, x_blk, block_start):
        if cfg.cfg_scale > 0.0:
            un_x = torch.where(prompt_index, cfg.mask_id, x)
            logits2 = window_forward_fn(torch.cat([x, un_x], dim=0), block_start)
            cond, uncond = logits2.chunk(2, dim=0)
            return uncond + (cfg.cfg_scale + 1.0) * (cond - uncond)
        return window_forward_fn(x, block_start)

    return fn


def _cached_block_logits_fn(cfg: SemiARConfig, step_fn: CachedStepFn, kv) -> BlockLogitsFn:
    """Cached mode: each step forwards only the block's tokens. Under CFG the
    capture ran on [x; un_x], and the uncond rows' block equals x's (no
    prompt position lies in the generated span), so the step doubles x_blk."""

    def fn(x, x_blk, block_start):
        if cfg.cfg_scale > 0.0:
            logits2 = step_fn(torch.cat([x_blk, x_blk], dim=0), kv, block_start)
            cond, uncond = logits2.chunk(2, dim=0)
            return uncond + (cfg.cfg_scale + 1.0) * (cond - uncond)
        return step_fn(x_blk, kv, block_start)

    return fn


def _capture_block_kv(cfg: SemiARConfig, capture_fn: CaptureFn, x: torch.Tensor,
                      prompt_index: torch.Tensor):
    """The once-a-block capture; under CFG the cond and uncond rows in one
    doubled batch."""
    if cfg.cfg_scale > 0.0:
        un_x = torch.where(prompt_index, cfg.mask_id, x)
        return capture_fn(torch.cat([x, un_x], dim=0))
    return capture_fn(x)


def _denoise_step(
    x: torch.Tensor,                 # (B, L) current tokens
    generator: Optional[torch.Generator],
    num_transfer: torch.Tensor,      # (B,) commits this step
    block_logits_fn: BlockLogitsFn,
    block_end: int,
    cfg: SemiARConfig,
    step_idx: int = 0,               # in-block step: tau's warmup gate
) -> torch.Tensor:
    """One denoise step, computed block-restricted: positions past the block
    are frozen and positions before it are committed, so only the block's
    logits can change `x`."""
    blk = cfg.block_length
    block_start = block_end - blk
    x_blk = x[:, block_start:block_end]
    mask_blk = x_blk == cfg.mask_id

    logits = block_logits_fn(x, x_blk, block_start).float()

    x0 = gumbel_argmax(logits, generator, cfg.temperature).to(x.dtype)
    if cfg.remasking == "low_confidence":
        x0_p = confidence_of(logits, x0)
    else:
        x0_p = uniform(x_blk.shape, generator, x.device)

    x0 = torch.where(mask_blk, x0, x_blk)
    confidence = torch.where(mask_blk, x0_p, NEG_INF)
    transfer = select_top_k_dynamic(confidence, num_transfer)
    if cfg.parallel_threshold > 0.0 and step_idx >= cfg.parallel_warmup_steps:
        # tau-parallel: also commit every masked candidate above tau (the
        # scheduled top-k stays the floor; a committed position is a no-op)
        transfer = transfer | (confidence >= cfg.parallel_threshold)
    x = x.clone()
    x[:, block_start:block_end] = torch.where(transfer, x0, x_blk)
    return x


def _block_logits_and_refresh(cfg: SemiARConfig, x, prompt_index, window_forward_fn,
                              cache_fns):
    """(block_logits_fn, refresh) for one block: the exact windowed fn, or a
    fresh capture's cached fn plus, with `cache_refresh_every`, `refresh(x)`
    that re-captures from the current tokens and returns the new cached fn."""
    if cache_fns is None:
        return _windowed_block_logits_fn(cfg, window_forward_fn, prompt_index), None
    capture_fn, step_fn = cache_fns

    def cached(xc):
        return _cached_block_logits_fn(cfg, step_fn,
                                       _capture_block_kv(cfg, capture_fn, xc, prompt_index))

    return cached(x), (cached if cfg.cache_refresh_every > 0 else None)


def _run_block_steps(cfg: SemiARConfig, x, block_logits_fn, block_end: int,
                     generator, transfers, refresh=None, states=None):
    """One block's denoise steps, for every combination of the knobs. With
    `refresh` the cache is re-captured before in-block steps s > 0 with
    s % cache_refresh_every == 0. With tau-parallel the loop leaves the block
    as soon as it has no [MASK]: that check reads the block's tokens on the
    host, one sync a step. `states` (a list) gains the tokens after each
    step."""
    blk = cfg.block_length
    every = cfg.cache_refresh_every
    for s in range(transfers.shape[1]):
        if cfg.parallel_threshold > 0.0 and not bool(
                (x[:, block_end - blk:block_end] == cfg.mask_id).any()):
            break
        if refresh is not None and s > 0 and s % every == 0:
            block_logits_fn = refresh(x)
        x = _denoise_step(x, generator, transfers[:, s], block_logits_fn, block_end, cfg,
                          step_idx=s)
        if states is not None:
            states.append(x)
    return x


def run_block_eager(cfg: SemiARConfig, x: torch.Tensor, prompt_index: torch.Tensor,
                    block_end: int, generator: Optional[torch.Generator],
                    transfers: torch.Tensor, *,
                    window_forward_fn: Optional[WindowForwardFn] = None,
                    cache_fns: Optional[tuple[CaptureFn, CachedStepFn]] = None,
                    states: Optional[list] = None) -> torch.Tensor:
    """One block of denoise steps (`transfers` (B, steps_per_block)): the
    exact windowed forward, or a capture at the block's start and the cached
    step (re-captured every `cache_refresh_every` steps)."""
    block_logits_fn, refresh = _block_logits_and_refresh(cfg, x, prompt_index,
                                                         window_forward_fn, cache_fns)
    return _run_block_steps(cfg, x, block_logits_fn, block_end, generator, transfers,
                            refresh=refresh, states=states)


def _blocks(forward_fn, prompt, cfg, generator, window_forward_fn, cache_fns, states=None):
    """Run the blocks one by one; yields (x, block_end) after each."""
    b, p = prompt.shape
    if window_forward_fn is None and cache_fns is None:
        window_forward_fn = as_window_forward_fn(forward_fn, cfg.block_length)
    needs_key = cfg.temperature > 0 or cfg.remasking == "random"
    if needs_key and generator is None:
        raise ValueError("stochastic sampling requires a torch.Generator")
    if not needs_key:
        generator = None

    x = torch.cat(
        [prompt.long(),
         torch.full((b, cfg.gen_length), cfg.mask_id, dtype=torch.long,
                    device=prompt.device)],
        dim=1,
    )
    prompt_index = x != cfg.mask_id
    spb = cfg.steps_per_block
    for block_idx in range(cfg.num_blocks):
        block_start = p + block_idx * cfg.block_length
        block_end = block_start + cfg.block_length
        block_mask = (x[:, block_start:block_end] == cfg.mask_id).sum(dim=1)
        transfers = num_transfer_schedule(block_mask, spb)  # (B, spb)
        x = run_block_eager(cfg, x, prompt_index, block_end, generator, transfers,
                            window_forward_fn=window_forward_fn, cache_fns=cache_fns,
                            states=states)
        yield x, block_end


def generate(
    forward_fn: Optional[ForwardFn],
    prompt: torch.Tensor,   # (B, P) int, no masks inside
    cfg: SemiARConfig,
    generator: Optional[torch.Generator] = None,
    window_forward_fn: Optional[WindowForwardFn] = None,
    cache_fns: Optional[tuple[CaptureFn, CachedStepFn]] = None,
) -> torch.Tensor:
    """Generate `(B, P + gen_length)` tokens. Deterministic at T=0 with
    'low_confidence' remasking. Pass `window_forward_fn` (position-windowed
    head) to skip the vocab head outside the active block; `forward_fn`
    alone computes full logits and slices them; `cache_fns` switches to the
    block-KV cached decode."""
    for x, _ in _blocks(forward_fn, prompt, cfg, generator, window_forward_fn, cache_fns):
        pass
    return x


def generate_stepwise(
    forward_fn: Optional[ForwardFn],
    prompt: torch.Tensor,
    cfg: SemiARConfig,
    generator: Optional[torch.Generator] = None,
    window_forward_fn: Optional[WindowForwardFn] = None,
    cache_fns: Optional[tuple[CaptureFn, CachedStepFn]] = None,
) -> torch.Tensor:
    """`generate`'s trajectory `(steps, B, P + gen_length)`: the tokens after
    every step, block-major; the last equals `generate`'s output. tau-parallel
    is refused: its step count depends on the data."""
    if cfg.parallel_threshold > 0.0:
        raise ValueError(
            "parallel_threshold has a data-dependent step count and cannot "
            "collect a fixed-shape trajectory; use the exact sampler for "
            "stepwise visualization")
    states: list = []
    for _ in _blocks(forward_fn, prompt, cfg, generator, window_forward_fn, cache_fns,
                     states=states):
        pass
    return torch.stack(states)


def generate_with_early_stop(
    forward_fn: Optional[ForwardFn],
    prompt: torch.Tensor,
    cfg: SemiARConfig,
    eot_token: int,
    generator: Optional[torch.Generator] = None,
    window_forward_fn: Optional[WindowForwardFn] = None,
    cache_fns: Optional[tuple[CaptureFn, CachedStepFn]] = None,
) -> torch.Tensor:
    """`generate`, stopping after the first block at whose end every row
    holds `eot_token` (one host check a block; `mmu_generate_fast`,
    modeling_mmada.py:484-556). The blocks not run stay masked; up to the
    block it stopped after, the tokens are `generate`'s."""
    for x, block_end in _blocks(forward_fn, prompt, cfg, generator, window_forward_fn,
                                cache_fns):
        if bool((x[:, block_end - 1] == eot_token).all()):
            break
    return x
