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
holds EOT in every row.

The segmented runs (`SegmentedRun`, `generate_segmented`) run the exact
sampler in chunks of at most `segment_steps` steps of a block, each chunk
started from the in-block step it continues (`step_offset`), so the refresh
cadence and tau's warmup gate read the block's step as in one run; the
serving engine interleaves chunks of concurrent requests. JAX precomputes a
key for each step; the port draws in sequence from a `torch.Generator`, so a
chunked run equals the monolithic one because it makes the same draws in the
same order with the same shapes. Rows with their own generators (a list,
one a row: the engine's per-row seeds) each draw as a batch-1 run would; a
row that a batch-1 run would not step draws nothing: its block holds no
[MASK] under tau-parallel, or it is past its block's steps (the engine's
padding steps). `run_rows` is the engine's chunk: every row at its own
block (`block_ends`) and step (`step_offsets`).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Sequence

import torch

from mmada_tpu_torch.sampling.gumbel import (
    NEG_INF,
    Generators,
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
    doubles the batch with the prompt re-masked. `block_start` is an int, or
    a `(B,)` tensor of per-row starts."""

    def fn(x, x_blk, block_start):
        if cfg.cfg_scale > 0.0:
            un_x = torch.where(prompt_index, cfg.mask_id, x)
            if isinstance(block_start, torch.Tensor):
                block_start = torch.cat([block_start, block_start])
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
    generator: Generators,
    num_transfer: torch.Tensor,      # (B,) commits this step
    block_logits_fn: BlockLogitsFn,
    block_end,                       # int, or (B,) tensor: each row's block
    cfg: SemiARConfig,
    step_idx=0,                      # in-block step (int or (B,)): tau's warmup gate
) -> torch.Tensor:
    """One denoise step, computed block-restricted: positions past the block
    are frozen and positions before it are committed, so only the block's
    logits can change `x`. With a `(B,)` `block_end` each row reads and
    writes its own block."""
    blk = cfg.block_length
    block_start = block_end - blk
    if isinstance(block_end, torch.Tensor):
        idx = block_start[:, None] + torch.arange(blk, device=x.device)
        x_blk = torch.gather(x, 1, idx)
    else:
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
    if cfg.parallel_threshold > 0.0:
        # tau-parallel: also commit every masked candidate above tau (the
        # scheduled top-k stays the floor; a committed position is a no-op)
        fire = confidence >= cfg.parallel_threshold
        if isinstance(step_idx, torch.Tensor):
            transfer = transfer | (fire & (step_idx >= cfg.parallel_warmup_steps)[:, None])
        elif step_idx >= cfg.parallel_warmup_steps:
            transfer = transfer | fire
    new_blk = torch.where(transfer, x0, x_blk)
    if isinstance(block_end, torch.Tensor):
        return x.scatter(1, idx, new_blk)
    x = x.clone()
    x[:, block_start:block_end] = new_blk
    return x


def _live_rows(generator, x, block_end, cfg: SemiARConfig):
    """Per-row generators under tau-parallel: a row whose block holds no
    [MASK] draws nothing (a batch-1 run would have left the block)."""
    if not isinstance(generator, (list, tuple)) or cfg.parallel_threshold <= 0.0:
        return generator
    live = (x[:, block_end - cfg.block_length:block_end] == cfg.mask_id).any(dim=1).tolist()
    return [g if on else None for g, on in zip(generator, live)]


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
                     generator, transfers, refresh=None, states=None, step_offset: int = 0):
    """One block's denoise steps, for every combination of the knobs: the
    block's in-block steps `step_offset`, ... (a chunk of them in a
    segmented run; `transfers` holds their columns). With `refresh` the
    cache is re-captured before in-block steps s > 0 with
    s % cache_refresh_every == 0. With tau-parallel the loop leaves the block
    as soon as it has no [MASK]: that check reads the block's tokens on the
    host, one sync a step. `states` (a list) gains the tokens after each
    step."""
    blk = cfg.block_length
    every = cfg.cache_refresh_every
    for i in range(transfers.shape[1]):
        s = step_offset + i
        if cfg.parallel_threshold > 0.0 and not bool(
                (x[:, block_end - blk:block_end] == cfg.mask_id).any()):
            break
        if refresh is not None and s > 0 and s % every == 0:
            block_logits_fn = refresh(x)
        x = _denoise_step(x, _live_rows(generator, x, block_end, cfg), transfers[:, i],
                          block_logits_fn, block_end, cfg, step_idx=s)
        if states is not None:
            states.append(x)
    return x


def run_block_eager(cfg: SemiARConfig, x: torch.Tensor, prompt_index: torch.Tensor,
                    block_end: int, generator: Generators,
                    transfers: torch.Tensor, *,
                    window_forward_fn: Optional[WindowForwardFn] = None,
                    cache_fns: Optional[tuple[CaptureFn, CachedStepFn]] = None,
                    states: Optional[list] = None, step_offset: int = 0) -> torch.Tensor:
    """One block of denoise steps (`transfers` (B, n), the columns of the
    block's in-block steps `step_offset` ... `step_offset + n - 1`): the
    exact windowed forward, or a capture at the block's start and the cached
    step (re-captured every `cache_refresh_every` steps)."""
    block_logits_fn, refresh = _block_logits_and_refresh(cfg, x, prompt_index,
                                                         window_forward_fn, cache_fns)
    return _run_block_steps(cfg, x, block_logits_fn, block_end, generator, transfers,
                            refresh=refresh, states=states, step_offset=step_offset)


def _needs_key(cfg: SemiARConfig) -> bool:
    return cfg.temperature > 0 or cfg.remasking == "random"


def _check_generator(cfg: SemiARConfig, generator):
    """The generator the sampler draws from: None for deterministic settings
    (a single generator is then ignored; a list of row generators is
    refused, as JAX refuses `row_keys`)."""
    if _needs_key(cfg):
        if generator is None:
            raise ValueError("stochastic sampling requires a torch.Generator")
        return list(generator) if isinstance(generator, (list, tuple)) else generator
    if isinstance(generator, (list, tuple)):
        raise ValueError(
            "row generators require stochastic sampling (temperature > 0 or "
            "remasking='random'); pass generator=None for deterministic settings")
    return None


def _initial_tokens(prompt: torch.Tensor, cfg: SemiARConfig, generator) -> torch.Tensor:
    """The prompt followed by `gen_length` [MASK]s; a list of row generators
    must hold one a row."""
    b = prompt.shape[0]
    if isinstance(generator, list) and len(generator) != b:
        raise ValueError(f"{len(generator)} row generators for {b} rows")
    return torch.cat(
        [prompt.long(),
         torch.full((b, cfg.gen_length), cfg.mask_id, dtype=torch.long, device=prompt.device)],
        dim=1,
    )


def _blocks(forward_fn, prompt, cfg, generator, window_forward_fn, cache_fns, states=None):
    """Run the blocks one by one; yields (x, block_end) after each."""
    p = prompt.shape[1]
    if window_forward_fn is None and cache_fns is None:
        window_forward_fn = as_window_forward_fn(forward_fn, cfg.block_length)
    generator = _check_generator(cfg, generator)
    x = _initial_tokens(prompt, cfg, generator)
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
    generator: Generators = None,
    window_forward_fn: Optional[WindowForwardFn] = None,
    cache_fns: Optional[tuple[CaptureFn, CachedStepFn]] = None,
) -> torch.Tensor:
    """Generate `(B, P + gen_length)` tokens. Deterministic at T=0 with
    'low_confidence' remasking. `generator` may be a list of one generator
    a row (stochastic settings only): each row then draws as its batch-1 run
    would. Pass `window_forward_fn` (position-windowed
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


def generate_segmented(
    forward_fn: Optional[ForwardFn],
    prompt: torch.Tensor,
    cfg: SemiARConfig,
    generator: Generators = None,
    segment_steps: int = 64,
    window_forward_fn: Optional[WindowForwardFn] = None,
) -> torch.Tensor:
    """`generate`, run as chunks of at most `segment_steps` steps of a block
    (`SegmentedRun` drained): the same tokens, since each chunk makes the
    monolithic run's draws in its order. The exact sampler only."""
    run = SegmentedRun(prompt, cfg, generator=generator, segment_steps=segment_steps,
                       forward_fn=forward_fn, window_forward_fn=window_forward_fn)
    while not run.step():
        pass
    return run.x


class SegmentedRun:
    """One segmented generation: `step()` runs ONE chunk (at most
    `segment_steps` steps of a block) and returns True once the last chunk
    has run; `.x` holds the `(B, P + gen_length)` tokens. The serving engine
    interleaves `step()` calls of concurrent runs, so a heavy generation
    yields the card every chunk. `generator` is one generator, or a list of
    one a row (stochastic settings only). `collect_states=True` keeps each
    chunk's per-step tokens in `.last_states` `(W, B, L)` (the streamed
    stepwise demo; concatenated, `generate_stepwise`'s trajectory)."""

    def __init__(self, prompt: torch.Tensor, cfg: SemiARConfig, generator: Generators = None,
                 segment_steps: int = 64, forward_fn: Optional[ForwardFn] = None,
                 window_forward_fn: Optional[WindowForwardFn] = None,
                 collect_states: bool = False):
        if segment_steps < 1:
            raise ValueError(f"segment_steps must be >= 1, got {segment_steps}")
        if collect_states and cfg.parallel_threshold > 0.0:
            raise ValueError(
                "parallel_threshold has a data-dependent step count and cannot collect a "
                "fixed-shape trajectory; use the exact sampler for stepwise visualization")
        self.cfg = cfg
        self._generator = _check_generator(cfg, generator)
        if collect_states and isinstance(self._generator, list):
            raise ValueError("collect_states with row generators is unsupported")
        self.x = _initial_tokens(prompt, cfg, self._generator)
        self._prompt_index = self.x != cfg.mask_id
        self._p = prompt.shape[1]
        if window_forward_fn is None:
            window_forward_fn = as_window_forward_fn(forward_fn, cfg.block_length)
        self._logits_fn = _windowed_block_logits_fn(cfg, window_forward_fn, self._prompt_index)
        self.collect_states = collect_states
        self.last_states = None
        spb, nb = cfg.steps_per_block, cfg.num_blocks
        self.total_chunks = nb * -(-spb // segment_steps)
        self.chunks_done = 0
        self.done = nb == 0
        self._gen = self._chunks(segment_steps, spb, nb)

    def _chunks(self, segment_steps, spb, nb):
        blk = self.cfg.block_length
        for bi in range(nb):
            block_end = self._p + (bi + 1) * blk
            block_mask = (self.x[:, block_end - blk:block_end] == self.cfg.mask_id).sum(dim=1)
            transfers = num_transfer_schedule(block_mask, spb)
            for s0 in range(0, spb, segment_steps):
                states = [] if self.collect_states else None
                self.x = _run_block_steps(self.cfg, self.x, self._logits_fn, block_end,
                                          self._generator, transfers[:, s0:s0 + segment_steps],
                                          states=states, step_offset=s0)
                if states is not None:
                    self.last_states = torch.stack(states)
                yield

    def step(self) -> bool:
        """Run ONE chunk; True once the generation is complete."""
        if not self.done:
            next(self._gen)
            self.chunks_done += 1
            self.done = self.chunks_done >= self.total_chunks
        return self.done


def run_rows(cfg: SemiARConfig, x: torch.Tensor, prompt_index: torch.Tensor,
             block_ends: torch.Tensor, transfers: torch.Tensor, step_offsets: Sequence[int],
             generators: Optional[Sequence[Optional[torch.Generator]]],
             window_forward_fn: WindowForwardFn) -> torch.Tensor:
    """One chunk of the serving engine's continuous batching: `transfers`
    `(B, C)` columns of C steps, each row at its own block (`block_ends`
    `(B,)`) and its own first in-block step (`step_offsets`). A row steps as
    its batch-1 run would, and draws from `generators[i]` (stochastic) only
    at the steps that run would take: none past the block's
    `steps_per_block` (the chunk's padding steps, which commit nothing: no
    [MASK] is left by then), none under tau-parallel once its block holds no
    [MASK]."""
    spb = cfg.steps_per_block
    offsets = torch.as_tensor(list(step_offsets), device=x.device)
    logits_fn = _windowed_block_logits_fn(cfg, window_forward_fn, prompt_index)
    blk = cfg.block_length
    idx = (block_ends - blk)[:, None] + torch.arange(blk, device=x.device)
    for i in range(transfers.shape[1]):
        gens = None
        if generators is not None:
            live = [o + i < spb for o in step_offsets]
            if cfg.parallel_threshold > 0.0:
                has_mask = (torch.gather(x, 1, idx) == cfg.mask_id).any(dim=1).tolist()
                live = [r and m for r, m in zip(live, has_mask)]
            gens = [g if on else None for g, on in zip(generators, live)]
        x = _denoise_step(x, gens, transfers[:, i], logits_fn, block_ends, cfg,
                          step_idx=offsets + i)
    return x
