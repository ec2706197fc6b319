"""Semi-autoregressive masked-diffusion text generation (the exact sampler).

Counterpart of the exact path of `mmada_tpu/sampling/text.py` (`generate`,
`_generate_scan`, `_denoise_step`): the answer span is split into blocks;
within each block every step runs a forward with the vocab head restricted
to the block, Gumbel-argmaxes a candidate everywhere, scores candidates by
softmax confidence (or uniform noise for 'random' remasking), and commits
exactly `num_transfer_tokens` highest-confidence candidates per row. The
block and step loops are Python loops. Classifier-free guidance doubles the
batch with the prompt re-masked and combines `un + (s + 1)(c - un)`.

`generate_with_early_stop` stops after the first block whose last position
holds EOT in every row. Block-KV, confidence-parallel and segmented variants
are later slices of the port (ROADMAP A.3-A.5).
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

    def __post_init__(self):
        if self.remasking not in ("low_confidence", "random"):
            raise ValueError(
                f"unknown remasking {self.remasking!r}; "
                "expected 'low_confidence' or 'random'"
            )
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


def _block_logits(cfg: SemiARConfig, window_forward_fn: WindowForwardFn,
                  x: torch.Tensor, prompt_index: torch.Tensor,
                  block_start: int) -> torch.Tensor:
    """Exact mode: the full-sequence forward with a block-windowed head; CFG
    doubles the batch with the prompt re-masked."""
    if cfg.cfg_scale > 0.0:
        un_x = torch.where(prompt_index, cfg.mask_id, x)
        logits2 = window_forward_fn(torch.cat([x, un_x], dim=0), block_start)
        cond, uncond = logits2.chunk(2, dim=0)
        return uncond + (cfg.cfg_scale + 1.0) * (cond - uncond)
    return window_forward_fn(x, block_start)


def _denoise_step(
    x: torch.Tensor,                 # (B, L) current tokens
    generator: Optional[torch.Generator],
    num_transfer: torch.Tensor,      # (B,) commits this step
    window_forward_fn: WindowForwardFn,
    prompt_index: torch.Tensor,
    block_end: int,
    cfg: SemiARConfig,
) -> torch.Tensor:
    """One denoise step, computed block-restricted: positions past the block
    are frozen and positions before it are committed, so only the block's
    logits can change `x`."""
    blk = cfg.block_length
    block_start = block_end - blk
    x_blk = x[:, block_start:block_end]
    mask_blk = x_blk == cfg.mask_id

    logits = _block_logits(cfg, window_forward_fn, x, prompt_index, block_start).float()

    x0 = gumbel_argmax(logits, generator, cfg.temperature).to(x.dtype)
    if cfg.remasking == "low_confidence":
        x0_p = confidence_of(logits, x0)
    else:
        x0_p = uniform(x_blk.shape, generator, x.device)

    x0 = torch.where(mask_blk, x0, x_blk)
    confidence = torch.where(mask_blk, x0_p, NEG_INF)
    transfer = select_top_k_dynamic(confidence, num_transfer)
    x = x.clone()
    x[:, block_start:block_end] = torch.where(transfer, x0, x_blk)
    return x


def _blocks(forward_fn, prompt, cfg, generator, window_forward_fn):
    """Run the blocks one by one; yields (x, block_end) after each."""
    b, p = prompt.shape
    if window_forward_fn is None:
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
        for step in range(spb):
            x = _denoise_step(x, generator, transfers[:, step], window_forward_fn,
                              prompt_index, block_end, cfg)
        yield x, block_end


def generate(
    forward_fn: Optional[ForwardFn],
    prompt: torch.Tensor,   # (B, P) int, no masks inside
    cfg: SemiARConfig,
    generator: Optional[torch.Generator] = None,
    window_forward_fn: Optional[WindowForwardFn] = None,
) -> torch.Tensor:
    """Generate `(B, P + gen_length)` tokens. Deterministic at T=0 with
    'low_confidence' remasking. Pass `window_forward_fn` (position-windowed
    head) to skip the vocab head outside the active block; `forward_fn`
    alone computes full logits and slices them."""
    for x, _ in _blocks(forward_fn, prompt, cfg, generator, window_forward_fn):
        pass
    return x


def generate_with_early_stop(
    forward_fn: Optional[ForwardFn],
    prompt: torch.Tensor,
    cfg: SemiARConfig,
    eot_token: int,
    generator: Optional[torch.Generator] = None,
    window_forward_fn: Optional[WindowForwardFn] = None,
) -> torch.Tensor:
    """`generate`, stopping after the first block at whose end every row
    holds `eot_token` (one host check a block; `mmu_generate_fast`,
    modeling_mmada.py:484-556). The blocks not run stay masked; up to the
    block it stopped after, the tokens are `generate`'s."""
    for x, block_end in _blocks(forward_fn, prompt, cfg, generator, window_forward_fn):
        if bool((x[:, block_end - 1] == eot_token).all()):
            break
    return x
