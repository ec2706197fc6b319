"""Forward diffusion (corruption) processes for multi-task training.

Counterpart of `mmada_tpu/training/masking.py`, with a `torch.Generator`
where the JAX package takes a key; the two give different random bits, so the
port is held to the same laws, not the same draws:

  * image tokens - timestep -> mask schedule -> per-row mask count, uniform
    random positions (or a contiguous 2-D region), mask or random-replace
    noise (training/utils.py:77-175 of the reference);
  * text (lm) - per-row uniform t, `p_mask = (1 - eps) t + eps`, iid
    Bernoulli masking;
  * mmu - the same law with the prompt positions restored and the answer
    lengths recorded for the loss normalisation.

Every draw happens on the tensors' device (the generator must live there),
with fixed shapes, so corruption adds no host round trip to a train step.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

IGNORE_ID = -100


def _uniform(generator: Optional[torch.Generator], shape, device) -> torch.Tensor:
    return torch.rand(shape, generator=generator, device=device)


def mask_image_tokens(
    generator: Optional[torch.Generator],
    image_tokens: torch.Tensor,      # (B, N) raw VQ or fused ids
    mask_id: int,
    mask_schedule: Callable,
    min_masking_rate: float = 0.0,
    noise_type: str = "mask",        # 'mask' | 'random_replace'
    codebook_size: int = 8192,
    mask_contiguous_region_prob: float = 0.0,
    mask_prob_override: Optional[torch.Tensor] = None,  # fixed ratios (B,)
):
    """Returns (input_ids, labels, mask_prob). Labels are IGNORE_ID at
    unmasked positions for 'mask' noise; the full tokens for
    'random_replace' (predict-all-tokens mode)."""
    b, n = image_tokens.shape
    device = image_tokens.device
    if mask_prob_override is not None:
        mask_prob = mask_prob_override.float()
    else:
        t = _uniform(generator, (b,), device)
        mask_prob = torch.clamp(mask_schedule(t), min=min_masking_rate)

    num_masked = torch.clamp(torch.round(n * mask_prob), min=1).to(torch.int64)

    # uniform random positions: rank of iid noise < count
    noise = _uniform(generator, (b, n), device)
    ranks = torch.argsort(torch.argsort(noise, dim=-1), dim=-1)
    random_mask = ranks < num_masked[:, None]

    if mask_contiguous_region_prob > 0.0:
        region_mask = _contiguous_region_mask(generator, num_masked, n)
        use_region = _uniform(generator, (), device) < mask_contiguous_region_prob
        mask = torch.where(use_region, region_mask, random_mask)
    else:
        mask = random_mask

    if noise_type == "mask":
        input_ids = torch.where(mask, torch.full_like(image_tokens, mask_id), image_tokens)
        labels = torch.where(mask, image_tokens, torch.full_like(image_tokens, IGNORE_ID))
    elif noise_type == "random_replace":
        rand_tokens = torch.randint(0, codebook_size, image_tokens.shape, generator=generator,
                                    device=device, dtype=image_tokens.dtype)
        input_ids = torch.where(mask, rand_tokens, image_tokens)
        labels = image_tokens
    else:
        raise ValueError(f"unknown noise_type: {noise_type}")
    return input_ids, labels, mask_prob


def _contiguous_region_mask(generator, num_masked: torch.Tensor, n: int) -> torch.Tensor:
    """A rectangle of about num_masked cells on the sqrt(n) x sqrt(n) grid."""
    res = int(round(n ** 0.5))
    b = num_masked.shape[0]
    device = num_masked.device
    min_h = torch.ceil(num_masked / res).to(torch.int64)
    max_h = torch.clamp(num_masked, max=res)
    u = _uniform(generator, (b,), device)
    height = (min_h + (u * (max_h - min_h + 1)).to(torch.int64)).clamp(1, res)
    width = torch.clamp(torch.ceil(num_masked / height).to(torch.int64), max=res)
    y0 = (_uniform(generator, (b,), device) * (res - height + 1)).to(torch.int64)
    x0 = (_uniform(generator, (b,), device) * (res - width + 1)).to(torch.int64)
    ys = torch.arange(res, device=device)[None, :, None]
    xs = torch.arange(res, device=device)[None, None, :]
    inside = (
        (ys >= y0[:, None, None]) & (ys < (y0 + height)[:, None, None])
        & (xs >= x0[:, None, None]) & (xs < (x0 + width)[:, None, None])
    )
    return inside.reshape(b, res * res)


def mask_text_tokens(
    generator: Optional[torch.Generator],
    input_ids: torch.Tensor,   # (B, L)
    mask_id: int,
    eps: float = 1e-3,
):
    """LLaDA-style uniform-t corruption: p = (1 - eps) t + eps, iid per
    token. Returns (noisy_ids, p_mask (B, L))."""
    b, l = input_ids.shape
    device = input_ids.device
    t = _uniform(generator, (b,), device)
    p_mask = ((1 - eps) * t + eps)[:, None] * torch.ones((1, l), device=device)
    masked = _uniform(generator, (b, l), device) < p_mask
    noisy = torch.where(masked, torch.full_like(input_ids, mask_id), input_ids)
    return noisy, p_mask


def mask_answer_tokens(
    generator: Optional[torch.Generator],
    input_ids: torch.Tensor,     # (B, L)
    prompt_mask: torch.Tensor,   # (B, L) 1 = prompt (kept clean)
    mask_id: int,
    eps: float = 1e-3,
):
    """mmu / chat corruption: Bernoulli mask, prompt restored, answer length
    per row. Returns (noisy_ids, p_mask, answer_lengths (B, L))."""
    noisy, p_mask = mask_text_tokens(generator, input_ids, mask_id, eps)
    noisy = torch.where(prompt_mask.bool(), input_ids, noisy)
    answer_len = torch.sum(1 - prompt_mask, dim=-1, keepdim=True)
    answer_lengths = answer_len.expand(input_ids.shape)
    return noisy, p_mask, answer_lengths
