"""Sampling primitives: Gumbel-max, confidence remasking, ranks.

Counterpart of `mmada_tpu/sampling/gumbel.py`. Gumbel noise is the log-space
form `logits + T * g` with `g = -log(-log u)` in fp32; at T=0 every sampler
reduces to argmax, the token-exact configuration. Random numbers come from
an explicit `torch.Generator` on the tensors' device, so they differ from
the JAX streams; the distributions are the same. Where JAX gives each row
its own key, the port gives each row its own generator: `generator` may be a
list with one entry a row, and each row then draws its own `(1, ...)`
numbers as a batch-1 run would, so a row's draws do not depend on what
shares its batch; a `None` entry draws nothing (its numbers are zeros).
"""

from __future__ import annotations

from typing import Optional, Sequence, Union

import torch

NEG_INF = float(torch.finfo(torch.float32).min)
_EPS = 1e-20


Generators = Union[None, torch.Generator, Sequence[Optional[torch.Generator]]]


def _rows(draw, shape, generators, device) -> torch.Tensor:
    """`draw(shape, generator)` row by row: row i from `generators[i]` with
    shape `(1, *shape[1:])`; a `None` entry draws nothing (zeros)."""
    row = (1, *shape[1:])
    return torch.cat([draw(row, g) if g is not None
                      else torch.zeros(row, device=device, dtype=torch.float32)
                      for g in generators])


def uniform(shape, generator: Generators, device, low: float = 0.0) -> torch.Tensor:
    """fp32 uniform numbers in [low, 1)."""
    if isinstance(generator, (list, tuple)):
        return _rows(lambda s, g: uniform(s, g, device, low), shape, generator, device)
    u = torch.rand(shape, generator=generator, device=device, dtype=torch.float32)
    return u * (1.0 - low) + low if low else u


def gumbel_noise(shape, generator: Generators, device) -> torch.Tensor:
    if isinstance(generator, (list, tuple)):
        return _rows(lambda s, g: gumbel_noise(s, g, device), shape, generator, device)
    u = uniform(shape, generator, device, low=_EPS)
    return -torch.log(-torch.log(u) + _EPS)


def gumbel_argmax(logits: torch.Tensor, generator: Generators, temperature: float) -> torch.Tensor:
    """argmax(logits + T * Gumbel): exact argmax at T=0."""
    logits = logits.float()
    if temperature == 0.0 or generator is None:
        return logits.argmax(dim=-1)
    noise = gumbel_noise(logits.shape, generator, logits.device)
    return (logits + temperature * noise).argmax(dim=-1)


def confidence_of(logits: torch.Tensor, token_ids: torch.Tensor) -> torch.Tensor:
    """Softmax probability of each chosen token (fp32), computed as
    exp(l_sel - logsumexp(l)) without materializing the probabilities."""
    logits = logits.float()
    lse = torch.logsumexp(logits, dim=-1)
    sel = torch.gather(logits, -1, token_ids[..., None])[..., 0]
    return torch.exp(sel - lse)


def ranks_desc(values: torch.Tensor) -> torch.Tensor:
    """Per-row 0-based rank in descending order (rank 0 = largest); ties
    resolve to the lower index first."""
    order = torch.argsort(-values, dim=-1, stable=True)
    ranks = torch.empty_like(order)
    put = torch.arange(values.shape[-1], device=values.device).expand_as(order)
    return ranks.scatter_(-1, order, put)


def select_top_k_dynamic(values: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """Boolean mask of each row's top-k entries, k a per-row count."""
    return ranks_desc(values) < k[:, None]


def mask_by_random_topk(
    mask_len: torch.Tensor,     # (B, 1) int: how many stay masked
    probs: torch.Tensor,        # (B, N) confidence of chosen tokens
    temperature: torch.Tensor,  # fp32 scalar
    generator: Optional[torch.Generator],
) -> torch.Tensor:
    """Gumbel-perturbed low-confidence remasking: the `mask_len`
    lowest-confidence positions go back to [MASK]."""
    conf = torch.log(torch.clamp(probs.float(), min=_EPS))
    if generator is not None:
        conf = conf + temperature * gumbel_noise(probs.shape, generator, probs.device)
    sorted_conf = torch.sort(conf, dim=-1).values
    cutoff = torch.gather(sorted_conf, -1, mask_len.long())
    return conf < cutoff
