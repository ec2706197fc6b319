"""Exponential moving average of the trained weights.

Counterpart of `mmada_tpu/training/ema.py:20-63` (the reference's `EMA`
class, models/training_utils.py:61-297): the decay warms up as
`min(max_decay, 1 - (1 + step / inv_gamma) ** -power)`. The shadow is a
tree like the trained parameters (a copy, not a view), updated in place.

Rounding as JAX's jitted update (the Trainer's). The decay is a weakly
typed fp32 number (`step / inv_gamma` divides an int32 by a Python float),
so it and `1 - decay` take the shadow's dtype before they multiply: a bf16
shadow blends in bf16, every product and the sum rounded to bf16, `p` first
cast to the shadow's dtype. In fp32 XLA contracts the blend into one fused
multiply-add, `fma(shadow, decay, p * (1 - decay))`: the second product
rounded to fp32, the first not. The port takes that product exactly in fp64
(24-bit by 24-bit significands fit in 53 bits) and rounds the sum to fp32
from there (a second rounding, which differs from the fused one only where
the fp64 sum lands on an fp32 tie: about once in 2^29). The decay's
`x ** -power` is torch's `pow`, which may differ from XLA's by one fp32 ulp
at some steps (steps 14 and 31 of the first 40 on the CPU).
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch

from mmada_tpu_torch.checkpoints.manager import flatten
from mmada_tpu_torch.training.optimizers import CHUNK


@dataclasses.dataclass
class EMAState:
    shadow: Any         # a tree (dicts and lists) of tensors like the trained params
    step: torch.Tensor  # 0-d int32 on the device

    @classmethod
    def create(cls, params) -> "EMAState":
        """A copy of `params`, a tree of dicts and lists of tensors."""
        shadow = _map(params, lambda t: t.detach().clone())
        device = next(iter(flatten(shadow).values())).device
        return cls(shadow=shadow, step=torch.zeros((), dtype=torch.int32, device=device))


def _map(tree, fn):
    if isinstance(tree, dict):
        return {k: _map(v, fn) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_map(v, fn) for v in tree]
    return fn(tree)


def ema_decay(step: torch.Tensor, max_decay: float = 0.9999, min_decay: float = 0.0,
              inv_gamma: float = 1.0, power: float = 2.0 / 3.0) -> torch.Tensor:
    """The warmup decay (models/training_utils.py:129-142), an fp32 0-d tensor."""
    value = 1.0 - (1.0 + step.to(torch.float32) / inv_gamma) ** -power
    return torch.clamp(value, min_decay, max_decay)


@torch.no_grad()
def ema_update(state: EMAState, params, max_decay: float = 0.9999, min_decay: float = 0.0,
               inv_gamma: float = 1.0, power: float = 2.0 / 3.0) -> EMAState:
    """One update of `state` in place (and returned): the step advances,
    then every shadow leaf blends in its parameter (see the module
    docstring for the rounding)."""
    state.step.add_(1)
    decay = ema_decay(state.step, max_decay, min_decay, inv_gamma, power)
    keep = 1.0 - decay
    live = flatten(params)
    for key, s in flatten(state.shadow).items():
        p = live[key]
        d, k = decay.to(s.dtype), keep.to(s.dtype)   # weak types: the shadow's dtype
        for sc, pc in zip(s.reshape(-1).split(CHUNK), p.reshape(-1).split(CHUNK)):
            rounded = pc.to(sc.dtype) * k
            if sc.dtype == torch.float32:   # XLA's fused multiply-add
                sc.copy_(sc.double() * d.double() + rounded.double())
            else:
                sc.copy_(sc * d + rounded)
    return state
