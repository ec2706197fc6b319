"""LR schedule factory: constant / linear / cosine (+ min scale) /
cosine_with_restarts / polynomial, all with linear warmup.

Counterpart of `mmada_tpu/training/lr_schedules.py`. A schedule maps the
optimizer's update count to the learning rate as a 0-d fp32 tensor on the
count's device, so a train step reads it without a host round trip.
"""

from __future__ import annotations

import math
from typing import Callable, Mapping, Optional, Union

import torch

Count = Union[int, torch.Tensor]


def _step(count: Count) -> torch.Tensor:
    if isinstance(count, torch.Tensor):
        return count.to(torch.float32)
    return torch.tensor(float(count), dtype=torch.float32)


def get_scheduler(
    name: str,
    learning_rate: float,
    warmup_steps: int = 0,
    total_steps: Optional[int] = None,
    min_lr_scale: float = 0.0,
    num_cycles: float = 0.5,
    power: float = 1.0,
) -> Callable[[Count], torch.Tensor]:
    name = name.lower()

    def warmup(step):
        return torch.clamp(step / max(1, warmup_steps), max=1.0)

    if name == "constant":
        if warmup_steps > 0:
            return lambda count: learning_rate * warmup(_step(count))
        return lambda count: torch.full_like(_step(count), learning_rate)

    if total_steps is None:
        raise ValueError(f"schedule {name!r} needs total_steps")

    def progress(step):
        return torch.clamp((step - warmup_steps) / max(1, total_steps - warmup_steps), 0.0, 1.0)

    if name == "linear":
        def fn(count):
            step = _step(count)
            return learning_rate * warmup(step) * (1.0 - progress(step))
        return fn

    if name == "cosine":
        def fn(count):
            step = _step(count)
            cos = 0.5 * (1.0 + torch.cos(math.pi * num_cycles * 2.0 * progress(step)))
            cos = min_lr_scale + (1.0 - min_lr_scale) * cos
            return learning_rate * warmup(step) * cos
        return fn

    if name == "cosine_with_restarts":
        def fn(count):
            step = _step(count)
            p = progress(step)
            cos = 0.5 * (1.0 + torch.cos(math.pi * ((num_cycles * p) % 1.0) * 2.0))
            return learning_rate * warmup(step) * cos
        return fn

    if name == "polynomial":
        def fn(count):
            step = _step(count)
            return learning_rate * warmup(step) * (1.0 - progress(step)) ** power
        return fn

    raise ValueError(f"unknown lr schedule: {name}")


def from_config(sched_cfg: Mapping, total_steps: Optional[int] = None) -> Callable:
    """Build from the reference config's `lr_scheduler:` block, as a dict:
    `{"scheduler": "cosine", "params": {"learning_rate": ..., ...}}`."""
    params = sched_cfg.get("params", {})
    return get_scheduler(
        sched_cfg.get("scheduler", "constant"),
        learning_rate=params.get("learning_rate", 1e-4),
        warmup_steps=params.get("warmup_steps", 0),
        total_steps=params.get("total_steps", total_steps),
        min_lr_scale=params.get("min_lr_scale", 0.0),
    )
