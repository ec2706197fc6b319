"""Mask-ratio schedules for MaskGIT-style denoising.

Counterpart of `mmada_tpu/sampling/schedules.py`: cosine, linear, pow<k>,
sigmoid. `t` is progress in [0, 1] as an fp32 tensor; the return value is the
fraction of positions that stay masked after the step.
"""

from __future__ import annotations

import math
from functools import partial
from typing import Callable

import torch


def cosine_schedule(t):
    return torch.cos(t * math.pi * 0.5)


def linear_schedule(t):
    return torch.clamp(1.0 - t, 1e-6, 1.0)


def pow_schedule(t, exponent: float):
    return torch.clamp(1.0 - t ** exponent, 1e-6, 1.0)


def sigmoid_schedule(t, start: float = -3.0, end: float = 3.0, tau: float = 1.0,
                     clip_min: float = 1e-6):
    v_start = 1.0 / (1.0 + math.exp(-start / tau))
    v_end = 1.0 / (1.0 + math.exp(-end / tau))
    output = 1.0 / (1.0 + torch.exp(-((t * (end - start) + start) / tau)))
    output = (v_end - output) / (v_end - v_start)
    return torch.clamp(output, clip_min, 1.0)


def get_mask_schedule(method: str, **kwargs) -> Callable:
    if method == "cosine":
        return cosine_schedule
    if method == "linear":
        return linear_schedule
    if method.startswith("pow"):
        return partial(pow_schedule, exponent=float(method[3:]))
    if method == "sigmoid":
        return partial(sigmoid_schedule, **kwargs)
    raise ValueError(f"unknown schedule method: {method}")
