"""Profiling and debugging instrumentation.

Counterpart of `mmada_tpu/utils/profiling.py` (:24-61) on `torch.profiler`:

  * `trace(logdir)` - a profiler window around training or serving steps
    (the CPU's activity, and the card's where there is one), written as a
    Chrome trace (`trace.json` under `logdir`, or the name given) when the
    window closes;
  * `annotate(name)` - a named span inside a step (`record_function`): the
    trace holds it, with the kernels launched inside it;
  * `enable_nan_debugging()` - autograd's anomaly mode: a backward that makes
    a NaN raises, naming the forward op (JAX's `jax_debug_nans`);
  * `step_timer(sync_on)` - wall-clock timing that synchronizes the tensors'
    device before it reads the clock, so that queued kernels count;
  * `device_memory_stats()` - the allocator's counters for each visible card.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Iterator, Optional

import torch


@contextlib.contextmanager
def trace(logdir: str, name: str = "trace.json",
          cuda: Optional[bool] = None) -> Iterator[torch.profiler.profile]:
    """Profile the block; the Chrome trace goes to `logdir/name` at its end.
    `cuda` (default: whether a card is visible) adds the card's activity.
    Yields the profiler (`key_averages()`, `events()`)."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available() if cuda is None else cuda:
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    profiler = torch.profiler.profile(activities=activities)
    profiler.__enter__()
    try:
        yield profiler
    finally:
        profiler.__exit__(None, None, None)
        os.makedirs(logdir, exist_ok=True)
        profiler.export_chrome_trace(os.path.join(logdir, name))


def annotate(name: str):
    """A named span of the trace (a context manager)."""
    return torch.profiler.record_function(name)


def enable_nan_debugging(enable: bool = True) -> None:
    torch.autograd.set_detect_anomaly(enable)


def _sync(tree) -> None:
    """Synchronize the device of every tensor in a (nested) tree."""
    if isinstance(tree, torch.Tensor):
        if tree.is_cuda:
            torch.cuda.synchronize(tree.device)
    elif isinstance(tree, dict):
        for v in tree.values():
            _sync(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            _sync(v)


@contextlib.contextmanager
def step_timer(sync_on=None) -> Iterator[dict]:
    """Times a block into the yielded dict's "seconds"; the devices of
    `sync_on` (a tensor or a tree of them) are synchronized at its end."""
    out: dict = {}
    t0 = time.perf_counter()
    yield out
    if sync_on is not None:
        _sync(sync_on)
    out["seconds"] = time.perf_counter() - t0


def device_memory_stats() -> dict:
    """`torch.cuda.memory_stats` of each visible card, by name ("cuda:0");
    empty without one."""
    if not torch.cuda.is_available():
        return {}
    return {f"cuda:{i}": torch.cuda.memory_stats(i) for i in range(torch.cuda.device_count())}
