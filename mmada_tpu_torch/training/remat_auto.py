"""`gradient_checkpointing: auto`: pick `dots` or `full` by memory fit.

Counterpart of `mmada_tpu/training/remat_auto.py:61-99`. `dots` keeps every
projection matmul's output for the backward and recomputes only the rest of
the layer, the attention kernel's forward included (`llada.DOTS_SAVED_OPS`);
`full` recomputes the whole layer and keeps only its input. JAX reads the
compiled step's buffer assignment; the port has none, so it measures: at the
first step, on the real batch's shapes, one layer's `dots` forward runs under
a counting policy that adds up the bytes of every output the policy keeps
(the selective checkpoint's own saved-tensor hooks hold them, so an outer
`saved_tensors_hooks` would see nothing), plus the layer's input. Then

    total = allocated + gradients + n_layers x (kept outputs + layer input)

where `allocated` is what the device holds already (weights, optimizer
moments, the tokenizer; on the CPU the train state's tensors), and the
gradients are one tensor per trained weight, all alive at once after the
backward. `dots` is kept if `total <= 0.92 x budget` (JAX's `_HEADROOM`),
else `full`. The budget is the device's memory (`torch.cuda.mem_get_info`'s
total; the host's physical memory for the CPU), or
`MMADA_REMAT_AUTO_BUDGET_GB` where set (JAX's override, for the CPU tests).
The measuring forward launches the attention kernel once.
"""

from __future__ import annotations

import dataclasses
import logging
import os

import torch
from torch.utils.checkpoint import CheckpointPolicy, checkpoint

from mmada_tpu_torch.checkpoints.manager import flatten
from mmada_tpu_torch.models import llada

logger = logging.getLogger(__name__)

# fraction of the budget the dots step may claim: room for the allocator's
# fragmentation and for what the count does not see (the loss's chunks)
_HEADROOM = 0.92


def device_memory_budget(device: torch.device) -> int:
    """Bytes of memory of `device`, or the override."""
    env = os.environ.get("MMADA_REMAT_AUTO_BUDGET_GB")
    if env:
        return int(float(env) * 1e9)
    if device.type == "cuda":
        return torch.cuda.mem_get_info(device)[1]
    return os.sysconf("SC_PHYS_PAGES") * os.sysconf("SC_PAGE_SIZE")


def _nbytes(tree) -> int:
    return sum(t.numel() * t.element_size() for t in flatten(tree).values())


def dots_layer_bytes(model, rows: int, length: int) -> int:
    """Bytes one layer's `dots` forward keeps for the backward at (rows,
    length): the outputs `llada.dots_policy` saves, counted as the policy
    sees them, plus the layer's input."""
    kept = [0]

    def counting_policy(ctx, op, *args, **kwargs):
        decision = llada.dots_policy(ctx, op, *args, **kwargs)
        if decision == CheckpointPolicy.MUST_SAVE and not ctx.is_recompute:
            a, b = args[-2], args[-1]   # mm(a, b); addmm(bias, a, b)
            kept[0] += a.shape[0] * b.shape[1] * a.element_size()
        return decision

    cfg, params = model.cfg, model.params
    lp = llada.layer_params(params)[0]
    device = params["wte"].device if "wte" in params else next(iter(lp.values())).device
    x = torch.zeros(rows, length, cfg.d_model, dtype=model.policy.compute_dtype,
                    device=device, requires_grad=True)
    sin, cos = llada.rope_sin_cos(length, cfg.head_dim, cfg.rope_theta, device=device)
    # over a mesh: the layer's shards gathered, its tensor-parallel width
    path = None if model.mesh is None else llada._MeshPath(cfg, model.mesh, params)
    with torch.enable_grad():
        out = checkpoint(llada._block, cfg, x, lp, None, sin, cos, use_reentrant=False,
                         context_fn=lambda: llada.dots_context(counting_policy), path=path)
    del out
    return kept[0] + x.numel() * x.element_size()


def pick_remat(model, state, rows: int, length: int, budget_bytes: int | None = None):
    """("dots" | "full", info) for training `model` (its live weights in
    `state.params`) on batches of `rows` rows of `length` tokens."""
    device = state.params["wte"].device
    budget = budget_bytes or device_memory_budget(device)
    per_layer = dots_layer_bytes(dataclasses.replace(model, params=state.params), rows, length)
    if device.type == "cuda":
        allocated = torch.cuda.memory_allocated(device)
    else:
        allocated = _nbytes(state.params) + _nbytes(state.opt_state)
    grads = _nbytes(state.params)
    saved = model.cfg.n_layers * per_layer
    total = allocated + grads + saved
    mode = "dots" if total <= _HEADROOM * budget else "full"
    info = {"dots_layer_bytes": per_layer, "dots_saved_bytes": saved,
            "allocated_bytes": allocated, "grads_bytes": grads, "total_bytes": total,
            "budget_bytes": budget, "headroom": _HEADROOM, "rows": rows, "length": length,
            "reason": "fits" if mode == "dots" else "dots exceeds budget"}
    logger.info("gradient_checkpointing=auto -> %s (%s)", mode, info)
    return mode, info
