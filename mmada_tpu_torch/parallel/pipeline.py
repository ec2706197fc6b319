"""Pipeline-parallel (GPipe) serving forward of the layer-stacked LLaDA.

Counterpart of `mmada_tpu/parallel/pipeline.py` (:42-165). The stack's
leading (n_layers) axis split contiguously over the mesh's fsdp ranks is the
stage assignment: stage p holds layers [p n/P, (p+1) n/P) and runs them with
the single-device layer body (`llada._block`); every other weight is
replicated. The only transfers are activations, point to point to the next
stage.

Schedule: GPipe over M microbatches in M + P - 1 ticks. At tick t stage p
runs microbatch t - p (when there is one): stage 0 takes it from the
queue, the others receive it from the stage before; each sends its output to
the next stage (non-blocking) and the last keeps it. The last stage's
outputs are then broadcast to the stage group, and every rank runs the final
norm and the vocab head (`logit_window`, `logit_positions` as
`llada.forward`'s). Serving only, without autograd, as in JAX: the training
path shards with FSDP and tensor parallelism (`parallel/sharding.py`). The
logits equal `llada.forward`'s without a bias.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from mmada_tpu_torch.core.mesh import FSDP_AXIS, axis_group, axis_index, axis_size
from mmada_tpu_torch.core.precision import FP32, Policy
from mmada_tpu_torch.models import llada
from mmada_tpu_torch.ops.quantization import is_quantized
from mmada_tpu_torch.parallel import collectives as C


def shard_stage_params(params: dict, mesh, axis_name: str = FSDP_AXIS) -> dict:
    """This rank's stage: its contiguous layers of every block weight, the
    rest of the tree whole. Plain tensors only (quantized trees keep their
    own layout through `parallel/sharding.py`)."""
    leaves = list(params["blocks"].values()) + [v for k, v in params.items() if k != "blocks"]
    if any(is_quantized(leaf) for leaf in leaves):
        raise ValueError("parallel.serving=pipeline requires unquantized params "
                         "(bf16 multi-card regime)")
    n, i = axis_size(mesh, axis_name), axis_index(mesh, axis_name)
    blocks = {k: v.chunk(n, dim=0)[i].clone() if n > 1 else v
              for k, v in params["blocks"].items()}
    return dict({k: v for k, v in params.items() if k != "blocks"}, blocks=blocks)


def microbatches(batch: int, n_stages: int, num_microbatches: Optional[int] = None) -> int:
    """The microbatch count of a batch (JAX's rule): `num_microbatches` or
    min(B, 2P), cut down until it divides B."""
    m = max(1, min(num_microbatches or min(batch, 2 * n_stages), batch))
    while batch % m:
        m -= 1
    return m


@torch.no_grad()
def pipeline_forward(
    params: dict,
    cfg: llada.LLaDAConfig,
    input_ids: torch.Tensor,          # (B, L) int, every rank the same
    mesh,
    axis_name: str = FSDP_AXIS,
    num_microbatches: Optional[int] = None,
    policy: Policy = FP32,
    logit_window: Optional[tuple[int, int]] = None,
    logit_positions: Optional[tuple] = None,
) -> torch.Tensor:
    """Logits of `llada.forward` (no bias), the block stack pipelined over
    `axis_name` with `params` from `shard_stage_params`. The stages must
    divide the layers; the microbatches (default min(B, 2P)) are cut down
    until they divide B."""
    n_stages = axis_size(mesh, axis_name)
    if cfg.n_layers % n_stages:
        raise ValueError(f"{cfg.n_layers} layers != multiple of {n_stages} stages")
    b, seq_len = input_ids.shape
    m = microbatches(b, n_stages, num_microbatches)

    x = params["wte"][input_ids].to(policy.compute_dtype)
    if cfg.input_emb_norm:
        x = x * math.sqrt(cfg.d_model)
    sin, cos = llada.rope_sin_cos(seq_len, cfg.head_dim, cfg.rope_theta, device=x.device)
    queue = x.reshape(m, b // m, seq_len, -1)
    group = axis_group(mesh, axis_name)
    stage = axis_index(mesh, axis_name)
    layers = llada.layer_params(params)

    outputs = torch.zeros_like(queue)
    sends = []
    for tick in range(m + n_stages - 1):
        mb = tick - stage
        if not 0 <= mb < m:
            continue
        h = queue[mb] if stage == 0 else C.recv(queue[0], stage - 1, group)
        for lp in layers:
            h = llada._block(cfg, h, lp, None, sin, cos)
        if stage == n_stages - 1:
            outputs[mb] = h
        else:
            sends.append(C.send(h, stage + 1, group))
    for req in sends:
        req.wait()
    x = C.broadcast(outputs, n_stages - 1, group).reshape(b, seq_len, -1)
    return llada.finish(params, cfg, x, logit_window, logit_positions, policy)
