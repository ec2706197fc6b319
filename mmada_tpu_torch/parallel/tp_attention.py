"""Tensor-parallel attention: heads split over the tensor axis, the port's
kernels on each rank's local heads.

Counterpart of `mmada_tpu/parallel/tp_attention.py` (:42-149). Bidirectional
attention is head-local, so tensor parallelism needs no collective inside
it: each rank runs `ops/attention.bidirectional_attention` (B1 with RoPE,
B2 with a bias, B4 / B4-bias past 4,096 tokens; B3 / B5 in the backward) on
its contiguous block of heads and its batch rows. With contiguous head
blocks, local q-head r maps to local kv-head r // (H/KVH) exactly as
globally, so GQA needs no index change. A (B|1, 1, L, L) bias is broadcast
to every head shard; a per-head bias is cut with the heads.

`local_attention` is the body the model's tensor-parallel block calls (its
q/k/v already hold the local heads: the projections are column-parallel);
`tp_attention` takes whole q/k/v, as JAX's does, and returns this rank's
block of the output (`gather=True`: the whole output, on every rank).
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch

from mmada_tpu_torch.core.mesh import BATCH_AXES, TENSOR_AXIS, axis_group, axis_index, axis_size
from mmada_tpu_torch.ops.attention import bidirectional_attention
from mmada_tpu_torch.parallel.collectives import all_gather, chunk


def best_batch_axes(batch_size: int, mesh, axis_names: Sequence[str] = BATCH_AXES
                    ) -> tuple[str, ...]:
    """Longest prefix of `axis_names` (of size > 1 in the mesh) whose joined
    size divides `batch_size` (JAX's rule: the dropped axes see the batch
    replicated)."""
    axes = tuple(a for a in axis_names if axis_size(mesh, a) > 1)
    while axes:
        if batch_size % axis_size(mesh, axes) == 0:
            return axes
        axes = axes[:-1]
    return ()


def shard_heads(t: torch.Tensor, shard: int, n_shards: int) -> torch.Tensor:
    """Heads block `shard` of `n_shards` of a (B, H, L, D) tensor (or of a
    per-head bias; a bias of one head is every shard's)."""
    if t.shape[1] == 1:
        return t
    per = t.shape[1] // n_shards
    return t[:, shard * per:(shard + 1) * per]


def local_attention(q, k, v, group, bias: Optional[torch.Tensor] = None,
                    rope_sin=None, rope_cos=None) -> torch.Tensor:
    """Attention of this rank's heads: q (B, H/T, L, D), k/v (B, KVH/T, L,
    D); a per-head bias (B|1, H, L, L) is cut to the rank's heads."""
    if bias is not None and bias.shape[1] > 1 and bias.shape[1] != q.shape[1]:
        bias = chunk(bias, 1, group)
    return bidirectional_attention(q, k, v, bias=bias, rope_sin=rope_sin, rope_cos=rope_cos)


def tp_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, mesh,
                 axis_name: str = TENSOR_AXIS, bias: Optional[torch.Tensor] = None,
                 batch_axes: Sequence[str] = (), rope_sin=None, rope_cos=None,
                 gather: bool = False) -> torch.Tensor:
    """Head-sharded attention over `axis_name` of whole q (B, H, L, D), k/v
    (B, KVH, L, D): this rank's heads (and its rows over `batch_axes`) run
    `local_attention`; the result is this rank's (B/b, H/T, L, D) block, or
    with `gather` the whole output on every rank. H and KVH must divide the
    axis size, B the batch axes' (JAX's errors)."""
    t = axis_size(mesh, axis_name)
    n_heads, n_kv = q.shape[1], k.shape[1]
    if n_heads % t or n_kv % t:
        raise ValueError(f"heads ({n_heads}, kv {n_kv}) must divide mesh axis "
                         f"'{axis_name}' of size {t}")
    b_ax = tuple(batch_axes)
    nb = axis_size(mesh, b_ax)
    if b_ax and q.shape[0] % nb:
        raise ValueError(f"batch {q.shape[0]} must divide batch_axes {b_ax} "
                         f"of total size {nb}")
    rows = slice(None)
    if b_ax:
        per = q.shape[0] // nb
        i = axis_index(mesh, b_ax)
        rows = slice(i * per, (i + 1) * per)
    shard = axis_index(mesh, axis_name)
    ql, kl, vl = (shard_heads(x[rows], shard, t) for x in (q, k, v))
    if bias is not None:
        bias = bias[rows] if bias.shape[0] != 1 else bias
        bias = shard_heads(bias, shard, t)
    out = bidirectional_attention(ql, kl, vl, bias=bias, rope_sin=rope_sin, rope_cos=rope_cos)
    if gather:
        out = all_gather(out, 1, axis_group(mesh, axis_name))
        if b_ax:
            out = all_gather(out, 0, axis_group(mesh, b_ax))
    return out

