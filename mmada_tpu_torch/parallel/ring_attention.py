"""Ring attention: bidirectional attention with the sequence sharded over
the mesh's fsdp axis.

Counterpart of `mmada_tpu/parallel/ring_attention.py` (:30-98), JAX's
function in plain torch, as JAX's is plain jnp with no Pallas: each rank
attends its query block to the K/V blocks that travel around the ring,
accumulating with the online-softmax recurrence (fp32 scores and sums,
divided at the end). K and V go together, one `batch_isend_irecv` a step
(`collectives.rotate`, differentiable: the backward sends the gradient
back round the ring), `axis_size - 1` transfers: the local block is
consumed first. Bidirectional attention skips nothing, so every rank does
the same work.

`ring_attention` takes whole q/k/v, as JAX's does; `ring_attention_rows`
is the model's (`llada._MeshPath.attend` with `attn_impl="ring"`), whose
q/k/v hold this rank's batch rows: the rows are gathered over fsdp, each
rank attends its sequence block of all of them, and the blocks are gathered
back before each rank keeps its rows.
"""

from __future__ import annotations

import torch

from mmada_tpu_torch.core.mesh import FSDP_AXIS, axis_group, axis_size
from mmada_tpu_torch.parallel.collectives import chunk, gather_shards, rotate


def ring_attention_local(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, group,
                         scale: float) -> torch.Tensor:
    """One rank's body: q (B, H, Lq, D) its query block, k/v its K/V block,
    which rotate around `group`."""
    n = 1 if group is None else torch.distributed.get_world_size(group)
    qf = q.float()

    def accumulate(acc, m, s, kv):
        k_cur, v_cur = kv[0].float(), kv[1].float()
        scores = torch.einsum("bhqd,bhkd->bhqk", qf, k_cur) * scale
        m_new = torch.maximum(m, scores.amax(dim=-1, keepdim=True))
        alpha = torch.exp(m - m_new)
        p = torch.exp(scores - m_new)
        s_new = s * alpha + p.sum(dim=-1, keepdim=True)
        acc_new = acc * alpha + torch.einsum("bhqk,bhkd->bhqd", p, v_cur)
        return acc_new, m_new, s_new

    b, h, lq, d = q.shape
    kv = torch.stack([k, v])
    acc, m, s = accumulate(q.new_zeros((b, h, lq, d), dtype=torch.float32),
                           q.new_full((b, h, lq, 1), float("-inf"), dtype=torch.float32),
                           q.new_zeros((b, h, lq, 1), dtype=torch.float32), kv)
    for _ in range(n - 1):
        kv = rotate(kv, group)   # rotate first: the local block is consumed
        acc, m, s = accumulate(acc, m, s, kv)
    return (acc / s).to(q.dtype)


def ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, mesh,
                   axis_name: str = FSDP_AXIS, gather: bool = False) -> torch.Tensor:
    """Attention of whole q/k/v (B, H, L, D), the sequence sharded over
    `axis_name`: this rank's (B, H, L/n, D) output block, or with `gather`
    the whole output. L must divide by the axis size. GQA: repeat K/V heads
    before calling (head counts must match q's)."""
    group = axis_group(mesh, axis_name)
    q, k, v = (chunk(x, 2, group) for x in (q, k, v))
    out = ring_attention_local(q, k, v, group, 1.0 / (q.shape[-1] ** 0.5))
    return gather_shards(out, 2, group) if gather else out


def ring_attention_rows(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        mesh) -> torch.Tensor:
    """The ring for q/k/v of this rank's rows (batch sharded over fsdp)."""
    group = axis_group(mesh, FSDP_AXIS)
    if axis_size(mesh, FSDP_AXIS) == 1:
        return ring_attention_local(q, k, v, None, 1.0 / (q.shape[-1] ** 0.5))
    rows = [gather_shards(x, 0, group) for x in (q, k, v)]
    out = ring_attention(*rows, mesh, FSDP_AXIS, gather=False)
    return chunk(gather_shards(out, 2, group), 0, group)
