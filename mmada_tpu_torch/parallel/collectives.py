"""The collectives of the mesh path, as autograd functions.

Under GSPMD the JAX package's collectives are inserted by the compiler; here
each is written where it runs, on plain contiguous tensors (the kernels
never see a distributed tensor type). The model's params are dicts of
tensors and the train step takes its gradients with `torch.autograd.grad`
on the leaves, so sharding is explicit collectives with explicit backward
rules, not module hooks:

  * `gather_shards`: a weight's fsdp shards gathered (all-gather) before
    its use, their gradient reduce-scattered (summed over the ranks whose
    batch rows used it) in the backward; placed inside a layer's
    checkpoint, so that full remat gathers again in the backward (ZeRO-3);
  * `gather_replicated`: shards gathered for a computation every rank of
    the group repeats alike (the embedding and the vocab head over the
    tensor axis): the backward keeps this rank's slice of the gradient,
    which every rank holds whole;
  * `copy_to_group` / `sum_over_group`: Megatron's f and g, around the
    column-parallel (q/k/v, ff_proj, up_proj) and row-parallel (attn_out,
    ff_out) matmuls of the tensor axis;
  * `rotate`: send to the next rank of a ring, receive from the previous
    (the backward sends the gradient back the other way).

Sums (`reduce_scatter`, `all_reduce`, `all_reduce_`) of bf16 or fp16
tensors run in fp32 and round once, as XLA sums a sharded product or
gradient (ROADMAP C.8). A group of None (one rank) makes each of them the
identity. `counts` tallies the collectives launched, by kind (the
counterpart of the HLO collective audit of the JAX package's tests).
"""

from __future__ import annotations

import collections
import torch
import torch.distributed as dist

counts: collections.Counter = collections.Counter()


def _size(group) -> int:
    return 1 if group is None else dist.get_world_size(group)


def _rank(group) -> int:
    return 0 if group is None else dist.get_rank(group)


def all_gather(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """The group's pieces of `x` joined along `dim`, in rank order."""
    n = _size(group)
    if n == 1:
        return x
    counts["all_gather"] += 1
    src = x.detach().movedim(dim, 0).contiguous()
    out = torch.empty((n * src.shape[0],) + src.shape[1:], dtype=src.dtype, device=src.device)
    dist.all_gather_into_tensor(out, src, group=group)
    return out.movedim(0, dim)


def reduce_scatter(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """The sum over the group of `x`, this rank's 1/n slice along `dim`."""
    n = _size(group)
    if n == 1:
        return x
    counts["reduce_scatter"] += 1
    src = _wide(x.detach().movedim(dim, 0)).contiguous()
    out = torch.empty((src.shape[0] // n,) + src.shape[1:], dtype=src.dtype, device=src.device)
    dist.reduce_scatter_tensor(out, src, group=group)
    return out.to(x.dtype).movedim(0, dim)


def all_reduce(x: torch.Tensor, group) -> torch.Tensor:
    """The sum over the group (a new tensor; `x` is left as it is)."""
    if _size(group) == 1:
        return x
    counts["all_reduce"] += 1
    out = _wide(x.detach()).clone()
    dist.all_reduce(out, group=group)
    return out.to(x.dtype)


def all_reduce_max(x: torch.Tensor, group) -> torch.Tensor:
    """The elementwise maximum over the group (exact in any order)."""
    if _size(group) == 1:
        return x
    counts["all_reduce_max"] += 1
    out = x.detach().clone()
    dist.all_reduce(out, op=dist.ReduceOp.MAX, group=group)
    return out


def all_reduce_(x: torch.Tensor, group) -> None:
    """`all_reduce` into `x` itself."""
    if _size(group) == 1:
        return
    if _wide(x) is x:
        counts["all_reduce"] += 1
        dist.all_reduce(x, group=group)
    else:
        x.copy_(all_reduce(x, group))


def _wide(x: torch.Tensor) -> torch.Tensor:
    """A sum's operand in fp32 when it is narrower: the ranks' bf16 (or
    fp16) parts are summed in fp32 and rounded once, as XLA sums a sharded
    product, not rounded after each rank's addition."""
    return x.float() if x.is_floating_point() and x.element_size() < 4 else x


def chunk(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """This rank's 1/n slice of `x` along `dim`."""
    n = _size(group)
    if n == 1:
        return x
    return x.chunk(n, dim=dim)[_rank(group)]


class _GatherShards(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group = dim, group
        return all_gather(x, dim, group)

    @staticmethod
    def backward(ctx, grad):
        return reduce_scatter(grad, ctx.dim, ctx.group), None, None


class _GatherReplicated(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group = dim, group
        return all_gather(x, dim, group)

    @staticmethod
    def backward(ctx, grad):
        return chunk(grad, ctx.dim, ctx.group).contiguous(), None, None


class _GatherJoined(torch.autograd.Function):
    """Rows sharded over (fsdp, tensor) joined: the gradient, whole and
    alike on the tensor ranks, is reduce-scattered over fsdp in blocks of
    the tensor ranks' rows, then cut to this tensor rank's block."""

    @staticmethod
    def forward(ctx, x, dim, fsdp, tensor, joined):
        ctx.dim, ctx.fsdp, ctx.tensor = dim, fsdp, tensor
        return all_gather(x, dim, joined)

    @staticmethod
    def backward(ctx, grad):
        part = reduce_scatter(grad, ctx.dim, ctx.fsdp)
        return chunk(part, ctx.dim, ctx.tensor).contiguous(), None, None, None, None


class _CopyToGroup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x

    @staticmethod
    def backward(ctx, grad):
        return all_reduce(grad, ctx.group), None


class _SumOverGroup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return all_reduce(x, group)

    @staticmethod
    def backward(ctx, grad):
        return grad, None


class _Rotate(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, step):
        ctx.group, ctx.step = group, step
        return _shift(x, group, step)

    @staticmethod
    def backward(ctx, grad):
        return _shift(grad, ctx.group, -ctx.step), None, None


def _shift(x: torch.Tensor, group, step: int) -> torch.Tensor:
    """Send `x` to the rank `step` ahead in the group, receive from the rank
    `step` behind."""
    n = _size(group)
    if n == 1:
        return x
    counts["send_recv"] += 1
    me = _rank(group)
    dst = dist.get_global_rank(group, (me + step) % n)
    src = dist.get_global_rank(group, (me - step) % n)
    x = x.detach().contiguous()
    out = torch.empty_like(x)
    ops = [dist.P2POp(dist.isend, x, dst, group), dist.P2POp(dist.irecv, out, src, group)]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return out


def _grad_free(x: torch.Tensor) -> bool:
    return not (torch.is_grad_enabled() and x.requires_grad)


def gather_shards(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    if _size(group) == 1:
        return x
    if _grad_free(x):
        return all_gather(x, dim, group)
    return _GatherShards.apply(x, dim, group)


def gather_replicated(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    if _size(group) == 1:
        return x
    if _grad_free(x):
        return all_gather(x, dim, group)
    return _GatherReplicated.apply(x, dim, group)


def gather_joined(x: torch.Tensor, dim: int, fsdp, tensor, joined) -> torch.Tensor:
    """Rows sharded over (fsdp, tensor), fsdp major (the embedding's),
    gathered whole on every rank."""
    if _size(tensor) == 1:
        return gather_shards(x, dim, fsdp)
    if _size(fsdp) == 1:
        return gather_replicated(x, dim, tensor)
    if _grad_free(x):
        return all_gather(x, dim, joined)
    return _GatherJoined.apply(x, dim, fsdp, tensor, joined)


def copy_to_group(x: torch.Tensor, group) -> torch.Tensor:
    if _size(group) == 1 or _grad_free(x):
        return x
    return _CopyToGroup.apply(x, group)


def sum_over_group(x: torch.Tensor, group) -> torch.Tensor:
    if _size(group) == 1:
        return x
    if _grad_free(x):
        return all_reduce(x, group)
    return _SumOverGroup.apply(x, group)


def rotate(x: torch.Tensor, group, step: int = 1) -> torch.Tensor:
    if _size(group) == 1:
        return x
    if _grad_free(x):
        return _shift(x, group, step)
    return _Rotate.apply(x, group, step)


def broadcast(x: torch.Tensor, src_in_group: int, group) -> torch.Tensor:
    """The group's rank `src_in_group`'s `x` on every rank of the group (no
    autograd: the pipeline serves)."""
    if _size(group) == 1:
        return x
    counts["broadcast"] += 1
    x = x.contiguous()
    dist.broadcast(x, src=dist.get_global_rank(group, src_in_group), group=group)
    return x


def send(x: torch.Tensor, dst_in_group: int, group):
    counts["send_recv"] += 1
    return dist.isend(x.contiguous(), dist.get_global_rank(group, dst_in_group), group=group)


def recv(like: torch.Tensor, src_in_group: int, group) -> torch.Tensor:
    out = torch.empty_like(like)
    dist.recv(out, dist.get_global_rank(group, src_in_group), group=group)
    return out


def sum_scalars(values: list, group) -> list:
    """0-d tensors summed over the group in one collective."""
    if _size(group) == 1 or not values:
        return list(values)
    stacked = torch.stack([v.detach().float() for v in values])
    summed = all_reduce(stacked, group)
    return [s.to(v.dtype) for s, v in zip(summed, values)]

