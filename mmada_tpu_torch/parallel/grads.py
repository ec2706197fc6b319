"""The train step's reductions over a mesh: batch rows, gradients, norms.

The JAX package's sharded step is its single-device step under GSPMD: the
batch is global and every reduction spans it. The port's ranks each hold
their rows, so the step makes the global function explicit
(`training/train_step.py`):

  * rows: the config's batch is the global batch; rank r of the R ranks of
    data x fsdp takes rows [r/R, (r+1)/R) of each task's part of the
    `[t2i | lm | mmu]` concat (`local_rows`); tensor ranks share rows;
  * losses: every denominator counts over the global batch (the per-position
    weight fields of `losses.loss_weights`, built on the whole batch, which
    every rank holds), so each rank's loss is its rows' share of the global
    loss and the shares sum to it;
  * gradients: a weight's fsdp shards come out of the backward already
    summed over fsdp (`collectives.gather_shards`' reduce-scatter); each
    gradient is then summed over the batch axes (data, fsdp) that its
    weight is not sharded on (`reduce`);
  * the global norm: each leaf's sum of squares summed over the axes its
    weight is sharded on (`norm_reduce`), then rounded and added as on one
    device (`optimizers.global_norm`).
"""

from __future__ import annotations

import torch

from mmada_tpu_torch.core.mesh import BATCH_AXES, MESH_AXES, axis_group, axis_index, axis_size
from mmada_tpu_torch.parallel import collectives as C
from mmada_tpu_torch.parallel import sharding
from mmada_tpu_torch.training.losses import IGNORE_ID


class MeshGrads:
    """The reductions of one model's train step over `mesh`."""

    def __init__(self, cfg, mesh, names):
        self.mesh = mesh
        self.layout = sharding.StateLayout(cfg, mesh, names)
        self.axes = {n: sharding.spec_axes(s) for n, s in self.layout.specs.items()}
        self.path_axes = {}
        for n, axes in self.axes.items():
            kind = "blocks/" + n.split(".", 2)[2] if n.startswith("layers.") else n
            self.path_axes[tuple(kind.split("/"))] = axes
        self.batch_ranks = axis_size(mesh, BATCH_AXES)
        self.batch_index = axis_index(mesh, BATCH_AXES)
        self.batch_group = axis_group(mesh, BATCH_AXES)

    def local_rows(self, sizes) -> torch.Tensor:
        """Global row indices of this rank's rows of a concat of parts of
        `sizes` rows (each must divide over the batch ranks)."""
        out, start = [], 0
        for n in sizes:
            if n % self.batch_ranks:
                raise ValueError(f"a batch part of {n} rows does not divide over the "
                                 f"{self.batch_ranks} batch ranks (data x fsdp)")
            per = n // self.batch_ranks
            out.append(torch.arange(start + self.batch_index * per,
                                    start + (self.batch_index + 1) * per))
            start += n
        return torch.cat(out) if out else torch.zeros(0, dtype=torch.long)

    def reduce(self, grads: dict) -> None:
        """Sum each gradient, in place, over the batch axes its weight is not
        sharded on."""
        for name, g in grads.items():
            axes = tuple(a for a in BATCH_AXES if a not in self.axes[name])
            group = axis_group(self.mesh, axes)
            C.all_reduce_(g, group)

    def norm_reduce(self, parts: dict) -> dict:
        """{path: a leaf's sum of squares over this rank's shard} summed over
        the axes the leaf is sharded on, one collective a set of axes."""
        by_axes: dict = {}
        for path, part in parts.items():
            axes = tuple(a for a in MESH_AXES if a in self.path_axes[path])
            by_axes.setdefault(axes, []).append(path)
        out = dict(parts)
        for axes, paths in by_axes.items():
            group = axis_group(self.mesh, axes) if axes else None
            summed = C.sum_scalars([parts[p] for p in paths], group)
            out.update(zip(paths, summed))
        return out

    def sum_rows(self, values: list) -> list:
        """0-d tensors (the rows' shares of the losses) summed over the batch."""
        return C.sum_scalars(values, self.batch_group)

    def gather_rows(self, batch: dict, eos_id: int) -> dict:
        """This rank's clean batch -> the global one (every rank the same),
        each key's rows joined in rank order; frames padded to the longest
        first, as `trainer._pad_flows_to_common_length` pads."""
        group = self.batch_group
        if group is None:
            return batch
        seq = [k for k, v in batch.items() if v.dim() == 2]
        if seq:
            length = torch.tensor(max(batch[k].shape[1] for k in seq), device=batch[seq[0]].device)
            torch.distributed.all_reduce(length, op=torch.distributed.ReduceOp.MAX, group=group)
            batch = {k: _pad(k, v, int(length), eos_id) if k in seq else v
                     for k, v in batch.items()}
        return {k: C.all_gather(v, 0, group) for k, v in batch.items()}


def pad_value(key: str, eos_id: int) -> int:
    """What pads a frame's key: labels the ignore id, prompt masks 1, other
    masks 0, ids EOS (the Trainer's frames, and the ranks' rows joined)."""
    if key.endswith("labels"):
        return IGNORE_ID
    if key.endswith("masks"):
        return 1 if "prompt" in key else 0
    return eos_id


def _pad(key: str, t: torch.Tensor, length: int, eos_id: int) -> torch.Tensor:
    if t.shape[1] == length:
        return t
    return torch.nn.functional.pad(t, (0, length - t.shape[1]), value=pad_value(key, eos_id))
