"""The multi-task train step.

Counterpart of `mmada_tpu/training/train_step.py`: one optimizer step is

  corrupt (t2i span masking + lm / mmu Bernoulli masking, training/masking.py)
  -> one backbone forward over the `[t2i | lm | mmu]` concat batch
  -> three masked-CE losses (training/losses.py)
  -> weighted sum -> grad -> clip -> AdamW or Lion update -> LR schedule,

everything on the batch's device and nothing read back to the host: the
metrics are 0-d device tensors.

Over a mesh of more than one rank (the template model's `mesh`, its
params this rank's shards) the step computes the global step
(`parallel/grads.py`): `__call__` gathers the ranks' clean rows into the
global batch and corrupts it whole, with the generator every rank seeds
alike, so the masks and ratios are those of one device; `apply` takes that
global batch, forwards this rank's rows with global denominators, sums the
gradients over the batch axes, and updates the local shards with the
global norm. The metrics are the global ones on every rank.

Where the JAX step returns a new state, this one updates the parameters and
the optimizer state in place (the full-width model leaves no room for a
second copy). A step whose loss or gradient norm is not finite is skipped on
the device: every tensor keeps its old value and the step count does not
advance.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional

import torch

from mmada_tpu_torch.core.mesh import TENSOR_AXIS, axis_size, world_size
from mmada_tpu_torch.models import llada
from mmada_tpu_torch.models.mmada import MMadaModel
from mmada_tpu_torch.ops.quantization import tag_w8a8_ste
from mmada_tpu_torch.parallel.grads import MeshGrads
from mmada_tpu_torch.sampling.schedules import cosine_schedule
from mmada_tpu_torch.training import losses as L
from mmada_tpu_torch.training import masking
from mmada_tpu_torch.training.optimizers import MultiSteps, global_norm


@dataclasses.dataclass
class TrainState:
    params: Any        # the trainable tree (llada.split_layers)
    opt_state: Any
    step: torch.Tensor  # 0-d int64 on the device

    @classmethod
    def create(cls, params, optimizer) -> "TrainState":
        """Trainable leaves over the storage of `params` (no copy) and a
        fresh optimizer state."""
        tree = llada.split_layers(params)
        device = tree["wte"].device
        return cls(params=tree, opt_state=optimizer.init(dict(llada.named_leaves(tree))),
                   step=torch.zeros((), dtype=torch.int64, device=device))


@dataclasses.dataclass(frozen=True)
class StepConfig:
    """Configuration of one train step (`mmada_tpu.training.train_step`)."""

    batch_size_t2i: int
    batch_size_lm: int
    batch_size_mmu: int
    max_seq_length: int          # text-frame length inside the t2i frame
    t2i_coeff: float = 1.0
    lm_coeff: float = 0.1
    mmu_coeff: float = 1.0
    min_masking_rate: float = 0.0
    noise_type: str = "mask"
    mask_contiguous_region_prob: float = 0.0
    mask_schedule: Callable = cosine_schedule
    lm_loss_mode: str = "llada"
    use_chat_lm: bool = False    # stage 3: lm rows carry prompt masks
    lm_pad_loss: bool = True     # False: EOS padding leaves the lm loss
    loss_chunk: int = 0          # > 0: position-chunked vocab head
    log_param_grad_norms: bool = False
    skip_nonfinite_updates: bool = True
    forward_quantize: str = "none"  # "w8a8": the block matmuls' STE int8 forward


def corrupt_batch(model: MMadaModel, sc: StepConfig, batch: dict,
                  generator: Optional[torch.Generator]) -> dict:
    """Apply the three corruption laws on the batch's device; returns the
    loss-ready tensors. `batch` carries clean frames from prompting."""
    mask_id = model.vocab.mask_token_id
    parts_ids, parts_labels = [], []
    out: dict[str, Any] = {}

    if sc.batch_size_t2i:
        ids = batch["t2i_input_ids"]
        span = slice(sc.max_seq_length + 1, ids.shape[1] - 1)  # image tokens
        noisy_span, span_labels, mask_prob = masking.mask_image_tokens(
            generator, ids[:, span], mask_id,
            mask_schedule=sc.mask_schedule,
            min_masking_rate=sc.min_masking_rate,
            noise_type=sc.noise_type,
            codebook_size=model.vocab.image_codebook_size,
            mask_contiguous_region_prob=sc.mask_contiguous_region_prob,
        )
        noisy = ids.clone()
        noisy[:, span] = noisy_span
        labels = torch.full_like(ids, L.IGNORE_ID)
        labels[:, span] = span_labels
        parts_ids.append(noisy)
        parts_labels.append(labels)
        out["mask_prob"] = mask_prob
        out["t2i_masks"] = batch.get("t2i_masks")

    if sc.batch_size_lm:
        ids = batch["lm_input_ids"]
        if sc.use_chat_lm:
            noisy, p_mask, ans_len = masking.mask_answer_tokens(
                generator, ids, batch["lm_prompt_masks"], mask_id)
            out["answer_lengths_lm"] = ans_len
        else:
            noisy, p_mask = masking.mask_text_tokens(generator, ids, mask_id)
        parts_ids.append(noisy)
        parts_labels.append(batch["lm_labels"])
        out["p_mask_lm"] = p_mask

    if sc.batch_size_mmu:
        ids = batch["mmu_input_ids"]
        noisy, p_mask, ans_len = masking.mask_answer_tokens(
            generator, ids, batch["mmu_prompt_masks"], mask_id)
        parts_ids.append(noisy)
        parts_labels.append(batch["mmu_labels"])
        out["p_mask_mmu"] = p_mask
        out["answer_lengths"] = ans_len

    out["input_ids"] = torch.cat(parts_ids, dim=0)
    out["labels"] = torch.cat(parts_labels, dim=0)
    return out


def per_kind_grad_norms(grads: dict[str, torch.Tensor], reduce=None) -> dict[str, torch.Tensor]:
    """`grad_norm/<kind>` per weight kind, the layers of a kind together
    (`blocks/q_proj`, as the JAX package's layer-stacked tree names it);
    `reduce` as `global_norm`'s (over a mesh)."""
    sq: dict[tuple, list] = {}
    for name, g in grads.items():
        kind = "blocks/" + name.split(".", 2)[2] if name.startswith("layers.") else name
        sq.setdefault(tuple(kind.split("/")), []).append(
            torch.linalg.vector_norm(g, dtype=torch.float32) ** 2)
    parts = {k: torch.stack(v).sum() for k, v in sq.items()}
    if reduce is not None:
        parts = reduce(parts)
    return {"grad_norm/" + "/".join(k): v.sqrt() for k, v in parts.items()}


class TrainStep:
    """`step(state, batch, generator) -> (state, metrics)`: corrupt, then
    `step.apply(state, corrupted)`, which takes an already corrupted batch
    (the tests hand it one the JAX package corrupted)."""

    def __init__(self, model_template: MMadaModel, optimizer, sc: StepConfig):
        if sc.forward_quantize not in ("none", "w8a8"):
            raise ValueError(f"forward_quantize must be 'none' or 'w8a8', "
                             f"got {sc.forward_quantize!r}")
        # no weights in the template: the state's leaves are the live ones
        self.model = dataclasses.replace(model_template, params=None)
        self.optimizer = optimizer
        self.sc = sc
        self.grads = None
        mesh = model_template.mesh
        if mesh is not None and world_size(mesh) > 1:
            if sc.forward_quantize == "w8a8" and axis_size(mesh, TENSOR_AXIS) > 1:
                raise NotImplementedError(
                    "forward_quantize=w8a8 with a tensor axis above 1: per-token "
                    "activation scales over row shards (ROADMAP A.12c)")
            names = [n for n, _ in llada.named_leaves(model_template.params)]
            self.grads = MeshGrads(model_template.cfg, mesh, names)
            inner = getattr(optimizer, "inner", optimizer)   # MultiSteps' inner update
            inner.norm_reduce = self.grads.norm_reduce       # the clip's norm, whole

    def loss(self, params, prepared: dict):
        sc = self.sc
        if sc.forward_quantize == "w8a8":
            # the block matmuls run W8A8 forward (straight-through gradients
            # to the trainable leaves, which the tags wrap without a copy);
            # the vocab head stays as it is
            params = tag_w8a8_ste(params)
        model = dataclasses.replace(self.model, params=params)
        _, loss_t2i, loss_lm, loss_mmu = L.forward_process(
            model, prepared["input_ids"], prepared["labels"],
            batch_size_t2i=sc.batch_size_t2i, batch_size_lm=sc.batch_size_lm,
            batch_size_mmu=sc.batch_size_mmu, max_seq_length=sc.max_seq_length,
            p_mask_lm=prepared.get("p_mask_lm"), p_mask_mmu=prepared.get("p_mask_mmu"),
            answer_lengths=prepared.get("answer_lengths"),
            t2i_masks=prepared.get("t2i_masks"),
            answer_lengths_lm=prepared.get("answer_lengths_lm"),
            lm_loss_mode=sc.lm_loss_mode, loss_chunk=sc.loss_chunk,
            rows=None if self.grads is None else self.grads.local_rows(
                (sc.batch_size_t2i, sc.batch_size_lm, sc.batch_size_mmu)),
        )
        loss = sc.t2i_coeff * loss_t2i + sc.lm_coeff * loss_lm + sc.mmu_coeff * loss_mmu
        mask_prob = prepared.get("mask_prob")
        if mask_prob is None:
            mask_prob = torch.zeros((max(sc.batch_size_t2i, 1),), device=loss.device)
        aux = {"loss_t2i": loss_t2i.detach(), "loss_lm": loss_lm.detach(),
               "loss_mmu": loss_mmu.detach(), "mask_prob": mask_prob.float().mean()}
        return loss, aux

    def apply(self, state: TrainState, prepared: dict):
        """One update from an already corrupted batch (over a mesh: the
        global batch, every rank the same)."""
        names, leaves = zip(*llada.named_leaves(state.params))
        loss, aux = self.loss(state.params, prepared)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        grads = {n: torch.zeros_like(t) if g is None else g
                 for n, t, g in zip(names, leaves, grads)}
        norm_reduce = None
        if self.grads is not None:
            self.grads.reduce(grads)
            keys = ("loss_t2i", "loss_lm", "loss_mmu")
            loss, *shares = self.grads.sum_rows([loss.detach()] + [aux[k] for k in keys])
            aux.update(zip(keys, shares))
            norm_reduce = self.grads.norm_reduce
        grad_norm = global_norm(grads, norm_reduce)
        gate = None
        metrics = dict(aux)
        if self.sc.skip_nonfinite_updates:
            gate = torch.isfinite(loss) & torch.isfinite(grad_norm)
            metrics["skipped_nonfinite"] = (~gate).float()
        self.optimizer.apply(dict(zip(names, leaves)), grads, state.opt_state, gate)
        state.step.add_(1 if gate is None else gate.to(state.step.dtype))
        metrics.update(loss=loss.detach(), grad_norm=grad_norm)
        if self.sc.log_param_grad_norms:
            metrics.update(per_kind_grad_norms(grads, norm_reduce))
        return state, metrics

    def __call__(self, state: TrainState, batch: dict,
                 generator: Optional[torch.Generator] = None):
        """Corrupt, then `apply`. Over a mesh `batch` holds this rank's clean
        rows; they are gathered into the global batch first."""
        if self.grads is not None:
            batch = self.grads.gather_rows(batch, self.model.vocab.eos_token_id)
        return self.apply(state, corrupt_batch(self.model, self.sc, batch, generator))


def make_train_step(model_template: MMadaModel, optimizer, sc: StepConfig) -> TrainStep:
    return TrainStep(model_template, optimizer, sc)


def with_grad_accumulation(optimizer, every_k: int):
    if every_k <= 1:
        return optimizer
    return MultiSteps(optimizer, every_k)
