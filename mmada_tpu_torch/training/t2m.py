"""Text-to-motion training: token mapping, corruption, loss, train step.

Counterpart of `mmada_tpu/training/t2m.py` (:31-229; the reference t2m
trainer core, training/train_t2m.py:538-660, and `forward_t2m`'s masked-CE
loss, models/modelling_ours.py:509-555). LoRA fine-tuning
(train_t2m_lora.py) goes through `models/lora.py`.

Dataset motion codes use EOM = nb_code and PAD = nb_code + 1
(dataset_TM_train.py:131-137); the fused vocab appends those two rows after
the motion codebook (`VocabLayout.motion_special`), so the whole mapping is
one addition of `motion_offset`, and the training head's window is the
codebook plus its 2 specials (514 rows for the flagship; the sampler reads
the 512 codes only).

One step is: corrupt the motion span `[max_text_len + 1, L - 1)` with the
schedule's masking law (`masking.mask_image_tokens`) on the batch's device
-> the backbone's hidden states (with autograd, the model's remat) -> the
vocab head over the motion window -> mean CE over the masked motion
positions -> grad -> clip + AdamW (or any optimizer of
`training/optimizers.py`), in place, a non-finite step skipped on the
device. The LoRA step differentiates only the trainable tree (`lora.
trainable_params`: the adapters, and the embedding and head when
configured); the base weights are frozen and the effective ones are merged
each step (`lora.apply_trainable`).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import numpy as np
import torch

from mmada_tpu_torch.checkpoints.manager import flatten
from mmada_tpu_torch.core.vocab import VocabLayout
from mmada_tpu_torch.models import llada
from mmada_tpu_torch.models import lora as lora_mod
from mmada_tpu_torch.models.mmada import MMadaModel
from mmada_tpu_torch.sampling.schedules import cosine_schedule
from mmada_tpu_torch.training import masking
from mmada_tpu_torch.training.losses import IGNORE_ID, masked_cross_entropy
from mmada_tpu_torch.training.optimizers import global_norm
from mmada_tpu_torch.training.train_step import TrainState


def map_motion_tokens(m_tokens, vocab: VocabLayout):
    """Dataset code space [0, nb_code + 1] -> fused ids (train_t2m.py:546-588):
    codes, EOM and PAD all shift by `motion_offset`."""
    return m_tokens + vocab.motion_offset


def t2m_loss(logits: torch.Tensor, labels: torch.Tensor,
             masked_indices: torch.Tensor) -> torch.Tensor:
    """Mean CE over the masked motion positions (`forward_t2m`,
    modelling_ours.py:541-548); labels window-relative or IGNORE_ID."""
    ce, valid = masked_cross_entropy(logits, labels)
    active = masked_indices & valid
    return torch.where(active, ce, torch.zeros_like(ce)).sum() / active.sum().clamp(min=1)


@dataclasses.dataclass(frozen=True)
class T2MStepConfig:
    batch_size: int
    max_text_len: int            # the frame's text length (prompting's max_text_len + 1)
    num_motion_tokens: int
    min_masking_rate: float = 0.0
    mask_schedule: Callable = cosine_schedule
    skip_nonfinite_updates: bool = True  # on-device NaN-batch skip


def training_window(vocab: VocabLayout) -> tuple[int, int]:
    """The head's window: the motion codebook and its EOM / PAD rows."""
    lo = vocab.motion_offset
    return lo, lo + vocab.motion_codebook_size + vocab.motion_special


def lora_state(params, lora, lcfg: lora_mod.LoRAConfig, optimizer) -> TrainState:
    """The LoRA step's state: the trainable tree (the adapters, and the base's
    embedding and head as leaves over their storage, no copy) and a fresh
    optimizer state over its names (`lora/blocks/q_proj/a`, `wte`, `head`)."""
    tree = lora_mod.trainable_params(params, lora, lcfg)
    tree = _leaves_requiring_grad(tree)
    device = params["wte"].device
    return TrainState(params=tree, opt_state=optimizer.init(flatten(tree)),
                      step=torch.zeros((), dtype=torch.int64, device=device))


def _leaves_requiring_grad(tree):
    if isinstance(tree, torch.Tensor):
        return tree.detach().requires_grad_()
    return {k: _leaves_requiring_grad(v) for k, v in tree.items()}


class T2MTrainStep:
    """`step(state, batch, generator) -> (state, metrics)`: corrupt, then
    `step.apply(state, prepared)`, which takes an already corrupted batch
    (`{"input_ids", "labels", "attention_mask", "mask_prob"}`; the tests hand
    it one the JAX package corrupted). With `lora_cfg` the state's params are
    the trainable tree and the template's params stay frozen."""

    def __init__(self, model_template: MMadaModel, optimizer, sc: T2MStepConfig,
                 lora_cfg: Optional[lora_mod.LoRAConfig] = None):
        self.vocab = model_template.vocab
        self.window = training_window(self.vocab)
        self.base_params = model_template.params if lora_cfg is not None else None
        self.model = dataclasses.replace(model_template, params=None)
        self.optimizer = optimizer
        self.sc = sc
        self.lora_cfg = lora_cfg

    def corrupt(self, batch: dict, generator: Optional[torch.Generator]) -> dict:
        ids = batch["input_ids"]
        span = slice(self.sc.max_text_len + 1, ids.shape[1] - 1)
        noisy_span, _, mask_prob = masking.mask_image_tokens(
            generator, ids[:, span], self.vocab.mask_token_id,
            mask_schedule=self.sc.mask_schedule, min_masking_rate=self.sc.min_masking_rate)
        noisy = ids.clone()
        noisy[:, span] = noisy_span
        return {"input_ids": noisy, "labels": batch["labels"],
                "attention_mask": batch.get("attention_mask"), "mask_prob": mask_prob}

    def loss(self, params, prepared: dict):
        if self.lora_cfg is not None:
            params = lora_mod.apply_trainable(self.base_params, params, self.lora_cfg)
        model = dataclasses.replace(self.model, params=params)
        noisy = prepared["input_ids"]
        masked = noisy == self.vocab.mask_token_id
        hidden = model.forward_hidden(noisy, attention_mask=prepared.get("attention_mask"))
        logits = model.apply_head(hidden, logit_window=self.window).float()
        labels = prepared["labels"]
        rel = torch.where(labels == IGNORE_ID, labels, labels - self.vocab.motion_offset)
        loss = t2m_loss(logits, rel, masked)
        return loss, {"loss_t2m": loss.detach(),
                      "mask_prob": prepared["mask_prob"].float().mean()}

    def _named(self, params) -> list[tuple[str, torch.Tensor]]:
        if self.lora_cfg is not None:
            return list(flatten(params).items())
        return llada.named_leaves(params)

    def apply(self, state: TrainState, prepared: dict):
        names, leaves = zip(*self._named(state.params))
        loss, aux = self.loss(state.params, prepared)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        grads = {n: torch.zeros_like(t) if g is None else g
                 for n, t, g in zip(names, leaves, grads)}
        grad_norm = global_norm(grads)
        gate = None
        metrics = dict(aux)
        if self.sc.skip_nonfinite_updates:
            gate = torch.isfinite(loss) & torch.isfinite(grad_norm)
            metrics["skipped_nonfinite"] = (~gate).float()
        self.optimizer.apply(dict(zip(names, leaves)), grads, state.opt_state, gate)
        state.step.add_(1 if gate is None else gate.to(state.step.dtype))
        metrics.update(loss=loss.detach(), grad_norm=grad_norm)
        return state, metrics

    def __call__(self, state: TrainState, batch: dict,
                 generator: Optional[torch.Generator] = None):
        return self.apply(state, self.corrupt(batch, generator))


def make_t2m_train_step(model_template: MMadaModel, optimizer,
                        sc: T2MStepConfig) -> T2MTrainStep:
    """Full fine-tuning: the state is `TrainState.create(model.params, opt)`."""
    return T2MTrainStep(model_template, optimizer, sc)


def make_t2m_lora_train_step(model_template: MMadaModel, optimizer, sc: T2MStepConfig,
                             lora_cfg: lora_mod.LoRAConfig) -> T2MTrainStep:
    """LoRA fine-tuning: the state is `lora_state(...)`; the template's
    params are the frozen base (JAX passes them to each call, to keep them
    out of its compiled program's closure)."""
    return T2MTrainStep(model_template, optimizer, sc, lora_cfg=lora_cfg)


def token_range_sanity(generated_vq, vocab: VocabLayout) -> dict:
    """In-loop generation checks: range validity, diversity, mode collapse
    (reference train_t2m.py:677-760)."""
    arr = (generated_vq.detach().cpu().numpy() if isinstance(generated_vq, torch.Tensor)
           else np.asarray(generated_vq))
    unique = np.unique(arr)
    counts = np.bincount(arr.reshape(-1), minlength=vocab.motion_codebook_size)
    top_frac = counts.max() / max(arr.size, 1)
    return {
        "in_range": bool((arr >= 0).all() and (arr < vocab.motion_codebook_size).all()),
        "unique_tokens": int(unique.size),
        "mode_collapse_top_token_frac": float(top_frac),
    }

