"""Multi-task trainer: the stage-1..4 training loop, with keyword settings.

Counterpart of `mmada_tpu/training/trainer.py` (:56-420, 546-564) without
yaml, Orbax or a device mesh: the settings are the reference config's blocks
as plain dicts (`training`, `optimizer`, `lr_scheduler`). The host assembles
clean frames (prompting); the train step corrupts them on the device,
forwards once over the `[t2i | lm | mmu]` concat, computes the three losses
and updates.

The flows carry images as pixels (`images`, `(B, H, W, 3)` in [-1, 1], with
optional `cache_keys`), which the frozen MAGVIT-v2 encoder (`vq_params`,
`vq_cfg`) turns into codes, as the JAX Trainer does; or as VQ codes already
(`image_codes`, raw ids in [0, codebook)). Not ported: weight EMA,
checkpoint save and resume, the validation hooks and the preemption
handler.

The optimizer is built from the `optimizer` block alone, as the JAX Trainer
builds it (`mmada_tpu/training/optimizers.py:89-98`): its clip is
`optimizer.params.max_grad_norm`. A `max_grad_norm` under `training:` (where
the stage configs put it, configs/mmada_pretraining_stage1.yaml:63) is read
by neither package.
"""

from __future__ import annotations

import time
from typing import Iterable, Mapping, Optional

import numpy as np
import torch

from mmada_tpu_torch.models import magvit2
from mmada_tpu_torch.models.mmada import MMadaModel
from mmada_tpu_torch.sampling.schedules import get_mask_schedule
from mmada_tpu_torch.training import losses as L
from mmada_tpu_torch.training import optimizers
from mmada_tpu_torch.training.lr_schedules import from_config as lr_from_config
from mmada_tpu_torch.training.train_step import (
    StepConfig,
    TrainState,
    make_train_step,
    with_grad_accumulation,
)


class Trainer:
    def __init__(
        self,
        model: MMadaModel,
        prompting,
        training: Optional[Mapping] = None,
        optimizer: Optional[Mapping] = None,
        lr_scheduler: Optional[Mapping] = None,
        mask_schedule: str = "cosine",
        lm_max_seq_length: int = 512,  # lm frame length when there is no t2i flow
        log_every: int = 50,
        vq_params=None,
        vq_cfg: Optional[magvit2.VQGANConfig] = None,
    ):
        tr = dict(training or {})
        self.model = model
        self.prompting = prompting
        self.vq_params = vq_params
        self.vq_cfg = vq_cfg
        self._vq_cache: dict = {}
        self.lm_max_seq_length = lm_max_seq_length
        self.log_every = log_every
        self.step_cfg = StepConfig(
            batch_size_t2i=tr.get("batch_size_t2i", 0),
            batch_size_lm=tr.get("batch_size_lm", 0),
            batch_size_mmu=tr.get("batch_size_mmu", 0),
            max_seq_length=prompting.max_text_len,
            t2i_coeff=tr.get("t2i_coeff", 1.0),
            lm_coeff=tr.get("lm_coeff", 0.1),
            mmu_coeff=tr.get("mmu_coeff", 1.0),
            min_masking_rate=tr.get("min_masking_rate", 0.0),
            noise_type=tr.get("noise_type", "mask"),
            mask_contiguous_region_prob=tr.get("mask_contiguous_region_prob", 0.0),
            mask_schedule=get_mask_schedule(mask_schedule),
            lm_loss_mode=tr.get("lm_loss_mode", "llada"),
            loss_chunk=tr.get("loss_chunk", 0),
            use_chat_lm=tr.get("use_chat_lm", False),
            lm_pad_loss=tr.get("lm_pad_loss", True),
            skip_nonfinite_updates=tr.get("skip_nonfinite_updates", True),
            log_param_grad_norms=tr.get("log_param_grad_norms", False),
            forward_quantize=tr.get("forward_quantize", "none"),
        )
        self.max_train_steps = tr.get("max_train_steps", 10000)
        lr = lr_from_config(lr_scheduler or {}, total_steps=self.max_train_steps)
        opt = optimizers.from_config(optimizer or {}, lr)
        self.optimizer = with_grad_accumulation(opt, tr.get("gradient_accumulation_steps", 1))
        self.train_step = make_train_step(model, self.optimizer, self.step_cfg)
        self.state = TrainState.create(model.params, self.optimizer)
        self.global_step = 0
        self.history: list[dict[str, float]] = []

    @property
    def device(self) -> torch.device:
        return self.state.params["wte"].device

    # -------------------------------------------------------------- data
    def encode_images(self, images, cache_keys=None) -> np.ndarray:
        """pixels (B, H, W, C), a host array -> fused image-token ids, by the
        MAGVIT-v2 encoder on its weights' device. `cache_keys` (one hashable
        per image) lets repeated images skip the encoder: it is frozen, so an
        image's codes never change."""
        if self.vq_params is None:
            raise ValueError("flows carry pixels ('images'): encoding them needs the "
                             "MAGVIT-v2 weights (vq_params, vq_cfg)")
        device = self.vq_params["encoder"]["conv_in"]["w"].device

        def codes(pixels):
            x = torch.as_tensor(np.ascontiguousarray(pixels), dtype=torch.float32).to(device)
            return magvit2.get_code(self.vq_params, self.vq_cfg, x).cpu().numpy()

        offset = self.model.vocab.image_offset
        if cache_keys is None:
            return codes(images) + offset
        missing = [i for i, k in enumerate(cache_keys) if k not in self._vq_cache]
        if missing:
            for i, c in zip(missing, codes(np.asarray(images)[missing])):
                self._vq_cache[cache_keys[i]] = c
        return np.stack([self._vq_cache[k] for k in cache_keys]) + offset

    def image_ids(self, flow: Mapping) -> np.ndarray:
        """A flow's images as fused image-token ids: its pixels encoded, or
        its VQ codes offset."""
        if "images" in flow:
            return self.encode_images(flow["images"], flow.get("cache_keys"))
        return np.asarray(flow["image_codes"], np.int64) + self.model.vocab.image_offset

    def prepare_batch(self, raw: Mapping) -> dict:
        """Host-side assembly of clean frames (images encoded; no corruption:
        that happens in the train step), padded to one length, as tensors on
        the device."""
        sc = self.step_cfg
        batch: dict[str, np.ndarray] = {}
        if sc.batch_size_t2i:
            flow = raw["t2i_flow"]
            image_ids = self.image_ids(flow)
            ids, masks, _ = self.prompting((flow["input_ids"], image_ids, image_ids), "t2i")
            batch["t2i_input_ids"] = ids
            batch["t2i_masks"] = masks
        if sc.batch_size_lm:
            flow = raw["lm_flow"]
            max_len = (batch["t2i_input_ids"].shape[1] if sc.batch_size_t2i
                       else self.lm_max_seq_length)
            if sc.use_chat_lm:
                ids, pmask, labels = self.prompting((flow["input_ids"], max_len), "lm_chat")
                batch["lm_prompt_masks"] = pmask
            else:
                ids, lm_mask, labels = self.prompting((flow["input_ids"], max_len), "lm")
                if not sc.lm_pad_loss:
                    # EOS padding past each row's text leaves the loss
                    labels = np.where(np.asarray(lm_mask, bool), labels, L.IGNORE_ID)
            batch["lm_input_ids"] = ids
            batch["lm_labels"] = labels
        if sc.batch_size_mmu:
            flow = raw["mmu_flow"]
            ids, pmask, labels = self.prompting((self.image_ids(flow), flow["input_ids"]), "mmu")
            batch["mmu_input_ids"] = ids
            batch["mmu_prompt_masks"] = pmask
            batch["mmu_labels"] = labels
        batch = _pad_flows_to_common_length(batch, self.model.vocab.eos_token_id)
        return {k: torch.as_tensor(np.asarray(v), dtype=torch.long).to(self.device)
                for k, v in batch.items()}

    # -------------------------------------------------------------- loop
    def fit(self, loader: Iterable[Mapping], rng_seed: int = 0) -> TrainState:
        """Train on `loader`'s raw batches until `max_train_steps`. Every
        `log_every` steps the metrics are read back (the loop's only host
        sync) into `history`, with the wall seconds and tokens/s since the
        last log and, on the card, the peak device memory so far."""
        generator = torch.Generator(self.device).manual_seed(rng_seed)
        end = time.perf_counter()
        tokens = 0
        for raw in loader:
            if self.global_step >= self.max_train_steps:
                break
            batch = self.prepare_batch(raw)
            tokens += sum(v.numel() for k, v in batch.items() if k.endswith("input_ids"))
            self.state, metrics = self.train_step(self.state, batch, generator)
            self.global_step += 1
            if self.global_step % self.log_every == 0:
                vals = {k: float(v) for k, v in metrics.items()}
                now = time.perf_counter()
                vals.update(step=self.global_step, seconds=now - end,
                            tokens_per_s=tokens / (now - end))
                if self.device.type == "cuda":
                    vals["max_memory_allocated_gib"] = (
                        torch.cuda.max_memory_allocated(self.device) / 2**30)
                end, tokens = now, 0
                self.history.append(vals)
        return self.state


def _pad_flows_to_common_length(batch: dict, eos_id: int) -> dict:
    """Pad every sequence array to the longest: labels with IGNORE_ID,
    prompt masks with 1, other masks with 0, ids with EOS."""
    seq_keys = [k for k in batch if k.endswith(("input_ids", "labels", "masks", "prompt_masks"))]
    if not seq_keys:
        return batch
    max_len = max(batch[k].shape[1] for k in seq_keys)
    out = dict(batch)
    for k in seq_keys:
        arr = np.asarray(batch[k])
        if arr.shape[1] == max_len:
            continue
        if k.endswith("labels"):
            fill = L.IGNORE_ID
        elif k.endswith(("masks", "prompt_masks")):
            fill = 1 if "prompt" in k else 0
        else:
            fill = eos_id
        out[k] = np.pad(arr, ((0, 0), (0, max_len - arr.shape[1])), constant_values=fill)
    return out
