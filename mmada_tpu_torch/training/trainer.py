"""Multi-task trainer: the stage-1..4 training loop.

Counterpart of `mmada_tpu/training/trainer.py` without Orbax. Built from a
`core.config.Config` (`Trainer.from_config`, the keys JAX's constructor
reads, `mmada_tpu/training/trainer.py:56-184`) or from keyword settings, the
reference config's blocks as plain dicts (`training`, `optimizer`,
`lr_scheduler`, `experiment`), which `entry.train` and `chip_smoke.py` use.
The host assembles clean frames (prompting); the train step corrupts them
on the device, forwards once over the `[t2i | lm | mmu]` concat, computes
the three losses and updates.

The flows carry images as pixels (`images`, `(B, H, W, 3)` in [-1, 1], with
optional `cache_keys`), which the frozen MAGVIT-v2 encoder (`vq_params`,
`vq_cfg`) turns into codes, as the JAX Trainer does; or as VQ codes already
(`image_codes`, raw ids in [0, codebook)).

`fit` adds what JAX's loop has around the step: the SIGTERM flag (installed
on the main thread only; the next iteration saves with `wait=True` and
stops; the previous handler is put back when `fit` returns), the weight EMA
after each step (`training.ema.*`), the checkpoint cadence
(`experiment.save_every`, async when `training.async_checkpointing`),
`resume()`, the validation hooks on `experiment.generate_every` (logged with
their traceback, never fatal), the meters' samples/s, data time and batch
time in each logged line, and `experiment.profile_at_step` as a three-step
`torch.profiler` trace (`utils/profiling.trace`). The loop's only host sync
is the logging read; the meters' data time stops before the step and the batch time after the read,
and save and hook time are left out of both (`saves` keeps each save's).
`gradient_checkpointing: auto` is resolved at the first step
(`training/remat_auto.py`; the decision in `remat_resolved`).

Over a mesh (`mesh=`, or `from_config` under a process group of more than
one rank: `parallel.{data,fsdp,tensor}`, `core/mesh.mesh_from_config`) the
model's weights are sharded (`parallel/sharding.py`, JAX's
`trainer.py:112-127`) and the loader's batches are this rank's rows of the
global batch the config names (`train_torch.build_dataloader`); the train
step is the global one (`train_step.py`), the optimizer and the EMA run on
the shards, `auto` remat takes one decision for every rank (full if any
rank's measure says so), the checkpoints keep the single-process layout
(gathered leaf by leaf, rank 0 writes, the others wait; a run resumes at
any world size), the hooks run on every rank and rank 0 writes their files,
the metrics file and the profile.

The optimizer is built from the `optimizer` block alone, as the JAX Trainer
builds it (`mmada_tpu/training/optimizers.py:89-111`): its clip is
`optimizer.params.max_grad_norm`. A `max_grad_norm` under `training:` (where
the stage configs put it, configs/mmada_pretraining_stage1.yaml:63) is read
by neither package.
"""

from __future__ import annotations

import dataclasses
import json
import logging
import os
import shutil
import signal
import tempfile
import threading
import time
from typing import Callable, Iterable, Mapping, Optional

import numpy as np
import torch
import torch.distributed as dist

from mmada_tpu_torch.checkpoints.manager import CheckpointManager
from mmada_tpu_torch.core.mesh import (
    BATCH_AXES,
    axis_index,
    axis_size,
    is_main_process,
    mesh_from_config,
    world_size,
)
from mmada_tpu_torch.models import llada, magvit2
from mmada_tpu_torch.models.mmada import MMadaModel
from mmada_tpu_torch.parallel import sharding
from mmada_tpu_torch.parallel.grads import pad_value
from mmada_tpu_torch.sampling.schedules import get_mask_schedule
from mmada_tpu_torch.training import ema as ema_mod
from mmada_tpu_torch.training import losses as L
from mmada_tpu_torch.training import optimizers
from mmada_tpu_torch.training.lr_schedules import from_config as lr_from_config
from mmada_tpu_torch.training.train_step import (
    StepConfig,
    TrainState,
    make_train_step,
    with_grad_accumulation,
)
from mmada_tpu_torch.utils import profiling
from mmada_tpu_torch.utils.logging import MetricsLogger
from mmada_tpu_torch.utils.meters import AverageMeter

logger = logging.getLogger(__name__)


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
        experiment: Optional[Mapping] = None,
        validation: Optional[Mapping] = None,
        write_image: Optional[Callable] = None,
        read_image: Optional[Callable] = None,
        mesh=None,
    ):
        """`experiment`: `output_dir` (None, the default: no checkpoints,
        metrics file or hooks), `checkpoints_total_limit`, `save_every`,
        `generate_every`, `profile_at_step`, `profile_dir`. `validation`:
        the hooks' inputs, `prompts_file`, `mmu_dir`, `chat_file`,
        `num_vq_tokens`, `resolution` (`from_config` reads them where JAX's
        hooks do). `write_image(path, (H, W, 3) uint8)` and
        `read_image(path, resolution) -> pixels` are the hooks' image IO."""
        tr = dict(training or {})
        if model.pipeline_axis is not None:
            raise ValueError("a model in pipeline stages serves only: train over "
                             "parallel.{data,fsdp,tensor} (parallel.serving auto)")
        if mesh is not None and model.mesh is None:
            specs = sharding.model_specs(model.cfg, mesh, model.params)
            model = dataclasses.replace(
                model, params=sharding.shard_params(model.params, specs, mesh), mesh=mesh)
        self.model = model
        self.mesh = model.mesh
        self.main = is_main_process()
        self.prompting = prompting
        self.vq_params = vq_params
        self.vq_cfg = vq_cfg
        self._vq_cache: dict = {}
        self.lm_max_seq_length = lm_max_seq_length
        self.log_every = log_every
        self.training = tr
        self.validation = dict(validation or {})
        self.write_image, self.read_image = write_image, read_image
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
        self.state = TrainState.create(model.params, self.optimizer)
        self.remat_resolved = None
        if model.remat == "auto":
            # resolved at the first step, on the real batch (remat_auto)
            self.train_step = self._resolve_auto_remat
        else:
            self.train_step = make_train_step(model, self.optimizer, self.step_cfg)

        # optional weight EMA (the reference ships one but never wires it,
        # models/training_utils.py:61-297): training.ema.*
        ema_cfg = dict(tr.get("ema") or {})
        self.ema_cfg = ema_cfg
        self.ema_state = (ema_mod.EMAState.create(self.state.params)
                          if ema_cfg.get("enabled") else None)

        ex = dict(experiment or {})
        self.output_dir = ex.get("output_dir")
        self.save_every = ex.get("save_every", 1000) if self.output_dir else 0
        self.generate_every = ex.get("generate_every", 0) if self.output_dir else 0
        self.async_checkpointing = bool(tr.get("async_checkpointing", False))
        self.profile_at = ex.get("profile_at_step")
        self.profile_dir = ex.get("profile_dir") or (
            os.path.join(self.output_dir, "profile") if self.output_dir else "profile")
        self.ckpt = self.metrics = None
        self.layout = None
        if self.mesh is not None and world_size(self.mesh) > 1:
            self.layout = sharding.StateLayout(model.cfg, self.mesh,
                                      [n for n, _ in llada.named_leaves(model.params)])
        if self.output_dir:
            self.ckpt = CheckpointManager(self.output_dir, ex.get("checkpoints_total_limit"))
            if self.main:
                self.metrics = MetricsLogger(os.path.join(self.output_dir, "metrics.jsonl"))
        self.global_step = 0
        self.history: list[dict[str, float]] = []
        self.saves: list[dict] = []          # CheckpointManager.last_save of each save
        self.hook_failures: list[str] = []   # names of the hooks that raised
        self._preempted = False

    @classmethod
    def from_config(cls, cfg, model: MMadaModel, prompting, vq_params=None, vq_cfg=None,
                    write_image: Optional[Callable] = None,
                    read_image: Optional[Callable] = None) -> "Trainer":
        """The JAX Trainer's constructor (`Trainer(cfg, model, prompting,
        vq_params, vq_cfg)`): the keys it reads, with its defaults; under a
        process group of more than one rank, the mesh of `parallel.*`."""
        mesh = model.mesh
        if mesh is None and dist.is_initialized() and dist.get_world_size() > 1:
            mesh = mesh_from_config(cfg, model.device)
        g = cfg.get_path
        experiment = {
            "output_dir": g("experiment.output_dir", "output"),
            "checkpoints_total_limit": g("experiment.checkpoints_total_limit"),
            "save_every": g("experiment.save_every", 1000),
            "generate_every": g("experiment.generate_every", 0),
            "profile_at_step": g("experiment.profile_at_step"),
            "profile_dir": g("experiment.profile_dir"),
        }
        validation = {
            "prompts_file": g("dataset.params.validation_prompts_file"),
            "mmu_dir": g("dataset.params.mmu_validation_dir", "mmu_validation"),
            "chat_file": g("dataset.params.lm_chat_validation_file",
                           os.path.join("lm_chat_validation", "questions.jsonl")),
            "num_vq_tokens": g("model.mmada.num_vq_tokens", 1024),
            "resolution": g("dataset.preprocessing.resolution", 256),
        }
        return cls(model, prompting, training=g("training", {}), optimizer=g("optimizer", {}),
                   lr_scheduler=g("lr_scheduler", {}),
                   mask_schedule=g("mask_schedule.schedule", "cosine"),
                   lm_max_seq_length=g("dataset.preprocessing.max_seq_length", 512),
                   log_every=g("experiment.log_every", 50), vq_params=vq_params, vq_cfg=vq_cfg,
                   experiment=experiment, validation=validation, write_image=write_image,
                   read_image=read_image, mesh=mesh)

    def _resolve_auto_remat(self, state, batch, generator=None):
        """First-step trampoline for `gradient_checkpointing: auto`: pick
        dots or full by memory fit at this batch's shapes, swap the chosen
        step into `self.train_step`, and run the step."""
        from mmada_tpu_torch.training.remat_auto import pick_remat

        frames = [t for k, t in batch.items() if k.endswith("input_ids")]
        rows, length = sum(t.shape[0] for t in frames), frames[0].shape[1]
        mode, info = pick_remat(self.model, state, rows, length)
        if self.layout is not None:   # one decision for every rank
            full = torch.tensor(float(mode == "full"), device=self.device)
            dist.all_reduce(full, op=dist.ReduceOp.MAX)
            mode = "full" if float(full) else "dots"
        self.remat_resolved = (mode, info)
        self.train_step = make_train_step(dataclasses.replace(self.model, remat=mode),
                                          self.optimizer, self.step_cfg)
        return self.train_step(state, batch, generator)

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

    # ------------------------------------------------------- checkpoints
    def _payload(self) -> dict:
        """The checkpointed tree: the train state and, when enabled, the
        EMA shadow and its step (which would otherwise reset on resume)."""
        out = {"train": {"params": self.state.params, "opt_state": self.state.opt_state,
                         "step": self.state.step}}
        if self.ema_state is not None:
            out["ema"] = {"shadow": self.ema_state.shadow, "step": self.ema_state.step}
        return out

    def save_checkpoint(self, wait: Optional[bool] = None) -> str:
        """checkpoint-{global_step}: async when `training.async_checkpointing`
        unless `wait`; preemption saves wait; over a mesh every rank takes
        part and the save waits."""
        if wait is None:
            wait = not self.async_checkpointing
        path = self.ckpt.save(self.global_step, self._payload(), wait=wait, layout=self.layout)
        self.saves.append(self.ckpt.last_save)
        return path

    def resume(self) -> int:
        """Restore the latest checkpoint into the train state (and the EMA),
        in place, and `global_step`; returns the step (0: nothing to resume)."""
        restored, step = self.ckpt.restore(self._payload(), layout=self.layout)
        if restored is not None:
            self.global_step = step
            logger.info("resumed from step %d", step)
        return self.global_step

    # -------------------------------------------------------------- loop
    def _install_preemption_handler(self):
        """SIGTERM (maintenance events, spot preemption) sets a flag: the
        next iteration saves and stops. Returns the handler it replaced,
        or None off the main thread, where signals cannot be caught."""
        if threading.current_thread() is not threading.main_thread():
            return None

        def handler(signum, frame):
            self._preempted = True

        previous = signal.signal(signal.SIGTERM, handler)
        return signal.SIG_DFL if previous is None else previous

    def fit(self, loader: Iterable[Mapping], rng_seed: int = 0) -> TrainState:
        """Train on `loader`'s raw batches until `max_train_steps` (or a
        SIGTERM). Every `log_every` steps the metrics are read back (the
        loop's only host sync) into `history` (and `metrics.jsonl`), with
        the steps' wall seconds (data included, saves and hooks not) and
        tokens/s since the last log, the meters' samples/s, data and batch
        time, and, on the card, the peak device memory so far. Each step
        draws its caption dropout (the prompting's `rng`) and corrupts its
        batch from generators seeded by `rng_seed` and the step
        (`step_seed`), so a resumed run draws what the uninterrupted one
        drew; over a mesh each rank takes its rows' share of the global
        batch's draws."""
        generator = torch.Generator(self.device)
        batch_meter, data_meter = AverageMeter(), AverageMeter()
        previous = self._install_preemption_handler()
        profiler = None
        window_s, tokens = 0.0, 0   # steps' wall time and tokens since the last log
        try:
            end = time.perf_counter()
            for raw in loader:
                if self.global_step >= self.max_train_steps:
                    break
                if self.layout is not None:   # every rank stops at the same step
                    flag = torch.tensor(float(self._preempted), device=self.device)
                    dist.all_reduce(flag, op=dist.ReduceOp.MAX)
                    self._preempted = bool(float(flag))
                if self._preempted:
                    logger.warning("preemption: saving checkpoint-%d and stopping",
                                   self.global_step)
                    if self.ckpt is not None:
                        self.save_checkpoint(wait=True)
                    break
                if (self.profile_at is not None and self.global_step == self.profile_at
                        and self.main):
                    profiler = self._start_profile()
                if profiler is not None and self.global_step == self.profile_at + 3:
                    profiler = self._stop_profile(profiler)
                seed = step_seed(rng_seed, self.global_step)
                self.prompting.rng = self._row_draws(np.random.default_rng(seed))
                batch = self.prepare_batch(raw)
                data_meter.update(time.perf_counter() - end)
                tokens += sum(v.numel() for k, v in batch.items() if k.endswith("input_ids"))
                generator.manual_seed(seed)
                self.state, metrics = self.train_step(self.state, batch, generator)
                if self.ema_state is not None:
                    ema_mod.ema_update(self.ema_state, self.state.params, **{
                        k: self.ema_cfg[k] for k in ("max_decay", "inv_gamma", "power")
                        if k in self.ema_cfg})
                self.global_step += 1
                logging_step = self.global_step % self.log_every == 0
                if logging_step:
                    vals = {k: float(v) for k, v in metrics.items()}   # the host sync
                batch_meter.update(time.perf_counter() - end)
                window_s += batch_meter.val
                if logging_step:
                    self._log(vals, batch_meter, data_meter, window_s, tokens)
                    window_s, tokens = 0.0, 0
                if self.save_every and self.global_step % self.save_every == 0:
                    self.save_checkpoint()
                if self.generate_every and self.global_step % self.generate_every == 0:
                    self.run_validation_hooks(raw)
                end = time.perf_counter()
        finally:
            if previous is not None:
                signal.signal(signal.SIGTERM, previous)
            if profiler is not None:   # the loop ended inside the window
                self._stop_profile(profiler)
        if self.ckpt is not None:
            self.ckpt.finalize()  # land any in-flight async save before returning
        return self.state

    def _row_draws(self, rng):
        """`rng`, or over a mesh its draws for the global batch cut to this
        rank's rows."""
        if self.layout is None:
            return rng
        return RowDraws(rng, axis_index(self.mesh, BATCH_AXES), axis_size(self.mesh, BATCH_AXES))

    def _log(self, vals: dict, batch_meter, data_meter, seconds: float, tokens: int) -> None:
        sc = self.step_cfg
        total_batch = sc.batch_size_t2i + sc.batch_size_lm + sc.batch_size_mmu
        vals.update(step=self.global_step, seconds=seconds, tokens_per_s=tokens / seconds,
                    samples_per_sec=total_batch / max(batch_meter.avg, 1e-9),
                    data_time=data_meter.avg, batch_time=batch_meter.avg)
        if self.device.type == "cuda":
            vals["max_memory_allocated_gib"] = torch.cuda.max_memory_allocated(self.device) / 2**30
        self.history.append(vals)
        if self.metrics is not None:
            self.metrics.log(vals)
        logger.info("step %d loss %.4f (t2i %.4f lm %.4f mmu %.4f) %.1f samp/s, data %.3fs "
                    "batch %.3fs", self.global_step, vals["loss"], vals["loss_t2i"],
                    vals["loss_lm"], vals["loss_mmu"], vals["samples_per_sec"],
                    vals["data_time"], vals["batch_time"])

    def _start_profile(self):
        window = profiling.trace(self.profile_dir, f"trace_step{self.profile_at}.json",
                                 cuda=self.device.type == "cuda")
        window.__enter__()
        return window

    def _stop_profile(self, window) -> None:
        window.__exit__(None, None, None)
        logger.info("profile trace written to %s", os.path.join(
            self.profile_dir, f"trace_step{self.profile_at}.json"))
        return None

    # -------------------------------------------------------- validation
    def _hook(self, name: str, fn, *args, **kwargs) -> None:
        """Run one hook; a failure is logged with its traceback, never fatal."""
        try:
            fn(*args, **kwargs)
        except Exception:  # a hook must never stop training
            logger.exception("%s validation hook failed", name)
            self.hook_failures.append(name)

    def run_validation_hooks(self, raw: Optional[Mapping] = None) -> None:
        """The cadence generations (train_mmada.py:698-730, 750-795): t2i
        from the validation prompts file, the understanding of the
        `mmu_validation` images, chat answers, and the triptychs of the
        current batch's t2i images."""
        model = dataclasses.replace(self.model, params=self.state.params)
        if not self.main:   # every rank samples (the mesh's collectives); rank 0 writes
            output_dir, self.output_dir = self.output_dir, tempfile.mkdtemp()
            try:
                self._run_hooks(model, raw)
            finally:
                shutil.rmtree(self.output_dir, ignore_errors=True)
                self.output_dir = output_dir
            return
        self._run_hooks(model, raw)

    def _run_hooks(self, model, raw) -> None:
        v = self.validation
        prompts_file = v.get("prompts_file")
        if prompts_file and os.path.exists(prompts_file) and self.vq_params:
            with open(prompts_file) as f:
                prompts = [ln.strip() for ln in f if ln.strip()][:4]
            self._hook("generate_images", self._generate_images, model, prompts)
        prompts_path = os.path.join(v.get("mmu_dir") or "mmu_validation", "prompts.jsonl")
        if os.path.exists(prompts_path) and self.vq_params:
            self._hook("understanding_images", self._understanding_images, model, prompts_path)
        chat_path = v.get("chat_file")
        if chat_path and os.path.exists(chat_path):
            self._hook("generate_chat_text", self._generate_chat_text, model, chat_path)
        images = (raw or {}).get("t2i_flow", {}).get("images")
        if images is not None and self.vq_params:
            self._hook("visualize_predictions", self._visualize_predictions, model, images)

    def _image_writer(self):
        if self.write_image is None:
            raise ValueError("the image hooks need write_image(path, uint8 array)")
        return self.write_image

    def _generate_images(self, model, prompts) -> None:
        from mmada_tpu_torch.training import validation as V

        tr = self.training
        V.generate_images(model, self.vq_params, self.vq_cfg, self.prompting, prompts,
                          self.output_dir, self.global_step, self._image_writer(),
                          num_vq_tokens=self.validation.get("num_vq_tokens", 1024),
                          timesteps=tr.get("generation_timesteps", 12),
                          guidance_scale=tr.get("guidance_scale", 1.5))

    def _understanding_images(self, model, prompts_path) -> None:
        """Caption the task-typed validation images with their per-image
        questions (train_mmada.py:872-932 + the mmu_validation fixtures)."""
        from mmada_tpu_torch.training import validation as V

        if self.read_image is None:
            raise ValueError("the understanding hook needs read_image(path, resolution)")
        res = self.validation.get("resolution", 256)
        mmu_dir = os.path.dirname(prompts_path)
        with open(prompts_path) as f:
            entries = [json.loads(ln) for ln in f if ln.strip()]
        images, questions = [], []
        for e in entries[:8]:
            path = os.path.join(mmu_dir, e.get("file_name", ""))
            if not os.path.exists(path):
                continue
            images.append(self.read_image(path, res))
            questions.append(e["prompt"])
        if not images:
            return
        tr = self.training
        V.understanding_images(model, self.vq_params, self.vq_cfg, self.prompting,
                               self.prompting.text_tokenizer, np.stack(images), questions,
                               self.output_dir, self.global_step,
                               max_new_tokens=tr.get("validation_max_new_tokens", 32),
                               steps=tr.get("validation_steps", 16))

    def _generate_chat_text(self, model, chat_path) -> None:
        from mmada_tpu_torch.training import validation as V

        questions = []
        with open(chat_path) as f:
            for ln in f:
                if ln.strip():
                    rec = json.loads(ln)
                    questions.append(rec.get("question") or rec.get("prompt") or "")
        if not questions:
            return
        tr = self.training
        n = tr.get("validation_max_new_tokens", 32)
        V.generate_chat_text(model, self.prompting.text_tokenizer, questions[:4],
                             self.output_dir, self.global_step, gen_length=n,
                             steps=tr.get("validation_steps", 16), block_length=n)

    def _visualize_predictions(self, model, images) -> None:
        from mmada_tpu_torch.training import validation as V

        imgs = np.asarray(images)[:2]
        V.visualize_predictions(model, self.vq_params, self.vq_cfg, self.prompting, imgs,
                                [""] * imgs.shape[0], self.output_dir, self.global_step,
                                self._image_writer())


class RowDraws:
    """A numpy generator's `random(n)` for rank `index` of `ranks`: the
    draws of the whole batch's n x ranks rows, cut to this rank's n."""

    def __init__(self, rng, index: int, ranks: int):
        self.rng, self.index, self.ranks = rng, index, ranks

    def random(self, n):
        return self.rng.random(n * self.ranks)[self.index * n:(self.index + 1) * n]


def step_seed(seed: int, step: int) -> int:
    """The corruption generator's seed of train step `step` (0-based)."""
    return seed * 1_000_003 + step


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
        out[k] = np.pad(arr, ((0, 0), (0, max_len - arr.shape[1])),
                        constant_values=pad_value(k, eos_id))
    return out
