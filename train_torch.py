"""Training on the card: `python train_torch.py config=configs/<stage>.yaml ...`

The PyTorch port's counterpart of `train.py` (`build_dataloader`, `main`):
the model, MAGVIT-v2, tokenizer and prompting from the config
(`serve.loader.load_all`), the Trainer from the config
(`Trainer.from_config`), a resume from the newest checkpoint when
`experiment.resume_from_checkpoint` is `latest`, the combined multi-flow
loader, then `fit`. The config is snapshotted into
`{experiment.output_dir}/config.yaml`.

    python train_torch.py config=configs/mmada_pretraining_stage1.yaml \\
        model.mmada.pretrained_model_path=/path/to/MMaDA-8B \\
        model.vq_model.vq_model_path=/path/to/magvitv2 \\
        training.gradient_accumulation_steps=1 training.loss_chunk=128

`training.task: t2m` runs text-to-motion training instead (`train_t2m`,
JAX's `train.py` `train_t2m`): the model with the motion vocab, t2m frames
from a token bank (`dataset.token_bank`, an .npz of captions, padded code
rows and lengths), synthetic codes (`dataset.synthetic`) or HumanML3D's
tokenized motions (`MotionTokenDataset`), full fine-tuning or LoRA when
`training.lora` is set, one metrics line every `experiment.log_every` steps:

    python train_torch.py config=configs/t2m_instruct.yaml \
        model.mmada.pretrained_model_path=/path/to/MMaDA-8B dataset.motion_root=...

One key more than `train.py`: `device` (the card unless `device=cpu`); and for
t2m `model.mmada.attention_bias_enabled` (the frames' masks reach attention)
and `experiment.resume_from_checkpoint=latest`. A `config=` file is read with
PyYAML; without it, give every key as a dotted override. PIL opens and
resizes the images (`open_image`, `image_transform`) and writes the
validation hooks' PNGs (`write_png`); the package itself imports neither.

Over several cards, one process a card under `torchrun` (NCCL; over gloo on
the CPU with `device=cpu`):

    torchrun --nproc-per-node 8 train_torch.py \
        config=configs/mmada_pretraining_stage1.yaml \
        config=configs/topologies/v5e8_fsdp.yaml ...

`distributed.initialize` (with `distributed.coordinator`, `.num_processes`,
`.process_id` where the launcher's environment does not say them) joins the
ranks (`core/mesh.initialize_distributed`); the weights shard over the mesh
of `parallel.{data,fsdp,tensor}` (the Trainer's mesh path); the config's
batch sizes are the global batch and each rank's loader yields its rows of
it (`build_dataloader`); rank 0 writes the config, the metrics, the
checkpoints (in the single-process layout: a run resumes at any world size)
and the hooks' files. Refused over more than one rank, naming the ROADMAP
item: t2m training (A.12c: JAX's `train_t2m` runs on one device) and
`parallel.serving: pipeline` (stages serve; they do not train).
"""

import itertools
import logging
import os
import sys


def _yaml(stream):
    import yaml

    return yaml.safe_load(stream)


def read_config(argv):
    from mmada_tpu_torch.core.config import load_config

    return load_config(cli_args=argv, reader=_yaml)


def save_config(cfg, output_dir: str) -> str:
    """`output_dir/config.yaml`, the run's resolved config (`Config.save` in
    JAX, train_mmada.py:151-155), written by rank 0."""
    import yaml

    from mmada_tpu_torch.core.mesh import is_main_process

    os.makedirs(output_dir, exist_ok=True)
    path = os.path.join(output_dir, "config.yaml")
    if not is_main_process():
        return path
    with open(path, "w") as f:
        f.write(yaml.safe_dump(cfg.to_dict(), sort_keys=False))
    return path


def open_image(source):
    """A loaded PIL image from a path or a binary file object."""
    from PIL import Image

    image = Image.open(source)
    image.load()
    return image


def image_transform(image, resolution: int = 256):
    """Short-side bicubic resize, centre crop, [-1, 1] float32 (H, W, 3)."""
    from inference_mmu_torch import image_transform as transform

    return transform(image, resolution)


def read_image(path: str, resolution: int):
    """The understanding hook's reader: `image_transform(open_image(path))`."""
    return image_transform(open_image(path), resolution)


def write_png(path: str, pixels) -> None:
    """An (H, W, 3) uint8 array as a PNG (the validation hooks' writer)."""
    from PIL import Image

    Image.fromarray(pixels).save(path)


def initialize(cfg) -> bool:
    """`distributed.initialize`: join the run's ranks (`train.py:309-318`),
    on the config's device's backend."""
    if not cfg.get_path("distributed.initialize", False):
        return False
    from mmada_tpu_torch.core.mesh import initialize_distributed

    return initialize_distributed(
        coordinator_address=cfg.get_path("distributed.coordinator", None),
        num_processes=cfg.get_path("distributed.num_processes", None),
        process_id=cfg.get_path("distributed.process_id", None),
        device=cfg.get("device"))


def _ranks() -> int:
    import torch.distributed as dist

    if dist.is_initialized():
        return dist.get_world_size()
    return int(os.environ.get("WORLD_SIZE", 1))


def check_supported(cfg) -> None:
    """Refuse what the port does not train over several ranks, naming its
    ROADMAP item."""
    if _ranks() <= 1:
        return
    if cfg.get_path("training.task") == "t2m":
        raise NotImplementedError("t2m training over more than one rank is not ported "
                                  "(ROADMAP A.12c; JAX's train_t2m runs on one device)")
    if str(cfg.get_path("parallel.serving", "auto")).lower() == "pipeline":
        raise NotImplementedError("parallel.serving=pipeline: pipeline stages serve and do "
                                  "not train (ROADMAP A.12c); training shards with "
                                  "parallel.{data,fsdp,tensor}")


def local_rows(loader, mesh):
    """This rank's rows of each flow of each raw batch (over the mesh's
    data x fsdp; tensor ranks share rows)."""
    from mmada_tpu_torch.core.mesh import process_local_batch_slice

    for raw in loader:
        out = {}
        for name, flow in raw.items():
            n = len(next(iter(flow.values())))
            rows = process_local_batch_slice(n, mesh)
            out[name] = {k: v[rows] for k, v in flow.items()}
        yield out


def build_dataloader(cfg, mesh=None):
    """The combined multi-flow loader from the config, as `train.py`'s:
    `dataset.synthetic_structured` (learnable pattern flows),
    `dataset.synthetic` (noise flows, for smoke runs), or the real readers:
    ImageNet folders or webdataset tars for t2i, RefinedWeb parquet for lm
    (the stage-4 base/instruct mixture by coefficients), webdataset tars for
    mmu (the stage-4 `<name>_in_mmu_coeff` mixture). Over a `mesh` of more
    than one rank every rank reads the global batches alike and yields its
    rows of them (`local_rows`)."""
    loader = _build_dataloader(cfg)
    if mesh is None or mesh.mesh.numel() == 1:
        return loader
    return local_rows(loader, mesh)


def _build_dataloader(cfg):
    import numpy as np

    from mmada_tpu_torch.data.combined import CombinedLoader
    from mmada_tpu_torch.data.imagenet import ImageNetDataset, collate_imagenet
    from mmada_tpu_torch.data.text import RefinedWebDataset, batched
    from mmada_tpu_torch.data.webdataset import WebDatasetReader, collate_image_text

    tr = cfg.training
    res = cfg.get_path("dataset.preprocessing.resolution", 256)
    mode = cfg.get_path("dataset.combined_loader_mode", "max_size_cycle")
    flows = {}

    if cfg.get_path("dataset.synthetic_structured"):
        from mmada_tpu_torch.data.synthetic import build_structured_flows

        return CombinedLoader(build_structured_flows(cfg), mode)

    if cfg.get_path("dataset.synthetic"):
        def synth_images(batch):
            rng = np.random.default_rng(0)
            while True:
                yield {
                    "images": rng.standard_normal((batch, res, res, 3)).astype(
                        np.float32).clip(-1, 1),
                    "input_ids": ["a synthetic image"] * batch,
                }

        def synth_text(batch):
            while True:
                yield {"input_ids": ["synthetic text sample"] * batch}

        if tr.get("batch_size_t2i"):
            flows["t2i_flow"] = synth_images(tr.batch_size_t2i)
        if tr.get("batch_size_lm"):
            flows["lm_flow"] = synth_text(tr.batch_size_lm)
        if tr.get("batch_size_mmu"):
            flows["mmu_flow"] = synth_images(tr.batch_size_mmu)
        return CombinedLoader(flows, mode)

    params = cfg.get_path("dataset.params", {})
    shuffle = params.get("shuffle_buffer_size", 1000)

    def tars(shards):
        return WebDatasetReader(shards, open_image, shuffle_buffer=shuffle,
                                transform=lambda img: image_transform(img, res))

    if tr.get("batch_size_t2i"):
        if cfg.get_path("dataset.gen_type", "imagenet1k") == "imagenet1k":
            ds = ImageNetDataset(params.get("train_t2i_shards_path_or_url"),
                                 params.get("imagenet_label_mapping"), resolution=res,
                                 open_image=open_image, transform=image_transform)
            flows["t2i_flow"] = (collate_imagenet(b)
                                 for b in batched(iter(ds), tr.batch_size_t2i))
        else:
            flows["t2i_flow"] = (collate_image_text(b) for b in batched(
                iter(tars(params.get("train_t2i_shards_path_or_url"))), tr.batch_size_t2i))
    if tr.get("batch_size_lm"):
        # stage 4 mixes base + instruct lm sources by probability
        # coefficients (train_mmada_stage4.py:636)
        base_coeff = params.get("base_in_lm_coeff")
        if base_coeff is not None and params.get("train_instruct_lm_shards_path_or_url"):
            from mmada_tpu_torch.data.vqa import MixedStream

            streams = {
                "base": iter(RefinedWebDataset(params.get("train_lm_shards_path_or_url"),
                                               shuffle_buffer=shuffle)),
                "instruct": iter(RefinedWebDataset(
                    params.get("train_instruct_lm_shards_path_or_url"), shuffle_buffer=shuffle)),
            }
            weights = {"base": base_coeff,
                       "instruct": params.get("instruct_in_lm_coeff", 1 - base_coeff)}
            lm_iter = iter(MixedStream(streams, weights))
        else:
            lm_iter = iter(RefinedWebDataset(params.get("train_lm_shards_path_or_url"),
                                             shuffle_buffer=shuffle))
        flows["lm_flow"] = ({"input_ids": [s["input_ids"] for s in b]}
                            for b in batched(lm_iter, tr.batch_size_lm))
    if tr.get("batch_size_mmu"):
        # und_type selects the mmu pipeline; image + caption tars cover the
        # captioning family (train_mmada.py:340-377)
        und_type = cfg.get_path("dataset.und_type", "captioning")
        if und_type not in ("captioning", "captioning_parquet"):
            raise NotImplementedError(f"Unsupported und_type {und_type}")
        # stage 4 mixes mmu sources ({cot,vqa,clevr2,geo170k}_in_mmu_coeff,
        # train_mmada_stage4.py:694)
        mmu_sources = {}
        for key, coeff in list(params.items()):
            if key.endswith("_in_mmu_coeff"):
                name = key[: -len("_in_mmu_coeff")]
                shards = params.get(f"train_{name}_mmu_shards_path_or_url")
                if shards:
                    mmu_sources[name] = (shards, coeff)
        if mmu_sources:
            from mmada_tpu_torch.data.vqa import MixedStream

            streams = {name: iter(tars(shards)) for name, (shards, _) in mmu_sources.items()}
            mmu_iter = iter(MixedStream(streams, {n: c for n, (_, c) in mmu_sources.items()}))
        else:
            mmu_iter = iter(tars(params.get("train_mmu_shards_path_or_url")))
        flows["mmu_flow"] = (collate_image_text(b) for b in batched(mmu_iter, tr.batch_size_mmu))
    return CombinedLoader(flows, mode)


def setup(cfg):
    """(trainer, loader) of `cfg`: the models loaded, the Trainer built (its
    config snapshotted), the loader built, and both resumed when asked (the
    loader past the batches the checkpoint's steps took)."""
    from mmada_tpu_torch.serve.loader import load_all
    from mmada_tpu_torch.training.trainer import Trainer

    initialize(cfg)
    check_supported(cfg)
    loaded = load_all(cfg, cfg.get("device"))
    trainer = Trainer.from_config(cfg, loaded.model, loaded.prompting, loaded.vq, loaded.vq_cfg,
                                  write_image=write_png, read_image=read_image)
    save_config(cfg, trainer.output_dir)
    loader = build_dataloader(cfg, trainer.mesh)
    if cfg.get_path("experiment.resume_from_checkpoint") == "latest" and trainer.resume():
        # the batches of the steps the checkpoint holds are read again and
        # dropped, so the resumed run continues the uninterrupted one
        loader = itertools.islice(loader, trainer.global_step, None)
    return trainer, loader


def run(cfg):
    """`setup(cfg)`, then `fit` from `training.seed`; returns the Trainer
    (for `training.task: t2m`, `train_t2m`'s `T2MRun`)."""
    if cfg.get_path("training.task") == "t2m":
        initialize(cfg)
        return train_t2m(cfg)
    trainer, loader = setup(cfg)
    trainer.fit(loader, rng_seed=cfg.get_path("training.seed", 0))
    return trainer


def motion_samples(cfg, vocab):
    """The t2m stream of (caption, padded code row, length): the token bank,
    synthetic codes, or `MotionTokenDataset` (`train.py` `train_t2m`)."""
    import numpy as np

    n_motion = cfg.get_path("dataset.max_motion_length", 55)
    if cfg.get_path("dataset.token_bank"):
        # pre-tokenized deterministic bank: caption -> fixed code row, already
        # padded MotionTokenDataset-style (codes, EOM, PAD...)
        bank = np.load(cfg.get_path("dataset.token_bank"))
        caps = [str(c) for c in bank["captions"]]
        toks = np.asarray(bank["tokens"], np.int64)
        lens = np.asarray(bank["lengths"], np.int64)

        def samples():
            rng = np.random.default_rng(0)
            while True:
                i = int(rng.integers(0, len(caps)))
                yield caps[i], toks[i], int(lens[i])
        return samples()
    if cfg.get_path("dataset.synthetic"):
        def samples():
            rng = np.random.default_rng(0)
            while True:
                yield ("a person walks",
                       rng.integers(0, vocab.motion_codebook_size, size=(n_motion,)), n_motion)
        return samples()
    from mmada_tpu_torch.data.motion import MotionTokenDataset

    root = cfg.get_path("dataset.motion_root")
    return iter(MotionTokenDataset(
        root, cfg.get_path("dataset.split_file", (root or "") + "/train.txt"),
        cfg.get_path("dataset.tokenizer_name", "VQVAE_tokens"),
        nb_code=vocab.motion_codebook_size, max_motion_length=n_motion))


class T2MRun:
    """Text-to-motion training from a config (`train_t2m`): `fit()` takes
    `training.max_train_steps` steps from `global_step`, logging `metrics.jsonl`
    under `experiment.output_dir` every `experiment.log_every` steps
    (`history` keeps the same lines, with each logged step's wall seconds)
    and saving `checkpoint-{step}` every `experiment.save_every` steps and
    at the last (none when it is 0: the port's Trainer's rule, where JAX
    always saves at the end). `experiment.resume_from_checkpoint=latest`
    restores the newest checkpoint and replays the data draws of the steps
    it holds, so a resumed run continues the uninterrupted one (each step
    corrupts its batch from a generator seeded by `training.seed` and the
    step)."""

    def __init__(self, cfg):
        import dataclasses

        import torch

        from mmada_tpu_torch.checkpoints.manager import CheckpointManager
        from mmada_tpu_torch.core.device import resolve_device
        from mmada_tpu_torch.models import lora as lora_mod
        from mmada_tpu_torch.serve.loader import (
            build_model,
            build_prompting,
            build_text_tokenizer,
            build_vocab,
        )
        from mmada_tpu_torch.training import t2m
        from mmada_tpu_torch.training.lr_schedules import from_config as lr_from_config
        from mmada_tpu_torch.training.optimizers import AdamW
        from mmada_tpu_torch.training.train_step import TrainState
        from mmada_tpu_torch.utils.logging import MetricsLogger

        check_supported(cfg)
        self.device = resolve_device(cfg.get("device"))
        tokenizer = build_text_tokenizer(cfg)
        vocab = build_vocab(cfg)
        if vocab.motion_codebook_size == 0:
            vocab = vocab.with_motion(cfg.get_path("model.mmada.motion_vocab_size", 512))
        self.vocab = vocab
        self.prompting = build_prompting(cfg, tokenizer, vocab)
        model = build_model(cfg, vocab, self.device)
        if cfg.get_path("model.mmada.attention_bias_enabled", False):
            model = dataclasses.replace(model, cfg=dataclasses.replace(
                model.cfg, attention_bias_enabled=True))
        self.model = model
        tr = cfg.training
        self.batch_size = tr.get("batch_size_t2m", 32)
        self.max_steps = tr.get("max_train_steps", 1000)
        self.seed = int(tr.get("seed", 0))
        lr = lr_from_config(cfg.get_path("lr_scheduler", {}), total_steps=self.max_steps)
        sc = t2m.T2MStepConfig(
            batch_size=self.batch_size, max_text_len=self.prompting.max_text_len,
            num_motion_tokens=cfg.get_path("dataset.max_motion_length", 55),
            skip_nonfinite_updates=tr.get("skip_nonfinite_updates", True))
        # JAX's optimizers.adamw(lr): clip 1.0, decay 0.01, its no-decay mask
        # on the trainable tree's paths
        opt = AdamW(lr)
        lora_raw = tr.get("lora")
        self.lora_cfg = None
        if lora_raw:
            self.lora_cfg = lora_mod.LoRAConfig(
                rank=lora_raw.get("rank", 32), alpha=lora_raw.get("alpha", 64),
                targets=tuple(lora_raw.get("targets", lora_mod.DEFAULT_TARGETS)),
                train_embeddings=lora_raw.get("train_embeddings", True))
            adapters = lora_mod.init_lora(model.params, self.lora_cfg,
                                          generator=torch.Generator(self.device).manual_seed(1))
            self.state = t2m.lora_state(model.params, adapters, self.lora_cfg, opt)
            self.step_fn = t2m.make_t2m_lora_train_step(model, opt, sc, self.lora_cfg)
        else:
            self.state = TrainState.create(model.params, opt)
            self.step_fn = t2m.make_t2m_train_step(model, opt, sc)
        self.stream = motion_samples(cfg, vocab)
        self.output_dir = cfg.get_path("experiment.output_dir", "t2m-output")
        os.makedirs(self.output_dir, exist_ok=True)
        self.metrics = MetricsLogger(os.path.join(self.output_dir, "metrics.jsonl"))
        self.ckpt = CheckpointManager(self.output_dir,
                                      cfg.get_path("experiment.checkpoints_total_limit"))
        self.save_every = cfg.get_path("experiment.save_every", 5000)
        self.log_every = cfg.get_path("experiment.log_every", 50)
        self.global_step = 0
        self.history: list[dict] = []
        if cfg.get_path("experiment.resume_from_checkpoint") == "latest":
            self.resume()

    def _payload(self) -> dict:
        """The checkpointed state: the trainable tensors and the optimizer's
        (its names with '.' for '/', the checkpoint's separator)."""
        opt = self.state.opt_state
        renamed = {k: ({n.replace("/", "."): t for n, t in v.items()} if isinstance(v, dict)
                       else v) for k, v in opt.items()}
        return {"train": {"params": self.state.params, "opt_state": renamed,
                          "step": self.state.step}}

    def next_batch(self) -> dict:
        import numpy as np
        import torch

        from mmada_tpu_torch.training.t2m import map_motion_tokens

        caps, toks = [], []
        for _ in range(self.batch_size):
            c, t, _ = next(self.stream)
            caps.append(c)
            toks.append(t)
        fused = map_motion_tokens(np.stack(toks), self.vocab)
        ids, masks, labels = self.prompting((caps, fused, fused), "t2m")
        return {k: torch.as_tensor(v, dtype=torch.long).to(self.device)
                for k, v in (("input_ids", ids), ("labels", labels), ("attention_mask", masks))}

    def resume(self) -> int:
        restored, step = self.ckpt.restore(self._payload())
        if restored is not None:
            for _ in range(step):  # the data draws of the steps it holds
                self.next_batch()
            self.global_step = step
            logging.getLogger("train").info("t2m resumed from step %d", step)
        return self.global_step

    def fit(self) -> "T2MRun":
        import time

        import torch

        log = logging.getLogger("train")
        while self.global_step < self.max_steps:
            t0 = time.perf_counter()
            batch = self.next_batch()
            gen = torch.Generator(self.device).manual_seed(self.seed * 1_000_003 + self.global_step)
            self.state, m = self.step_fn(self.state, batch, gen)
            self.global_step += 1
            last = self.global_step == self.max_steps
            if self.global_step % self.log_every == 0 or last:
                vals = {k: float(v) for k, v in m.items()}
                vals["seconds"] = time.perf_counter() - t0
                self.metrics.log(vals, step=self.global_step)
                self.history.append(dict(vals, step=self.global_step))
                log.info("t2m step %d loss %.4f", self.global_step, vals["loss"])
            if self.save_every and (self.global_step % self.save_every == 0 or last):
                self.ckpt.save(self.global_step, self._payload())
        self.ckpt.finalize()
        return self


def train_t2m(cfg) -> T2MRun:
    """Text-to-motion training (`train.py` `train_t2m`): `T2MRun(cfg).fit()`;
    the config is snapshotted into the output directory."""
    run = T2MRun(cfg)
    save_config(cfg, run.output_dir)
    return run.fit()


def main(argv) -> int:
    logging.basicConfig(level=logging.INFO)
    run(read_config(argv))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
