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

One key more than `train.py`: `device` (the card unless `device=cpu`). A
`config=` file is read with PyYAML; without it, give every key as a dotted
override. PIL opens and resizes the images (`open_image`,
`image_transform`) and writes the validation hooks' PNGs (`write_png`); the
package itself imports neither. Not ported, each refused with its ROADMAP
item: `training.task: t2m` (A.11) and `distributed.initialize` or a
`parallel` layout over more than one device (A.12).
"""

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
    JAX, train_mmada.py:151-155)."""
    import yaml

    os.makedirs(output_dir, exist_ok=True)
    path = os.path.join(output_dir, "config.yaml")
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


def check_supported(cfg) -> None:
    """Refuse what the port does not train yet, naming its ROADMAP item."""
    if cfg.get_path("training.task") == "t2m":
        raise NotImplementedError("training.task=t2m (text-to-motion training, train.py "
                                  "train_t2m) is not ported yet: ROADMAP A.11")
    if cfg.get_path("distributed.initialize", False):
        raise NotImplementedError("distributed.initialize (multi-host training) is not "
                                  "ported yet: ROADMAP A.12")
    parallel = cfg.get_path("parallel") or {}
    wide = {k: v for k, v in dict(parallel).items() if isinstance(v, int) and v > 1}
    if wide:
        raise NotImplementedError(f"parallel {wide}: device meshes are not ported yet "
                                  "(ROADMAP A.12); the port trains on one device")


def build_dataloader(cfg):
    """The combined multi-flow loader from the config, as `train.py`'s:
    `dataset.synthetic_structured` (learnable pattern flows),
    `dataset.synthetic` (noise flows, for smoke runs), or the real readers:
    ImageNet folders or webdataset tars for t2i, RefinedWeb parquet for lm
    (the stage-4 base/instruct mixture by coefficients), webdataset tars for
    mmu (the stage-4 `<name>_in_mmu_coeff` mixture)."""
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
    config snapshotted), resumed when asked, and the loader built."""
    from mmada_tpu_torch.serve.loader import load_all
    from mmada_tpu_torch.training.trainer import Trainer

    check_supported(cfg)
    loaded = load_all(cfg, cfg.get("device"))
    trainer = Trainer.from_config(cfg, loaded.model, loaded.prompting, loaded.vq, loaded.vq_cfg,
                                  write_image=write_png, read_image=read_image)
    save_config(cfg, trainer.output_dir)
    if cfg.get_path("experiment.resume_from_checkpoint") == "latest":
        trainer.resume()
    return trainer, build_dataloader(cfg)


def run(cfg):
    """`setup(cfg)`, then `fit` from `training.seed`; returns the Trainer."""
    trainer, loader = setup(cfg)
    trainer.fit(loader, rng_seed=cfg.get_path("training.seed", 0))
    return trainer


def main(argv) -> int:
    logging.basicConfig(level=logging.INFO)
    run(read_config(argv))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
