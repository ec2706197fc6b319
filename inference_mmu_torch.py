"""Multimodal understanding (an image and a question in, text out) on the card.

The PyTorch port's counterpart of `inference_mmu.py`, with its keys and
defaults:

    python inference_mmu_torch.py config=configs/mmada_demo.yaml \\
        model.mmada.pretrained_model_path=/path/to/MMaDA-8B-Base \\
        model.vq_model.vq_model_path=/path/to/magvitv2 \\
        mmu_image_root=./mmu_validation question='Please describe this image in detail.'

Each image under `mmu_image_root` is read with PIL, resized and cropped to
`dataset.preprocessing.resolution` (`image_transform`), encoded by
MAGVIT-v2 and answered alone: `<|mmu|> <|soi|> codes <|eoi|> <bos>
question`, then semi-AR text denoising (`fast=true`: stop after the first
block that ends in EOT). One key more: `device` (the card unless
`device=cpu`). A `config=` file is read with PyYAML. The fast-decode knobs
default to the family-resolved `serving.mmu.*` / `serving.*` values;
`segment_steps` above 0 runs the exact sampler in chunks (the same tokens;
the cached decode and `fast` win when set), as `inference_mmu.py` does.

`load(cfg)` calls `serve.loader.load_all`; `run(cfg, loaded, images)`
returns each image's generated ids; `read_images` and `main` do the file
work. Under `torchrun` the loader serves the model sharded or in pipeline
stages over the ranks (`parallel.*`); every rank computes, rank 0 prints.
"""

import os
import sys

IMAGE_SUFFIXES = (".jpg", ".jpeg", ".png", ".webp")


def _yaml(stream):
    import yaml

    return yaml.safe_load(stream)


def read_config(argv):
    from mmada_tpu_torch.core.config import load_config

    return load_config(cli_args=argv, reader=_yaml)


def image_transform(image, resolution: int = 256, normalize: bool = True):
    """A PIL image as (resolution, resolution, 3) float32 pixels: bicubic
    resize of the short side, centre crop, [-1, 1] (a copy of
    `mmada_tpu/data/transforms.image_transform`, the reference's torchvision
    transforms, training/utils.py:200-220)."""
    import numpy as np
    from PIL import Image

    w, h = image.size
    scale = resolution / min(w, h)
    new_w, new_h = round(w * scale), round(h * scale)
    image = image.resize((new_w, new_h), Image.BICUBIC)
    left = (new_w - resolution) // 2
    top = (new_h - resolution) // 2
    image = image.crop((left, top, left + resolution, top + resolution))
    arr = np.asarray(image.convert("RGB"), dtype=np.float32) / 255.0
    return arr * 2.0 - 1.0 if normalize else arr


def read_images(image_root: str, resolution: int):
    """(file names, (N, resolution, resolution, 3) pixels) of the images
    under `image_root`, sorted by name; no images gives ([], None)."""
    import numpy as np
    from PIL import Image

    names = sorted(f for f in os.listdir(image_root)
                   if f.lower().endswith(IMAGE_SUFFIXES)) if os.path.isdir(image_root) else []
    pixels = []
    for name in names:
        with Image.open(os.path.join(image_root, name)) as img:
            pixels.append(image_transform(img, resolution))
    return names, (np.stack(pixels) if pixels else None)


def settings(cfg) -> dict:
    """The sampler's keywords for `entry.serve_mmu`: the direct keys over the
    family-resolved serving defaults."""
    from mmada_tpu_torch.core.config import parse_kv_cache
    from mmada_tpu_torch.serve.loader import task_serving_defaults

    d = task_serving_defaults(cfg, "mmu")
    max_new_tokens = int(cfg.get("max_new_tokens", 128))
    kv_cache = parse_kv_cache(cfg.get("kv_cache", d["kv_cache"]))
    fast = bool(cfg.get("fast", False))
    return dict(
        max_new_tokens=max_new_tokens,
        steps=int(cfg.get("steps", max_new_tokens // 2)),
        block_length=int(cfg.get("block_length", max_new_tokens)),
        fast=fast,
        seed=int(cfg.get("seed", 0)),
        block_kv_cache=kv_cache,
        parallel_threshold=float(cfg.get("parallel_threshold", d["parallel_threshold"])),
        parallel_warmup_steps=int(cfg.get("parallel_warmup_steps", d["parallel_warmup_steps"])),
        cache_refresh_every=int(cfg.get("cache_refresh_every", d["cache_refresh_every"])),
        # the exact sampler only; the cached decode wins when both are set
        segment_steps=0 if kv_cache or fast else int(cfg.get("segment_steps",
                                                             d["segment_steps"])),
    )


def load(cfg):
    from mmada_tpu_torch.serve.loader import load_all

    return load_all(cfg, cfg.get("device"))


def run(cfg, loaded, images):
    """Each image's `max_new_tokens` generated ids (fused vocab, on the
    CPU), one request an image: `images` (N, H, W, 3) in [-1, 1]."""
    from generate_torch import chat_text
    from mmada_tpu_torch.entry import serve_mmu

    s = settings(cfg)
    question = chat_text(loaded.tokenizer,
                         cfg.get("question", "Please describe this image in detail."))
    return [serve_mmu(loaded.model, loaded.vq, loaded.vq_cfg, images[i:i + 1], [question],
                      loaded.tokenizer, special_ids=loaded.prompting.sp,
                      device=cfg.get("device"), **s)[0]
            for i in range(len(images))]


def main(argv) -> int:
    from generate_torch import answer_text
    from mmada_tpu_torch.core.mesh import is_main_process

    cfg = read_config(argv)
    image_root = cfg.get("mmu_image_root", "mmu_validation")
    names, pixels = read_images(image_root,
                                int(cfg.get_path("dataset.preprocessing.resolution", 512)))
    if not names:
        print(f"no images under {image_root}", file=sys.stderr)
        return 1
    loaded = load(cfg)
    answers = run(cfg, loaded, pixels)   # every rank computes (a launcher's ranks)
    if is_main_process():
        for name, ids in zip(names, answers):
            print(f"=== {name}\n{answer_text(loaded, ids)}\n")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
