"""Text-to-image generation (MaskGIT with CFG, MAGVIT-v2 decode) on the card.

The PyTorch port's counterpart of `inference_t2i.py`, with its keys and
defaults:

    python inference_t2i_torch.py config=configs/mmada_demo.yaml \\
        model.mmada.pretrained_model_path=/path/to/MMaDA-8B-Base \\
        model.vq_model.vq_model_path=/path/to/magvitv2 \\
        validation_prompts_file=validation_prompts/text2image_prompts.txt \\
        batch_size=1 guidance_scale=3.5 generation_timesteps=15

Images are written to `{output_dir}/NNNN.png` (PIL). One key more: `device`
(the card unless `device=cpu`). A `config=` file is read with PyYAML. The
fast-decode knobs default to the family-resolved `serving.t2i.*` /
`serving.*` values; `segment_timesteps` above 0 runs the exact sampler in
windows of that many steps (the same codes; the cached decode wins when both
are set), as `inference_t2i.py` does. `quantative=true` scores the images
with CLIP (`eval.clip_dir`, a transformers CLIP checkpoint) on the run's
device (`eval/image_quality.py`), writes `{output_dir}/quantative.json` and
prints it; with no directory configured it writes `{}` (generation only).

`load(cfg)` calls `serve.loader.load_all`; `run(cfg, loaded)` returns the
codes and the uint8 images; `main` reads the prompts and writes the PNGs.
Each batch of `batch_size` prompts draws from `seed` plus its first
prompt's index. Under `torchrun` the loader serves the model sharded or in
pipeline stages over the ranks (`parallel.*`); every rank computes, rank 0
writes the PNGs and prints.
"""

import os
import sys

DEFAULT_PROMPTS_FILE = "validation_prompts/text2image_prompts.txt"


def _yaml(stream):
    import yaml

    return yaml.safe_load(stream)


def read_config(argv):
    from mmada_tpu_torch.core.config import load_config

    return load_config(cli_args=argv, reader=_yaml)


def settings(cfg) -> dict:
    """The sampler's keywords for `entry.serve_t2i`: the direct keys over the
    family-resolved serving defaults."""
    from mmada_tpu_torch.core.config import parse_cfg_interval, parse_kv_cache
    from mmada_tpu_torch.serve.loader import task_serving_defaults

    d = task_serving_defaults(cfg, "t2i")
    kv_cache = parse_kv_cache(cfg.get("kv_cache", d["kv_cache"]))
    return dict(
        guidance_scale=float(cfg.get("guidance_scale", 3.5)),
        timesteps=int(cfg.get("generation_timesteps", 15)),
        temperature=float(cfg.get("generation_temperature", 1.0)),
        num_vq_tokens=int(cfg.get_path("model.mmada.num_vq_tokens", 1024)),
        max_text_len=int(cfg.get_path("dataset.preprocessing.max_seq_length", 512)),
        block_kv_cache=kv_cache,
        cache_refresh_every=int(cfg.get("cache_refresh_every", d["cache_refresh_every"])),
        # the cached decode wins over segmentation and the guidance interval
        segment_timesteps=0 if kv_cache else int(cfg.get("segment_timesteps",
                                                         d["segment_timesteps"])),
        cfg_interval=(0.0, 1.0) if kv_cache else parse_cfg_interval(
            cfg.get("cfg_interval", d["cfg_interval"])),
    )


def read_prompts(cfg) -> list:
    """The prompts file's non-empty lines, or the config's `prompt`."""
    path = cfg.get("validation_prompts_file", DEFAULT_PROMPTS_FILE)
    if os.path.exists(path):
        with open(path) as f:
            return [ln.strip() for ln in f if ln.strip()]
    return [cfg.get("prompt", "a photo of a cat")]


def load(cfg):
    from mmada_tpu_torch.serve.loader import load_all

    return load_all(cfg, cfg.get("device"))


def run(cfg, loaded, prompts):
    """((N, num_vq_tokens) codes, (N, H, W, 3) uint8 images), on the CPU, for
    `prompts` in batches of `batch_size`."""
    import torch

    from mmada_tpu_torch.entry import decode_images, serve_t2i

    s = settings(cfg)
    batch_size = int(cfg.get("batch_size", 1))
    seed = int(cfg.get("seed", 0))
    device = cfg.get("device")
    codes, images = [], []
    for start in range(0, len(prompts), batch_size):
        chunk = prompts[start:start + batch_size]
        c = serve_t2i(loaded.model, chunk, loaded.tokenizer, special_ids=loaded.prompting.sp,
                      device=device, seed=seed + start, **s)
        codes.append(c)
        images.append(decode_images(loaded.vq, loaded.vq_cfg, c, device=device))
    return torch.cat(codes), torch.cat(images)


def load_scorer(cfg):
    """The CLIP scorer of `quantative=true` (`eval.clip_dir`) on the run's
    device; a configured directory that does not load raises."""
    from mmada_tpu_torch.eval.image_quality import load_scorer as load

    return load(cfg.get_path("eval.clip_dir"), device=cfg.get("device"))


def quantative(scorer, images, prompts) -> dict:
    """The scorer's summary of the uint8 images, as `inference_t2i.py`
    scores its PNGs' pixels ([-1, 1] from the uint8 values)."""
    pixels = images.numpy().astype("float32") / 127.5 - 1.0
    return scorer.quantitative_images(pixels, prompts)


def main(argv) -> int:
    import json

    from PIL import Image

    from mmada_tpu_torch.core.mesh import is_main_process

    cfg = read_config(argv)
    settings(cfg)
    output_dir = cfg.get("output_dir", "t2i_outputs")
    prompts = read_prompts(cfg)
    loaded = load(cfg)   # under a launcher this joins the ranks' group
    scorer = load_scorer(cfg) if cfg.get("quantative", False) and is_main_process() else None
    _, images = run(cfg, loaded, prompts)   # every rank computes (a launcher's ranks)
    if not is_main_process():
        return 0
    os.makedirs(output_dir, exist_ok=True)
    for i, prompt in enumerate(prompts):
        path = os.path.join(output_dir, f"{i:04d}.png")
        Image.fromarray(images[i].numpy()).save(path)
        print(f"{path}: {prompt}")
    if scorer is not None and prompts:
        results = quantative(scorer, images, prompts)
        with open(os.path.join(output_dir, "quantative.json"), "w") as f:
            json.dump(results, f, indent=2)
        print("quantative:", results or "(scoring models unavailable)")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
