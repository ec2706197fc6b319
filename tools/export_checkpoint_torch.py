"""Export a checkpoint of the port's trainer to a reference-compatible HF
directory.

The PyTorch port's counterpart of `tools/export_checkpoint.py`: reads
`checkpoint-{step}` (the newest, or `step=N`) of a `train_torch.py` run
(`checkpoints/manager.py`: the flattened state under `state/`), takes its
train params (`train/params/...`) or, with `ema=true`, the EMA shadow
(`ema/shadow/...`, written by runs with `training.ema.enabled`), and writes
`hf_import.export_pretrained`'s `config.json` and safetensors shards
(reference key names), which `MMadaModel.from_pretrained` and the
reference's `MMadaModelLM.from_pretrained` load.

    python tools/export_checkpoint_torch.py config=configs/<stage>.yaml \\
        checkpoint_dir=<output_dir> out_dir=<export_dir> [step=N] [ema=true]

The model of `config` (`serve.loader.build_model`) gives the weights'
names, shapes and dtypes; every one is checked against the checkpoint's
before a byte is read. One key more than `tools/export_checkpoint.py`:
`device` (where the weights are staged; the card unless `device=cpu`).
"""

import logging
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

logger = logging.getLogger(__name__)


def export(cfg) -> str:
    """Export the checkpoint `cfg` names; returns the export directory.
    Raises FileNotFoundError without a checkpoint and ValueError where the
    checkpoint does not hold what is asked for."""
    import torch

    from mmada_tpu_torch.checkpoints import safetensors_io
    from mmada_tpu_torch.checkpoints.hf_import import export_pretrained
    from mmada_tpu_torch.checkpoints.manager import STATE, flatten, latest_checkpoint
    from mmada_tpu_torch.models import llada
    from mmada_tpu_torch.serve.loader import build_model, build_vocab

    ckpt_dir = cfg.get("checkpoint_dir") or cfg.get_path("experiment.output_dir")
    if not ckpt_dir:
        raise ValueError("set checkpoint_dir=... or experiment.output_dir in the config")
    step = cfg.get("step")
    path = (latest_checkpoint(ckpt_dir) if step is None
            else os.path.join(ckpt_dir, f"checkpoint-{int(step)}"))
    if path is None or not os.path.isdir(path):
        raise FileNotFoundError(f"no checkpoint under {ckpt_dir}")
    out_dir = cfg.get("out_dir", os.path.join(ckpt_dir, "export"))
    ema = str(cfg.get("ema", "false")).lower() in ("1", "true", "yes")
    prefix = "ema/shadow/" if ema else "train/params/"

    vocab = build_vocab(cfg)
    model = build_model(cfg, vocab, cfg.get("device"))
    # the trainer's form (a `layers` list): its leaves are views of the
    # model's stacked weights, so loading them fills `model.params`
    want = {prefix + k: t for k, t in flatten(llada.split_layers(model.params)).items()}
    state_dir = os.path.join(path, STATE)
    stored = {}
    for name in safetensors_io.checkpoint_files(state_dir):
        stored.update(safetensors_io.read_header(name)[0])
    held = {k: v for k, v in stored.items() if k.startswith(prefix)}
    if not held:
        raise ValueError(f"{path} holds no {prefix[:-1]}"
                         + (" (train with training.ema.enabled)" if ema else ""))
    missing, extra = sorted(set(want) - set(held)), sorted(set(held) - set(want))
    if missing or extra:
        raise ValueError(f"{path}: {prefix[:-1]} differs from the model of the config: "
                         f"missing {missing[:8]}, extra {extra[:8]}")
    for key, t in want.items():
        info = held[key]
        if tuple(info["shape"]) != tuple(t.shape) or safetensors_io.DTYPES.get(
                info["dtype"]) != t.dtype:
            raise ValueError(f"{path}: {key} is {info['dtype']} {info['shape']}, the "
                             f"model's {t.dtype} {list(t.shape)}")
    with torch.no_grad():
        for key, t in safetensors_io.iter_safetensors(state_dir):
            if key in want:
                want[key].copy_(t)
    logger.info("%s of %s -> %s", "EMA shadow" if ema else "train params", path, out_dir)
    export_pretrained(out_dir, model.params, model.cfg, vocab)
    return out_dir


def main(argv) -> int:
    logging.basicConfig(level=logging.INFO)
    from train_torch import read_config

    out = export(read_config(argv))
    print(f"exported config.json and safetensors to {out}")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
