"""Pre-tokenize raw motion features into VQ code files, on the card.

The PyTorch port's counterpart of `tools/tokenize_motions.py` (the
reference's `dataset_tokenize` flow, dataset/dataset_tokenize.py): encode
every `new_joint_vecs/{name}.npy` of `dataset.split_file` through the motion
VQ-VAE (`model.motion_vq_model`: a `save_params_only` directory at
`pretrained_path`, as `train_motion_vq_torch.py` writes it, read by
`load_params_only`; random weights from seed 0, with a warning, where there
is none) and write `{dataset.motion_root}/{out_name}/{name}.npy` code
sequences (int32, as JAX's tool writes them), which `MotionTokenDataset`
reads. Features are normalised by the
root's `Mean.npy` / `Std.npy` where both exist and cut to a multiple of the
VQ's temporal stride; a clip shorter than one stride is skipped.

    python tools/tokenize_motions_torch.py config=configs/t2m_instruct.yaml \\
        dataset.split_file=data/HumanML3D/train.txt out_name=VQVAE_tokens

One key more than `tools/tokenize_motions.py`: `device` (the card unless
`device=cpu`).
"""

import logging
import os
import sys

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

logger = logging.getLogger(__name__)


def tokenize(cfg) -> int:
    """Write the code files of `cfg`; returns how many clips were encoded."""
    import torch

    from mmada_tpu_torch.checkpoints.manager import load_params_only
    from mmada_tpu_torch.core.device import resolve_device
    from mmada_tpu_torch.models import motion_vq
    from mmada_tpu_torch.serve.loader import motion_vq_config

    device = resolve_device(cfg.get("device"))
    root = cfg.get_path("dataset.motion_root")
    names = [ln.strip() for ln in open(cfg.get_path("dataset.split_file")) if ln.strip()]
    mcfg = motion_vq_config(cfg)
    vq = motion_vq.init_motion_vq(mcfg, device=device,
                                  generator=torch.Generator(device).manual_seed(0))
    ckpt = cfg.get_path("model.motion_vq_model.pretrained_path")
    if ckpt and os.path.exists(str(ckpt)):
        load_params_only(str(ckpt), vq)
    else:
        logger.warning("no VQ checkpoint at %s; using random init", ckpt)

    stats = [os.path.join(root, f) for f in ("Mean.npy", "Std.npy")]
    mean, std = (np.load(p) for p in stats) if all(map(os.path.exists, stats)) else (None, None)
    out_dir = os.path.join(root, cfg.get("out_name", "VQVAE_tokens"))
    os.makedirs(out_dir, exist_ok=True)
    stride = 2 ** mcfg.down_t
    done = 0
    for name in names:
        m = np.load(os.path.join(root, "new_joint_vecs", f"{name}.npy"))
        if mean is not None:
            m = (m - mean) / (std + 1e-8)
        t = (m.shape[0] // stride) * stride
        if t < stride:
            logger.warning("skip %s: %d frames, under one stride of %d", name, m.shape[0], stride)
            continue
        x = torch.as_tensor(m[None, :t], dtype=torch.float32, device=device)
        with torch.no_grad():
            codes = motion_vq.encode(vq, mcfg, x)
        np.save(os.path.join(out_dir, f"{name}.npy"), codes[0].cpu().numpy().astype(np.int32))
        done += 1
    logger.info("tokenized %d/%d motions into %s", done, len(names), out_dir)
    return done


def main(argv) -> int:
    logging.basicConfig(level=logging.INFO)
    from train_torch import read_config

    tokenize(read_config(argv))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
