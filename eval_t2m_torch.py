"""Text-to-motion evaluation on the card: FID / R-precision / diversity /
matching.

The PyTorch port's counterpart of `eval_t2m.py` (the reference's
train_t2m.py:769-800 driving `evaluation_mmada_t2m`), with its keys: the
model, the motion VQ-VAE (`model.motion_vq_model`), the T2M evaluators
(`eval.evaluator_dir`, `eval.evaluator_file`), the word vectors
(`eval.glove_dir`, the hash stand-in without it) and the HumanML3D eval
split (`dataset.motion_root`, `dataset.split_file`, `eval.batch_size`,
`eval.max_motion_frames`, `eval.num_motion_tokens`, `eval.timesteps`,
`eval.max_batches`), through `eval/t2m_eval.evaluate_mmada_t2m`:

    python eval_t2m_torch.py config=configs/t2m_instruct.yaml \\
        dataset.split_file=data/HumanML3D/val.txt \\
        eval.evaluator_dir=checkpoints/t2m/Comp_v6_KLD005

One key more: `device` (the card unless `device=cpu`). It returns 1, as
`eval_t2m.py` does, without the eval split or the evaluators. `load(cfg)`
builds the pieces, `run(cfg, loaded)` evaluates and returns the metrics;
`main` prints them as JSON. The sampler draws from a generator seeded 0
on the model's device.
"""

import json
import logging
import os
import sys
from typing import Any, NamedTuple

logger = logging.getLogger(__name__)


class EvalLoaded(NamedTuple):
    model: Any
    motion_vq: Any
    motion_vq_cfg: Any
    evaluator: Any           # None without `eval.evaluator_dir`
    prompting: Any
    word_vectorizer: Any


def _yaml(stream):
    import yaml

    return yaml.safe_load(stream)


def read_config(argv):
    from mmada_tpu_torch.core.config import load_config

    return load_config(cli_args=argv, reader=_yaml)


def has_data(cfg) -> bool:
    root, split = cfg.get_path("dataset.motion_root"), cfg.get_path("dataset.split_file")
    return bool(root and split and os.path.exists(split))


def load(cfg) -> EvalLoaded:
    """The model with the motion vocab (`model.mmada.motion_vocab_size`,
    512 by default), its prompting, the motion VQ-VAE, the evaluators and
    the word vectors, on `device`."""
    from mmada_tpu_torch.eval.components import build_evaluator, build_word_vectorizer
    from mmada_tpu_torch.serve.loader import (build_model, build_motion_vq, build_prompting,
                                              build_text_tokenizer, build_vocab)

    device = cfg.get("device")
    tokenizer = build_text_tokenizer(cfg)
    vocab = build_vocab(cfg)
    if vocab.motion_codebook_size == 0:
        vocab = vocab.with_motion(cfg.get_path("model.mmada.motion_vocab_size", 512))
    vq, vq_cfg = build_motion_vq(cfg, device)
    return EvalLoaded(model=build_model(cfg, vocab, device), motion_vq=vq, motion_vq_cfg=vq_cfg,
                      evaluator=build_evaluator(cfg, device),
                      prompting=build_prompting(cfg, tokenizer, vocab),
                      word_vectorizer=build_word_vectorizer(cfg))


def eval_config(cfg, vq_cfg):
    """`T2MEvalConfig` from `eval.*`: VQ tokens, not frames (`unit_length`
    frames a token)."""
    from mmada_tpu_torch.eval.t2m_eval import T2MEvalConfig

    max_frames = int(cfg.get_path("eval.max_motion_frames", 196))
    unit = 2 ** vq_cfg.down_t
    return T2MEvalConfig(
        num_motion_tokens=int(cfg.get_path("eval.num_motion_tokens",
                                           max_frames // unit // 4 * 4 or 49)),
        timesteps=int(cfg.get_path("eval.timesteps", 18)), unit_length=unit)


def run(cfg, loaded: EvalLoaded, eval_batches=None, generator=None,
        embeddings=None) -> dict:
    """The metrics over the eval split (or `eval_batches`): the evaluator
    reads the normalized motion space, as the dataset's ground truth does
    (the reference's eval_trans.py:775-776), so nothing is denormalized."""
    import torch

    from mmada_tpu_torch.eval.components import build_eval_batches
    from mmada_tpu_torch.eval.t2m_eval import evaluate_mmada_t2m

    if eval_batches is None:
        eval_batches = build_eval_batches(cfg, loaded.word_vectorizer)
    if generator is None:
        generator = torch.Generator(loaded.model.device).manual_seed(0)
    return evaluate_mmada_t2m(
        loaded.model, loaded.motion_vq, loaded.motion_vq_cfg, loaded.evaluator,
        loaded.prompting, eval_batches, eval_config(cfg, loaded.motion_vq_cfg),
        generator=generator, max_batches=cfg.get_path("eval.max_batches"),
        embeddings=embeddings)


def main(argv) -> int:
    logging.basicConfig(level=logging.INFO)
    cfg = read_config(argv)
    if not has_data(cfg):
        logger.error("dataset.motion_root + dataset.split_file (HumanML3D layout) are required; "
                     "got root=%s split=%s", cfg.get_path("dataset.motion_root"),
                     cfg.get_path("dataset.split_file"))
        return 1
    if not os.path.isdir(cfg.get_path("eval.evaluator_dir") or ""):
        logger.error("eval.evaluator_dir with T2M evaluator checkpoints required")
        return 1
    results = run(cfg, load(cfg))
    print(json.dumps({k: float(v) for k, v in results.items()}, indent=2))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
