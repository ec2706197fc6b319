"""Config-driven construction of the T2M evaluation stack.

The counterpart of `mmada_tpu/eval/components.py`, shared by
`eval_t2m_torch.py` (text-to-motion metrics) and `train_motion_vq_torch.py`'s
reconstruction eval (`evaluation_vqvae`): the reference's
EvaluatorModelWrapper + dataset_TM_eval bring-up
(models/evaluator_wrapper.py:8-90, train_t2m.py:326-333).
`random_evaluator_state` writes the evaluators at `Comp_v6_KLD005`'s
published widths on weights from a seed, in the checkpoint's layout, for
runs where the checkpoint is not on the machine.
"""

from __future__ import annotations

import logging
import os

import numpy as np
import torch

from mmada_tpu_torch.core.device import DeviceLike, resolve_device

logger = logging.getLogger(__name__)


def build_word_vectorizer(cfg):
    """GloVe metas when available, the hash stand-in otherwise (metrics from
    the stand-in are NOT comparable to published numbers)."""
    from mmada_tpu_torch.eval.word_vectorizer import RandomWordVectorizer, WordVectorizer

    glove_dir = cfg.get_path("eval.glove_dir")
    if glove_dir and os.path.isdir(glove_dir):
        return WordVectorizer(glove_dir, cfg.get_path("eval.glove_prefix", "our_vab"))
    logger.warning("no GloVe metas (eval.glove_dir); using hash stand-in — metrics are "
                   "NOT comparable to published numbers")
    return RandomWordVectorizer()


def build_evaluator(cfg, device: DeviceLike = None):
    """The T2M BiGRU evaluators from the torch checkpoint directory
    (`eval.evaluator_dir`, `eval.evaluator_file`), on `device`; None when
    unset."""
    from mmada_tpu_torch.eval.t2m_evaluator import EvaluatorWrapper

    evaluator_dir = cfg.get_path("eval.evaluator_dir")
    if not (evaluator_dir and os.path.isdir(evaluator_dir)):
        return None
    path = os.path.join(evaluator_dir, cfg.get_path("eval.evaluator_file", "finest.tar"))
    ckpt = torch.load(path, map_location="cpu", weights_only=True)
    return EvaluatorWrapper.from_torch_checkpoint(
        ckpt.get("text_encoder", ckpt), ckpt.get("motion_encoder", ckpt),
        ckpt.get("movement_encoder", ckpt), device=device)


def build_eval_batches(cfg, word_vectorizer, batch_size=None):
    """A generator of `MotionEvalDataset` batches, or None if the data paths
    are unset."""
    from mmada_tpu_torch.data.motion import MotionEvalDataset
    from mmada_tpu_torch.data.text import batched
    from mmada_tpu_torch.eval.t2m_eval import collate_eval_items

    root = cfg.get_path("dataset.motion_root")
    split = cfg.get_path("dataset.split_file")
    if not (root and split and os.path.exists(split)):
        return None
    batch_size = batch_size or int(cfg.get_path("eval.batch_size", 32))
    max_frames = int(cfg.get_path("eval.max_motion_frames", 196))
    ds = MotionEvalDataset(root, split, word_vectorizer, max_motion_length=max_frames)
    items = [ds[i] for i in range(len(ds))]
    return (collate_eval_items(b) for b in batched(iter(items), batch_size))


def synthetic_evaluator(mv_cfg, seed: int = 3, hidden: int = 8, out_dim: int = 6,
                        device: DeviceLike = None):
    """A tiny random-weight `EvaluatorWrapper` for a `MotionVQConfig`'s pose
    width (word vectors of 12), the JAX package's `synthetic_evaluator` draw
    for draw: it proves the plumbing, and its metrics are NOT comparable to
    published numbers."""
    from mmada_tpu_torch.eval.t2m_evaluator import EvaluatorWrapper

    device = resolve_device(device)
    rng = np.random.default_rng(seed)

    def t(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=device)

    def lin(i, o):
        return t(rng.normal(size=(o, i)).astype(np.float32) * 0.1)

    def zeros(*shape):
        return torch.zeros(shape, device=device)

    def gru(d):
        return {"w_ih_f": lin(d, 3 * hidden), "w_hh_f": lin(hidden, 3 * hidden),
                "b_ih_f": zeros(3 * hidden), "b_hh_f": zeros(3 * hidden),
                "w_ih_b": lin(d, 3 * hidden), "w_hh_b": lin(hidden, 3 * hidden),
                "b_ih_b": zeros(3 * hidden), "b_hh_b": zeros(3 * hidden)}

    def outnet():
        return {"fc1_w": lin(2 * hidden, hidden), "fc1_b": zeros(hidden),
                "ln_w": torch.ones(hidden, device=device), "ln_b": zeros(hidden),
                "fc2_w": lin(hidden, out_dim), "fc2_b": zeros(out_dim)}

    move_out = out_dim
    text = {"pos_emb_w": lin(15, 12), "pos_emb_b": zeros(12),
            "input_emb_w": lin(12, hidden), "input_emb_b": zeros(hidden),
            "gru": gru(hidden), "out": outnet(), "hidden": zeros(2, 1, hidden)}
    motion = {"input_emb_w": lin(move_out, hidden), "input_emb_b": zeros(hidden),
              "gru": gru(hidden), "out": outnet(), "hidden": zeros(2, 1, hidden)}
    # the JAX draws are TIO conv kernels; torch's layout is (out, in, k)
    conv1 = rng.normal(size=(4, mv_cfg.pose_dim - 4, 5)).astype(np.float32) * 0.1
    conv2 = rng.normal(size=(4, 5, move_out)).astype(np.float32) * 0.1
    movement = {"conv1": {"w": t(conv1.transpose(2, 1, 0)), "b": zeros(5)},
                "conv2": {"w": t(conv2.transpose(2, 1, 0)), "b": zeros(move_out)},
                "out_w": lin(move_out, move_out), "out_b": zeros(move_out)}
    return EvaluatorWrapper(text_params=text, motion_params=motion, movement_params=movement,
                            unit_length=2 ** mv_cfg.down_t)


def random_evaluator_state(pose_dim: int = 263, word_size: int = 300, pos_size: int = 15,
                           text_hidden: int = 512, text_out: int = 512, move_hidden: int = 512,
                           move_out: int = 512, motion_hidden: int = 1024,
                           motion_out: int = 512, seed: int = 0) -> dict:
    """The three evaluators' state dicts in the published checkpoint's
    layout (`{"text_encoder": ..., "motion_encoder": ..., "movement_encoder":
    ...}`, what `build_evaluator` reads from `finest.tar`) at
    `Comp_v6_KLD005`'s widths by default (T2M-GPT's
    models/evaluator_wrapper.py: the text BiGRU 300 + 15 -> 512 -> 512, the
    motion BiGRU 512 -> 1,024 -> 512, the movement conv encoder 259 -> 512
    -> 512, kernel 4), on CPU weights drawn from `seed` as torch initialises
    them (uniform within 1/sqrt(fan-in))."""
    g = torch.Generator().manual_seed(seed)

    def uni(fan_in, *shape):
        return (torch.rand(shape, generator=g) * 2 - 1) / fan_in ** 0.5

    def linear(state, name, i, o):
        state[f"{name}.weight"], state[f"{name}.bias"] = uni(i, o, i), uni(i, o)

    def gru(state, h):
        for sfx in ("", "_reverse"):
            state[f"gru.weight_ih_l0{sfx}"] = uni(h, 3 * h, h)
            state[f"gru.weight_hh_l0{sfx}"] = uni(h, 3 * h, h)
            state[f"gru.bias_ih_l0{sfx}"] = uni(h, 3 * h)
            state[f"gru.bias_hh_l0{sfx}"] = uni(h, 3 * h)
        state["hidden"] = torch.randn((2, 1, h), generator=g)

    def output_net(state, h, o):
        linear(state, "output_net.0", 2 * h, h)
        state["output_net.1.weight"], state["output_net.1.bias"] = torch.ones(h), torch.zeros(h)
        linear(state, "output_net.3", h, o)

    text: dict = {}
    linear(text, "pos_emb", pos_size, word_size)
    linear(text, "input_emb", word_size, text_hidden)
    gru(text, text_hidden)
    output_net(text, text_hidden, text_out)
    motion: dict = {}
    linear(motion, "input_emb", move_out, motion_hidden)
    gru(motion, motion_hidden)
    output_net(motion, motion_hidden, motion_out)
    d_in = pose_dim - 4
    movement = {"main.0.weight": uni(d_in * 4, move_hidden, d_in, 4),
                "main.0.bias": uni(d_in * 4, move_hidden),
                "main.3.weight": uni(move_hidden * 4, move_out, move_hidden, 4),
                "main.3.bias": uni(move_hidden * 4, move_out)}
    linear(movement, "out_net", move_out, move_out)
    return {"text_encoder": text, "motion_encoder": motion, "movement_encoder": movement}
