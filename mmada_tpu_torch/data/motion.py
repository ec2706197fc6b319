"""Motion datasets: pre-tokenized motion codes, raw VQ windows, eval items.

A copy of `mmada_tpu/data/motion.py` (numpy only): the same samples for the
same files and seeds. Equivalents of the reference motion data layer
(dataset/):

  * `MotionTokenDataset` — `dataset_TM_train.py:18-139`: per-sample lists of
    pre-tokenized motion code sequences + captions; random head/tail token
    drop (1/3 probability), EOM = nb_code and PAD = nb_code+1 appended to a
    fixed max length.
  * `MotionVQDataset` — `dataset_VQ.py`: random fixed-length windows of raw
    motion features, mean/std normalized, for VQ-VAE training.
  * `MotionEvalDataset` — `dataset_TM_eval.py`: caption word
    embeddings/POS one-hots + normalized motion features + lengths for the
    evaluator metrics.

On-disk layout matches HumanML3D conventions: `{root}/texts/{name}.txt`
(caption#tokens lines), `{root}/{tokenizer_name}/{name}.npy` motion codes,
`{root}/new_joint_vecs/{name}.npy` features, `Mean.npy` / `Std.npy`.
"""

from __future__ import annotations

import logging
import os
import random
from typing import Iterator, Optional

import numpy as np

logger = logging.getLogger(__name__)


def read_split(split_file: str) -> list[str]:
    with open(split_file) as f:
        return [ln.strip() for ln in f if ln.strip()]


def read_caption_file(path: str) -> list[dict]:
    """HumanML3D text file: `caption#tok/POS ...#f_start#f_end` lines."""
    out = []
    with open(path) as f:
        for line in f:
            parts = line.strip().split("#")
            if not parts or not parts[0]:
                continue
            item = {"caption": parts[0]}
            if len(parts) > 1:
                item["tokens"] = parts[1].split(" ")
            if len(parts) > 3:
                try:
                    item["f_start"] = float(parts[2])
                    item["f_end"] = float(parts[3])
                except ValueError:
                    pass
            out.append(item)
    return out


class MotionTokenDataset:
    """(caption, padded motion codes, true length) samples for t2m training."""

    def __init__(
        self,
        root: str,
        split_file: str,
        tokenizer_name: str,
        nb_code: int = 512,
        max_motion_length: int = 55,   # 26 if unit_length == 8 else 51+4
        seed: int = 0,
    ):
        self.nb_code = nb_code
        self.mot_end_idx = nb_code           # EOM row
        self.mot_pad_idx = nb_code + 1       # PAD row
        self.max_motion_length = max_motion_length
        self.rng = random.Random(seed)
        self.np_rng = np.random.default_rng(seed)

        self.data: list[dict] = []
        for name in read_split(split_file):
            token_path = os.path.join(root, tokenizer_name, f"{name}.npy")
            text_path = os.path.join(root, "texts", f"{name}.txt")
            try:
                tokens = np.load(token_path)
                if tokens.ndim == 1:
                    tokens = tokens[None]
                texts = read_caption_file(text_path)
                if len(texts) == 0 or tokens.size == 0:
                    continue
                self.data.append(
                    {"m_token_list": [t for t in tokens], "text": texts}
                )
            except Exception as e:
                logger.warning("skipping %s: %s", name, e)

    def __len__(self) -> int:
        return len(self.data)

    def __getitem__(self, item: int):
        entry = self.data[item]
        m_tokens = np.asarray(self.rng.choice(entry["m_token_list"]))
        caption = self.rng.choice(entry["text"])["caption"]

        # 1/3 probability: drop one token at head or tail
        # (dataset_TM_train.py:119-127)
        if self.np_rng.choice([False, False, True]):
            if self.np_rng.choice([True, False]):
                m_tokens = m_tokens[:-1]
            else:
                m_tokens = m_tokens[1:]
        m_len = int(m_tokens.shape[0])

        if m_len + 1 < self.max_motion_length:
            padded = np.concatenate([
                m_tokens,
                [self.mot_end_idx],
                np.full(self.max_motion_length - 1 - m_len, self.mot_pad_idx),
            ])
        else:
            padded = np.concatenate([m_tokens, [self.mot_end_idx]])
        return caption, padded.astype(np.int64), m_len

    def __iter__(self) -> Iterator:
        while True:
            order = list(range(len(self.data)))
            self.rng.shuffle(order)
            for idx in order:
                yield self[idx]


class MotionVQDataset:
    """Random fixed windows of normalized raw motion features for VQ-VAE
    training (dataset_VQ.py)."""

    def __init__(
        self,
        root: str,
        split_file: str,
        window_size: int = 64,
        min_motion_len: int = 40,
        max_motion_len: int = 196,
        seed: int = 0,
    ):
        self.window_size = window_size
        self.rng = random.Random(seed)
        mean_path = os.path.join(root, "Mean.npy")
        std_path = os.path.join(root, "Std.npy")
        self.mean = np.load(mean_path) if os.path.exists(mean_path) else None
        self.std = np.load(std_path) if os.path.exists(std_path) else None

        self.motions: list[np.ndarray] = []
        for name in read_split(split_file):
            try:
                m = np.load(os.path.join(root, "new_joint_vecs", f"{name}.npy"))
                if m.shape[0] < min_motion_len or m.shape[0] >= max_motion_len + 4:
                    continue
                self.motions.append(m.astype(np.float32))
            except Exception as e:
                logger.warning("skipping %s: %s", name, e)

    def normalize(self, m: np.ndarray) -> np.ndarray:
        if self.mean is not None and self.std is not None:
            return (m - self.mean) / (self.std + 1e-8)
        return m

    def denormalize(self, m: np.ndarray) -> np.ndarray:
        if self.mean is not None and self.std is not None:
            return m * (self.std + 1e-8) + self.mean
        return m

    def __len__(self) -> int:
        return len(self.motions)

    def __getitem__(self, item: int) -> np.ndarray:
        m = self.motions[item]
        start = self.rng.randint(0, m.shape[0] - self.window_size)
        return self.normalize(m[start : start + self.window_size])

    def __iter__(self):
        while True:
            order = list(range(len(self.motions)))
            self.rng.shuffle(order)
            for idx in order:
                yield self[idx]


class MotionEvalDataset:
    """Evaluator-facing items: word vectors + POS one-hots + normalized
    motions + lengths (dataset_TM_eval.py)."""

    def __init__(
        self,
        root: str,
        split_file: str,
        word_vectorizer,
        max_text_len: int = 20,
        unit_length: int = 4,
        min_motion_len: int = 40,
        max_motion_length: int = 196,
    ):
        self.w_vectorizer = word_vectorizer
        self.max_text_len = max_text_len
        self.unit_length = unit_length
        self.max_motion_length = max_motion_length
        mean_path = os.path.join(root, "Mean.npy")
        std_path = os.path.join(root, "Std.npy")
        self.mean = np.load(mean_path) if os.path.exists(mean_path) else None
        self.std = np.load(std_path) if os.path.exists(std_path) else None

        self.items: list[dict] = []
        for name in read_split(split_file):
            try:
                m = np.load(os.path.join(root, "new_joint_vecs", f"{name}.npy"))
                if m.shape[0] < min_motion_len or m.shape[0] >= 200:
                    continue
                for text in read_caption_file(
                    os.path.join(root, "texts", f"{name}.txt")
                ):
                    self.items.append({"motion": m.astype(np.float32),
                                       "text": text, "name": name})
            except Exception as e:
                logger.warning("skipping %s: %s", name, e)

    def __len__(self) -> int:
        return len(self.items)

    def __getitem__(self, item: int):
        entry = self.items[item]
        motion = entry["motion"]
        m_len = (motion.shape[0] // self.unit_length) * self.unit_length
        motion = motion[:m_len]
        if self.mean is not None and self.std is not None:
            motion = (motion - self.mean) / (self.std + 1e-8)
        if m_len < self.max_motion_length:
            motion = np.concatenate([
                motion,
                np.zeros((self.max_motion_length - m_len, motion.shape[1]),
                         np.float32),
            ])

        tokens = entry["text"].get("tokens")
        caption = entry["text"]["caption"]
        if tokens is None:
            tokens = [f"{w}/OTHER" for w in caption.split(" ")]
        if len(tokens) < self.max_text_len:
            tokens = ["sos/OTHER"] + tokens + ["eos/OTHER"]
            sent_len = len(tokens)
            tokens += ["unk/OTHER"] * (self.max_text_len + 2 - sent_len)
        else:
            tokens = ["sos/OTHER"] + tokens[: self.max_text_len] + ["eos/OTHER"]
            sent_len = len(tokens)
        word_embs, pos_ohots = [], []
        for token in tokens:
            emb, pos = self.w_vectorizer[token]
            word_embs.append(emb)
            pos_ohots.append(pos)
        return {
            "word_embs": np.stack(word_embs).astype(np.float32),
            "pos_onehot": np.stack(pos_ohots).astype(np.float32),
            "caption": caption,
            "cap_len": sent_len,
            "motion": motion,
            "m_len": m_len,
            "name": entry["name"],
        }
