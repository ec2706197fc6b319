"""VQA and reasoning-to-image datasets, and the stage-4 source mixture.

Counterpart of `mmada_tpu/data/vqa.py` (the reference's
parquet/my_dataset.py):

  * `VQADataset` (:298-422) — LLaVA-style json conversation files with an
    image per sample; a random turn boundary truncates the dialogue, the
    text renders through the chat template, and the image is
    squash-resized.
  * `R2iDataset` (:175-296) — (image, long caption, short caption) triples
    assembled into the "think a detailed description, then generate the
    image" reasoning prompt.
  * `MixedStream` — probability-weighted mixture of sample streams.

The same samples in the same order as JAX's for the same seed. The package
imports no PIL: `VQADataset` and `R2iDataset` take the image opener
(`open_image(path) -> image`, a loaded image) and the transform
(`transform(image, resolution) -> pixels`, the squash resize of
`image_transform_squash` in JAX).
"""

from __future__ import annotations

import json
import logging
import os
import random
from typing import Callable, Iterator, Optional

import numpy as np

logger = logging.getLogger(__name__)

R2I_PROMPT = (
    "You should first think about how to describe the image in detail, "
    "and then generate the image."
)

ImageOpener = Callable[[str], object]
Transform = Callable[[object, int], np.ndarray]


def render_chat(turns: list[dict], tokenizer=None) -> str:
    """llama3-style chat rendering; uses the tokenizer's template when
    available, else a plain header-tag format."""
    messages = [
        {
            "role": "user" if t.get("from") in ("human", "user") else "assistant",
            "content": t.get("value", ""),
        }
        for t in turns
    ]
    if tokenizer is not None and hasattr(tokenizer, "apply_chat_template"):
        try:
            return tokenizer.apply_chat_template(messages, tokenize=False)
        except Exception:  # a tokenizer whose template is missing or broken
            pass
    parts = []
    for m in messages:
        parts.append(
            f"<|start_header_id|>{m['role']}<|end_header_id|>\n"
            f"{m['content']}<|eot_id|>"
        )
    return "".join(parts)


class VQADataset:
    def __init__(
        self,
        json_path: str,
        image_root: str,
        tokenizer=None,
        resolution: int = 256,
        seed: int = 0,
        max_turns_truncation: bool = True,
        *,
        open_image: ImageOpener,
        transform: Transform,
    ):
        with open(json_path) as f:
            self.records = json.load(f)
        self.image_root = image_root
        self.tokenizer = tokenizer
        self.resolution = resolution
        self.rng = random.Random(seed)
        self.max_turns_truncation = max_turns_truncation
        self.open_image = open_image
        self.transform = transform

    def __len__(self) -> int:
        return len(self.records)

    def __getitem__(self, idx: int) -> Optional[dict]:
        rec = self.records[idx]
        conversations = rec.get("conversations", [])
        if self.max_turns_truncation and len(conversations) > 2:
            # random even truncation keeping at least one QA pair
            n_pairs = len(conversations) // 2
            keep = self.rng.randint(1, n_pairs)
            conversations = conversations[: keep * 2]
        text = render_chat(conversations, self.tokenizer)
        text = text.replace("<image>", "").strip()
        image_path = os.path.join(self.image_root, rec.get("image", ""))
        try:
            pixels = self.transform(self.open_image(image_path), self.resolution)
        except Exception as e:  # an unreadable image drops the sample
            logger.warning("bad VQA image %s: %s", image_path, e)
            return None
        return {"pixels": pixels, "caption": text}

    def __iter__(self) -> Iterator[dict]:
        while True:
            order = list(range(len(self.records)))
            self.rng.shuffle(order)
            for idx in order:
                sample = self[idx]
                if sample is not None:
                    yield sample


class R2iDataset:
    """(image, caption, short caption) -> reasoning prompt + image pixels."""

    def __init__(
        self,
        image_dir: str,
        caption_dir: str,
        short_caption_dir: str,
        resolution: int = 256,
        seed: int = 0,
        *,
        open_image: ImageOpener,
        transform: Transform,
    ):
        self.image_dir = image_dir
        self.caption_dir = caption_dir
        self.short_caption_dir = short_caption_dir
        self.resolution = resolution
        self.rng = random.Random(seed)
        self.open_image = open_image
        self.transform = transform
        self.names = sorted(
            os.path.splitext(f)[0]
            for f in os.listdir(image_dir)
            if f.lower().endswith((".jpg", ".jpeg", ".png", ".webp"))
        )

    def __len__(self) -> int:
        return len(self.names)

    def _read_text(self, root: str, name: str) -> str:
        path = os.path.join(root, f"{name}.txt")
        with open(path) as f:
            return f.read().strip()

    def __getitem__(self, idx: int) -> Optional[dict]:
        name = self.names[idx]
        try:
            for ext in (".jpg", ".jpeg", ".png", ".webp"):
                path = os.path.join(self.image_dir, name + ext)
                if os.path.exists(path):
                    break
            pixels = self.transform(self.open_image(path), self.resolution)
            caption = self._read_text(self.caption_dir, name)
            short = self._read_text(self.short_caption_dir, name)
        except Exception as e:  # an unreadable image or caption drops the sample
            logger.warning("bad r2i sample %s: %s", name, e)
            return None
        text = (
            f"{short}\n{R2I_PROMPT}\n<think>{caption}</think>"
        )
        return {"pixels": pixels, "caption": text}

    def __iter__(self) -> Iterator[dict]:
        while True:
            order = list(range(len(self.names)))
            self.rng.shuffle(order)
            for idx in order:
                sample = self[idx]
                if sample is not None:
                    yield sample


class MixedStream:
    """Probability-weighted mixture of sample streams — the stage-4 source
    mixing (`{base,instruct}_in_lm_coeff`, `{cot,vqa,clevr2,geo}_in_mmu_coeff`,
    train_mmada_stage4.py:636,694)."""

    def __init__(self, streams: dict[str, Iterator], weights: dict[str, float],
                 seed: int = 0):
        if set(streams) != set(weights):
            raise ValueError(f"streams {sorted(streams)} and weights {sorted(weights)} differ")
        self.names = list(streams)
        self.iters = {k: iter(v) for k, v in streams.items()}
        total = sum(weights.values())
        self.probs = [weights[k] / total for k in self.names]
        self.rng = np.random.default_rng(seed)

    def __iter__(self):
        while True:
            name = self.rng.choice(self.names, p=self.probs)
            yield next(self.iters[name])
