"""ImageNet folder dataset with label-text captions.

Counterpart of `mmada_tpu/data/imagenet.py` (the reference's
training/imagenet_dataset.py:24-78: a DatasetFolder whose caption is the
class-name text from `imagenet_label_mapping`; an unreadable image retries
the next index). The same samples in the same order for the same seed. The
package imports no PIL, so the dataset takes the image opener
(`open_image(path) -> image`, a loaded image) and the transform
(`transform(image, resolution) -> (resolution, resolution, 3)` float32 in
[-1, 1]); the command line passes PIL's (`train_torch`).
"""

from __future__ import annotations

import logging
import os
import random
from typing import Callable, Optional

import numpy as np

logger = logging.getLogger(__name__)

IMG_EXTS = (".jpg", ".jpeg", ".png", ".webp")


def load_label_mapping(path: Optional[str]) -> dict[str, str]:
    """`<wnid> <class text>` lines (reference imagenet_label_mapping file)."""
    mapping: dict[str, str] = {}
    if path and os.path.exists(path):
        with open(path) as f:
            for line in f:
                parts = line.strip().split(maxsplit=1)
                if len(parts) == 2:
                    mapping[parts[0]] = parts[1]
    return mapping


class ImageNetDataset:
    def __init__(
        self,
        root: str,
        label_mapping_path: Optional[str] = None,
        resolution: int = 256,
        rank: int = 0,
        world_size: int = 1,
        seed: int = 0,
        shuffle: bool = True,
        *,
        open_image: Callable[[str], object],
        transform: Callable[[object, int], np.ndarray],
    ):
        self.root = root
        self.resolution = resolution
        self.open_image = open_image
        self.transform = transform
        self.mapping = load_label_mapping(label_mapping_path)
        samples = []
        for cls in sorted(os.listdir(root)):
            cls_dir = os.path.join(root, cls)
            if not os.path.isdir(cls_dir):
                continue
            for fname in sorted(os.listdir(cls_dir)):
                if fname.lower().endswith(IMG_EXTS):
                    samples.append((os.path.join(cls_dir, fname), cls))
        self.samples = samples[rank::world_size]
        self.seed = seed
        self.shuffle = shuffle

    def __len__(self) -> int:
        return len(self.samples)

    def caption_for(self, cls: str) -> str:
        return self.mapping.get(cls, cls.replace("_", " "))

    def __getitem__(self, idx: int) -> dict:
        # error-tolerant: retry next index (imagenet_dataset.py:65-67)
        for offset in range(len(self.samples)):
            path, cls = self.samples[(idx + offset) % len(self.samples)]
            try:
                pixels = self.transform(self.open_image(path), self.resolution)
                return {"pixels": pixels, "caption": self.caption_for(cls)}
            except Exception as e:  # any unreadable file: the next index
                logger.warning("bad image %s: %s", path, e)
        raise RuntimeError("no readable images in dataset")

    def __iter__(self):
        rng = random.Random(self.seed)
        while True:
            order = list(range(len(self.samples)))
            if self.shuffle:
                rng.shuffle(order)
            for idx in order:
                yield self[idx]


def collate_imagenet(batch: list[dict]) -> dict:
    return {
        "images": np.stack([s["pixels"] for s in batch]),
        "input_ids": [s["caption"] for s in batch],
    }
