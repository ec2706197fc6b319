"""Webdataset-style tar streaming for image-text shards.

Counterpart of `mmada_tpu/data/webdataset.py` (the reference's `wds`
pipeline, training/data.py:64-300): brace-expanded shard lists, resampled
shard order, nothrow tar expansion grouped by sample key, image decode,
external caption joins, filter, batch. The same samples in the same order as
JAX's reader for the same seed. The one change: the package imports no PIL,
so `decode_sample` and `WebDatasetReader` take the image opener as an
argument, `open_image(file) -> image` (a loaded image, from a binary file
object); the command line passes PIL's (`train_torch.open_image`).

The tar members come from the threaded C++ streamer (`data/native.py`,
`native/tario.cc`) when it builds, else from Python's `tarfile`, as in JAX;
`WebDatasetReader.native` says which one the reader took.
"""

from __future__ import annotations

import io
import json
import logging
import random
import re
import tarfile
from typing import Callable, Iterator, Optional

import numpy as np

from mmada_tpu_torch.data.text import _ShuffleBuffer

logger = logging.getLogger(__name__)

_BRACE_RE = re.compile(r"\{(\d+)\.\.(\d+)\}")

IMAGE_EXTS = ("jpg", "jpeg", "png", "webp")
TEXT_EXTS = ("txt", "text", "caption")
JSON_EXTS = ("json",)

ImageOpener = Callable[[io.BufferedIOBase], object]


def brace_expand(pattern: str) -> list[str]:
    """`shard-{0000..0099}.tar` → 100 paths (webdataset shard syntax)."""
    m = _BRACE_RE.search(pattern)
    if not m:
        return [pattern]
    lo, hi = m.group(1), m.group(2)
    width = len(lo)
    out = []
    for i in range(int(lo), int(hi) + 1):
        expanded = pattern[: m.start()] + str(i).zfill(width) + pattern[m.end():]
        out.extend(brace_expand(expanded))
    return out


def expand_shards(urls) -> list[str]:
    if isinstance(urls, str):
        urls = [urls]
    shards: list[str] = []
    for u in urls:
        shards.extend(brace_expand(u))
    return shards


def split_wds_name(name: str) -> tuple[str, str]:
    """webdataset keying: split at the FIRST dot of the basename, so
    `dir/000123.caption.txt` → key `dir/000123`, ext `caption.txt`
    (the reference's wds grouping convention, data.py:64-100)."""
    slash = name.rfind("/")
    dot = name.find(".", slash + 1)
    if dot == -1:
        return "", ""
    return name[:dot], name[dot + 1:].lower()


def _group_tar_samples(tar: tarfile.TarFile) -> Iterator[dict]:
    """Group tar members by basename-without-extension (webdataset keying);
    nothrow semantics — corrupt members are skipped with a warning
    (data.py:64-100)."""
    current_key, sample = None, {}
    for member in tar:
        if not member.isfile():
            continue
        name = member.name
        key, ext = split_wds_name(name)
        if not key:
            continue
        if current_key is not None and key != current_key and sample:
            yield dict(sample, __key__=current_key)
            sample = {}
        current_key = key
        try:
            data = tar.extractfile(member).read()
            sample[ext.lower()] = data
        except Exception as e:  # nothrow: a corrupt member drops only itself
            logger.warning("bad tar member %s: %s", name, e)
    if sample:
        yield dict(sample, __key__=current_key)


def decode_sample(raw: dict, open_image: ImageOpener) -> Optional[dict]:
    """bytes → {'image': open_image(bytes), 'caption': str, 'json': dict,
    '__key__'}; None where a part fails to decode."""
    out = {"__key__": raw.get("__key__", "")}
    for ext, data in raw.items():
        if ext == "__key__":
            continue
        # multi-part extensions ('caption.txt') dispatch on the last part
        ext = ext.rsplit(".", 1)[-1]
        try:
            if ext in IMAGE_EXTS:
                out["image"] = open_image(io.BytesIO(data))
            elif ext in TEXT_EXTS:
                out["caption"] = data.decode("utf-8", errors="replace").strip()
            elif ext in JSON_EXTS:
                out["json"] = json.loads(data)
        except Exception as e:  # nothrow: a sample that fails to decode is dropped
            logger.warning("decode failure (%s): %s", ext, e)
            return None
    return out


class WebDatasetReader:
    """Resampled-shard tar stream with optional caption join and transform.

    caption_fn(sample) -> str | None: external caption lookup (the
    reference joins SA-1B/laion/cc12m caption files and VQA CSVs,
    data.py:298-493). Return None to drop the sample. `native` is True when
    the C++ streamer reads the tars, False for Python's `tarfile`.
    """

    def __init__(
        self,
        shards,
        open_image: ImageOpener,
        rank: int = 0,
        world_size: int = 1,
        shuffle_buffer: int = 1000,
        seed: int = 0,
        resample: bool = True,
        transform: Optional[Callable] = None,
        caption_fn: Optional[Callable] = None,
        max_caption_len: Optional[int] = None,
        use_native: bool = True,
        native_threads: int = 4,
    ):
        self.shards = expand_shards(shards)[rank::world_size]
        if not self.shards:
            raise ValueError("no shards for this rank")
        self.open_image = open_image
        self.shuffle_buffer = shuffle_buffer
        self.seed = seed
        self.resample = resample
        self.transform = transform
        self.caption_fn = caption_fn
        self.max_caption_len = max_caption_len
        self.native_threads = native_threads
        self._native = None
        if use_native:
            from mmada_tpu_torch.data import native as native_mod

            if native_mod.available():
                self._native = native_mod
        self.native = self._native is not None
        logger.info("WebDatasetReader over %d shard(s): %s", len(self.shards),
                    "native tar streamer" if self.native else "Python tarfile")

    def __iter__(self) -> Iterator[dict]:
        rng = random.Random(self.seed)
        buf = _ShuffleBuffer(self.shuffle_buffer, rng)
        while True:
            shards = list(self.shards)
            if self.resample:
                shards = [rng.choice(shards) for _ in shards]
            else:
                rng.shuffle(shards)
            for raw in self._iter_raw(shards):
                sample = decode_sample(raw, self.open_image)
                if sample is None:
                    continue
                prepared = self._prepare(sample)
                if prepared is None:
                    continue
                out = buf.push(prepared)
                if out is not None:
                    yield out
            if not self.resample:
                yield from buf.drain()
                return

    def _iter_raw(self, shards: list[str]) -> Iterator[dict]:
        """Raw grouped samples: the native C++ threaded streamer when built
        (data/native.py), Python tarfile otherwise."""
        if self._native is not None:
            reader = self._native.NativeTarReader(shards, threads=self.native_threads)
            try:
                yield from reader
            finally:
                reader.close()
            return
        for shard in shards:
            try:
                with tarfile.open(shard, mode="r|*") as tar:
                    yield from _group_tar_samples(tar)
            except Exception as e:  # nothrow: a bad shard is skipped
                logger.warning("skipping bad shard %s: %s", shard, e)

    def _prepare(self, sample: dict) -> Optional[dict]:
        if "image" not in sample:
            return None
        if self.caption_fn is not None:
            caption = self.caption_fn(sample)
            if caption is None:
                return None
            sample["caption"] = caption
        caption = sample.get("caption", "")
        if self.max_caption_len and len(caption) > self.max_caption_len:
            return None
        if self.transform is not None:
            sample["pixels"] = self.transform(sample["image"])
            sample.pop("image")
        return sample


def collate_image_text(batch: list[dict]) -> dict:
    return {
        "images": np.stack([s["pixels"] for s in batch]),
        "input_ids": [s.get("caption", "") for s in batch],
    }
