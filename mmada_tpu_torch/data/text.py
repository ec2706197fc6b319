"""Streaming text datasets over parquet shards.

A copy of `mmada_tpu/data/text.py`: the same samples in the same order for
the same seed; `pyarrow` is imported only when a file is read.

Equivalents of the reference's parquet pipelines (parquet/my_dataset.py):

  * `RefinedWebDataset` (:15-89) — iterate `content` column across parquet
    files, shard files per host `files[rank::world_size]`, random-crop long
    documents to `max_length` characters, shuffle buffer, infinite repeat.
  * `ChatDataset` (:91-173) — conversations pre-rendered to chat text,
    filtered by tokenized length.

Implemented on pyarrow with explicit `random.Random` streams; crash-tolerant like the
reference (bad files logged and skipped).
"""

from __future__ import annotations

import glob
import logging
import random
from typing import Iterator, Optional


logger = logging.getLogger(__name__)


def expand_files(path_or_paths) -> list[str]:
    if isinstance(path_or_paths, str):
        path_or_paths = [path_or_paths]
    files: list[str] = []
    for p in path_or_paths:
        hits = sorted(glob.glob(p))
        files.extend(hits if hits else [p])
    return files


class _ShuffleBuffer:
    def __init__(self, size: int, rng: random.Random):
        self.size = size
        self.rng = rng
        self.buf: list = []

    def push(self, item) -> Optional[object]:
        if self.size <= 1:
            return item
        self.buf.append(item)
        if len(self.buf) >= self.size:
            idx = self.rng.randrange(len(self.buf))
            self.buf[idx], self.buf[-1] = self.buf[-1], self.buf[idx]
            return self.buf.pop()
        return None

    def drain(self):
        self.rng.shuffle(self.buf)
        yield from self.buf
        self.buf = []


class RefinedWebDataset:
    """Infinite iterator of {'input_ids': str} samples (the reference yields
    raw text under the 'input_ids' key, my_dataset.py:63-78)."""

    def __init__(
        self,
        data_path,
        rank: int = 0,
        world_size: int = 1,
        max_length: int = 8000,
        shuffle_buffer: int = 1000,
        seed: int = 0,
        column: str = "content",
        repeat: bool = True,
    ):
        self.files = expand_files(data_path)[rank::world_size]
        if not self.files:
            raise ValueError(f"no parquet files for rank {rank}: {data_path}")
        self.max_length = max_length
        self.shuffle_buffer = shuffle_buffer
        self.seed = seed
        self.column = column
        self.repeat = repeat

    def _iter_texts(self, epoch: int) -> Iterator[str]:
        import pyarrow.parquet as pq

        files = list(self.files)
        rng = random.Random(self.seed + epoch)
        rng.shuffle(files)
        for path in files:
            try:
                pf = pq.ParquetFile(path)
                for batch in pf.iter_batches(
                    batch_size=256, columns=[self.column]
                ):
                    for text in batch.column(0).to_pylist():
                        if text:
                            yield text
            except Exception as e:  # crash-tolerant streaming
                logger.warning("skipping bad parquet %s: %s", path, e)

    def __iter__(self):
        epoch = 0
        rng = random.Random(self.seed)
        buf = _ShuffleBuffer(self.shuffle_buffer, rng)
        while True:
            for text in self._iter_texts(epoch):
                if len(text) > self.max_length:
                    start = rng.randrange(len(text) - self.max_length)
                    text = text[start : start + self.max_length]
                out = buf.push({"input_ids": text})
                if out is not None:
                    yield out
            if not self.repeat:
                yield from buf.drain()
                return
            epoch += 1


class ChatDataset(RefinedWebDataset):
    """Chat-formatted text stream with a tokenizer length filter
    (my_dataset.py:91-173)."""

    def __init__(self, data_path, tokenizer=None, max_token_length: int = 512,
                 column: str = "text", **kw):
        super().__init__(data_path, column=column, **kw)
        self.tokenizer = tokenizer
        self.max_token_length = max_token_length

    def __iter__(self):
        for sample in super().__iter__():
            if self.tokenizer is not None:
                n = len(self.tokenizer([sample["input_ids"]])["input_ids"][0])
                if n > self.max_token_length:
                    continue
            yield sample


def batched(iterator, batch_size: int) -> Iterator[list]:
    batch = []
    for item in iterator:
        batch.append(item)
        if len(batch) == batch_size:
            yield batch
            batch = []
