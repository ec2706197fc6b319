"""External caption joins for image-text tar shards.

A copy of `mmada_tpu/data/captions.py`: the same captions for the same
samples and seeds.

The reference's webdataset pipeline joins captions from outside the tars
(training/data.py:298-493): per-sample caption files (SA-1B/LAION/CC12M
caption directories), a JourneyDB json map, and CSV question/answer files
(ai2d/clevr/docvqa/geo) rendered with a chain-of-thought template. Each
factory here returns a `caption_fn(sample) -> str | None` for
`data/webdataset.WebDatasetReader` (None drops the sample).
"""

from __future__ import annotations

import csv
import json
import logging
import os
import random
from typing import Callable, Optional

logger = logging.getLogger(__name__)

COT_TEMPLATE = (
    "Question: {question}\n"
    "Answer the question with a detailed reasoning process.\n"
    "Reasoning: {reasoning}\n"
    "Answer: {answer}"
)

QA_TEMPLATE = "Question: {question}\nAnswer: {answer}"

CAPTION_PROMPTS = (
    "Describe the image.",
    "Please describe this image in detail.",
    "What is shown in this picture?",
    "Give a detailed description of the image.",
)


def caption_dir_join(caption_root: str, ext: str = ".txt") -> Callable:
    """Per-key caption files: `{caption_root}/{key}{ext}` (the SA-1B /
    laion-aesthetics / cc12m external caption layout)."""

    def fn(sample: dict) -> Optional[str]:
        key = os.path.basename(sample.get("__key__", ""))
        path = os.path.join(caption_root, key + ext)
        try:
            with open(path) as f:
                text = f.read().strip()
            return text or None
        except OSError:
            return None

    return fn


def journeydb_join(anno_json_path: str, key_field: str = "img_path",
                   caption_field: str = "prompt") -> Callable:
    """JourneyDB annotation json: list of records keyed by image path."""
    with open(anno_json_path) as f:
        records = json.load(f)
    table = {}
    for rec in records:
        key = os.path.splitext(os.path.basename(rec.get(key_field, "")))[0]
        if key:
            table[key] = rec.get(caption_field, "")

    def fn(sample: dict) -> Optional[str]:
        key = os.path.basename(sample.get("__key__", ""))
        return table.get(key) or None

    return fn


def qa_csv_join(
    csv_path: str,
    key_column: str = "image",
    question_column: str = "question",
    answer_column: str = "answer",
    reasoning_column: Optional[str] = None,
    use_cot: bool = False,
    seed: int = 0,
) -> Callable:
    """CSV QA joins (ai2d/clevr/docvqa/geo): one or more QA rows per image,
    rendered with the plain or chain-of-thought template."""
    table: dict[str, list[dict]] = {}
    with open(csv_path) as f:
        for row in csv.DictReader(f):
            key = os.path.splitext(os.path.basename(row.get(key_column, "")))[0]
            if key:
                table.setdefault(key, []).append(row)
    rng = random.Random(seed)

    def fn(sample: dict) -> Optional[str]:
        key = os.path.basename(sample.get("__key__", ""))
        rows = table.get(key)
        if not rows:
            return None
        row = rng.choice(rows)
        if use_cot and reasoning_column and row.get(reasoning_column):
            return COT_TEMPLATE.format(
                question=row[question_column],
                reasoning=row[reasoning_column],
                answer=row[answer_column],
            )
        return QA_TEMPLATE.format(
            question=row[question_column], answer=row[answer_column]
        )

    return fn


def add_caption_prompt(caption_fn: Optional[Callable] = None,
                       seed: int = 0) -> Callable:
    """Prefix a random captioning instruction (the reference's
    `add_caption_prompt` option, data.py / configs `add_caption_prompt`)."""
    rng = random.Random(seed)

    def fn(sample: dict) -> Optional[str]:
        base = (
            caption_fn(sample) if caption_fn is not None
            else sample.get("caption")
        )
        if base is None:
            return None
        return f"{rng.choice(CAPTION_PROMPTS)} {base}"

    return fn


def first_of(*fns: Callable) -> Callable:
    """Try caption sources in order; first non-None wins."""

    def fn(sample: dict) -> Optional[str]:
        for f in fns:
            out = f(sample)
            if out is not None:
                return out
        return None

    return fn
