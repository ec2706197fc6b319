"""UniversalPrompting: the text, t2i, mmu and r2i sequence layouts.

Counterpart of `mmada_tpu/prompting/universal.py` but for the motion frame
(t2m), in pure numpy:

  t2i      [pad]* <|t2i|> <bos> text <eos> <|soi|> img <|eoi|>
  t2i_gen  same frame, no labels
  lm       text <eos> [<eos> padding]
  lm_chat  same ids; mask = prompt up to last <|end_header_id|>
  mmu      <|mmu|> <|soi|> img <|eoi|> <bos> text <eos> [<eos> padding]
  mmu_gen  same frame, no labels
  r2i      <|r2i|> <bos> text <eos> [<eos> padding] <|soi|> img <|eoi|>

The text tokenizer is injected (duck-typed: `__call__(list[str])` -> dict
with 'input_ids'); tests and the smoke run use the deterministic
`ByteTokenizer`.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np

from mmada_tpu_torch.core.vocab import RESERVED_TOKENS, VocabLayout

IGNORE_ID = -100


@dataclasses.dataclass
class SpecialIds:
    soi: int
    eoi: int
    t2i: int
    mmu: int
    r2i: int
    t2m: int
    som: int
    eom: int
    pad: int      # [iPAD]
    bos: int      # <|sot|>
    eos: int      # <|eot|>
    end_header: Optional[int] = None  # llama3-style <|end_header_id|>

    @classmethod
    def from_vocab(cls, vocab: VocabLayout, end_header: Optional[int] = None):
        return cls(
            soi=RESERVED_TOKENS["<|soi|>"],
            eoi=RESERVED_TOKENS["<|eoi|>"],
            t2i=RESERVED_TOKENS["<|t2i|>"],
            mmu=RESERVED_TOKENS["<|mmu|>"],
            r2i=RESERVED_TOKENS["<|r2i|>"],
            t2m=RESERVED_TOKENS["<|t2m|>"],
            som=RESERVED_TOKENS["<|som|>"],
            eom=RESERVED_TOKENS["<|eom|>"],
            pad=vocab.pad_token_id,
            bos=vocab.bos_token_id,
            eos=vocab.eos_token_id,
            end_header=end_header,
        )


class UniversalPrompting:
    """Task-keyed sequence assembler (reference __call__ dispatch,
    prompting_utils.py:482-541)."""

    TASKS = ("t2i", "t2i_gen", "lm", "lm_chat", "mmu", "mmu_gen", "r2i")

    def __init__(
        self,
        text_tokenizer,
        special_ids: SpecialIds,
        max_text_len: int = 512,
        ignore_id: int = IGNORE_ID,
        cond_dropout_prob: float = 0.1,
        rng: Optional[np.random.Generator] = None,
    ):
        self.text_tokenizer = text_tokenizer
        self.sp = special_ids
        # reference stores max_text_len + 1 ("plus 1 because ... task token")
        self.max_text_len = max_text_len + 1
        self.ignore_id = ignore_id
        self.cond_dropout_prob = cond_dropout_prob
        self.rng = rng or np.random.default_rng(0)

    # ------------------------------------------------------------- helpers
    def _tokenize(self, texts: Sequence[str]) -> list[list[int]]:
        out = self.text_tokenizer(list(texts))
        return [list(ids) for ids in out["input_ids"]]

    def _with_bos(self, ids: list[int]) -> list[int]:
        if not ids:
            return [self.sp.bos]
        if ids[0] != self.sp.bos:
            return [self.sp.bos] + ids
        return ids

    def _padded_text_frame(self, ids: list[int], task_token: int,
                           drop: bool) -> tuple[list[int], int]:
        """`[pad]* task <bos> text <eos>` of fixed len max_text_len; returns
        (frame, pad_len)."""
        ids = self._with_bos(ids)
        frame = [task_token] + ids + [self.sp.eos]
        if drop:
            frame = [task_token, self.sp.bos, self.sp.eos]
        if len(frame) <= self.max_text_len:
            pad_len = self.max_text_len - len(frame)
            return [self.sp.pad] * pad_len + frame, pad_len
        return frame[: self.max_text_len - 1] + [self.sp.eos], 0

    def _last_end_header(self, ids: Sequence[int]) -> int:
        if self.sp.end_header is None:
            return -1
        arr = np.asarray(ids)
        hits = np.nonzero(arr == self.sp.end_header)[0]
        return int(hits[-1]) if len(hits) else -1

    # ---------------------------------------------------------------- t2i
    def t2i(self, texts, image_ids: np.ndarray, labels: np.ndarray,
            dropout: bool = True):
        """Returns (input_ids, attention_mask, label_ids); image_ids/labels
        are fused-space `(B, N)`."""
        token_lists = self._tokenize(texts)
        b, n = image_ids.shape
        drops = (
            self.rng.random(b) < self.cond_dropout_prob if dropout
            else np.zeros(b, bool)
        )
        seqs, masks, labs = [], [], []
        for i in range(b):
            frame, pad_len = self._padded_text_frame(
                token_lists[i], self.sp.t2i, bool(drops[i])
            )
            seq = np.concatenate(
                [frame, [self.sp.soi], image_ids[i], [self.sp.eoi]]
            ).astype(np.int64)
            lab = np.concatenate(
                [frame, [self.sp.soi], labels[i], [self.sp.eoi]]
            ).astype(np.int64)
            lab = np.where(lab == self.sp.pad, self.ignore_id, lab)
            mask = np.concatenate(
                [np.zeros(pad_len, np.int64), np.ones(len(seq) - pad_len, np.int64)]
            )
            seqs.append(seq), masks.append(mask), labs.append(lab)
        return np.stack(seqs), np.stack(masks), np.stack(labs)

    def t2i_gen(self, texts, image_ids: np.ndarray):
        ids, mask, _ = self.t2i(texts, image_ids, image_ids, dropout=False)
        return ids, mask

    def t2i_gen_uncond(self, batch_size: int, num_vq_tokens: int, mask_id: int):
        """Empty-prompt CFG frame (inference_t2i.py:95-100 semantics)."""
        ids, mask = self.t2i_gen(
            [""] * batch_size,
            np.full((batch_size, num_vq_tokens), mask_id, np.int64),
        )
        return ids, mask

    # ----------------------------------------------------------------- lm
    def lm(self, texts, max_seq_len: int):
        token_lists = self._tokenize(texts)
        seqs, masks, labs = [], [], []
        for ids in token_lists:
            ids = self._with_bos(ids) + [self.sp.eos]
            if len(ids) <= max_seq_len:
                n_pad = max_seq_len - len(ids)
                mask = [1] * len(ids) + [0] * n_pad
                ids = ids + [self.sp.eos] * n_pad
            else:
                ids = ids[:max_seq_len]
                mask = [1] * max_seq_len
            seqs.append(ids), masks.append(mask), labs.append(list(ids))
        return (
            np.asarray(seqs, np.int64),
            np.asarray(masks, np.int64),
            np.asarray(labs, np.int64),
        )

    def lm_chat(self, texts, max_seq_len: int):
        """Returns (input_ids, prompt_masks, labels): prompt mask covers up
        to the last <|end_header_id|> (positions kept un-noised in training,
        prompting_utils.py:271-314)."""
        ids, _, labs = self.lm(texts, max_seq_len)
        prompt_masks = np.zeros_like(ids)
        for i in range(ids.shape[0]):
            pos = self._last_end_header(ids[i])
            prompt_len = pos + 1 if pos != -1 else 0
            prompt_masks[i, :prompt_len] = 1
        return ids, prompt_masks, labs

    # ---------------------------------------------------------------- mmu
    def mmu(self, image_ids: np.ndarray, texts):
        """Returns (input_ids, prompt_masks, labels): the prompt mask covers
        the image frame and the text up to the last <|end_header_id|>
        (prompting_utils.py:316-425)."""
        token_lists = self._tokenize(texts)
        b, n = image_ids.shape
        max_text_len = self.max_text_len - 1
        seqs, pmasks, labs = [], [], []
        for i in range(b):
            ids = self._with_bos(token_lists[i]) + [self.sp.eos]
            if len(ids) <= max_text_len:
                ids = ids + [self.sp.eos] * (max_text_len - len(ids))
            else:
                ids = ids[: max_text_len - 1] + [self.sp.eos]
            seq = np.concatenate([
                [self.sp.mmu, self.sp.soi], image_ids[i], [self.sp.eoi], ids
            ]).astype(np.int64)
            lab = np.concatenate([
                [self.ignore_id, self.ignore_id],
                np.full(n, self.ignore_id),
                [self.ignore_id],
                ids,
            ]).astype(np.int64)
            lab = np.where(lab == self.sp.pad, self.ignore_id, lab)
            pos = self._last_end_header(ids)
            frame_len = len(seq) - len(ids)
            prompt_len = frame_len + (pos + 1 if pos != -1 else 0)
            pm = np.zeros(len(seq), np.int64)
            pm[:prompt_len] = 1
            seqs.append(seq), pmasks.append(pm), labs.append(lab)
        return np.stack(seqs), np.stack(pmasks), np.stack(labs)

    def mmu_gen(self, image_ids: np.ndarray, texts):
        """The mmu frame and its prompt mask, without labels."""
        ids, pmask, _ = self.mmu(image_ids, texts)
        return ids, pmask

    # ---------------------------------------------------------------- r2i
    def r2i(self, image_ids: np.ndarray, texts):
        """Returns (input_ids, prompt_masks, labels = input_ids): the prompt
        mask covers the task token, the text up to the last
        <|end_header_id|> (else all of it) and <|soi|> and <|eoi|>."""
        token_lists = self._tokenize(texts)
        b, n = image_ids.shape
        max_text_len = self.max_text_len - 1
        seqs, pmasks = [], []
        for i in range(b):
            ids = self._with_bos(token_lists[i]) + [self.sp.eos]
            if len(ids) <= max_text_len:
                ids = ids + [self.sp.eos] * (max_text_len - len(ids))
            else:
                ids = ids[: max_text_len - 1] + [self.sp.eos]
            seq = np.concatenate([
                [self.sp.r2i], ids, [self.sp.soi], image_ids[i], [self.sp.eoi]
            ]).astype(np.int64)
            pm = np.zeros(len(seq), np.int64)
            pm[0] = 1
            pos = self._last_end_header(ids)
            if pos != -1:
                pm[1 : pos + 2] = 1
            else:
                pm[1 : len(ids) + 1] = 1
            pm[len(ids) + 1] = 1                  # <|soi|>
            pm[len(ids) + 2 + n] = 1              # <|eoi|>
            seqs.append(seq), pmasks.append(pm)
        seqs = np.stack(seqs)
        return seqs, np.stack(pmasks), seqs.copy()

    # ------------------------------------------------------------ dispatch
    def __call__(self, inputs, task: str, **kwargs):
        if task == "t2i":
            return self.t2i(*inputs, **kwargs)
        if task == "t2i_gen":
            return self.t2i_gen(*inputs)
        if task == "lm":
            return self.lm(*inputs)
        if task == "lm_chat":
            return self.lm_chat(*inputs)
        if task == "mmu":
            return self.mmu(*inputs)
        if task == "mmu_gen":
            return self.mmu_gen(*inputs)
        if task == "r2i":
            return self.r2i(*inputs)
        raise NotImplementedError(f"unknown task: {task}")


class ByteTokenizer:
    """Deterministic toy tokenizer for tests: bytes offset into [16, 16+256)."""

    def __init__(self, bos: int = 1, eos: int = 2, offset: int = 16):
        self.bos_token_id = bos
        self.eos_token_id = eos
        self.offset = offset

    def __call__(self, texts, **kwargs):
        return {
            "input_ids": [
                [self.offset + b for b in t.encode("utf-8")] for t in texts
            ]
        }

    def decode(self, ids):
        return bytes(
            i - self.offset
            for i in ids
            if self.offset <= i < self.offset + 256
        ).decode("utf-8", errors="replace")

    def __len__(self):
        return self.offset + 256
