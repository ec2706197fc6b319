"""Structured synthetic data: learnable flows for on-chip proxy training.

A copy of `mmada_tpu/data/synthetic.py`: the same images, captions, text
batches and motion clips (`motion_clip`, `motion_caption`, which feed the
motion VQ-VAE and text-to-motion training) for the same seeds.

The zero-egress environment has no real corpora, and the plain
`dataset.synthetic` smoke flows (train.py) are *unlearnable* (random-noise
images) — fine for smoke tests, useless for producing a model whose greedy
top-1 margins separate. These flows are deterministic and low-entropy, so
a mid-scale model trained on them becomes *confident*, which is exactly
what the fast-decode/quantization promotion gates need (QUANT_r02.json's
"margin starvation" note): on random weights argmax agreement is
uninformative; on a model trained here it is a real promote/demote signal.

Design:
  * `pattern_image(k, res)` — procedural image for pattern id k
    (stripes/checker/rings with k-derived geometry+colors), identical
    across epochs. Through ANY fixed VQ encoder (including the random-init
    MAGVIT-v2 used here) each pattern maps to one fixed code grid, so
    caption -> codes is a deterministic, memorizable mapping.
  * captions name the pattern in words ("pattern zero four two") — the
    ByteTokenizer spells them out character-level.
  * `sentence(i)` — templated text bank; given a few characters of
    context the rest of the sentence is deterministic.

Flow dicts match the Trainer.prepare_batch contract
(t2i/mmu: {"images", "input_ids"}; lm: {"input_ids"}).
"""

from __future__ import annotations

import numpy as np

_DIGITS = ["zero", "one", "two", "three", "four", "five", "six", "seven",
           "eight", "nine"]

_ADJ = ["red", "blue", "green", "small", "large", "quiet", "bright",
        "heavy"]
_NOUN = ["fox", "river", "stone", "cloud", "lantern", "engine", "garden",
         "window"]
_VERB = ["crosses", "watches", "follows", "carries", "circles", "guards",
         "paints", "measures"]


def caption_for(k: int) -> str:
    digits = " ".join(_DIGITS[int(c)] for c in f"{k:03d}")
    return f"pattern {digits}"


def pattern_image(k: int, resolution: int) -> np.ndarray:
    """Deterministic (H, W, 3) float32 image in [-1, 1] for pattern id k."""
    rng = np.random.default_rng(1000 + k)
    yy, xx = np.mgrid[0:resolution, 0:resolution].astype(np.float32)
    yy, xx = yy / resolution, xx / resolution
    kind = k % 3
    period = 2 + (k // 3) % 6
    angle = (k * 37) % 180 / 180.0 * np.pi
    u = xx * np.cos(angle) + yy * np.sin(angle)
    if kind == 0:       # stripes
        field = np.sin(2 * np.pi * period * u)
    elif kind == 1:     # checkerboard
        v = -xx * np.sin(angle) + yy * np.cos(angle)
        field = np.sign(np.sin(2 * np.pi * period * u)
                        * np.sin(2 * np.pi * period * v))
    else:               # rings
        r = np.sqrt((xx - 0.5) ** 2 + (yy - 0.5) ** 2)
        field = np.sin(2 * np.pi * period * 2 * r)
    c0 = rng.uniform(-1, 1, size=3).astype(np.float32)
    c1 = rng.uniform(-1, 1, size=3).astype(np.float32)
    w = ((field + 1.0) / 2.0)[..., None]
    return (c0 * (1 - w) + c1 * w).astype(np.float32)


def sentence(i: int) -> str:
    a = _ADJ[i % len(_ADJ)]
    n1 = _NOUN[(i // 8) % len(_NOUN)]
    v = _VERB[(i // 64) % len(_VERB)]
    n2 = _NOUN[(3 * i + 1) % len(_NOUN)]
    digits = " ".join(_DIGITS[int(c)] for c in f"{i:03d}")
    return f"story {digits} : the {a} {n1} {v} the {n2} ."


class PatternBank:
    """Pre-rendered pattern images (rendering 512px floats per step would
    dominate host time)."""

    def __init__(self, n_patterns: int, resolution: int):
        self.n = n_patterns
        self.images = np.stack(
            [pattern_image(k, resolution) for k in range(n_patterns)]
        )
        self.captions = [caption_for(k) for k in range(n_patterns)]

    def batches(self, batch_size: int, seed: int = 0):
        rng = np.random.default_rng(seed)
        while True:
            ks = rng.integers(0, self.n, size=batch_size)
            yield {
                "images": self.images[ks],
                "input_ids": [self.captions[k] for k in ks],
                # pattern id = content hash: images are deterministic per
                # id, so the trainer's VQ-code cache can skip re-encoding
                "cache_keys": [int(k) for k in ks],
            }


def text_batches(batch_size: int, n_sentences: int = 64, seed: int = 1,
                 pack_chars: int = 0):
    """`pack_chars > 0` concatenates randomly-drawn bank sentences up to
    ~pack_chars characters per row, the way real LM corpora fill the
    training frame. Without it, a ~60-char sentence inside the t2i-sized
    concat frame (1090 tokens for the 512px proxy) drowns in EOS padding:
    the reference keeps pad positions in the lm loss
    (prompting_utils.py:249-250), so masked positions are ~95% EOS and
    the model learns "masked → EOS" instead of the text (proxy campaign B
    plateaued at loss_lm ≈ 0.12 with 0% infill accuracy; packing is the
    data-side fix that keeps loss semantics reference-faithful)."""
    rng = np.random.default_rng(seed)
    bank = [sentence(i) for i in range(n_sentences)]
    while True:
        rows = []
        for _ in range(batch_size):
            if pack_chars > 0:
                parts = [bank[rng.integers(0, n_sentences)]]
                while sum(len(p) + 1 for p in parts) < pack_chars:
                    parts.append(bank[rng.integers(0, n_sentences)])
                rows.append(" ".join(parts))
            else:
                rows.append(bank[rng.integers(0, n_sentences)])
        yield {"input_ids": rows}


def motion_clip(k: int, length: int = 192, pose_dim: int = 263) -> np.ndarray:
    """Deterministic smooth motion clip for pattern id k: a rank-4
    superposition of sinusoids (k-derived frequencies/phases) mixed into
    pose_dim channels. The motion analog of `pattern_image`: through ANY
    fixed VQ encoder each clip maps to one fixed code sequence, so
    caption -> codes is a memorizable mapping."""
    rng = np.random.default_rng(1000 + k)
    t = np.arange(length, dtype=np.float32)[:, None] / 32.0
    freqs = rng.uniform(0.3, 2.0, size=(1, 4)).astype(np.float32)
    phases = rng.uniform(0, 2 * np.pi, size=(1, 4)).astype(np.float32)
    basis = np.sin(2 * np.pi * freqs * t + phases)           # (length, 4)
    mix = (rng.normal(size=(4, pose_dim)) * 0.5).astype(np.float32)
    return (basis @ mix).astype(np.float32)


def motion_caption(k: int) -> str:
    v = _VERB[k % len(_VERB)]
    digits = " ".join(_DIGITS[int(c)] for c in f"{k:03d}")
    return f"motion {digits} : a person {v} smoothly"


def gate_forward_ids(tokenizer, n: int = 16, seq_len: int = 48,
                     start: int = 4) -> np.ndarray:
    """Fixed (n, seq_len) in-distribution token grid for the quantization
    gates' forward-agreement check.

    tools/quant_gate.py (ckpt mode) and tools/real_weight_harness.py
    (stage 5) both call this so their artifacts measure the SAME quantity:
    round 3 learned that two tools independently sampling 24 vs 96
    positions can disagree on a promote decision by pure sampling noise
    (a 0.99 bar on 96 positions is a zero-flip coin toss). 768 positions
    give the bar a real resolution of ~7 tolerated flips.

    Rows start at bank `sentence(start + row)`; short tokenizations are
    filled by concatenating further bank sentences, then truncated.
    """
    rows = []
    for r in range(n):
        ids: list = []
        j = start + r
        while len(ids) < seq_len:
            ids.extend(tokenizer([sentence(j)])["input_ids"][0])
            j += n
        rows.append(ids[:seq_len])
    return np.asarray(rows, np.int64)


def gate_decode_prompt_rows(tokenizer, bos_id: int, n: int = 8,
                            prompt_len: int = 40,
                            start: int = 0) -> np.ndarray:
    """BOS-framed bank-sentence prefixes for the decode-agreement gates.

    Training-frame-faithful: every LM training row starts with BOS
    (prompting/universal.py lm()) and serving adds it too (app._text_ids)
    — the first truth-gate calibration measured 0.17 completion accuracy
    on BOS-less 24-token prompts vs deterministic completion at 40-token
    BOS-framed ones (the digit→content-word recall is the model's weak
    skill; local continuation is its strong one, and a quantization gate
    wants to stand on the strong one). Fill-and-truncate appends further
    bank sentences only when a subword tokenizer yields short rows —
    never for the char-level proxy. Rows where fill kicked in have no
    aligned truth (gate_text_truth returns None for them).
    """
    rows = []
    for r in range(n):
        ids: list = [bos_id]
        j = start + r
        while len(ids) < prompt_len:
            ids.extend(tokenizer([sentence(j)])["input_ids"][0])
            j += n
        rows.append(ids[:prompt_len])
    return np.asarray(rows, np.int64)


def gate_text_truth(tokenizer, bos_id: int, n: int = 8,
                    prompt_len: int = 40, start: int = 0) -> list:
    """Known training-time continuation of each gate decode prompt row.

    The packed LM flow (text_batches pack_chars) joins bank sentences
    with a single space, so the deterministic continuation of a
    mid-sentence prefix is the rest of THAT sentence plus the separator
    and the next sentence's constant prefix " story"; everything after
    (the next sentence's digits) is genuinely random across epochs.
    Scoring generated tokens only on this span separates quantization /
    approximation damage from intrinsic model entropy — raw
    agreement-vs-reference over a full gen window conflates the two
    (campaign C: int8 raw text agreement 0.54 on a model whose
    memorized-span completion is exact). Rows whose tokenization is
    shorter than prompt_len get None (no aligned truth).
    """
    truths = []
    for r in range(n):
        base = [bos_id] + tokenizer([sentence(start + r)])["input_ids"][0]
        if len(base) < prompt_len:
            # the PROMPT row was fill-and-truncated past this sentence
            # (gate_decode_prompt_rows appended the next bank sentence),
            # so no truth span aligns with it — guarding on the suffixed
            # tokenization instead would hand out a continuation the
            # model was never conditioned toward (subword tokenizers
            # can cross the boundary either way)
            truths.append(None)
            continue
        full = [bos_id] + tokenizer(
            [sentence(start + r) + " story"]
        )["input_ids"][0]
        truths.append(
            np.asarray(full[prompt_len:], np.int64)
            if len(full) > prompt_len else None
        )
    return truths


def require_truth(truths, what: str = "decode gate"):
    """Fail LOUDLY when a truth bank has no scorable rows — every gate
    tool feeds truth_accuracy's result into round()/threshold math, and a
    None there is a confusing TypeError three frames later. All-None
    banks happen with subword tokenizers whose prompt rows all
    fill-and-truncate (gate_decode_prompt_rows docstring)."""
    if all(t is None or t.size == 0 for t in truths):
        raise ValueError(
            f"{what}: no truth spans align with the gate prompts (every "
            "row was fill-and-truncated — likely a subword tokenizer "
            "with short bank sentences); lengthen the bank sentences or "
            "lower GATE_TEXT_PROMPT_LEN"
        )
    return truths


def truth_accuracy(gen_tokens, truths) -> float:
    """Accuracy of (n, L) generated tokens against per-row truth spans;
    None/empty rows are skipped; None if no scorable positions
    (pre-check banks with require_truth for a diagnosable error)."""
    num = den = 0
    gen_tokens = np.asarray(gen_tokens)
    for g, t in zip(gen_tokens, truths):
        if t is None or t.size == 0:
            continue
        t = t[: g.shape[0]]
        num += int((g[: t.size] == t).sum())
        den += int(t.size)
    return float(num / den) if den else None


def build_structured_flows(cfg) -> dict:
    """Flows dict for CombinedLoader from `dataset.synthetic_structured`."""
    tr = cfg.training
    res = cfg.get_path("dataset.preprocessing.resolution", 256)
    n_patterns = cfg.get_path("dataset.n_patterns", 32)
    n_sentences = cfg.get_path("dataset.n_sentences", 64)
    flows = {}
    bank = None
    if tr.get("batch_size_t2i") or tr.get("batch_size_mmu"):
        bank = PatternBank(n_patterns, res)
    if tr.get("batch_size_t2i"):
        flows["t2i_flow"] = bank.batches(tr.batch_size_t2i, seed=2)
    if tr.get("batch_size_lm"):
        flows["lm_flow"] = text_batches(
            tr.batch_size_lm, n_sentences=n_sentences, seed=3,
            pack_chars=cfg.get_path("dataset.lm_pack_chars", 0),
        )
    if tr.get("batch_size_mmu"):
        flows["mmu_flow"] = bank.batches(tr.batch_size_mmu, seed=4)
    return flows
