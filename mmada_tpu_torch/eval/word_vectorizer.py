"""GloVe word vectorizer + POS one-hots for the T2M evaluator.

Same file contract and lookup semantics as the reference
(utils/word_vectorizer.py:46-97): `{prefix}_data.npy` embedding matrix,
`{prefix}_words.pkl` word list, `{prefix}_idx.pkl` word→row map; tokens are
`word/POS` with VIP word classes overriding the POS tag; unknown words map
to the `unk` vector with POS OTHER.
"""

from __future__ import annotations

import os
import pickle

import numpy as np

POS_ENUMERATOR = {
    "VERB": 0, "NOUN": 1, "DET": 2, "ADP": 3, "NUM": 4, "AUX": 5,
    "PRON": 6, "ADJ": 7, "ADV": 8, "Loc_VIP": 9, "Body_VIP": 10,
    "Obj_VIP": 11, "Act_VIP": 12, "Desc_VIP": 13, "OTHER": 14,
}

VIP_DICT = {
    "Loc_VIP": (
        "left", "right", "clockwise", "counterclockwise", "anticlockwise",
        "forward", "back", "backward", "up", "down", "straight", "curve",
    ),
    "Body_VIP": (
        "arm", "chin", "foot", "feet", "face", "hand", "mouth", "leg",
        "waist", "eye", "knee", "shoulder", "thigh",
    ),
    "Obj_VIP": (
        "stair", "dumbbell", "chair", "window", "floor", "car", "ball",
        "handrail", "baseball", "basketball",
    ),
    "Act_VIP": (
        "walk", "run", "swing", "pick", "bring", "kick", "put", "squat",
        "throw", "hop", "dance", "jump", "turn", "stumble", "stop", "sit",
        "lift", "lower", "raise", "wash", "stand", "kneel", "stroll", "rub",
        "bend", "balance", "flap", "jog", "shuffle", "lean", "rotate",
        "spin", "spread", "climb",
    ),
    "Desc_VIP": (
        "slowly", "carefully", "fast", "careful", "slow", "quickly",
        "happy", "angry", "sad", "happily", "angrily", "sadly",
    ),
}


def pos_onehot(pos: str) -> np.ndarray:
    vec = np.zeros(len(POS_ENUMERATOR), np.float32)
    vec[POS_ENUMERATOR.get(pos, POS_ENUMERATOR["OTHER"])] = 1.0
    return vec


class WordVectorizer:
    def __init__(self, meta_root: str, prefix: str):
        vectors = np.load(os.path.join(meta_root, f"{prefix}_data.npy"))
        with open(os.path.join(meta_root, f"{prefix}_words.pkl"), "rb") as f:
            words = pickle.load(f)
        with open(os.path.join(meta_root, f"{prefix}_idx.pkl"), "rb") as f:
            self.word2idx = pickle.load(f)
        self.word2vec = {w: vectors[self.word2idx[w]] for w in words}

    def __len__(self) -> int:
        return len(self.word2vec)

    def __getitem__(self, item: str):
        word, _, pos = item.partition("/")
        if word in self.word2vec:
            word_vec = self.word2vec[word]
            for key, values in VIP_DICT.items():
                if word in values:
                    pos = key
                    break
            return word_vec, pos_onehot(pos)
        return self.word2vec["unk"], pos_onehot("OTHER")


class RandomWordVectorizer:
    """Deterministic hash-based stand-in when GloVe metas are unavailable
    (zero-egress environments); keeps the (vec, pos) interface so the eval
    plumbing runs end-to-end."""

    def __init__(self, dim: int = 300, seed: int = 0):
        self.dim = dim
        self.seed = seed

    def __getitem__(self, item: str):
        word, _, pos = item.partition("/")
        h = abs(hash((self.seed, word))) % (2**32)
        vec = np.random.default_rng(h).normal(size=(self.dim,)).astype(np.float32)
        for key, values in VIP_DICT.items():
            if word in values:
                pos = key
                break
        return vec, pos_onehot(pos)
