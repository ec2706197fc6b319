"""Image quality instruments: the CLIP score and ImageReward.

The counterpart of `mmada_tpu/eval/image_quality.py`: the reference's
stage-4 `quantative_images` evaluation (train_mmada_stage4.py:1008-1115,
torchmetrics' CLIP score + ImageReward). `load_scorer` builds a scorer from
local checkpoint directories: the towers (`eval/clip.py`,
`eval/image_reward.py`) run on the card in fp32 under
`core.precision.exact_fp32_products`; tokenization and the CLIP / BERT
image processors stay on the host through `transformers`, as in JAX. With
no directory configured the scorer is empty (generation only, as in JAX);
a configured directory that fails to load raises, where JAX logs a warning
and drops the scorer.
"""

from __future__ import annotations

import dataclasses
import logging
import os
from typing import Callable, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from mmada_tpu_torch.core.device import DeviceLike, resolve_device
from mmada_tpu_torch.core.precision import exact_fp32_products

logger = logging.getLogger(__name__)

# OpenAI CLIP's pixel normalization, which BLIP's inference (the ImageReward
# repo) uses too
IMAGE_MEAN = np.array([0.48145466, 0.4578275, 0.40821073], np.float32)
IMAGE_STD = np.array([0.26862954, 0.26130258, 0.27577711], np.float32)


def clip_score_from_embeddings(image_embs: np.ndarray, text_embs: np.ndarray,
                               scale: float = 100.0) -> np.ndarray:
    """The CLIP score: max(100 cos(img, text), 0) a pair (the torchmetrics
    definition the reference uses)."""
    def norm(x):
        return x / np.clip(np.linalg.norm(x, axis=-1, keepdims=True), 1e-8, None)

    sims = (norm(image_embs) * norm(text_embs)).sum(-1)
    return np.maximum(scale * sims, 0.0)


@dataclasses.dataclass
class ImageQualityScorer:
    """The CLIP score's embedding functions and an optional reward model.

    image_embed_fn(pixels (B, H, W, C) in [-1, 1]) -> (B, D)
    text_embed_fn(list[str]) -> (B, D)
    reward_fn(pixels, prompts) -> (B,), ImageReward's scores.
    """

    image_embed_fn: Optional[Callable] = None
    text_embed_fn: Optional[Callable] = None
    reward_fn: Optional[Callable] = None

    @property
    def available(self) -> bool:
        return self.image_embed_fn is not None and self.text_embed_fn is not None

    def clip_scores(self, pixels: np.ndarray, prompts: Sequence[str]) -> Optional[np.ndarray]:
        if not self.available:
            logger.warning("CLIP scorer unavailable (no local checkpoint)")
            return None
        img = _np(self.image_embed_fn(pixels))
        txt = _np(self.text_embed_fn(list(prompts)))
        return clip_score_from_embeddings(img, txt)

    def rewards(self, pixels: np.ndarray, prompts: Sequence[str]) -> Optional[np.ndarray]:
        if self.reward_fn is None:
            return None
        return _np(self.reward_fn(pixels, list(prompts)))

    def quantitative_images(self, pixels, prompts) -> dict:
        """The stage-4 eval's summary dict."""
        out: dict = {}
        cs = self.clip_scores(pixels, prompts)
        if cs is not None:
            out["clip_score_mean"] = float(cs.mean())
            out["clip_score"] = cs.tolist()
        rw = self.rewards(pixels, prompts)
        if rw is not None:
            out["image_reward_mean"] = float(rw.mean())
        return out


def _np(x) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def load_scorer(clip_dir: Optional[str] = None, reward_dir: Optional[str] = None,
                backend: str = "torch", device: DeviceLike = None) -> ImageQualityScorer:
    """A scorer from local checkpoint directories (None: that part absent).

    clip_dir: the transformers CLIPModel layout. `backend="torch"` (the
    default) runs the towers of `eval/clip.py` on `device`;
    `backend="transformers"` runs `transformers.CLIPModel` on the CPU, a
    cross-check. reward_dir: an ImageReward checkpoint (`ImageReward.pt`,
    or a directory holding it and its BERT tokenizer) -> `eval/image_reward.py`."""
    scorer = ImageQualityScorer()
    if clip_dir:
        scorer = (clip_scorer(clip_dir, device) if backend == "torch"
                  else _transformers_clip_scorer(clip_dir))
    if reward_dir:
        scorer.reward_fn = reward_scorer(reward_dir, device)
    return scorer


def clip_scorer(clip_dir: str, device: DeviceLike = None) -> ImageQualityScorer:
    """The CLIP towers of `clip_dir` on `device`, fed by its processor."""
    from transformers import CLIPProcessor

    from mmada_tpu_torch.eval import clip

    params, cfg = clip.load_clip(clip_dir, resolve_device(device))
    return clip_towers_scorer(params, cfg,
                              CLIPProcessor.from_pretrained(clip_dir, local_files_only=True))


def clip_towers_scorer(params, cfg, processor) -> ImageQualityScorer:
    """The CLIP towers `params` (`eval/clip.py`, on their device) fed by
    `processor`, a transformers `CLIPProcessor` on the host: the images'
    resize, crop and normalization, and the tokenizer."""
    from mmada_tpu_torch.eval import clip

    def image_embed(pixels):
        imgs = ((np.asarray(pixels) + 1.0) * 127.5).clip(0, 255).astype(np.uint8)
        inputs = processor(images=list(imgs), return_tensors="np")
        with exact_fp32_products():
            return clip.image_features(params, cfg, inputs["pixel_values"])

    def text_embed(texts):
        inputs = processor(text=texts, return_tensors="np", padding=True, truncation=True)
        with exact_fp32_products():
            return clip.text_features(params, cfg, inputs["input_ids"],
                                      inputs.get("attention_mask"))

    return ImageQualityScorer(image_embed, text_embed)


def _transformers_clip_scorer(clip_dir: str) -> ImageQualityScorer:
    from transformers import CLIPModel, CLIPProcessor

    model = CLIPModel.from_pretrained(clip_dir, local_files_only=True).eval()
    processor = CLIPProcessor.from_pretrained(clip_dir, local_files_only=True)

    def image_embed(pixels):
        imgs = ((np.asarray(pixels) + 1.0) * 127.5).clip(0, 255).astype(np.uint8)
        inputs = processor(images=list(imgs), return_tensors="pt")
        with torch.no_grad():
            return model.get_image_features(**inputs).numpy()

    def text_embed(texts):
        inputs = processor(text=texts, return_tensors="pt", padding=True, truncation=True)
        with torch.no_grad():
            return model.get_text_features(**inputs).numpy()

    return ImageQualityScorer(image_embed, text_embed)


def blip_pixels(pixels, image_size: int) -> np.ndarray:
    """(B, H, W, 3) in [-1, 1] -> BLIP's normalized (B, 3, S, S) at S =
    `image_size`: the ImageReward repo's inference transform (the shorter
    side resized to S, bicubic and antialiased; a center crop; CLIP's
    normalization). Images already S x S are only normalized."""
    x = (torch.as_tensor(np.asarray(pixels, np.float32)).permute(0, 3, 1, 2) + 1.0) / 2.0
    h, w = x.shape[-2:]
    if (h, w) != (image_size, image_size):
        # torchvision's Resize(S): the longer side scaled and truncated
        size = ((image_size, int(image_size * w / h)) if h <= w
                else (int(image_size * h / w), image_size))
        x = F.interpolate(x, size=size, mode="bicubic", antialias=True,
                          align_corners=False).clamp(0, 1)
        top, left = (int(round((n - image_size) / 2.0)) for n in size)
        x = x[..., top:top + image_size, left:left + image_size]
    mean, std = (torch.as_tensor(a)[:, None, None] for a in (IMAGE_MEAN, IMAGE_STD))
    return ((x - mean) / std).contiguous().numpy()


def reward_scorer(reward_dir: str, device: DeviceLike = None) -> Callable:
    """ImageReward (`eval/image_reward.py`, the v1.0 geometry) from its
    checkpoint on `device`, tokenized by the BERT tokenizer beside it."""
    from transformers import AutoTokenizer

    from mmada_tpu_torch.eval import image_reward as IR

    path = reward_dir
    if os.path.isdir(path):
        for cand in ("ImageReward.pt", "pytorch_model.bin"):
            if os.path.exists(os.path.join(path, cand)):
                path = os.path.join(path, cand)
                break
    state = torch.load(path, map_location="cpu", weights_only=True)
    if "state_dict" in state:
        state = state["state_dict"]
    cfg = IR.image_reward_v1()
    params = IR.from_imagereward_state(state, cfg, resolve_device(device))
    tok = AutoTokenizer.from_pretrained(os.path.dirname(path) or ".", local_files_only=True)
    return blip_reward_fn(params, cfg, tok)


def blip_reward_fn(params, cfg, tokenizer) -> Callable:
    """reward(pixels, prompts) of the ImageReward weights `params`
    (`eval/image_reward.py`, on their device): the pixels through
    `blip_pixels` at the config's size and the prompts through `tokenizer`
    (BERT's, padded to ImageReward's 35 tokens) on the host."""
    from mmada_tpu_torch.eval import image_reward as IR

    def reward(pixels, prompts):
        enc = tokenizer(list(prompts), padding="max_length", truncation=True, max_length=35,
                        return_tensors="np")
        with exact_fp32_products():
            return IR.rewards(params, cfg, blip_pixels(pixels, cfg.image_size),
                              enc["input_ids"], enc["attention_mask"])

    return reward
