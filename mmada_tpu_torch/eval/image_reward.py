"""ImageReward: a BLIP backbone and an MLP reward head.

The counterpart of `mmada_tpu/eval/image_reward_jax.py`. The reference's
stage-4 eval scores generated images against their prompts with
ImageReward-v1.0 (train_mmada_stage4.py:1008-1115): a BLIP image-text
backbone (a ViT vision encoder, a med-BERT text encoder whose every layer
cross-attends to the vision tokens), whose pooled [CLS] text feature feeds
an MLP giving a scalar, z-normalized by fixed constants. The numerics are
`transformers.BlipForImageTextRetrieval`'s, in plain torch ops and the JAX
package's order. Two weight layouts load:

  * `from_blip_torch_state`: the transformers Blip* names;
  * `from_imagereward_state`: the ImageReward checkpoint's own names
    (`blip.visual_encoder.*` timm ViT, `blip.text_encoder.*` med-BERT,
    `mlp.layers.*`).

`image_reward_v1()` is ImageReward-v1.0's geometry (BLIP ViT-L/16 at 224 px,
BERT-base with cross-attention, the 1,024 -> 128 -> 64 -> 16 -> 1 head) and
`init_image_reward` gives it random weights from a seed. On the card it
runs in fp32 under `core.precision.exact_fp32_products`.
"""

from __future__ import annotations

import dataclasses
import re
from typing import Any, Mapping, Optional

import numpy as np
import torch

from mmada_tpu_torch.core.device import DeviceLike
from mmada_tpu_torch.eval.clip import _layers, _ln, _np, as_tensor, to_tensors

Params = dict[str, Any]

# z-normalization constants of the ImageReward repo (ImageReward.py)
REWARD_MEAN = 0.16717362830052426
REWARD_STD = 1.0333394966054072


@dataclasses.dataclass(frozen=True)
class BlipRewardConfig:
    text_hidden: int
    text_intermediate: int
    text_layers: int
    text_heads: int
    vision_hidden: int
    vision_intermediate: int
    vision_layers: int
    vision_heads: int
    image_size: int = 224
    patch_size: int = 16
    vocab_size: int = 30524
    max_positions: int = 512
    layer_norm_eps: float = 1e-12
    vision_eps: float = 1e-5

    @classmethod
    def from_hf(cls, hf_cfg) -> "BlipRewardConfig":
        d = hf_cfg if isinstance(hf_cfg, dict) else hf_cfg.to_dict()
        t, v = d["text_config"], d["vision_config"]
        return cls(
            text_hidden=t["hidden_size"], text_intermediate=t["intermediate_size"],
            text_layers=t["num_hidden_layers"], text_heads=t["num_attention_heads"],
            vision_hidden=v["hidden_size"], vision_intermediate=v["intermediate_size"],
            vision_layers=v["num_hidden_layers"], vision_heads=v["num_attention_heads"],
            image_size=v["image_size"], patch_size=v["patch_size"],
            vocab_size=t["vocab_size"], max_positions=t["max_position_embeddings"],
            layer_norm_eps=t.get("layer_norm_eps", 1e-12),
            vision_eps=v.get("layer_norm_eps", 1e-5))


def image_reward_v1() -> BlipRewardConfig:
    """ImageReward-v1.0: BLIP ViT-L/16 at 224 px (24 x 1,024, 16 heads,
    4,096: 197 tokens) and the BERT-base text encoder with cross-attention
    (12 x 768, 12 heads, 3,072), the geometry the JAX package's loader fixes
    (`mmada_tpu/eval/image_quality.py:174-178`)."""
    return BlipRewardConfig(text_hidden=768, text_intermediate=3072, text_layers=12,
                            text_heads=12, vision_hidden=1024, vision_intermediate=4096,
                            vision_layers=24, vision_heads=16, image_size=224, patch_size=16)


#: the reward head's widths after the text feature (ImageReward's MLP)
MLP_WIDTHS = (1024, 128, 64, 16, 1)


def _attend(q, k, v, n_heads: int, mask: Optional[torch.Tensor]) -> torch.Tensor:
    """(B, Lq, D) x (B, Lk, Dk) multi-head attention's core."""
    b, lq, d = q.shape
    lk = k.shape[1]
    hd = d // n_heads

    def split(h, length):
        return h.reshape(b, length, n_heads, hd).transpose(1, 2)

    qh, kh, vh = split(q, lq), split(k, lk), split(v, lk)
    s = (qh @ kh.transpose(-1, -2)).float() * (hd ** -0.5)
    if mask is not None:
        s = s + mask
    p = torch.softmax(s, dim=-1).to(q.dtype)
    return (p @ vh).transpose(1, 2).reshape(b, lq, d)


def _gelu(x):
    return torch.nn.functional.gelu(x, approximate="none")


def _device_of(params: Params) -> torch.device:
    return params["text"]["word_emb"].device


# ------------------------------------------------------------------ vision

@torch.no_grad()
def vision_forward(params: Params, cfg: BlipRewardConfig, pixel_values) -> torch.Tensor:
    """BLIP's ViT: the patch embedding (+ bias), [CLS], learned positions,
    pre-LN blocks with a fused qkv, the post-LN. Returns (B, 1 + N, D), every
    token (the text encoder cross-attends to all of them)."""
    p = params["vision"]
    pv = as_tensor(pixel_values, _device_of(params), torch.float32)
    b = pv.shape[0]
    ps = cfg.patch_size
    g = cfg.image_size // ps
    patches = pv.reshape(b, 3, g, ps, g, ps).permute(0, 2, 4, 1, 3, 5).reshape(b, g * g, -1)
    x = patches @ p["patch_w"] + p["patch_b"]
    cls = p["cls"].expand(b, 1, cfg.vision_hidden).to(x.dtype)
    x = torch.cat([cls, x], dim=1) + p["pos_emb"]
    heads, eps = cfg.vision_heads, cfg.vision_eps
    for lp in _layers(p["layers"]):
        a = _ln(x, lp["ln1_w"], lp["ln1_b"], eps)
        q, k, v = (a @ lp["qkv_w"] + lp["qkv_b"]).chunk(3, dim=-1)
        x = x + (_attend(q, k, v, heads, mask=None) @ lp["proj_w"] + lp["proj_b"])
        m = _ln(x, lp["ln2_w"], lp["ln2_b"], eps)
        m = _gelu(m @ lp["fc1_w"] + lp["fc1_b"])
        x = x + (m @ lp["fc2_w"] + lp["fc2_b"])
    return _ln(x, p["post_ln_w"], p["post_ln_b"], eps)


# -------------------------------------------------------------------- text

@torch.no_grad()
def text_forward(params: Params, cfg: BlipRewardConfig, input_ids, image_embeds,
                 attention_mask=None) -> torch.Tensor:
    """BLIP's med-BERT text encoder: post-LN self-attention, a per-layer
    cross-attention over the vision tokens, a post-LN FFN. Returns the last
    hidden state (B, L, D); the reward pools [:, 0]."""
    p = params["text"]
    device = _device_of(params)
    input_ids = as_tensor(input_ids, device, torch.long)
    image_embeds = as_tensor(image_embeds, device)
    l = input_ids.shape[1]
    x = p["word_emb"][input_ids] + p["pos_emb"][:l]
    x = _ln(x, p["emb_ln_w"], p["emb_ln_b"], cfg.layer_norm_eps)
    mask = None
    if attention_mask is not None:
        am = as_tensor(attention_mask, device, torch.float32)
        mask = (1.0 - am[:, None, None, :]) * torch.finfo(torch.float32).min
    heads, eps = cfg.text_heads, cfg.layer_norm_eps
    for lp in _layers(p["layers"]):
        q = x @ lp["sa_q_w"] + lp["sa_q_b"]
        k = x @ lp["sa_k_w"] + lp["sa_k_b"]
        v = x @ lp["sa_v_w"] + lp["sa_v_b"]
        att = _attend(q, k, v, heads, mask)
        x = _ln(att @ lp["sa_o_w"] + lp["sa_o_b"] + x, lp["sa_ln_w"], lp["sa_ln_b"], eps)
        q = x @ lp["ca_q_w"] + lp["ca_q_b"]
        k = image_embeds @ lp["ca_k_w"] + lp["ca_k_b"]
        v = image_embeds @ lp["ca_v_w"] + lp["ca_v_b"]
        att = _attend(q, k, v, heads, mask=None)
        x = _ln(att @ lp["ca_o_w"] + lp["ca_o_b"] + x, lp["ca_ln_w"], lp["ca_ln_b"], eps)
        m = _gelu(x @ lp["fc1_w"] + lp["fc1_b"])
        x = _ln(m @ lp["fc2_w"] + lp["fc2_b"] + x, lp["ffn_ln_w"], lp["ffn_ln_b"], eps)
    return x


@torch.no_grad()
def rewards(params: Params, cfg: BlipRewardConfig, pixel_values, input_ids,
            attention_mask=None, mean: float = REWARD_MEAN,
            std: float = REWARD_STD) -> torch.Tensor:
    """ImageReward scores: BLIP's cross-modal [CLS] feature -> MLP -> a
    scalar, z-normalized ((r - mean) / std, the repo's constants)."""
    img = vision_forward(params, cfg, pixel_values)
    txt = text_forward(params, cfg, input_ids, img, attention_mask)
    h = txt[:, 0]
    for w, b in params["mlp"]:
        h = h @ w + b
    return (h[:, 0] - mean) / std


# --------------------------------------------------------------- converters

def _stack(state: Mapping, fmt: str, n: int, transpose: bool) -> np.ndarray:
    mats = [_np(state[fmt.format(i)]) for i in range(n)]
    return np.stack([m.T for m in mats] if transpose else mats)


_BLIP_TEXT = {
    "sa_q_w": ("attention.self.query.weight", True),
    "sa_q_b": ("attention.self.query.bias", False),
    "sa_k_w": ("attention.self.key.weight", True),
    "sa_k_b": ("attention.self.key.bias", False),
    "sa_v_w": ("attention.self.value.weight", True),
    "sa_v_b": ("attention.self.value.bias", False),
    "sa_o_w": ("attention.output.dense.weight", True),
    "sa_o_b": ("attention.output.dense.bias", False),
    "sa_ln_w": ("attention.output.LayerNorm.weight", False),
    "sa_ln_b": ("attention.output.LayerNorm.bias", False),
    "ca_q_w": ("crossattention.self.query.weight", True),
    "ca_q_b": ("crossattention.self.query.bias", False),
    "ca_k_w": ("crossattention.self.key.weight", True),
    "ca_k_b": ("crossattention.self.key.bias", False),
    "ca_v_w": ("crossattention.self.value.weight", True),
    "ca_v_b": ("crossattention.self.value.bias", False),
    "ca_o_w": ("crossattention.output.dense.weight", True),
    "ca_o_b": ("crossattention.output.dense.bias", False),
    "ca_ln_w": ("crossattention.output.LayerNorm.weight", False),
    "ca_ln_b": ("crossattention.output.LayerNorm.bias", False),
    "fc1_w": ("intermediate.dense.weight", True),
    "fc1_b": ("intermediate.dense.bias", False),
    "fc2_w": ("output.dense.weight", True),
    "fc2_b": ("output.dense.bias", False),
    "ffn_ln_w": ("output.LayerNorm.weight", False),
    "ffn_ln_b": ("output.LayerNorm.bias", False),
}

_BLIP_VISION = {
    "qkv_w": ("self_attn.qkv.weight", True),
    "qkv_b": ("self_attn.qkv.bias", False),
    "proj_w": ("self_attn.projection.weight", True),
    "proj_b": ("self_attn.projection.bias", False),
    "ln1_w": ("layer_norm1.weight", False),
    "ln1_b": ("layer_norm1.bias", False),
    "fc1_w": ("mlp.fc1.weight", True),
    "fc1_b": ("mlp.fc1.bias", False),
    "fc2_w": ("mlp.fc2.weight", True),
    "fc2_b": ("mlp.fc2.bias", False),
    "ln2_w": ("layer_norm2.weight", False),
    "ln2_b": ("layer_norm2.bias", False),
}

_TIMM_VISION = {
    "qkv_w": ("attn.qkv.weight", True),
    "qkv_b": ("attn.qkv.bias", False),
    "proj_w": ("attn.proj.weight", True),
    "proj_b": ("attn.proj.bias", False),
    "ln1_w": ("norm1.weight", False), "ln1_b": ("norm1.bias", False),
    "fc1_w": ("mlp.fc1.weight", True), "fc1_b": ("mlp.fc1.bias", False),
    "fc2_w": ("mlp.fc2.weight", True), "fc2_b": ("mlp.fc2.bias", False),
    "ln2_w": ("norm2.weight", False), "ln2_b": ("norm2.bias", False),
}


def _text_from_state(state: Mapping, cfg: BlipRewardConfig) -> dict:
    """`text_encoder.*` in transformers' med-BERT names (ImageReward's own
    `blip.text_encoder.*` are the same after the prefix)."""
    return {
        "word_emb": _np(state["text_encoder.embeddings.word_embeddings.weight"]),
        "pos_emb": _np(state["text_encoder.embeddings.position_embeddings.weight"]),
        "emb_ln_w": _np(state["text_encoder.embeddings.LayerNorm.weight"]),
        "emb_ln_b": _np(state["text_encoder.embeddings.LayerNorm.bias"]),
        "layers": {ours: _stack(state, f"text_encoder.encoder.layer.{{0}}.{theirs}",
                                cfg.text_layers, tr)
                   for ours, (theirs, tr) in _BLIP_TEXT.items()},
    }


def _finish(text, vision, mlp, device, dtype) -> Params:
    tree = to_tensors({"text": text, "vision": vision}, device, dtype)
    tree["mlp"] = [tuple(to_tensors({"w": w, "b": b}, device, dtype).values()) for w, b in mlp]
    return tree


def from_blip_torch_state(state: Mapping, cfg: BlipRewardConfig,
                          mlp_state: Optional[Mapping] = None, device: DeviceLike = None,
                          dtype: torch.dtype = torch.float32) -> Params:
    """transformers `BlipForImageTextRetrieval` names. `mlp_state` gives the
    reward head's `layers.{i}.weight/bias`; without it a one-layer zero head
    stands in, so that the backbone runs alone."""
    vision = {
        "cls": _np(state["vision_model.embeddings.class_embedding"]).reshape(cfg.vision_hidden),
        "pos_emb": _np(state["vision_model.embeddings.position_embedding"])[0],
        "patch_w": _np(state["vision_model.embeddings.patch_embedding.weight"])
        .reshape(cfg.vision_hidden, -1).T,
        "patch_b": _np(state["vision_model.embeddings.patch_embedding.bias"]),
        "post_ln_w": _np(state["vision_model.post_layernorm.weight"]),
        "post_ln_b": _np(state["vision_model.post_layernorm.bias"]),
        "layers": {ours: _stack(state, f"vision_model.encoder.layers.{{0}}.{theirs}",
                                cfg.vision_layers, tr)
                   for ours, (theirs, tr) in _BLIP_VISION.items()},
    }
    mlp = _mlp_from_state(mlp_state) if mlp_state else [
        (np.zeros((cfg.text_hidden, 1), np.float32), np.zeros((1,), np.float32))]
    return _finish(_text_from_state(state, cfg), vision, mlp, device, dtype)


def _mlp_from_state(mlp_state: Mapping):
    """`layers.{i}.weight/bias` (ImageReward's 1024 -> 128 -> 64 -> 16 -> 1
    linear stack; its Dropout layers hold no parameters)."""
    idx = sorted({int(m.group(1)) for k in mlp_state
                  if (m := re.match(r"(?:mlp\.)?layers\.(\d+)\.weight", k))})
    out = []
    for i in idx:
        prefix = f"mlp.layers.{i}" if f"mlp.layers.{i}.weight" in mlp_state else f"layers.{i}"
        out.append((_np(mlp_state[f"{prefix}.weight"]).T, _np(mlp_state[f"{prefix}.bias"])))
    return out


def from_imagereward_state(state: Mapping, cfg: BlipRewardConfig, device: DeviceLike = None,
                           dtype: torch.dtype = torch.float32) -> Params:
    """The ImageReward checkpoint's own names: `blip.visual_encoder.*` a timm
    ViT (fused qkv, `norm1/norm2`, `mlp.fc1/fc2`, `patch_embed.proj`,
    `cls_token`, `pos_embed`), `blip.text_encoder.*` the transformers
    med-BERT names, `mlp.layers.*` the reward head."""
    tstate = {k[len("blip."):]: v for k, v in state.items() if k.startswith("blip.text_encoder.")}
    v = "blip.visual_encoder"
    vision = {
        "cls": _np(state[f"{v}.cls_token"]).reshape(cfg.vision_hidden),
        "pos_emb": _np(state[f"{v}.pos_embed"])[0],
        "patch_w": _np(state[f"{v}.patch_embed.proj.weight"]).reshape(cfg.vision_hidden, -1).T,
        "patch_b": _np(state[f"{v}.patch_embed.proj.bias"]),
        "post_ln_w": _np(state[f"{v}.norm.weight"]),
        "post_ln_b": _np(state[f"{v}.norm.bias"]),
        "layers": {ours: _stack(state, f"{v}.blocks.{{0}}.{theirs}", cfg.vision_layers, tr)
                   for ours, (theirs, tr) in _TIMM_VISION.items()},
    }
    mlp = _mlp_from_state({k: x for k, x in state.items() if k.startswith("mlp.")})
    return _finish(_text_from_state(tstate, cfg), vision, mlp, device, dtype)


def init_image_reward(cfg: BlipRewardConfig, seed: int = 0, device: DeviceLike = None) -> Params:
    """Random params for `cfg` and the reward head (`text_hidden` ->
    MLP_WIDTHS) from `seed` (weights normal at 0.02, biases and norms
    perturbed), drawn on the CPU and moved to `device`."""
    g = torch.Generator().manual_seed(seed)

    def randn(*shape, std=0.02):
        return torch.randn(shape, generator=g) * std

    def layers(names, n, d, f, kv=None):
        out = {}
        for ours, (_, tr) in names.items():
            if ours.endswith("_b"):
                continue
            width = {"qkv_w": 3 * d, "fc1_w": f}.get(ours, d)
            rows = {"fc2_w": f, "ca_k_w": kv, "ca_v_w": kv}.get(ours) or d
            if ours.startswith(("ln", "sa_ln", "ca_ln", "ffn_ln")):
                out[ours], out[ours[:-1] + "b"] = 1 + randn(n, d), randn(n, d)
            else:
                out[ours], out[ours[:-1] + "b"] = randn(n, rows, width), randn(n, width)
        return out

    t, v = cfg.text_hidden, cfg.vision_hidden
    n_tok = (cfg.image_size // cfg.patch_size) ** 2 + 1
    text = {"word_emb": randn(cfg.vocab_size, t), "pos_emb": randn(cfg.max_positions, t),
            "emb_ln_w": 1 + randn(t), "emb_ln_b": randn(t),
            "layers": layers(_BLIP_TEXT, cfg.text_layers, t, cfg.text_intermediate, kv=v)}
    vision = {"cls": randn(v), "pos_emb": randn(n_tok, v),
              "patch_w": randn(3 * cfg.patch_size ** 2, v), "patch_b": randn(v),
              "post_ln_w": 1 + randn(v), "post_ln_b": randn(v),
              "layers": layers(_BLIP_VISION, cfg.vision_layers, v, cfg.vision_intermediate)}
    widths = (t,) + MLP_WIDTHS
    mlp = [(randn(a, b, std=a ** -0.5), randn(b)) for a, b in zip(widths[:-1], widths[1:])]
    return _finish(text, vision, mlp, device, torch.float32)
