"""CLIP (the dual-tower ViT + text transformer) for the CLIP score.

The counterpart of `mmada_tpu/eval/clip_jax.py`. The reference's stage-4
quality eval scores generated images with torchmetrics' CLIPScore
(train_mmada_stage4.py:1008-1115), which wraps `transformers.CLIPModel`;
this module computes the same features with plain torch ops in the JAX
package's order (no `scaled_dot_product_attention`), so that the towers run
on the card beside the sampler. The patch embedding is a reshape + matmul
(stride = kernel patches make the conv a plain product), the activation
`quick_gelu` (x * sigmoid(1.702 x)), CLIP's default.

Params are a dict of tensors: matrices `(in, out)`, each tower's layers
stacked on a leading axis (`layers[name][i]`), as the JAX package keeps
them. `from_torch_state` reads the transformers `CLIPModel` key layout,
`load_clip` a local checkpoint directory; `clip_vit_l14()` is the published
ViT-L/14 (torchmetrics' `CLIPScore` default) and `init_clip` gives it random
weights from a seed. On the card it runs in fp32 under
`core.precision.exact_fp32_products` (TF32 off).
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Any, Mapping, Optional

import numpy as np
import torch

from mmada_tpu_torch.core.device import DeviceLike, resolve_device

Params = dict[str, Any]


@dataclasses.dataclass(frozen=True)
class CLIPTowerConfig:
    hidden_size: int
    intermediate_size: int
    num_layers: int
    num_heads: int
    hidden_act: str = "quick_gelu"
    layer_norm_eps: float = 1e-5


@dataclasses.dataclass(frozen=True)
class CLIPConfig:
    text: CLIPTowerConfig
    vision: CLIPTowerConfig
    projection_dim: int
    image_size: int = 224
    patch_size: int = 14
    vocab_size: int = 49408
    max_positions: int = 77
    eos_token_id: int = 2

    @classmethod
    def from_hf(cls, hf_cfg) -> "CLIPConfig":
        """From a transformers.CLIPConfig (or its to_dict())."""
        d = hf_cfg if isinstance(hf_cfg, dict) else hf_cfg.to_dict()
        t, v = d["text_config"], d["vision_config"]

        def tower(c):
            return CLIPTowerConfig(
                hidden_size=c["hidden_size"], intermediate_size=c["intermediate_size"],
                num_layers=c["num_hidden_layers"], num_heads=c["num_attention_heads"],
                hidden_act=c.get("hidden_act", "quick_gelu"),
                layer_norm_eps=c.get("layer_norm_eps", 1e-5))

        return cls(text=tower(t), vision=tower(v), projection_dim=d["projection_dim"],
                   image_size=v["image_size"], patch_size=v["patch_size"],
                   vocab_size=t["vocab_size"], max_positions=t["max_position_embeddings"],
                   eos_token_id=t.get("eos_token_id", 2))


def clip_vit_l14() -> CLIPConfig:
    """`openai/clip-vit-large-patch14`: text 12 x 768 (12 heads, MLP 3,072,
    77 positions, vocab 49,408, legacy eos 2), vision 24 x 1,024 (16 heads,
    MLP 4,096, 224 px, patch 14: 257 tokens), projection 768."""
    return CLIPConfig(text=CLIPTowerConfig(768, 3072, 12, 12),
                      vision=CLIPTowerConfig(1024, 4096, 24, 16), projection_dim=768)


def _act(name: str, x: torch.Tensor) -> torch.Tensor:
    if name == "quick_gelu":
        return x * torch.sigmoid(1.702 * x)
    if name in ("gelu", "gelu_new"):
        return torch.nn.functional.gelu(x, approximate="tanh" if name == "gelu_new" else "none")
    raise ValueError(f"unknown activation {name}")


def _ln(x, w, b, eps):
    xf = x.float()
    mu = xf.mean(-1, keepdim=True)
    var = ((xf - mu) ** 2).mean(-1, keepdim=True)
    return ((xf - mu) * torch.rsqrt(var + eps) * w + b).to(x.dtype)


def _mha(lp, x, n_heads: int, mask: Optional[torch.Tensor]) -> torch.Tensor:
    """A pre-LN CLIP attention block's body (the residual add is the
    caller's). x: (B, L, D); mask: additive fp32 (B|1, 1, L, L) or None."""
    b, l, d = x.shape
    hd = d // n_heads

    def split(h):
        return h.reshape(b, l, n_heads, hd).transpose(1, 2)

    q = split(x @ lp["q_w"] + lp["q_b"]) * (hd ** -0.5)
    k = split(x @ lp["k_w"] + lp["k_b"])
    v = split(x @ lp["v_w"] + lp["v_b"])
    s = (q @ k.transpose(-1, -2)).float()
    if mask is not None:
        s = s + mask
    p = torch.softmax(s, dim=-1).to(x.dtype)
    o = (p @ v).transpose(1, 2).reshape(b, l, d)
    return o @ lp["o_w"] + lp["o_b"]


def _layers(layers: Params):
    n = next(iter(layers.values())).shape[0]
    for i in range(n):
        yield {k: v[i] for k, v in layers.items()}


def _tower(cfg: CLIPTowerConfig, layers: Params, x: torch.Tensor,
           mask: Optional[torch.Tensor]) -> torch.Tensor:
    for lp in _layers(layers):
        a = _ln(x, lp["ln1_w"], lp["ln1_b"], cfg.layer_norm_eps)
        x = x + _mha(lp, a, cfg.num_heads, mask)
        m = _ln(x, lp["ln2_w"], lp["ln2_b"], cfg.layer_norm_eps)
        m = _act(cfg.hidden_act, m @ lp["fc1_w"] + lp["fc1_b"])
        x = x + (m @ lp["fc2_w"] + lp["fc2_b"])
    return x


def _device_of(params: Params) -> torch.device:
    return params["text"]["tok_emb"].device


def as_tensor(x, device, dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """A numpy array or tensor on `device` (as `dtype` when given)."""
    t = x if isinstance(x, torch.Tensor) else torch.as_tensor(np.asarray(x))
    return t.to(device, dtype) if dtype is not None else t.to(device)


@torch.no_grad()
def text_features(params: Params, cfg: CLIPConfig, input_ids,
                  attention_mask=None) -> torch.Tensor:
    """`CLIPModel.get_text_features`: the causal text tower, pooled at the
    eos position, projected (not normalized). Ids may be numpy; they go to
    the weights' device."""
    p = params["text"]
    device = _device_of(params)
    input_ids = as_tensor(input_ids, device, torch.long)
    b, l = input_ids.shape
    x = p["tok_emb"][input_ids] + p["pos_emb"][:l]
    mask = torch.triu(torch.full((l, l), -torch.inf, device=device), diagonal=1)[None, None]
    if attention_mask is not None:
        am = as_tensor(attention_mask, device)
        mask = mask + torch.where(am[:, None, None, :] > 0, 0.0, -torch.inf)
    h = _tower(cfg.text, p["layers"], x, mask)
    h = _ln(h, p["final_ln_w"], p["final_ln_b"], cfg.text.layer_norm_eps)
    if cfg.eos_token_id == 2:
        # transformers keeps CLIP's legacy pooling when eos_token_id == 2:
        # the ARGMAX of the ids (EOT is the largest id, 49407, in the real
        # vocab), not the first literal eos position
        eos_pos = input_ids.argmax(dim=-1)
    else:
        eos_pos = (input_ids == cfg.eos_token_id).int().argmax(dim=-1)
    pooled = h[torch.arange(b, device=device), eos_pos]
    return pooled @ p["proj"]


@torch.no_grad()
def image_features(params: Params, cfg: CLIPConfig, pixel_values) -> torch.Tensor:
    """`CLIPModel.get_image_features`. pixel_values: (B, 3, H, W), already
    CLIP-normalized (numpy or a tensor)."""
    p = params["vision"]
    pv = as_tensor(pixel_values, _device_of(params), torch.float32)
    b = pv.shape[0]
    ps = cfg.patch_size
    g = cfg.image_size // ps
    # a non-overlapping conv is a reshape + matmul (the patch's pixels in
    # the conv weight's (C, ph, pw) order)
    patches = pv.reshape(b, 3, g, ps, g, ps).permute(0, 2, 4, 1, 3, 5).reshape(b, g * g, -1)
    x = patches @ p["patch"]
    cls = p["cls"].expand(b, 1, cfg.vision.hidden_size).to(x.dtype)
    x = torch.cat([cls, x], dim=1) + p["pos_emb"]
    x = _ln(x, p["pre_ln_w"], p["pre_ln_b"], cfg.vision.layer_norm_eps)
    h = _tower(cfg.vision, p["layers"], x, mask=None)
    pooled = _ln(h[:, 0], p["post_ln_w"], p["post_ln_b"], cfg.vision.layer_norm_eps)
    return pooled @ p["proj"]


def clip_scores(params: Params, cfg: CLIPConfig, pixel_values, input_ids,
                attention_mask=None) -> torch.Tensor:
    """torchmetrics CLIPScore: max(100 cos(img, txt), 0) a pair."""
    img = image_features(params, cfg, pixel_values)
    txt = text_features(params, cfg, input_ids, attention_mask)

    def norm(x):
        return x / x.norm(dim=-1, keepdim=True).clamp_min(1e-8)

    return (100.0 * (norm(img) * norm(txt)).sum(-1)).clamp_min(0.0)


# --------------------------------------------------------------- converters

def _np(v) -> np.ndarray:
    return np.asarray(v.detach().cpu().float().numpy() if hasattr(v, "detach") else v)


def _tower_from_torch(state: Mapping, prefix: str, n_layers: int) -> dict:
    """`{prefix}.encoder.layers.{i}` stacked into (L, ...) arrays; torch's
    Linear weights (out, in) transposed to (in, out)."""
    names = {
        "q_w": "self_attn.q_proj.weight", "q_b": "self_attn.q_proj.bias",
        "k_w": "self_attn.k_proj.weight", "k_b": "self_attn.k_proj.bias",
        "v_w": "self_attn.v_proj.weight", "v_b": "self_attn.v_proj.bias",
        "o_w": "self_attn.out_proj.weight", "o_b": "self_attn.out_proj.bias",
        "ln1_w": "layer_norm1.weight", "ln1_b": "layer_norm1.bias",
        "fc1_w": "mlp.fc1.weight", "fc1_b": "mlp.fc1.bias",
        "fc2_w": "mlp.fc2.weight", "fc2_b": "mlp.fc2.bias",
        "ln2_w": "layer_norm2.weight", "ln2_b": "layer_norm2.bias",
    }
    out = {}
    for ours, theirs in names.items():
        mats = [_np(state[f"{prefix}.encoder.layers.{i}.{theirs}"]) for i in range(n_layers)]
        if ours.endswith("_w") and not ours.startswith("ln"):
            mats = [m.T for m in mats]
        out[ours] = np.stack(mats)
    return out


def to_tensors(tree, device: DeviceLike = None, dtype: torch.dtype = torch.float32):
    """A nested dict of arrays as tensors on `device` (floats as `dtype`)."""
    device = resolve_device(device)

    def conv(x):
        t = x if isinstance(x, torch.Tensor) else torch.from_numpy(np.array(x))
        return t.to(device, dtype if t.is_floating_point() else t.dtype)

    return {k: to_tensors(v, device, dtype) if isinstance(v, dict) else conv(v)
            for k, v in tree.items()}


def from_torch_state(state: Mapping, cfg: CLIPConfig, device: DeviceLike = None,
                     dtype: torch.dtype = torch.float32) -> Params:
    """A `transformers.CLIPModel` state dict (CLIP checkpoints' format) as
    this module's params on `device`."""
    params = {
        "text": {
            "tok_emb": _np(state["text_model.embeddings.token_embedding.weight"]),
            "pos_emb": _np(state["text_model.embeddings.position_embedding.weight"]),
            "layers": _tower_from_torch(state, "text_model", cfg.text.num_layers),
            "final_ln_w": _np(state["text_model.final_layer_norm.weight"]),
            "final_ln_b": _np(state["text_model.final_layer_norm.bias"]),
            "proj": _np(state["text_projection.weight"]).T,
        },
        "vision": {
            "cls": _np(state["vision_model.embeddings.class_embedding"]),
            "patch": _np(state["vision_model.embeddings.patch_embedding.weight"])
            .reshape(cfg.vision.hidden_size, -1).T,
            "pos_emb": _np(state["vision_model.embeddings.position_embedding.weight"]),
            "pre_ln_w": _np(state["vision_model.pre_layrnorm.weight"]),
            "pre_ln_b": _np(state["vision_model.pre_layrnorm.bias"]),
            "layers": _tower_from_torch(state, "vision_model", cfg.vision.num_layers),
            "post_ln_w": _np(state["vision_model.post_layernorm.weight"]),
            "post_ln_b": _np(state["vision_model.post_layernorm.bias"]),
            "proj": _np(state["visual_projection.weight"]).T,
        },
        "logit_scale": _np(state["logit_scale"]),
    }
    return to_tensors(params, device, dtype)


def init_clip(cfg: CLIPConfig, seed: int = 0, device: DeviceLike = None) -> Params:
    """Random params for `cfg` from `seed` (weights normal at 0.02, biases
    and norms perturbed), drawn on the CPU and moved to `device`, so that
    every device holds the same weights."""
    g = torch.Generator().manual_seed(seed)

    def randn(*shape, std=0.02):
        return torch.randn(shape, generator=g) * std

    def tower(c: CLIPTowerConfig):
        n, d, f = c.num_layers, c.hidden_size, c.intermediate_size
        out = {}
        for name in ("q", "k", "v", "o"):
            out[f"{name}_w"], out[f"{name}_b"] = randn(n, d, d), randn(n, d)
        for ln in ("ln1", "ln2"):
            out[f"{ln}_w"], out[f"{ln}_b"] = 1 + randn(n, d), randn(n, d)
        out["fc1_w"], out["fc1_b"] = randn(n, d, f), randn(n, f)
        out["fc2_w"], out["fc2_b"] = randn(n, f, d), randn(n, d)
        return out

    t, v = cfg.text, cfg.vision
    n_pos = (cfg.image_size // cfg.patch_size) ** 2 + 1
    params = {
        "text": {"tok_emb": randn(cfg.vocab_size, t.hidden_size),
                 "pos_emb": randn(cfg.max_positions, t.hidden_size, std=0.01),
                 "layers": tower(t), "final_ln_w": 1 + randn(t.hidden_size),
                 "final_ln_b": randn(t.hidden_size),
                 "proj": randn(t.hidden_size, cfg.projection_dim)},
        "vision": {"cls": randn(v.hidden_size),
                   "patch": randn(3 * cfg.patch_size ** 2, v.hidden_size),
                   "pos_emb": randn(n_pos, v.hidden_size),
                   "pre_ln_w": 1 + randn(v.hidden_size), "pre_ln_b": randn(v.hidden_size),
                   "layers": tower(v), "post_ln_w": 1 + randn(v.hidden_size),
                   "post_ln_b": randn(v.hidden_size),
                   "proj": randn(v.hidden_size, cfg.projection_dim)},
        "logit_scale": torch.tensor(np.log(1 / 0.07), dtype=torch.float32),
    }
    return to_tensors(params, device)


def load_clip(clip_dir: str, device: DeviceLike = None, dtype: torch.dtype = torch.float32):
    """(params, cfg) from a local transformers CLIP checkpoint directory
    (config.json + safetensors or pytorch_model.bin weights)."""
    with open(os.path.join(clip_dir, "config.json")) as f:
        cfg = CLIPConfig.from_hf(json.load(f))
    return from_torch_state(load_state(clip_dir), cfg, device, dtype), cfg


def load_state(model_dir: str) -> Mapping:
    """A checkpoint directory's flat state dict: its safetensors files
    (the port's reader), else `pytorch_model.bin`."""
    if any(f.endswith(".safetensors") for f in os.listdir(model_dir)):
        from mmada_tpu_torch.checkpoints.safetensors_io import iter_safetensors

        return dict(iter_safetensors(model_dir))
    return torch.load(os.path.join(model_dir, "pytorch_model.bin"), map_location="cpu",
                      weights_only=True)
