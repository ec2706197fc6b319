"""LoRA adapters for the LLaDA backbone.

Counterpart of `mmada_tpu/models/lora.py` (the reference's PEFT setup for t2m
LoRA fine-tuning, training/train_t2m_lora.py:443-454;
configs/t2m_instruct_lora.yaml:53-58: r=32, alpha=64, adapters on the
attention and MLP projections, plus fully trainable embeddings and head,
`modules_to_save=["embed_tokens","lm_head"]`, `wte` / `ff_out` here).

The adapters are a tree of their own, `{"blocks": {name: {"a": (L, in, r),
"b": (L, r, out)}}}` over the layer-stacked weights; `merge` folds
`W + (scale * A @ B in fp32).to(W.dtype)` into the effective weights and the
unchanged forward runs on them. A side branch `x @ W + scale * (x @ A) @ B`
would round otherwise in bf16, so the merge is kept, as in JAX. The tree that
trains is `trainable_params`: `{"lora": adapters, "wte", "head"}`, whose
names (`checkpoints.manager.flatten`: `lora/blocks/q_proj/a`, `wte`, `head`)
are the JAX tree's paths, so the optimizer's decay mask and global norm see
the leaves JAX's do.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional, Sequence

import torch

from mmada_tpu_torch.models import llada

DEFAULT_TARGETS = ("q_proj", "k_proj", "v_proj", "attn_out",
                   "ff_proj", "up_proj", "ff_out")


@dataclasses.dataclass(frozen=True)
class LoRAConfig:
    rank: int = 32
    alpha: float = 64.0
    targets: Sequence[str] = DEFAULT_TARGETS
    train_embeddings: bool = True   # modules_to_save analog (wte + head)

    @property
    def scale(self) -> float:
        return self.alpha / self.rank


@torch.no_grad()
def init_lora(params: Any, lcfg: LoRAConfig, dtype: torch.dtype = torch.float32,
              generator: Optional[torch.Generator] = None) -> Any:
    """Per-target A (normal 0.02, drawn in fp32) and B (zeros), layer-stacked
    on the weights' device, so the merged deltas start at zero. The draws
    differ from JAX's for the same seed (other streams)."""
    lora: dict = {"blocks": {}}
    blocks = params["blocks"]
    for name in lcfg.targets:
        if name not in blocks:
            continue
        n, d_in, d_out = blocks[name].shape
        device = blocks[name].device
        a = torch.empty((n, d_in, lcfg.rank), dtype=torch.float32, device=device)
        a.normal_(0.0, 1.0, generator=generator)
        lora["blocks"][name] = {
            "a": (a * 0.02).to(dtype),
            "b": torch.zeros((n, lcfg.rank, d_out), dtype=dtype, device=device),
        }
    return lora


def _merged(w: torch.Tensor, a: torch.Tensor, b: torch.Tensor, scale: float) -> torch.Tensor:
    """W + (scale * A @ B in fp32) cast to W's dtype before the addition."""
    return w + (torch.matmul(a.float(), b.float()) * scale).to(w.dtype)


def merge(params: Any, lora: Any, lcfg: LoRAConfig) -> Any:
    """Effective params: W + scale * A @ B per adapted block weight (the delta
    in fp32, cast to W's dtype before the addition)."""
    merged_blocks = dict(params["blocks"])
    for name, ab in lora["blocks"].items():
        merged_blocks[name] = _merged(params["blocks"][name], ab["a"], ab["b"], lcfg.scale)
    out = dict(params)
    out["blocks"] = merged_blocks
    return out


def trainable_params(params: Any, lora: Any, lcfg: LoRAConfig) -> Any:
    """The tree that trains: the adapters (+ embeddings and head when
    configured). Its embedding and head are the base's tensors (no copy)."""
    out = {"lora": lora}
    if lcfg.train_embeddings:
        out["wte"] = params["wte"]
        if "ff_out" in params:
            out["head"] = params["ff_out"]
    return out


def apply_trainable(params: Any, trainable: Any, lcfg: LoRAConfig) -> Any:
    """The full effective params from (frozen base, trainable subset): `merge`'s
    weights, layer by layer, as a `layers` list (`llada.split_layers`' form),
    so that a layer's gradient reaches its slice of the adapters without a
    layer-stacked gradient the size of the weights."""
    out = {k: v for k, v in params.items() if k not in ("blocks", "layers")}
    if "wte" in trainable:
        out["wte"] = trainable["wte"]
    if "head" in trainable:
        out["ff_out"] = trainable["head"]
    adapters = trainable["lora"]["blocks"]
    layers = []
    for i, lp in enumerate(llada.layer_params(params)):
        layer = dict(lp)
        for name, ab in adapters.items():
            layer[name] = _merged(lp[name], ab["a"][i], ab["b"][i], lcfg.scale)
        layers.append(layer)
    out["layers"] = layers
    return out


def param_count(lora: Any) -> int:
    if isinstance(lora, torch.Tensor):
        return lora.numel()
    return sum(param_count(v) for v in lora.values())
