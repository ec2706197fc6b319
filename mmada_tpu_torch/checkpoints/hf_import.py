"""Local Hugging Face checkpoints of LLaDA / MMaDA into the port's params.

Counterpart of `mmada_tpu/checkpoints/hf_import.py`. The reference key
layout (models/modeling_llada.py):

    model.transformer.wte.weight                     (V, D) embedding
    model.transformer.blocks.{i}.attn_norm.weight    (D,)
    model.transformer.blocks.{i}.q_proj.weight       (D, D)    [llama block]
    model.transformer.blocks.{i}.k_proj.weight       (KVH*hd, D)
    model.transformer.blocks.{i}.v_proj.weight       (KVH*hd, D)
    model.transformer.blocks.{i}.att_proj.weight     (D+2*KVH*hd, D) [sequential]
    model.transformer.blocks.{i}.attn_out.weight     (D, D)
    model.transformer.blocks.{i}.ff_norm.weight      (D,)
    model.transformer.blocks.{i}.ff_proj.weight      (F, D)
    model.transformer.blocks.{i}.up_proj.weight      (F, D)    [llama block]
    model.transformer.blocks.{i}.ff_out.weight       (D, F')
    model.transformer.ln_f.weight                    (D,)
    model.transformer.ff_out.weight                  (V, D)    [no weight tying]

Blocks may be grouped (`block_groups.{g}.{j}.`, `block_group_size` > 1).
Torch stores a linear weight `(out, in)`; the port's params hold `(in, out)`
with the layers stacked on a leading axis.

`fill_params` streams: each stacked leaf is allocated once, on the target
device in the target dtype, when its first layer arrives, and every tensor
is copied into its layer's slot as it is read (moved in its stored dtype,
transposed on the device). Loading a full-width 8B therefore holds one
tensor on the host at a time, never the model. `load_pretrained` feeds it
from safetensors files (`safetensors_io`, BF16 included) or from
`pytorch_model.bin`; `from_jax.params_from_torch_state_dict` from a dict.

`export_pretrained` writes the inverse: `config.json` in the reference's
field names and the weights in the reference key layout, sharded with an
index (the counterparts of `export_hf_config` and `export_safetensors`,
`mmada_tpu/checkpoints/manager.py`).
"""

from __future__ import annotations

import json
import os
import re
from typing import Iterable, Optional

import numpy as np
import torch

from mmada_tpu_torch.checkpoints import safetensors_io
from mmada_tpu_torch.core.device import DeviceLike, resolve_device
from mmada_tpu_torch.models.llada import LLaDAConfig, Params

_BLOCK_RE = re.compile(
    r"(?:model\.)?transformer\.(?:blocks\.(\d+)|block_groups\.(\d+)\.(\d+))\.(.+)"
)
_LINEAR_2D = {
    "q_proj", "k_proj", "v_proj", "att_proj", "attn_out",
    "ff_proj", "up_proj", "ff_out",
}
_NORM_1D = {"attn_norm", "ff_norm", "q_norm", "k_norm"}


def _canon_layer(key: str, block_group_size: int) -> Optional[tuple[int, str]]:
    """(layer, rest of the key) of a block's tensor, None for other keys; a
    block index past `block_group_size` in a group raises."""
    m = _BLOCK_RE.match(key)
    if not m:
        return None
    if m.group(1) is not None:
        return int(m.group(1)), m.group(4)
    g, j = int(m.group(2)), int(m.group(3))
    if j >= block_group_size:
        raise ValueError(f"{key}: block {j} of a group, but block_group_size is "
                         f"{block_group_size}")
    return g * block_group_size + j, m.group(4)


def _as_tensor(value) -> torch.Tensor:
    """A state dict's value (a CPU tensor, or a numpy array, ml_dtypes'
    bfloat16 included) as a tensor on the host."""
    if isinstance(value, torch.Tensor):
        return value
    arr = np.asarray(value)
    if str(arr.dtype) == "bfloat16":
        return torch.from_numpy(np.ascontiguousarray(arr).view(np.uint16)).view(torch.bfloat16)
    return torch.from_numpy(np.array(arr) if not arr.flags.writeable else arr)


def _copy_into(slot: torch.Tensor, t: torch.Tensor, transpose: bool) -> None:
    """`slot` <- `t` (transposed), moved in its stored dtype and cast on
    `slot`'s device."""
    if tuple(slot.shape) != (t.shape[::-1] if transpose else tuple(t.shape)):
        raise ValueError(f"a tensor of shape {tuple(t.shape)} for a slot of "
                         f"{tuple(slot.shape)}{' (transposed)' if transpose else ''}")
    t = t.to(slot.device)
    slot.copy_(t.T if transpose else t)


@torch.no_grad()
def fill_params(items: Iterable[tuple[str, object]], cfg: LLaDAConfig,
                device: DeviceLike = None, dtype: torch.dtype = torch.bfloat16,
                block_group_size: int = 1) -> Params:
    """Stacked params on `device` in `dtype` from (key, value) pairs of a
    reference state dict, consumed one at a time. Keys outside the layout
    are skipped; a missing layer, a layer given twice, a layer past
    `cfg.n_layers`, a missing embedding or final norm, and a missing
    `transformer.ff_out.weight` when `cfg.weight_tying` is false raise."""
    device = resolve_device(device)
    n = cfg.n_layers
    blocks: dict[str, torch.Tensor] = {}
    filled: dict[str, list[bool]] = {}
    top: dict[str, torch.Tensor] = {}
    for key, value in items:
        parsed = _canon_layer(key, block_group_size)
        if parsed is not None:
            layer, rest = parsed
            name, _, leaf = rest.partition(".")
            if leaf == "weight" and name in _LINEAR_2D:
                transpose = True
            elif leaf == "weight" and name in _NORM_1D:
                transpose = False
            elif leaf == "bias":
                name, transpose = f"{name}_bias", False
            else:
                continue
            if not 0 <= layer < n:
                raise ValueError(f"{key}: layer {layer} of a {n}-layer config")
            t = _as_tensor(value)
            if name not in blocks:
                shape = t.shape[::-1] if transpose else tuple(t.shape)
                blocks[name] = torch.empty((n, *shape), dtype=dtype, device=device)
                filled[name] = [False] * n
            if filled[name][layer]:
                raise ValueError(f"{key}: layer {layer} of {name!r} given twice")
            _copy_into(blocks[name][layer], t, transpose)
            filled[name][layer] = True
            continue
        skey = key[len("model."):] if key.startswith("model.") else key
        name = {"transformer.wte.weight": "wte", "transformer.ln_f.weight": "ln_f",
                "transformer.ff_out.weight": "ff_out"}.get(skey)
        if name is None or (name == "ff_out" and cfg.weight_tying):
            continue
        t = _as_tensor(value)
        transpose = name == "ff_out"
        top[name] = torch.empty(t.shape[::-1] if transpose else tuple(t.shape), dtype=dtype,
                                device=device)
        _copy_into(top[name], t, transpose)

    for name, done in filled.items():
        missing = [i for i, d in enumerate(done) if not d]
        if missing:
            raise ValueError(f"layers {missing} missing tensor {name!r}")
    for name in ("wte", "ln_f"):
        if name not in top:
            raise ValueError(f"no transformer.{name}.weight in the checkpoint")
    if not cfg.weight_tying and "ff_out" not in top:
        raise ValueError("weight_tying=False but no transformer.ff_out.weight")
    params = {"wte": top["wte"], "ln_f": top["ln_f"], "blocks": blocks}
    if "ff_out" in top:
        params["ff_out"] = top["ff_out"]
    return params


def _has_safetensors(model_dir: str) -> bool:
    return os.path.exists(os.path.join(model_dir, safetensors_io.INDEX_NAME)) or any(
        f.endswith(".safetensors") for f in os.listdir(model_dir))


def load_pretrained(model_dir: str, cfg: LLaDAConfig, device: DeviceLike = None,
                    dtype: torch.dtype = torch.bfloat16, block_group_size: int = 1) -> Params:
    """LLaDA / MMaDA weights from a local checkpoint directory onto `device`
    (the card unless told otherwise) in `dtype`: safetensors (single or
    sharded) or `pytorch_model.bin`, the two formats the reference resume
    path handles (train_mmada.py:404-434). A `.bin` keeps its stored dtype
    until it reaches the device; it is memory-mapped where its format
    allows."""
    device = resolve_device(device)
    if _has_safetensors(model_dir):
        items = safetensors_io.iter_safetensors(model_dir)
    else:
        bin_path = os.path.join(model_dir, "pytorch_model.bin")
        if not os.path.exists(bin_path):
            raise FileNotFoundError(f"no safetensors or pytorch_model.bin under {model_dir}")
        try:
            raw = torch.load(bin_path, map_location="cpu", weights_only=True, mmap=True)
        except RuntimeError:  # the legacy (non-zip) format cannot be mapped
            raw = torch.load(bin_path, map_location="cpu", weights_only=True)
        items = raw.items()
    return fill_params(items, cfg, device=device, dtype=dtype,
                       block_group_size=block_group_size)


_HF_FIELDS = (
    "d_model", "n_heads", "n_kv_heads", "n_layers", "mlp_hidden_size", "mlp_ratio",
    "vocab_size", "embedding_size", "max_sequence_length", "rope_theta",
    "rope_full_precision", "layer_norm_type", "rms_norm_eps", "activation_type",
    "block_type", "weight_tying", "include_bias", "include_qkv_bias",
    "attention_layer_norm", "input_emb_norm", "scale_logits", "mask_token_id",
)


def config_from_hf_json(path_or_dict) -> LLaDAConfig:
    """A Hugging Face `config.json` (LLaDAConfig / MMadaConfig fields), or the
    directory holding it, as the port's `LLaDAConfig`; `new_vocab_size`
    (MMadaConfig, after the embedding resize) supersedes `vocab_size` and
    `embedding_size`."""
    if isinstance(path_or_dict, (str, os.PathLike)):
        with open(os.path.join(str(path_or_dict), "config.json")) as f:
            raw = json.load(f)
    else:
        raw = dict(path_or_dict)
    kwargs = {k: raw[k] for k in _HF_FIELDS if raw.get(k) is not None}
    if raw.get("new_vocab_size"):
        kwargs["vocab_size"] = kwargs["embedding_size"] = raw["new_vocab_size"]
    return LLaDAConfig(**kwargs)


def hf_config(cfg: LLaDAConfig, vocab=None) -> dict:
    """The reference-compatible `config.json` of `cfg` (the inverse of
    `config_from_hf_json`; `export_hf_config`'s fields), with the fused
    vocab's sizes when `vocab` (a `VocabLayout`) is given."""
    raw = {"architectures": ["MMadaModelLM"], "model_type": "mmada"}
    raw.update({k: getattr(cfg, k) for k in _HF_FIELDS})
    raw.update(embedding_size=cfg.effective_vocab_size, rope=True, alibi=False,
               use_cache=False, block_group_size=1)
    if vocab is not None:
        raw.update(new_vocab_size=vocab.total_vocab_size, llm_vocab_size=vocab.text_vocab_size,
                   codebook_size=vocab.image_codebook_size)
    return raw


def state_dict_views(params: Params) -> dict[str, torch.Tensor]:
    """The params in the reference key layout: views, `(out, in)` linear
    weights as transposed views of the stacked leaves (no copy is made)."""
    out = {"model.transformer.wte.weight": params["wte"],
           "model.transformer.ln_f.weight": params["ln_f"]}
    if "ff_out" in params:
        out["model.transformer.ff_out.weight"] = params["ff_out"].T
    layers = next(iter(params["blocks"].values())).shape[0]
    for i in range(layers):
        prefix = f"model.transformer.blocks.{i}"
        for name, stacked in params["blocks"].items():
            if name.endswith("_bias"):
                out[f"{prefix}.{name[:-len('_bias')]}.bias"] = stacked[i]
            elif stacked.ndim == 3:
                out[f"{prefix}.{name}.weight"] = stacked[i].T
            else:
                out[f"{prefix}.{name}.weight"] = stacked[i]
    return out


def export_pretrained(model_dir: str, params: Params, cfg: LLaDAConfig, vocab=None,
                      max_shard_bytes: int = 5 * 10**9) -> list[str]:
    """Write `config.json` and the weights (their own dtype, sharded with
    `model.safetensors.index.json`) into `model_dir`; returns the shards."""
    os.makedirs(model_dir, exist_ok=True)
    with open(os.path.join(model_dir, "config.json"), "w") as f:
        json.dump(hf_config(cfg, vocab), f, indent=2)
    return safetensors_io.save_sharded(state_dict_views(params), model_dir,
                                       max_shard_bytes=max_shard_bytes,
                                       metadata={"format": "pt"})
