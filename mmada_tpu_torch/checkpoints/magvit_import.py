"""MAGVIT-v2 (showlab/magvitv2) reference weights into the port's tree.

Counterpart of `mmada_tpu/checkpoints/magvit_import.py`. The state dict
follows the reference module tree (models/modeling_magvitv2.py): `encoder.*`,
`decoder.*` and `quantize.*` (the LFQ holds only constant buffers: nothing
to load). The port's convs take torch's OIHW kernels, so every weight is
kept as it is: no transpose. `load_magvit2` reads a checkpoint's
safetensors files (`safetensors_io`, BF16 included); `magvit2_state_dict`
is the inverse, the fused state dict of the port's params.
"""

from __future__ import annotations

from typing import Any, Mapping

import numpy as np
import torch

from mmada_tpu_torch.checkpoints.safetensors_io import iter_safetensors
from mmada_tpu_torch.core.device import DeviceLike, resolve_device
from mmada_tpu_torch.models.magvit2 import VQGANConfig

Params = dict[str, Any]


def _component_from_state(state: Mapping[str, object], num_res_blocks, device, dtype,
                          is_encoder: bool) -> Params:
    """One of the encoder and decoder: `{down|up}.{level}.{block|attn}.{j}...`
    into the level lists, every other key into nested dicts; `.weight` is
    the leaf `w`, `.bias` the leaf `b`, any other key is skipped."""
    levels_key = "down" if is_encoder else "up"
    levels = [{"block": [{} for _ in range(n)], "attn": []} for n in num_res_blocks]
    out: Params = {levels_key: levels}
    for key, value in state.items():
        *parts, leaf = key.split(".")
        if leaf not in ("weight", "bias"):
            continue
        arr = (value.to(device=device, dtype=dtype) if isinstance(value, torch.Tensor)
               else torch.tensor(np.asarray(value, np.float32), dtype=dtype, device=device))
        node = out
        if parts[0] == levels_key:
            level, kind = levels[int(parts[1])], parts[2]
            if kind in ("block", "attn"):
                idx, parts, items = int(parts[3]), parts[4:], level[kind]
                while len(items) <= idx:
                    items.append({})
                node = items[idx]
            else:  # downsample / upsample
                node, parts = level.setdefault(kind, {}), parts[3:]
        for part in parts:
            node = node.setdefault(part, {})
        node["w" if leaf == "weight" else "b"] = arr
    return out


def magvit2_params_from_torch(encoder_state: Mapping[str, np.ndarray],
                              decoder_state: Mapping[str, np.ndarray], cfg: VQGANConfig,
                              dtype: torch.dtype = torch.float32,
                              device: DeviceLike = None) -> Params:
    """The port's MAGVIT-v2 params from the reference encoder and decoder
    state dicts (numpy values), on `device` (the card unless told
    otherwise)."""
    device = resolve_device(device)
    return {
        "encoder": _component_from_state(encoder_state, cfg.enc_num_res_blocks, device, dtype,
                                         is_encoder=True),
        "decoder": _component_from_state(decoder_state, cfg.dec_num_res_blocks, device, dtype,
                                         is_encoder=False),
    }


def magvit2_params_from_fused_state(state: Mapping[str, np.ndarray], cfg: VQGANConfig,
                                    dtype: torch.dtype = torch.float32,
                                    device: DeviceLike = None) -> Params:
    """Split a fused `MAGVITv2` state dict (`encoder.*` / `decoder.*`, the
    reference wrapper's save format) and convert it."""
    enc = {k[len("encoder."):]: v for k, v in state.items() if k.startswith("encoder.")}
    dec = {k[len("decoder."):]: v for k, v in state.items() if k.startswith("decoder.")}
    return magvit2_params_from_torch(enc, dec, cfg, dtype, device)


def load_magvit2(model_dir: str, cfg: VQGANConfig, device: DeviceLike = None,
                 dtype: torch.dtype = torch.bfloat16) -> Params:
    """The MAGVIT-v2 params of a local checkpoint (a fused `encoder.*` /
    `decoder.*` state dict in safetensors files) on `device` in `dtype`."""
    return magvit2_params_from_fused_state(dict(iter_safetensors(model_dir)), cfg, dtype,
                                           device)


def magvit2_state_dict(params: Params) -> dict[str, torch.Tensor]:
    """The fused state dict (`encoder.*` / `decoder.*`, the reference
    wrapper's keys) of the port's params: the inverse of
    `magvit2_params_from_fused_state`, its tensors the params' own."""
    out: dict[str, torch.Tensor] = {}

    def walk(node, prefix):
        if isinstance(node, torch.Tensor):
            leaf = {"w": "weight", "b": "bias"}[prefix.rsplit(".", 1)[-1]]
            out[f"{prefix.rsplit('.', 1)[0]}.{leaf}"] = node
            return
        items = node.items() if isinstance(node, Mapping) else enumerate(node)
        for k, v in items:
            walk(v, f"{prefix}.{k}")

    for part in ("encoder", "decoder"):
        walk(params[part], part)
    return out
