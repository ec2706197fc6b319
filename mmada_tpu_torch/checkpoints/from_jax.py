"""Weights into the port's parameter layout.

* `params_from_jax` takes the JAX package's LLaDA params as numpy arrays
  (`jax.device_get(params)`) and returns the port's: the layouts are the
  same, so this is `torch.from_numpy` and a move, with no transposes. A
  quantized leaf of the JAX package (`QuantizedTensor`, `W8A8Tensor`,
  `Int4Tensor`, as `jax.device_get` returns them: the JAX dataclass with
  numpy fields) becomes the port's class of the same name, its int8 codes
  kept int8 and its scales fp32.
* `named_from_jax` takes any tree of that shape (params, or the optax AdamW
  moments `mu` / `nu`, which mirror it) into the trainable layout's flat
  names (`llada.named_leaves` of `llada.split_layers`: one tensor per layer
  and weight kind, `layers.{i}.{kind}`).
* `magvit2_from_jax` takes the JAX package's MAGVIT-v2 params as numpy
  arrays and returns the port's: the same tree, with each HWIO conv kernel
  transposed to torch's OIHW.
* `motion_vq_from_jax` takes the JAX package's motion VQ-VAE params as
  numpy arrays (`init_motion_vq`, `motion_vq_from_torch`) and returns the
  port's `MotionVQ`: each TIO conv kernel transposed to torch's `(out, in,
  k)`, placed at the reference's positional keys.
* `params_from_torch_state_dict` is the counterpart of
  `mmada_tpu/checkpoints/hf_import.params_from_torch_state_dict`: it reads a
  flat reference state dict (`model.transformer.blocks.{i}.q_proj.weight`,
  ...; the goldens' `w::` keys), transposes torch's `(out, in)` linear
  weights to `(in, out)` and stacks the layers, through the same streaming
  filler as checkpoint loading (`hf_import.fill_params`).
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

from mmada_tpu_torch.checkpoints.hf_import import fill_params
from mmada_tpu_torch.core.device import DeviceLike, resolve_device
from mmada_tpu_torch.models.llada import LLaDAConfig, Params, named_leaves
from mmada_tpu_torch.ops import quantization as Q

# the JAX package's quantized leaf classes, by name, and their fields
_QUANTIZED = {"QuantizedTensor": (Q.QuantizedTensor, ("values", "scales")),
              "W8A8Tensor": (Q.W8A8Tensor, ("values", "scales")),
              "Int4Tensor": (Q.Int4Tensor, ("packed", "scales"))}


def _tensor(a, device: torch.device, dtype: torch.dtype) -> torch.Tensor:
    arr = np.asarray(a)
    if arr.dtype.kind == "V" or str(arr.dtype) == "bfloat16":
        arr = arr.astype(np.float32)  # ml_dtypes bfloat16 has no torch twin
    return torch.tensor(arr, dtype=dtype, device=device)


def _leaf(a, device: torch.device, dtype: torch.dtype):
    """A weight as `dtype`, or a quantized leaf as the port's class with its
    fields' own dtypes."""
    quantized = _QUANTIZED.get(type(a).__name__)
    if quantized is None:
        return _tensor(a, device, dtype)
    cls, fields = quantized
    return cls(**{f: torch.from_numpy(np.array(getattr(a, f))).to(device) for f in fields})


def params_from_jax(np_tree: Mapping, cfg: LLaDAConfig, device: DeviceLike = None,
                    dtype: torch.dtype = torch.float32) -> Params:
    """The JAX `llada.init_params` / `load_pretrained` pytree (numpy leaves),
    or a quantized one (`quantize_llada_params`), as the port's params on
    `device`."""
    device = resolve_device(device)
    params: Params = {
        "wte": _tensor(np_tree["wte"], device, dtype),
        "ln_f": _tensor(np_tree["ln_f"], device, dtype),
        "blocks": {
            name: _leaf(arr, device, dtype)
            for name, arr in np_tree["blocks"].items()
        },
    }
    if not cfg.weight_tying:
        params["ff_out"] = _leaf(np_tree["ff_out"], device, dtype)
    n = cfg.n_layers
    for name, t in params["blocks"].items():
        if t.shape[0] != n:
            raise ValueError(f"blocks[{name!r}] has {t.shape[0]} layers, config {n}")
    return params


def named_from_jax(np_tree: Mapping, device: DeviceLike = None,
                   dtype: torch.dtype = torch.float32) -> dict[str, torch.Tensor]:
    """A JAX params-shaped tree (numpy leaves) by the trainable layout's
    names: `wte`, `ln_f`, `ff_out`, `layers.{i}.{kind}`."""
    device = resolve_device(device)
    tree: Params = {name: _tensor(a, device, dtype)
                    for name, a in np_tree.items() if name != "blocks"}
    tree["blocks"] = {name: _tensor(a, device, dtype)
                      for name, a in np_tree["blocks"].items()}
    return {name: t.contiguous() for name, t in named_leaves(tree)}


def magvit2_from_jax(np_tree, cfg, device: DeviceLike = None,
                     dtype: torch.dtype = torch.float32):
    """The JAX `magvit2.init_magvit2` / `magvit2_params_from_torch` pytree
    (numpy leaves) as the port's MAGVIT-v2 params on `device`. `cfg` (a
    `VQGANConfig`) is checked against the tree's encoder levels."""
    device = resolve_device(device)

    def convert(node):
        if isinstance(node, Mapping):
            return {k: convert(v) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return [convert(v) for v in node]
        t = _tensor(node, device, dtype)
        return t.permute(3, 2, 0, 1).contiguous() if t.ndim == 4 else t  # HWIO -> OIHW

    params = convert(np_tree)
    if len(params["encoder"]["down"]) != cfg.num_levels:
        raise ValueError(f"encoder has {len(params['encoder']['down'])} levels, "
                         f"config {cfg.num_levels}")
    return params


def params_from_torch_state_dict(
    state: Mapping[str, np.ndarray],
    cfg: LLaDAConfig,
    device: DeviceLike = None,
    dtype: torch.dtype = torch.float32,
    block_group_size: int = 1,
) -> Params:
    """Stacked params from a flat reference state dict (numpy values):
    `hf_import.fill_params` over the dict's items."""
    return fill_params(state.items(), cfg, device=device, dtype=dtype,
                       block_group_size=block_group_size)


def motion_vq_state_from_jax(np_tree) -> dict[str, np.ndarray]:
    """The JAX motion VQ-VAE tree (numpy leaves) as a `MotionVQ` state dict:
    the reference's positional keys, `(out, in, k)` conv weights."""
    out: dict[str, np.ndarray] = {}

    def conv(prefix, p):
        out[f"{prefix}.weight"] = np.asarray(p["w"], np.float32).transpose(2, 1, 0)
        out[f"{prefix}.bias"] = np.asarray(p["b"], np.float32)

    def resnet(prefix, blocks):
        for d, blk in enumerate(blocks):
            conv(f"{prefix}.model.{d}.conv1", blk["conv1"])
            conv(f"{prefix}.model.{d}.conv2", blk["conv2"])

    enc, dec = np_tree["encoder"], np_tree["decoder"]
    conv("encoder.model.0", enc["conv_in"])
    for i, level in enumerate(enc["down"]):
        conv(f"encoder.model.{2 + i}.0", level["conv"])
        resnet(f"encoder.model.{2 + i}.1", level["resnet"])
    conv(f"encoder.model.{2 + len(enc['down'])}", enc["conv_out"])
    conv("decoder.model.0", dec["conv_in"])
    for i, level in enumerate(dec["up"]):
        resnet(f"decoder.model.{2 + i}.0", level["resnet"])
        conv(f"decoder.model.{2 + i}.2", level["conv"])
    conv(f"decoder.model.{2 + len(dec['up'])}", dec["conv_mid"])
    conv(f"decoder.model.{4 + len(dec['up'])}", dec["conv_out"])
    out["codebook"] = np.asarray(np_tree["codebook"], np.float32)
    return out


def motion_vq_from_jax(np_tree, cfg, device: DeviceLike = None,
                       dtype: torch.dtype = torch.float32):
    """The JAX `motion_vq.init_motion_vq` / `motion_vq_from_torch` tree
    (numpy leaves) as the port's `MotionVQ` on `device` (`cfg` a
    `MotionVQConfig`; a strict load checks every weight's place and shape)."""
    from mmada_tpu_torch.checkpoints.motion_import import motion_vq_from_torch

    return motion_vq_from_torch(motion_vq_state_from_jax(np_tree), cfg, device=device,
                                dtype=dtype)
