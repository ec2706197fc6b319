"""Motion VQ-VAE reference weights into the port's `MotionVQ`.

Counterpart of `mmada_tpu/checkpoints/motion_import.py` (:28-90). The
reference modules are anonymous `nn.Sequential` stacks
(motion_vqvae/models/encdec.py), so state-dict keys are positional:

  encoder: model.0 conv_in | model.1 ReLU | model.{2..1+down_t}
           (.0 stride conv, .1.model.{d} res blocks) | model.{2+down_t} conv_out
  decoder: model.0 conv_in | model.1 ReLU | model.{2..1+down_t}
           (.0.model.{d} res blocks, .2 conv) | conv_mid | ReLU | conv_out

The port's `MotionVQ` is laid out the same way with torch's `(out, in, k)`
conv weights, so a reference state dict loads by its own keys, with no
transpose: `vqvae.encoder.*` / `vqvae.decoder.*` (a full `HumanVQVAE`
checkpoint) or `encoder.*` / `decoder.*`, and the codebook from
`vqvae.quantizer.codebook` (zeros when the dict has none, as in JAX).
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

from mmada_tpu_torch.core.device import DeviceLike, resolve_device
from mmada_tpu_torch.models.motion_vq import MotionVQ, MotionVQConfig

_CODEBOOK_KEYS = ("vqvae.quantizer.codebook", "quantizer.codebook", "codebook")


def _tensor(value, device, dtype) -> torch.Tensor:
    if isinstance(value, torch.Tensor):
        return value.detach().to(device=device, dtype=dtype)
    return torch.tensor(np.asarray(value, np.float32), dtype=dtype, device=device)


def motion_vq_from_torch(state: Mapping, cfg: MotionVQConfig, device: DeviceLike = None,
                         dtype: torch.dtype = torch.float32) -> MotionVQ:
    """A `HumanVQVAE` state dict (torch tensors or numpy arrays) as the
    port's `MotionVQ` on `device`. Every encoder and decoder weight must be
    present (a strict load)."""
    device = resolve_device(device)
    vq = MotionVQ(cfg).to(device=device, dtype=dtype)
    own: dict[str, torch.Tensor] = {}
    for key, value in state.items():
        name = key[len("vqvae."):] if key.startswith("vqvae.") else key
        if name.startswith(("encoder.", "decoder.")):
            own[name] = _tensor(value, device, dtype)
    for key in _CODEBOOK_KEYS:
        if key in state:
            own["codebook"] = _tensor(state[key], device, dtype)
            break
    else:
        own["codebook"] = torch.zeros((cfg.nb_code, cfg.code_dim), dtype=dtype, device=device)
    vq.load_state_dict(own, strict=True)
    return vq
