"""T2M evaluator models: BiGRU text / motion encoders and the movement conv
encoder, with the published checkpoint's import.

The counterpart of `mmada_tpu/eval/t2m_evaluator.py` (the reference's
models/modules.py:13-109 and models/evaluator_wrapper.py:8-90), producing
the embeddings that `eval/t2m_metrics.py` consumes. The pretrained weights
ship as torch checkpoints (`checkpoints/t2m/Comp_v6_KLD005/`); `*_from_torch`
read their state dicts.

The GRU is written as the JAX package writes it, one cell a step with the
gates ordered (r, z, n) and each row's length as a mask (`bigru_last`): the
forward direction's last hidden is the state at the row's final valid step,
the backward direction's the state after scanning from the last valid step
down to 0 (the packed-sequence semantics). It is not `torch.nn.GRU` over
packed sequences: the masked cell is what the goldens and JAX compute.
Params are dicts of fp32 tensors with the JAX package's keys; the conv
weights keep torch's `(out, in, k)` layout.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Mapping

import numpy as np
import torch
import torch.nn.functional as F

from mmada_tpu_torch.core.device import DeviceLike, resolve_device

Params = dict[str, Any]


# ----------------------------------------------------------------- GRU core

def gru_cell(x, h, w_ih, w_hh, b_ih, b_hh):
    """torch.nn.GRU's cell: gates ordered (reset, update, new)."""
    gi = x @ w_ih.T + b_ih
    gh = h @ w_hh.T + b_hh
    i_r, i_z, i_n = gi.chunk(3, dim=-1)
    h_r, h_z, h_n = gh.chunk(3, dim=-1)
    r = torch.sigmoid(i_r + h_r)
    z = torch.sigmoid(i_z + h_z)
    n = torch.tanh(i_n + r * h_n)
    return (1.0 - z) * n + z * h


def bigru_last(p: Params, x: torch.Tensor, lengths: torch.Tensor,
               h0: torch.Tensor) -> torch.Tensor:
    """A bidirectional GRU's final hidden states.

    x: (B, T, D); lengths: (B,); h0: (2, 1, H), the learned initial hidden
    (modules.py `self.hidden`). Returns (B, 2H): concat(fwd_last, bwd_last),
    `torch.cat([gru_last[0], gru_last[1]])` over packed sequences."""
    b, t, _ = x.shape
    lengths = lengths.to(x.device)
    h_f = h0[0].expand(b, h0.shape[-1])
    h_b = h0[1].expand(b, h0.shape[-1])
    for i in range(t):
        h_new = gru_cell(x[:, i], h_f, p["w_ih_f"], p["w_hh_f"], p["b_ih_f"], p["b_hh_f"])
        h_f = torch.where((i < lengths)[:, None], h_new, h_f)
    for i in reversed(range(t)):
        h_new = gru_cell(x[:, i], h_b, p["w_ih_b"], p["w_hh_b"], p["b_ih_b"], p["b_hh_b"])
        h_b = torch.where((i < lengths)[:, None], h_new, h_b)
    return torch.cat([h_f, h_b], dim=-1)


def _output_net(p: Params, x: torch.Tensor) -> torch.Tensor:
    """Linear -> LayerNorm -> LeakyReLU(0.2) -> Linear (modules.py output_net)."""
    h = x @ p["fc1_w"].T + p["fc1_b"]
    mean = h.mean(-1, keepdim=True)
    var = ((h - mean) ** 2).mean(-1, keepdim=True)
    h = (h - mean) / torch.sqrt(var + 1e-5)
    h = h * p["ln_w"] + p["ln_b"]
    h = torch.where(h >= 0, h, 0.2 * h)
    return h @ p["fc2_w"].T + p["fc2_b"]


# ------------------------------------------------------------- the encoders

def text_encoder_forward(p: Params, word_embs, pos_onehot, cap_lens):
    """TextEncoderBiGRUCo (modules.py:36-74): GloVe word vectors + POS
    one-hots -> BiGRU -> projection."""
    pos = pos_onehot @ p["pos_emb_w"].T + p["pos_emb_b"]
    inputs = word_embs + pos
    embs = inputs @ p["input_emb_w"].T + p["input_emb_b"]
    last = bigru_last(p["gru"], embs, cap_lens, p["hidden"])
    return _output_net(p["out"], last)


def motion_encoder_forward(p: Params, motion_feats, m_lens):
    """MotionEncoderBiGRUCo (modules.py:77-109): movement features -> BiGRU
    -> projection."""
    embs = motion_feats @ p["input_emb_w"].T + p["input_emb_b"]
    last = bigru_last(p["gru"], embs, m_lens, p["hidden"])
    return _output_net(p["out"], last)


def movement_encoder_forward(p: Params, raw_feats):
    """MovementConvEncoder (modules.py:13-33): two stride-2 conv1d +
    LeakyReLU, then a linear. (B, T, D_pose - 4) -> (B, T/4, D_move)."""
    x = raw_feats.transpose(1, 2)
    for conv in ("conv1", "conv2"):
        x = F.conv1d(x, p[conv]["w"], p[conv]["b"], stride=2, padding=1)
        x = torch.where(x >= 0, x, 0.2 * x)
    return x.transpose(1, 2) @ p["out_w"].T + p["out_b"]


# --------------------------------------------------------------- torch import

def _getter(state: Mapping, device):
    def g(key):
        v = state[key]
        v = v.detach().cpu().numpy() if hasattr(v, "detach") else np.asarray(v)
        return torch.as_tensor(np.asarray(v, np.float32), device=device)
    return g


def _gru_from_torch(g, prefix: str) -> Params:
    return {
        "w_ih_f": g(f"{prefix}.weight_ih_l0"), "w_hh_f": g(f"{prefix}.weight_hh_l0"),
        "b_ih_f": g(f"{prefix}.bias_ih_l0"), "b_hh_f": g(f"{prefix}.bias_hh_l0"),
        "w_ih_b": g(f"{prefix}.weight_ih_l0_reverse"),
        "w_hh_b": g(f"{prefix}.weight_hh_l0_reverse"),
        "b_ih_b": g(f"{prefix}.bias_ih_l0_reverse"),
        "b_hh_b": g(f"{prefix}.bias_hh_l0_reverse"),
    }


def _out_from_torch(g, prefix: str) -> Params:
    return {"fc1_w": g(f"{prefix}.0.weight"), "fc1_b": g(f"{prefix}.0.bias"),
            "ln_w": g(f"{prefix}.1.weight"), "ln_b": g(f"{prefix}.1.bias"),
            "fc2_w": g(f"{prefix}.3.weight"), "fc2_b": g(f"{prefix}.3.bias")}


def text_encoder_from_torch(state: Mapping, device: DeviceLike = None) -> Params:
    g = _getter(state, resolve_device(device))
    return {"pos_emb_w": g("pos_emb.weight"), "pos_emb_b": g("pos_emb.bias"),
            "input_emb_w": g("input_emb.weight"), "input_emb_b": g("input_emb.bias"),
            "gru": _gru_from_torch(g, "gru"), "out": _out_from_torch(g, "output_net"),
            "hidden": g("hidden")}


def motion_encoder_from_torch(state: Mapping, device: DeviceLike = None) -> Params:
    g = _getter(state, resolve_device(device))
    return {"input_emb_w": g("input_emb.weight"), "input_emb_b": g("input_emb.bias"),
            "gru": _gru_from_torch(g, "gru"), "out": _out_from_torch(g, "output_net"),
            "hidden": g("hidden")}


def movement_encoder_from_torch(state: Mapping, device: DeviceLike = None) -> Params:
    g = _getter(state, resolve_device(device))
    return {"conv1": {"w": g("main.0.weight"), "b": g("main.0.bias")},
            "conv2": {"w": g("main.3.weight"), "b": g("main.3.bias")},
            "out_w": g("out_net.weight"), "out_b": g("out_net.bias")}


def _tensor(x, device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(x) if not isinstance(x, torch.Tensor) else x,
                           device=device)


@dataclasses.dataclass
class EvaluatorWrapper:
    """The bundled evaluators (models/evaluator_wrapper.py:8-90): raw motion
    -> movement features -> motion embedding; a caption's word vectors ->
    text embedding. Inputs may be numpy arrays or tensors; they go to the
    weights' device, and the embeddings come back as fp32 tensors there."""

    text_params: Params
    motion_params: Params
    movement_params: Params
    unit_length: int = 4

    @property
    def device(self) -> torch.device:
        return self.movement_params["out_w"].device

    def _in(self, *xs):
        return [_tensor(x, self.device) for x in xs]

    def get_co_embeddings(self, word_embs, pos_onehot, cap_lens, motions, m_lens):
        word_embs, pos_onehot, cap_lens, motions, m_lens = self._in(
            word_embs, pos_onehot, cap_lens, motions, m_lens)
        move = movement_encoder_forward(self.movement_params, motions[..., :-4])
        motion_emb = motion_encoder_forward(self.motion_params, move,
                                            m_lens // self.unit_length)
        text_emb = text_encoder_forward(self.text_params, word_embs, pos_onehot, cap_lens)
        return text_emb, motion_emb

    def get_motion_embeddings(self, motions, m_lens):
        motions, m_lens = self._in(motions, m_lens)
        move = movement_encoder_forward(self.movement_params, motions[..., :-4])
        return motion_encoder_forward(self.motion_params, move, m_lens // self.unit_length)

    @classmethod
    def from_torch_checkpoint(cls, text_state, motion_state, movement_state,
                              unit_length: int = 4, device: DeviceLike = None):
        return cls(text_params=text_encoder_from_torch(text_state, device),
                   motion_params=motion_encoder_from_torch(motion_state, device),
                   movement_params=movement_encoder_from_torch(movement_state, device),
                   unit_length=unit_length)
