"""SmoothQuant scale migration for W8A8 serving.

Counterpart of `mmada_tpu/ops/smoothquant.py`. W8A8 quantizes activations per
token, so one hot channel sets a token's scale and crushes the others'
resolution. SmoothQuant (Xiao et al. 2022) moves that difficulty into the
weights with a per-input-channel factor s: the matmul input becomes x / s and
the weight s * W. Every fold is exact on this architecture:

  q/k/v (or att_proj)  <- attn_norm affine
  attn_out             <- v_proj output channels (shared over each GQA
                          group: query head h reads kv head h // rep)
  ff_proj / up_proj    <- ff_norm affine
  ff_out               <- up_proj output channels ('llama' blocks only)
  vocab-head ff_out    <- ln_f affine (untied heads only)

Biases sit after the input-side folds and are untouched; v_bias and the v
slice of att_proj_bias are output-side of the v fold and divide by s.

The stats come from `models.llada.calibration_stats`: the serving forward
itself, with taps at each quantized matmul's input. They only steer the
choice of s; the migration is exact for any s > 0. `entry.quantize`
("w8a8_smooth") calibrates, migrates and quantizes.
"""

from __future__ import annotations

from typing import Any

import torch

Params = Any

# s outside this range means one side of the migration is degenerate (a dead
# channel, a zero weight column): clamp rather than blow up the weight
# quantizer's range
_S_MIN, _S_MAX = 1e-2, 1e2


def _smooth_scales(act_amax: torch.Tensor, w_amax: torch.Tensor, alpha: float) -> torch.Tensor:
    a = torch.clamp(act_amax.float(), min=1e-6)
    w = torch.clamp(w_amax.float(), min=1e-6)
    return torch.clamp(a ** alpha / w ** (1.0 - alpha), _S_MIN, _S_MAX)


def _row_amax(w: torch.Tensor) -> torch.Tensor:
    """Per-input-channel (contracting row) absmax: (..., in, out) -> (..., in)."""
    return w.abs().amax(dim=-1).float()


def _scale_norm(weight: torch.Tensor, s: torch.Tensor, gemma: bool) -> torch.Tensor:
    """Fold 1/s into a norm affine: plain affines multiply by w, Gemma-RMS by
    (1 + w)."""
    wf = weight.float()
    out = ((1.0 + wf) / s - 1.0) if gemma else wf / s
    return out.to(weight.dtype)


def _layers(w: torch.Tensor):
    """Indices that cut a stacked (layers, in, out) weight into its layers, or
    `...` (the whole) for a 2-D one: the fp32 products below are made one
    layer at a time, with a layer's temporaries instead of the stack's."""
    return range(w.shape[0]) if w.dim() == 3 else [...]


def _scale_rows(w: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """w[..., i, :] * s[..., i] in fp32, cast back to w's dtype."""
    out = torch.empty_like(w)
    for i in _layers(w):
        out[i] = (w[i].float() * s[i][..., :, None]).to(w.dtype)
    return out


def _scale_cols(w: torch.Tensor, inv_s: torch.Tensor) -> torch.Tensor:
    """w[..., :, j] * inv_s[..., j] in fp32, cast back to w's dtype."""
    out = torch.empty_like(w)
    for i in _layers(w):
        out[i] = (w[i].float() * inv_s[i][..., None, :]).to(w.dtype)
    return out


def migrate_params(params: Params, cfg, stats: dict, alpha: float = 0.5) -> Params:
    """New params with the SmoothQuant scales folded in: the forward is the
    same function; only where magnitudes live changes. Untouched leaves (the
    embedding) are shared with `params`."""
    gemma = cfg.layer_norm_type == "gemma_rms"
    blocks = dict(params["blocks"])
    out = dict(params)
    n = cfg.n_layers
    kvh, hd = cfg.effective_n_kv_heads, cfg.head_dim
    rep = cfg.n_heads // kvh
    d = cfg.d_model

    # site 1: attn_norm -> q/k/v (or the fused att_proj)
    qkv_names = ("q_proj", "k_proj", "v_proj") if cfg.block_type == "llama" else ("att_proj",)
    if "attn_norm" in blocks and all(nm in blocks for nm in qkv_names):
        w_amax = torch.stack([_row_amax(blocks[nm]) for nm in qkv_names]).amax(dim=0)
        s = _smooth_scales(stats["qkv_in"], w_amax, alpha)
        blocks["attn_norm"] = _scale_norm(blocks["attn_norm"], s, gemma)
        for nm in qkv_names:
            blocks[nm] = _scale_rows(blocks[nm], s)

    # site 2: v output channels -> attn_out; context channel c = h*hd + j
    # comes from kv head h // rep, so s is shared within each group
    if "attn_out" in blocks:
        ctx = stats["ctx"].reshape(n, kvh, rep, hd).amax(dim=2)
        w_amax = _row_amax(blocks["attn_out"]).reshape(n, kvh, rep, hd).amax(dim=2)
        s_v = _smooth_scales(ctx, w_amax, alpha)                          # (n, kvh, hd)
        s_flat = s_v.reshape(n, kvh * hd)
        s_ctx = s_v[:, :, None, :].expand(n, kvh, rep, hd).reshape(n, d)
        inv = 1.0 / s_flat
        if cfg.block_type == "llama":
            blocks["v_proj"] = _scale_cols(blocks["v_proj"], inv)
            if "v_bias" in blocks:
                blocks["v_bias"] = (blocks["v_bias"].float() * inv).to(blocks["v_bias"].dtype)
        else:
            fused = blocks["att_proj"].to(torch.float32, copy=True)
            fused[..., :, d + kvh * hd:] *= inv[..., None, :]
            blocks["att_proj"] = fused.to(blocks["att_proj"].dtype)
            if "att_proj_bias" in blocks:
                fb = blocks["att_proj_bias"].to(torch.float32, copy=True)
                fb[..., d + kvh * hd:] *= inv
                blocks["att_proj_bias"] = fb.to(blocks["att_proj_bias"].dtype)
        blocks["attn_out"] = _scale_rows(blocks["attn_out"], s_ctx)

    # site 3: ff_norm -> ff_proj (+ up_proj)
    ff_names = ("ff_proj", "up_proj") if cfg.block_type == "llama" else ("ff_proj",)
    if "ff_norm" in blocks and all(nm in blocks for nm in ff_names):
        w_amax = torch.stack([_row_amax(blocks[nm]) for nm in ff_names]).amax(dim=0)
        s = _smooth_scales(stats["mlp_in"], w_amax, alpha)
        blocks["ff_norm"] = _scale_norm(blocks["ff_norm"], s, gemma)
        for nm in ff_names:
            blocks[nm] = _scale_rows(blocks[nm], s)

    # site 4: up_proj output channels -> the block's ff_out (llama only)
    if cfg.block_type == "llama" and "up_proj" in blocks:
        s = _smooth_scales(stats["mlp_mid"], _row_amax(blocks["ff_out"]), alpha)
        blocks["up_proj"] = _scale_cols(blocks["up_proj"], 1.0 / s)
        blocks["ff_out"] = _scale_rows(blocks["ff_out"], s)

    # site 5: ln_f -> the vocab head (untied only)
    if not cfg.weight_tying and "ff_out" in params and "ln_f" in params:
        s = _smooth_scales(stats["head_in"], _row_amax(params["ff_out"]), alpha)
        out["ln_f"] = _scale_norm(params["ln_f"], s, gemma)
        out["ff_out"] = _scale_rows(params["ff_out"], s)

    out["blocks"] = blocks
    return out
