"""LLaDA bidirectional masked-diffusion transformer backbone, in PyTorch.

Counterpart of `mmada_tpu/models/llada.py`: token embedding -> N pre-norm
blocks (non-causal attention with RoPE + gated MLP) -> final RMSNorm -> vocab
head. Parameters keep the JAX layout: a dict of layer-stacked tensors
(`blocks[name]` is `(n_layers, ...)`, `(in, out)` matrices, `x @ w`), so the
weights of either package convert to the other with no transposes.

The layer loop is a Python loop over per-layer views `blocks[name][i]`. For
training, `split_layers` gives every weight its own leaf: the stack becomes
a `layers` list of per-layer leaves that are views of the same storage, so
each layer's gradient is a tensor of one layer's size (indexing the stack
under autograd would give every layer a zero gradient the size of the whole
stack) and an optimizer's in-place updates land in the storage serving
reads. `forward` takes either form. RoPE rides into the attention call,
which rotates q and k inside the kernel's C entry. `remat` recomputes each
layer in the backward (`torch.utils.checkpoint`, the counterpart of
`jax.checkpoint` in `_wrap_remat`). Every block matmul and the vocab head go
through `ops/quantization.py`'s dispatch (`maybe_matmul` / `multi_matmul`),
so a weight may be a quantized leaf (int8, W8A8, int4: kernel B6) or a
W8A8 training tag; a plain tensor takes `x @ w` as before. No KV cache here:
that is a later slice.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Optional

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from mmada_tpu_torch.core.device import DeviceLike, resolve_device
from mmada_tpu_torch.core.precision import FP32, Policy
from mmada_tpu_torch.ops.attention import NEG_INF, apply_rope, bidirectional_attention
from mmada_tpu_torch.ops.norms import layer_norm, rms_norm
from mmada_tpu_torch.ops.tensor_maps import ROW_FLOATS
from mmada_tpu_torch.ops.quantization import (
    Int4Tensor,
    QuantizedTensor,
    maybe_matmul,
    multi_matmul,
)

Params = dict[str, Any]


@dataclasses.dataclass(frozen=True)
class LLaDAConfig:
    """Backbone hyper-parameters (`mmada_tpu.models.llada.LLaDAConfig`)."""

    d_model: int = 4096
    n_heads: int = 32
    n_kv_heads: Optional[int] = None
    n_layers: int = 32
    mlp_hidden_size: Optional[int] = 12288
    mlp_ratio: int = 4
    vocab_size: int = 126464
    embedding_size: Optional[int] = 126464
    max_sequence_length: int = 4096
    rope_theta: float = 500000.0
    rope_full_precision: bool = True
    layer_norm_type: str = "rms"          # 'rms' | 'gemma_rms' | 'default'
    layer_norm_with_affine: bool = True
    rms_norm_eps: float = 1e-5
    activation_type: str = "silu"          # 'silu' | 'swiglu' | 'gelu' | 'relu'
    block_type: str = "llama"              # 'llama' | 'sequential'
    weight_tying: bool = False
    include_bias: bool = False
    include_qkv_bias: bool = False
    attention_layer_norm: bool = False     # q/k norm
    input_emb_norm: bool = False
    scale_logits: bool = False
    mask_token_id: int = 126336
    attention_bias_enabled: bool = False
    """Whether attention masks/biases gate attention. False (the default) is
    checkpoint-faithful: the reference never passes its masks to attention."""

    @property
    def effective_n_kv_heads(self) -> int:
        return self.n_kv_heads if self.n_kv_heads is not None else self.n_heads

    @property
    def head_dim(self) -> int:
        return self.d_model // self.n_heads

    @property
    def hidden_size(self) -> int:
        return (
            self.mlp_hidden_size
            if self.mlp_hidden_size is not None
            else self.mlp_ratio * self.d_model
        )

    @property
    def effective_hidden_size(self) -> int:
        """Width of the MLP activation entering ff_out (SwiGLU halves it)."""
        if self.block_type == "sequential" and self.activation_type == "swiglu":
            return self.hidden_size // 2
        return self.hidden_size

    @property
    def effective_vocab_size(self) -> int:
        return self.embedding_size if self.embedding_size is not None else self.vocab_size


def llada_8b(vocab_size: int = 134656) -> LLaDAConfig:
    """Flagship 8B config with the fused multimodal vocabulary."""
    return LLaDAConfig(vocab_size=vocab_size, embedding_size=vocab_size)


def tiny_config(
    vocab_size: int = 320,
    d_model: int = 64,
    n_heads: int = 4,
    n_kv_heads: Optional[int] = None,
    n_layers: int = 2,
    mlp_hidden_size: int = 128,
    block_type: str = "llama",
    activation_type: str = "silu",
    weight_tying: bool = False,
    max_sequence_length: int = 256,
    attention_layer_norm: bool = False,
) -> LLaDAConfig:
    return LLaDAConfig(
        d_model=d_model,
        n_heads=n_heads,
        n_kv_heads=n_kv_heads,
        n_layers=n_layers,
        mlp_hidden_size=mlp_hidden_size,
        vocab_size=vocab_size,
        embedding_size=vocab_size,
        max_sequence_length=max_sequence_length,
        rope_theta=10000.0,
        block_type=block_type,
        activation_type=activation_type,
        weight_tying=weight_tying,
        attention_layer_norm=attention_layer_norm,
        mask_token_id=vocab_size - 1,
    )


# --------------------------------------------------------------------------
# Initialization
# --------------------------------------------------------------------------

@torch.no_grad()
def init_params(
    cfg: LLaDAConfig,
    device: DeviceLike = None,
    dtype: torch.dtype = torch.float32,
    generator: Optional[torch.Generator] = None,
) -> Params:
    """Random init, normal(0, 0.02), filled in place on `device` (a full-width
    model never passes through host memory). `generator` must live on that
    device. The values differ from the JAX init for the same seed; tests
    carry weights across with `checkpoints.from_jax.params_from_jax`."""
    device = resolve_device(device)
    d, nh, kvh, hd = cfg.d_model, cfg.n_heads, cfg.effective_n_kv_heads, cfg.head_dim
    f, f_out = cfg.hidden_size, cfg.effective_hidden_size
    v = cfg.effective_vocab_size
    n = cfg.n_layers

    def w(*shape):
        t = torch.empty(shape, dtype=dtype, device=device)
        return t.normal_(0.0, 0.02, generator=generator)

    def ones(*shape):
        return torch.ones(shape, dtype=dtype, device=device)

    def zeros(*shape):
        return torch.zeros(shape, dtype=dtype, device=device)

    blocks: Params = {
        "attn_norm": ones(n, d),
        "ff_norm": ones(n, d),
        "attn_out": w(n, d, d),
        "ff_out": w(n, f_out, d),
    }
    if cfg.block_type == "llama":
        blocks.update(
            q_proj=w(n, d, nh * hd),
            k_proj=w(n, d, kvh * hd),
            v_proj=w(n, d, kvh * hd),
            ff_proj=w(n, d, f),
            up_proj=w(n, d, f),
        )
        if cfg.include_bias or cfg.include_qkv_bias:
            blocks.update(
                q_bias=zeros(n, nh * hd),
                k_bias=zeros(n, kvh * hd),
                v_bias=zeros(n, kvh * hd),
            )
    elif cfg.block_type == "sequential":
        fused = d + 2 * kvh * hd
        blocks.update(att_proj=w(n, d, fused), ff_proj=w(n, d, f))
        if cfg.include_bias or cfg.include_qkv_bias:
            blocks["att_proj_bias"] = zeros(n, fused)
    else:
        raise ValueError(f"unknown block_type: {cfg.block_type}")

    if cfg.attention_layer_norm:
        blocks["q_norm"] = ones(n, d)
        blocks["k_norm"] = ones(n, kvh * hd)

    params: Params = {"wte": w(v, d), "ln_f": ones(d), "blocks": blocks}
    if not cfg.weight_tying:
        params["ff_out"] = w(d, v)
    return params


def layer_params(params: Params) -> list[Params]:
    """One dict of tensors per layer: the `layers` list of a split tree, or
    views `t[i]` of the layer-stacked `blocks`."""
    if "layers" in params:
        return params["layers"]
    blocks = params["blocks"]
    n = next(iter(blocks.values())).shape[0]
    return [{name: t[i] for name, t in blocks.items()} for i in range(n)]


def split_layers(params: Params) -> Params:
    """The trainable form of `params`: every tensor a leaf that requires
    grad, and the layer stack a `layers` list of per-layer leaves that are
    views of the stacked storage (no copy; updates in place reach it)."""
    out = {name: t.detach().requires_grad_()
           for name, t in params.items() if name not in ("blocks", "layers")}
    out["layers"] = [{name: t.detach().requires_grad_() for name, t in lp.items()}
                     for lp in layer_params(params)]
    return out


def named_leaves(params: Params) -> list[tuple[str, torch.Tensor]]:
    """(name, tensor) of every weight, layer weights named `layers.{i}.{kind}`."""
    out = [(name, t) for name, t in params.items() if name not in ("blocks", "layers")]
    for i, lp in enumerate(layer_params(params)):
        out += [(f"layers.{i}.{name}", t) for name, t in lp.items()]
    return out


def param_count(params: Params) -> int:
    return sum(t.numel() for _, t in named_leaves(params))


# --------------------------------------------------------------------------
# Forward
# --------------------------------------------------------------------------

def _norm(cfg: LLaDAConfig, x: torch.Tensor, weight: Optional[torch.Tensor]) -> torch.Tensor:
    if cfg.layer_norm_type == "rms":
        return rms_norm(x, weight, eps=cfg.rms_norm_eps)
    if cfg.layer_norm_type == "gemma_rms":
        return rms_norm(x, weight, eps=cfg.rms_norm_eps, gemma_style=True)
    return layer_norm(x, weight, None, eps=1e-5)


def _activation(cfg: LLaDAConfig, x: torch.Tensor) -> torch.Tensor:
    act = cfg.activation_type
    if act == "silu":
        return F.silu(x)
    if act == "gelu":
        return F.gelu(x, approximate="none")
    if act == "relu":
        return F.relu(x)
    if act == "swiglu":
        # reference SwiGLU chunks [value, gate]
        val, gate = x.chunk(2, dim=-1)
        return F.silu(gate) * val
    raise ValueError(f"unknown activation: {act}")


def rope_sin_cos(
    seq_len: int, head_dim: int, theta: float, device: DeviceLike = None,
    dtype: torch.dtype = torch.float32,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Neox-style rotary tables `(L, head_dim)` with duplicated halves."""
    device = resolve_device(device)
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32, device=device) / head_dim
    inv_freq = 1.0 / (theta ** exps)
    pos = torch.arange(seq_len, dtype=torch.float32, device=device)
    freqs = torch.outer(pos, inv_freq)
    emb = torch.cat([freqs, freqs], dim=-1)
    return emb.sin().to(dtype), emb.cos().to(dtype)


def _qkv(cfg: LLaDAConfig, lp: Params, h: torch.Tensor):
    """Project normed hidden states to per-head q/k/v `(B, H, L, D)`
    (un-roped, as strided views of the projections)."""
    b, l, d = h.shape
    nh, kvh, hd = cfg.n_heads, cfg.effective_n_kv_heads, cfg.head_dim
    if cfg.block_type == "llama":
        # one activation-quantize pass for q/k/v under W8A8
        q, k, v = multi_matmul(h, (lp["q_proj"], lp["k_proj"], lp["v_proj"]))
        if "q_bias" in lp:
            q, k, v = q + lp["q_bias"], k + lp["k_bias"], v + lp["v_bias"]
    else:
        fused = maybe_matmul(h, lp["att_proj"])
        if "att_proj_bias" in lp:
            fused = fused + lp["att_proj_bias"]
        q, k, v = fused.split([d, kvh * hd, kvh * hd], dim=-1)

    if "q_norm" in lp:
        q = _norm(cfg, q, lp["q_norm"])
        k = _norm(cfg, k, lp["k_norm"])

    q = q.view(b, l, nh, hd).transpose(1, 2)
    k = k.view(b, l, kvh, hd).transpose(1, 2)
    v = v.view(b, l, kvh, hd).transpose(1, 2)
    return q, k, v


def _tap(taps: Optional[dict], site: str, t: torch.Tensor) -> None:
    """SmoothQuant calibration: append t's per-channel absmax over (batch,
    seq), in fp32, to `taps[site]` (when there are taps)."""
    if taps is not None:
        taps[site].append(t.float().abs().amax(dim=(0, 1)))


def _mlp(cfg: LLaDAConfig, lp: Params, x: torch.Tensor,
         taps: Optional[dict] = None) -> torch.Tensor:
    h = _norm(cfg, x, lp.get("ff_norm"))
    _tap(taps, "mlp_in", h)
    if cfg.block_type == "llama":
        # act(ff_proj(h)) * up_proj(h): ff_proj is the gate input
        gate, up = multi_matmul(h, (lp["ff_proj"], lp["up_proj"]))
        h = _activation(cfg, gate) * up
    else:
        h = _activation(cfg, maybe_matmul(h, lp["ff_proj"]))
    _tap(taps, "mlp_mid", h)
    return x + maybe_matmul(h, lp["ff_out"])


def _block(
    cfg: LLaDAConfig,
    x: torch.Tensor,       # (B, L, D)
    lp: Params,            # one layer's params (no leading layer axis)
    bias: Optional[torch.Tensor],
    sin: torch.Tensor,
    cos: torch.Tensor,
    taps: Optional[dict] = None,  # calibration_stats: the quantized matmuls' inputs
) -> torch.Tensor:
    b, l, d = x.shape
    h = _norm(cfg, x, lp.get("attn_norm"))
    _tap(taps, "qkv_in", h)
    q, k, v = _qkv(cfg, lp, h)
    if cfg.rope_full_precision:
        att = bidirectional_attention(q, k, v, bias=bias, rope_sin=sin, rope_cos=cos)
    else:
        q, k = apply_rope(q, k, sin, cos, full_precision=False)
        att = bidirectional_attention(q, k, v, bias=bias)
    att = att.transpose(1, 2).reshape(b, l, d)
    _tap(taps, "ctx", att)
    x = x + maybe_matmul(att, lp["attn_out"])
    return _mlp(cfg, lp, x, taps)


def prepare_attention_bias(
    attention_mask: Optional[torch.Tensor] = None,  # (B, L) 1=keep 0=pad
    attention_bias: Optional[torch.Tensor] = None,  # (B|1, 1, L, L) bool/float
) -> Optional[torch.Tensor]:
    """Merge mask/bias into one additive fp32 bias (reference semantics).

    The result is a view of the first L columns of a tensor whose rows are
    padded to a multiple of ROW_FLOATS (16 bytes): the biased kernels read
    it through TMA, which needs rows that start 16 bytes apart, and one bias
    serves every layer of the forward, so the padding is made here, once,
    and no kernel wrapper copies it (`tensor_maps.bias_operand`)."""
    out = None
    length = None
    if attention_bias is not None:
        length = attention_bias.shape[-1]
        pad = (0, -length % ROW_FLOATS)
        if attention_bias.dtype == torch.bool:
            out = torch.where(F.pad(attention_bias, pad), 0.0, NEG_INF).float()
        else:
            out = F.pad(attention_bias.float(), pad)
    if attention_mask is not None:
        length = attention_mask.shape[-1]
        cols = F.pad(attention_mask, (0, -length % ROW_FLOATS))
        pair = (attention_mask[:, :, None] * cols[:, None, :]) > 0
        mask_bias = torch.where(pair, 0.0, NEG_INF).float()[:, None]
        out = mask_bias if out is None else out + mask_bias
    if out is None:
        return None
    # min + min would be -inf; clamp to the finite min
    return torch.clamp(out, min=NEG_INF)[..., :length]


def forward(
    params: Params,
    cfg: LLaDAConfig,
    input_ids: torch.Tensor,                        # (B, L) int
    attention_mask: Optional[torch.Tensor] = None,  # (B, L)
    attention_bias: Optional[torch.Tensor] = None,  # (B|1, 1, L, L)
    policy: Policy = FP32,
    logit_window: Optional[tuple[int, int]] = None,
    logit_positions: Optional[tuple[int, int]] = None,
    remat=False,  # False | True | "full" (_check_remat)
    return_normed_hidden: bool = False,
    taps: Optional[dict] = None,
) -> torch.Tensor:
    """Logits `(B, L, V)`, or `(B, L, stop - start)` with
    `logit_window=(start, stop)` over the vocab; `logit_positions=(start,
    LENGTH)` restricts the head to that position span, giving
    `(B, LENGTH, ...)`. `return_normed_hidden=True` stops after the final
    norm and returns the `(B, L, D)` hidden states (the chunked training
    loss applies the head itself). `taps` (lists under CALIBRATION_SITES)
    gain each layer's per-channel input absmax at its quantized matmuls
    (`calibration_stats`, which runs without autograd, so without remat)."""
    remat = _check_remat(remat)
    x = params["wte"][input_ids].to(policy.compute_dtype)
    if cfg.input_emb_norm:
        x = x * math.sqrt(cfg.d_model)

    if cfg.attention_bias_enabled:
        bias = prepare_attention_bias(attention_mask, attention_bias)
    else:
        bias = None  # reference-faithful: masks never reach attention

    sin, cos = rope_sin_cos(x.shape[1], cfg.head_dim, cfg.rope_theta, device=x.device)
    remat = remat and torch.is_grad_enabled()
    for lp in layer_params(params):
        if remat:
            x = checkpoint(_block, cfg, x, lp, bias, sin, cos, use_reentrant=False)
        else:
            x = _block(cfg, x, lp, bias, sin, cos, taps)

    if logit_positions is not None:
        # the head runs only over the span the sampler reads
        p_start, p_len = logit_positions
        x = x[:, p_start:p_start + p_len]

    x = _norm(cfg, x, params["ln_f"])
    if return_normed_hidden:
        return x
    return _head(params, cfg, x, logit_window, policy)


# the input of every quantized block matmul, as SmoothQuant's migration reads
# it: q/k/v (or att_proj), attn_out, ff_proj/up_proj, ff_out
CALIBRATION_SITES = ("qkv_in", "ctx", "mlp_in", "mlp_mid")


@torch.no_grad()
def calibration_stats(params: Params, cfg: LLaDAConfig, calib_batches,
                      policy: Policy = FP32) -> dict:
    """SmoothQuant calibration (`collect_stats` of the JAX package's
    `ops/smoothquant.py`): `forward` over each (B, L) batch of ids (numpy or
    torch) without autograd, the max over batches of each site's per-channel
    input absmax: {qkv_in, ctx, mlp_in (n, d), mlp_mid (n, f_out), head_in
    (d,)}, fp32 on the params' device."""
    device = params["wte"].device
    acc = None
    for ids in calib_batches:
        taps: dict = {site: [] for site in CALIBRATION_SITES}
        hidden = forward(params, cfg, torch.as_tensor(ids, dtype=torch.long).to(device),
                         policy=policy, return_normed_hidden=True, taps=taps)
        stats = {site: torch.stack(t) for site, t in taps.items()}
        stats["head_in"] = hidden.float().abs().amax(dim=(0, 1))
        acc = stats if acc is None else {k: torch.maximum(acc[k], stats[k]) for k in acc}
    return acc


def _check_remat(remat) -> bool:
    """Activation checkpointing modes of `_wrap_remat`: False saves every
    activation; True / "full" recomputes each layer in the backward. The
    policy modes "dots" (save the matmul outputs) and "auto" (pick by memory
    fit) are not ported yet."""
    if remat in (False, None):
        return False
    if remat is True or remat == "full":
        return True
    if remat in ("dots", "auto"):
        raise NotImplementedError(
            f"remat={remat!r} is not ported yet; use False, True or 'full'")
    raise ValueError(f"remat must be False/True/'full', got {remat!r}")


def _head(
    params: Params,
    cfg: LLaDAConfig,
    x: torch.Tensor,                               # normed hidden (B, L', D)
    logit_window: Optional[tuple[int, int]],
    policy: Policy,
) -> torch.Tensor:
    head = params["wte"].T if cfg.weight_tying else params["ff_out"]
    if isinstance(head, (QuantizedTensor, Int4Tensor)):
        if logit_window is not None:
            # window the head's output channels (vocab ids): the last dim of
            # the codes and of their scales, read in place
            start, stop = logit_window
            if isinstance(head, Int4Tensor):
                head = Int4Tensor(packed=head.packed[..., :, start:stop],
                                  scales=head.scales[..., :, start:stop])
            else:
                head = type(head)(values=head.values[..., :, start:stop],
                                  scales=head.scales[..., start:stop])
        logits = maybe_matmul(x, head).to(policy.logits_dtype)
    else:
        if logit_window is not None:
            start, stop = logit_window
            head = head[:, start:stop]
        logits = (x @ head.to(x.dtype)).to(policy.logits_dtype)
    if cfg.scale_logits:
        logits = logits * (1.0 / math.sqrt(cfg.d_model))
    return logits
