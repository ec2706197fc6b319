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
`jax.checkpoint` in `_wrap_remat`): "full" all of it, "dots" all but the
matmuls' outputs, which it keeps (`DOTS_SAVED_OPS`). Every block matmul and the vocab head go
through `ops/quantization.py`'s dispatch (`maybe_matmul` / `multi_matmul`),
so a weight may be a quantized leaf (int8, W8A8, int4: kernel B6) or a
W8A8 training tag; a plain tensor takes `x @ w` as before.

The block-KV cache of the fast samplers (`forward_kv_capture`,
`forward_kv_step`, `_quantize_kv`) is the counterpart of JAX's block-cached
decode (`mmada_tpu/models/llada.py:605-757`): a capture pass keeps each
layer's post-RoPE K and V (bf16, or int8 with one fp32 scale a head vector),
and each denoise step forwards only the active block's (or image span's)
tokens against them.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Optional

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import (
    CheckpointPolicy,
    checkpoint,
    create_selective_checkpoint_contexts,
)

from mmada_tpu_torch.core.device import DeviceLike, resolve_device
from mmada_tpu_torch.core.precision import FP32, Policy
from mmada_tpu_torch.ops.attention import NEG_INF, apply_rope, bidirectional_attention
from mmada_tpu_torch.ops.norms import layer_norm, rms_norm
from mmada_tpu_torch.ops.tensor_maps import ROW_FLOATS
from mmada_tpu_torch.ops.quantization import (
    Int4Tensor,
    QuantizedTensor,
    RowShards,
    W8A8Tensor,
    W8A8TrainTensor,
    is_quantized,
    maybe_matmul,
    multi_matmul,
    w8a8_matmul,
    w8a8_ste_matmul,
)
from mmada_tpu_torch.core.mesh import FSDP_AXIS, TENSOR_AXIS, axis_group, axis_size
from mmada_tpu_torch.parallel import collectives as C
from mmada_tpu_torch.parallel import ring_attention, sharding, tp_attention
from mmada_tpu_torch.parallel.collectives import copy_to_group, sum_over_group

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
    kvh, hd = cfg.effective_n_kv_heads, cfg.head_dim
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

    # heads from the widths: a tensor-parallel rank holds its heads only
    q = q.view(b, l, -1, hd).transpose(1, 2)
    k = k.view(b, l, -1, hd).transpose(1, 2)
    v = v.view(b, l, -1, hd).transpose(1, 2)
    return q, k, v


def _tap(taps: Optional[dict], site: str, t: torch.Tensor) -> None:
    """SmoothQuant calibration: append t's per-channel absmax over (batch,
    seq), in fp32, to `taps[site]` (when there are taps)."""
    if taps is not None:
        taps[site].append(t.float().abs().amax(dim=(0, 1)))


def _mlp(cfg: LLaDAConfig, lp: Params, x: torch.Tensor,
         taps: Optional[dict] = None, tp=None) -> torch.Tensor:
    h = _norm(cfg, x, lp.get("ff_norm"))
    _tap(taps, "mlp_in", h)
    h = copy_to_group(h, tp)
    if cfg.block_type == "llama":
        # act(ff_proj(h)) * up_proj(h): ff_proj is the gate input
        gate, up = multi_matmul(h, (lp["ff_proj"], lp["up_proj"]))
        h = _activation(cfg, gate) * up
    else:
        h = _activation(cfg, maybe_matmul(h, lp["ff_proj"]))
    _tap(taps, "mlp_mid", h)
    return x + _row_parallel(h, lp["ff_out"], tp)


def _row_parallel(x: torch.Tensor, w, tp) -> torch.Tensor:
    """`x @ w` of a row-parallel weight (attn_out, ff_out) summed over the
    tensor group. Over several ranks each rank's partial product stays in
    fp32 (a bf16 product accumulates in fp32 and is not rounded) and the
    sum is rounded to x's dtype once, as XLA's sharded dot is: the sharded
    forward is then the whole one up to the order of an fp32 sum. A
    quantized weight's partial, bf16, is summed in fp32 likewise; a W8A8
    weight (served or trained) sums the ranks' exact int32 products and
    rounds once (`ops/quantization.w8a8_matmul` over `RowShards`): the whole
    product bit for bit."""
    if tp is None or torch.distributed.get_world_size(tp) == 1:
        return maybe_matmul(x, w)
    if isinstance(w, (W8A8Tensor, W8A8TrainTensor)):
        shards = RowShards(max=lambda t: C.all_reduce_max(t, tp),
                           sum=lambda t: C.all_reduce(t, tp))
        if isinstance(w, W8A8Tensor):
            return w8a8_matmul(x, w, shards=shards)
        return w8a8_ste_matmul(x, w.values, shards=shards)
    if isinstance(w, torch.Tensor) and x.dtype != torch.float32:
        part = _fp32_product(x, w)
    else:
        part = maybe_matmul(x, w)
    return sum_over_group(part, tp).to(x.dtype)


class _Fp32Product(torch.autograd.Function):
    """x @ w for bf16 operands, accumulated and returned in fp32 (cuBLAS's
    bf16 product with an fp32 output on the card). The backward takes the
    cotangent in x's dtype, as the whole model's bf16 product does."""

    @staticmethod
    def forward(ctx, x, w):
        ctx.save_for_backward(x, w)
        if x.is_cuda:
            out = torch.mm(x.reshape(-1, x.shape[-1]), w, out_dtype=torch.float32)
            return out.view(*x.shape[:-1], w.shape[-1])
        return x.float() @ w.float()

    @staticmethod
    def backward(ctx, grad):
        x, w = ctx.saved_tensors
        g = grad.to(x.dtype)
        gx = g @ w.T if ctx.needs_input_grad[0] else None
        gw = (x.reshape(-1, x.shape[-1]).T @ g.reshape(-1, g.shape[-1])
              if ctx.needs_input_grad[1] else None)
        return gx, gw


_fp32_product = _Fp32Product.apply


def _join_cache(k: torch.Tensor, v: torch.Tensor, cache) -> tuple[torch.Tensor, torch.Tensor]:
    """A cached step's fresh block K/V joined to one layer's cache `(kc, vc,
    span)`: written over `span` in place, or, with `span` None (a compact
    cache), concatenated in front of it."""
    kc, vc, span = cache
    if span is None:
        return torch.cat([k, kc], dim=2), torch.cat([v, vc], dim=2)
    kc[:, :, span].copy_(k)
    vc[:, :, span].copy_(v)
    return kc, vc


def _block(
    cfg: LLaDAConfig,
    x: torch.Tensor,       # (B, L, D)
    lp: Params,            # one layer's params (no leading layer axis)
    bias: Optional[torch.Tensor],
    sin: torch.Tensor,
    cos: torch.Tensor,
    taps: Optional[dict] = None,  # calibration_stats: the quantized matmuls' inputs
    return_kv: bool = False,
    cache=None,            # a cached step's layer cache: (kc, vc, span | None)
    path=None,             # the mesh path (_MeshPath): gathers, tensor group, attention
):
    """One layer. With `return_kv` (the cache's capture pass) it returns
    `(x, (k, v))`, k rotated: RoPE runs here, outside the kernel, so the
    cached K is post-RoPE in the compute dtype, and attention takes no rope
    tables. With `cache` (a cached step: x holds the block's positions, sin
    and cos their rows) the block's queries attend to its fresh K/V joined
    to the cache (`_join_cache`), rectangular and without rope tables.

    With a mesh `path` the layer's fsdp shards are gathered first, and a
    tensor-parallel block runs its local heads and MLP hidden between
    Megatron's f (`copy_to_group`) and g (`sum_over_group`)."""
    b, l, d = x.shape
    attend, tp = bidirectional_attention, None
    if path is not None:
        lp, tp, attend = path.layer(lp), path.tp, path.attend
    h = _norm(cfg, x, lp.get("attn_norm"))
    _tap(taps, "qkv_in", h)
    q, k, v = _qkv(cfg, lp, copy_to_group(h, tp))
    if return_kv or cache is not None or not cfg.rope_full_precision:
        q, k = apply_rope(q, k, sin, cos, full_precision=cfg.rope_full_precision)
        ka, va = (k, v) if cache is None else _join_cache(k, v, cache)
        att = attend(q, ka, va, bias=bias)
    else:
        att = attend(q, k, v, bias=bias, rope_sin=sin, rope_cos=cos)
    att = att.transpose(1, 2).reshape(b, l, -1)
    _tap(taps, "ctx", att)
    x = x + _row_parallel(att, lp["attn_out"], tp)
    x = _mlp(cfg, lp, x, taps, tp)
    return (x, (k, v)) if return_kv else x


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
    logit_positions: Optional[tuple] = None,
    remat=False,  # False | True | "full" | "dots" | "auto" (_check_remat)
    return_normed_hidden: bool = False,
    taps: Optional[dict] = None,
    mesh=None,
    attn_impl: str = "auto",  # "auto" | "ring" (with a mesh: sequence over fsdp)
) -> torch.Tensor:
    """Logits `(B, L, V)`, or `(B, L, stop - start)` with
    `logit_window=(start, stop)` over the vocab; `logit_positions=(start,
    LENGTH)` restricts the head to that position span, giving
    `(B, LENGTH, ...)`; `start` may be a `(B,)` tensor, one span a row (the
    serving engine's rows each decode their own block). `return_normed_hidden=True` stops after the final
    norm and returns the `(B, L, D)` hidden states (the chunked training
    loss applies the head itself). `taps` (lists under CALIBRATION_SITES)
    gain each layer's per-channel input absmax at its quantized matmuls
    (`calibration_stats`, which runs without autograd, so without remat).

    With a `mesh` the params are this rank's shards (`parallel/sharding`)
    and `input_ids` this rank's rows: the embedding and each layer gather
    their shards (inside the layer's checkpoint, so full remat gathers
    again in the backward), tensor-parallel blocks split heads and MLP
    hidden, and the vocab head is gathered whole (`_MeshPath`);
    `attn_impl="ring"` shards attention's sequence over fsdp instead
    (`parallel/ring_attention`)."""
    remat = _check_remat(remat)
    if not torch.is_grad_enabled():
        remat = False
    path = None if mesh is None else _MeshPath(cfg, mesh, params, attn_impl)
    wte = params["wte"] if path is None else path.embedding(params["wte"])
    x = wte[input_ids].to(policy.compute_dtype)
    if cfg.input_emb_norm:
        x = x * math.sqrt(cfg.d_model)

    if cfg.attention_bias_enabled:
        bias = prepare_attention_bias(attention_mask, attention_bias)
    else:
        bias = None  # reference-faithful: masks never reach attention

    sin, cos = rope_sin_cos(x.shape[1], cfg.head_dim, cfg.rope_theta, device=x.device)
    for lp in layer_params(params):
        if remat == "full":
            x = checkpoint(_block, cfg, x, lp, bias, sin, cos, use_reentrant=False, path=path)
        elif remat == "dots":
            x = checkpoint(_block, cfg, x, lp, bias, sin, cos, use_reentrant=False,
                           context_fn=dots_context, path=path)
        else:
            x = _block(cfg, x, lp, bias, sin, cos, taps, path=path)

    if return_normed_hidden:
        return finish(params, cfg, x, None, logit_positions, policy, normed_only=True)
    return finish(params, cfg, x, logit_window, logit_positions, policy, mesh)


def finish(params: Params, cfg: LLaDAConfig, x: torch.Tensor, logit_window, logit_positions,
           policy: Policy, mesh=None, normed_only: bool = False) -> torch.Tensor:
    """After the layer stack: the position span (`logit_positions`), the
    final norm, then the (windowed) vocab head unless `normed_only`."""
    if logit_positions is not None:
        # the head runs only over the span the sampler reads
        p_start, p_len = logit_positions
        if isinstance(p_start, torch.Tensor):
            idx = p_start.to(x.device, torch.long)[:, None] + torch.arange(p_len, device=x.device)
            x = torch.gather(x, 1, idx[..., None].expand(-1, -1, x.shape[-1]))
        else:
            x = x[:, p_start:p_start + p_len]
    x = _norm(cfg, x, params["ln_f"])
    if normed_only:
        return x
    return _head(params, cfg, x, logit_window, policy, mesh)


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


#: The ops whose outputs `remat="dots"` keeps for the backward: the block's
#: projection matmuls (`jax.checkpoint_policies.dots_with_no_batch_dims_saveable`;
#: `x @ w` of a (B, L, D) activation and a 2-D weight runs as one `mm`).
#: Everything else, the attention kernel's forward included, is recomputed.
DOTS_SAVED_OPS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def dots_policy(ctx, op, *args, **kwargs) -> CheckpointPolicy:
    return (CheckpointPolicy.MUST_SAVE if op in DOTS_SAVED_OPS
            else CheckpointPolicy.PREFER_RECOMPUTE)


def dots_context(policy=dots_policy):
    """The selective-checkpoint contexts of one `remat="dots"` layer."""
    return create_selective_checkpoint_contexts(policy)


def _check_remat(remat):
    """Activation checkpointing modes of `_wrap_remat` -> False | "full" |
    "dots": False saves every activation; True / "full" recomputes each
    layer in the backward; "dots" keeps the matmuls' outputs
    (`DOTS_SAVED_OPS`) and recomputes the rest. An unresolved "auto" (a
    forward outside the Trainer, which picks dots or full by memory fit,
    `training/remat_auto.py`) is "full"."""
    if remat in (False, None):
        return False
    if remat is True or remat in ("full", "auto"):
        return "full"
    if remat == "dots":
        return "dots"
    raise ValueError(f"remat must be False/True/'full'/'dots'/'auto', got {remat!r}")


def _head(
    params: Params,
    cfg: LLaDAConfig,
    x: torch.Tensor,                               # normed hidden (B, L', D)
    logit_window: Optional[tuple[int, int]],
    policy: Policy,
    mesh=None,
) -> torch.Tensor:
    if mesh is not None:   # the head gathered whole (a mesh's shards)
        params = _MeshPath(cfg, mesh, params).head_params(params)
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


class _MeshPath:
    """What one forward over a mesh does beside the single-device layer
    loop (the collectives GSPMD inserts for the JAX package's
    `_dispatch_attention` / `_block`, `mmada_tpu/models/llada.py:270-410`):
    each layer's fsdp shards gathered (`layer`), the tensor group of a
    tensor-parallel block (`tp`, None when the block runs whole), the
    attention of the local heads or the ring (`attend`), the embedding's
    rows and the vocab head gathered whole (`embedding`, `head_params`)."""

    def __init__(self, cfg: LLaDAConfig, mesh, params: Params, attn_impl: str = "auto"):
        self.cfg, self.mesh, self.attn_impl = cfg, mesh, attn_impl
        self.specs = sharding.model_specs(cfg, mesh, params)
        tp_block = TENSOR_AXIS in sharding.spec_axes(self.specs["blocks"]["attn_out"])
        self.tp = axis_group(mesh, TENSOR_AXIS) if tp_block else None
        self.fsdp = axis_group(mesh, FSDP_AXIS)
        self._layer_specs: dict = {}

    def _spec(self, kind: str, leaf) -> tuple:
        key = (kind, type(leaf), sharding._weight(leaf).dim())
        if key not in self._layer_specs:
            self._layer_specs[key] = sharding.resolved_spec(
                self.cfg, self.specs, self.mesh, "blocks", kind, leaf)
        return self._layer_specs[key]

    def layer(self, lp: Params) -> Params:
        """One layer's weights with their fsdp dims gathered; a quantized
        weight's scales cut to this tensor rank's columns (or int4 row
        groups) where its values are tensor-sharded."""
        if self.fsdp is None and self.tp is None:
            return lp
        return {kind: self._gather(leaf, self._spec(kind, leaf)) for kind, leaf in lp.items()}

    def _gather(self, leaf, spec):
        w = sharding._weight(leaf)
        for dim, axis in enumerate(spec):
            if axis == FSDP_AXIS:
                w = C.gather_shards(w, dim, self.fsdp)
        if not is_quantized(leaf):
            return w
        # a gather along a dim other than the first hands back a strided
        # view; B6 reads a weight's rows whole (ROADMAP C.9)
        w = w.contiguous()
        if isinstance(leaf, Int4Tensor):
            scales = leaf.scales
            for dim, axis in enumerate(spec):
                if axis == TENSOR_AXIS:
                    scales = C.chunk(scales, dim - len(spec), self.tp)
            return Int4Tensor(packed=w, scales=scales)
        if hasattr(leaf, "scales"):
            scales = C.chunk(leaf.scales, -1, self.tp) if spec[-1] == TENSOR_AXIS else leaf.scales
            return type(leaf)(values=w, scales=scales)
        return type(leaf)(values=w)   # a W8A8 training tag

    def _whole(self, name: str, t: torch.Tensor) -> torch.Tensor:
        spec = sharding.resolved_spec(self.cfg, self.specs, self.mesh, name)
        tensor = axis_group(self.mesh, TENSOR_AXIS)
        for dim, axis in enumerate(spec):
            if axis == FSDP_AXIS:
                t = C.gather_shards(t, dim, self.fsdp)
            elif axis == TENSOR_AXIS:
                t = C.gather_replicated(t, dim, tensor)
            elif isinstance(axis, tuple):
                t = C.gather_joined(t, dim, self.fsdp, tensor,
                                    axis_group(self.mesh, (FSDP_AXIS, TENSOR_AXIS)))
        return t

    def embedding(self, wte: torch.Tensor) -> torch.Tensor:
        """The whole embedding (its rows are sharded over fsdp x tensor)."""
        if is_quantized(wte):
            return wte
        return self._whole("wte", wte)

    def head_params(self, params: Params) -> Params:
        """`params` with the vocab head (the embedding when tied) whole."""
        name = "wte" if self.cfg.weight_tying else "ff_out"
        head = params[name]
        if is_quantized(head):   # frozen: gathered without autograd
            spec = sharding.resolved_spec(self.cfg, self.specs, self.mesh, name, leaf=head)
            w = sharding._weight(head)
            for dim, axis in enumerate(spec):
                if axis is not None:
                    w = C.all_gather(w, dim, axis_group(self.mesh, axis))
            w = w.contiguous()   # as `_gather`'s (ROADMAP C.9)
            head = (Int4Tensor(packed=w, scales=head.scales) if isinstance(head, Int4Tensor)
                    else type(head)(values=w, scales=head.scales))
        else:
            head = self._whole(name, head)
        return dict(params, **{name: head})

    def attend(self, q, k, v, bias=None, rope_sin=None, rope_cos=None):
        sp = axis_size(self.mesh, FSDP_AXIS)
        if self.attn_impl == "ring" and bias is None and sp > 1 and q.shape[2] % sp == 0:
            if rope_sin is not None:   # the ring shards the sequence: rotate first
                q, k = apply_rope(q, k, rope_sin, rope_cos)
            if k.shape[1] != q.shape[1]:   # GQA: the ring takes equal heads
                rep = q.shape[1] // k.shape[1]
                k = k.repeat_interleave(rep, dim=1)
                v = v.repeat_interleave(rep, dim=1)
            return ring_attention.ring_attention_rows(q, k, v, self.mesh)
        return tp_attention.local_attention(q, k, v, self.tp, bias=bias,
                                            rope_sin=rope_sin, rope_cos=rope_cos)


# --------------------------------------------------------------------------
# Block-KV cache (the fast samplers' cached decode)
# --------------------------------------------------------------------------

def _quantize_kv(t: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Symmetric int8 codes of a K/V tensor `(..., D)`, one fp32 scale per
    head vector (`(..., 1)`): amax / 127, rounded half to even as
    `jnp.round` rounds."""
    t = t.float()
    scale = t.abs().amax(dim=-1, keepdim=True).clamp_min(1e-8) / 127.0
    return torch.round(t / scale).to(torch.int8), scale


def _dequantize_kv(codes: torch.Tensor, scale: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    return (codes * scale).to(dtype)   # int8 x fp32: the product in fp32


@torch.no_grad()
def forward_kv_capture(
    params: Params,
    cfg: LLaDAConfig,
    input_ids: torch.Tensor,                  # (B, L) int
    policy: Policy = FP32,
    remat=False,
    drop_span: Optional[tuple[int, int]] = None,
    cache_dtype: Optional[str] = None,         # None | "int8"
    mesh=None,
):
    """The backbone over the whole frame, without the vocab head, returning
    every layer's post-RoPE K and V: `(k, v)`, each `(n_layers, B, KVH, L,
    D)` in the compute dtype, or with `cache_dtype="int8"` each a pair
    (int8 codes `(n_layers, B, KVH, L, D)`, fp32 scales `(n_layers, B, KVH,
    L, 1)`). `drop_span=(lo, hi)` leaves that span's positions out of the
    cache (the compact cache of the MaskGIT samplers, whose span is
    recomputed every step; attention is invariant to the keys' order). No
    attention bias: the cache serves the unbiased (checkpoint-faithful)
    path only. Without autograd; `remat` must be False (nothing is saved
    for a backward). With a `mesh` (every rank the same rows) the cache holds
    this rank's kv heads of a tensor-parallel block."""
    if remat not in (False, None):
        raise NotImplementedError(
            f"forward_kv_capture serves without autograd: remat={remat!r} is not taken")
    if cache_dtype not in (None, "int8"):
        raise ValueError(f"cache_dtype must be None or 'int8', got {cache_dtype!r}")
    path = None if mesh is None else _MeshPath(cfg, mesh, params)
    wte = params["wte"] if path is None else path.embedding(params["wte"])
    x = wte[input_ids].to(policy.compute_dtype)
    if cfg.input_emb_norm:
        x = x * math.sqrt(cfg.d_model)
    b, l = input_ids.shape
    sin, cos = rope_sin_cos(l, cfg.head_dim, cfg.rope_theta, device=x.device)
    lo, hi = drop_span if drop_span is not None else (l, l)
    layers = layer_params(params)
    kv_heads = cfg.effective_n_kv_heads
    if path is not None and path.tp is not None:
        kv_heads //= torch.distributed.get_world_size(path.tp)
    shape = (len(layers), b, kv_heads, l - (hi - lo), cfg.head_dim)

    def empty():
        if cache_dtype == "int8":
            return (torch.empty(shape, dtype=torch.int8, device=x.device),
                    torch.empty(shape[:-1] + (1,), dtype=torch.float32, device=x.device))
        return torch.empty(shape, dtype=x.dtype, device=x.device)

    k_cache, v_cache = empty(), empty()
    for i, lp in enumerate(layers):
        x, kv = _block(cfg, x, lp, None, sin, cos, return_kv=True, path=path)
        for t, cache in zip(kv, (k_cache, v_cache)):
            if drop_span is not None:
                t = torch.cat([t[:, :, :lo], t[:, :, hi:]], dim=2)
            if cache_dtype == "int8":
                for dst, src in zip(cache, _quantize_kv(t)):
                    dst[i].copy_(src)
            else:
                cache[i].copy_(t)
    return k_cache, v_cache


@torch.no_grad()
def forward_kv_step(
    params: Params,
    cfg: LLaDAConfig,
    block_ids: torch.Tensor,       # (B, blk) int: the active block's tokens
    kv_cache,                      # forward_kv_capture's, of the same B
    block_start: int,              # the block's offset in the frame
    policy: Policy = FP32,
    logit_window: Optional[tuple[int, int]] = None,
    cache_is_compact: bool = False,
    mesh=None,
) -> torch.Tensor:
    """`(B, blk, V|window)` logits of the block's tokens against the cached
    K/V. Per layer (`_block` with the layer's cache): q/k/v of the block's
    positions, RoPE at their absolute offsets; the fresh K/V overwrite the
    block's slice of the cache, or, with `cache_is_compact` (a `drop_span`
    capture), are concatenated in front of it; the block's queries attend to
    all of them (rectangular attention without rope tables, the one-pass
    tier: B1); the MLP, the final norm and the (windowed) head run over the
    block only.

    A bf16 or fp32 cache's block slice is overwritten in place: each step
    writes it again with the block's fresh K/V before reading it, so every
    step reads what JAX's functional update gives, without copying the
    cache. An int8 cache is dequantised a layer at a time and stays as
    captured."""
    k_cache, v_cache = kv_cache
    quantized = isinstance(k_cache, tuple)
    cache_len = (k_cache[0] if quantized else k_cache).shape[3]
    blk = block_ids.shape[1]
    seq_len = cache_len + (blk if cache_is_compact else 0)

    path = None if mesh is None else _MeshPath(cfg, mesh, params)
    wte = params["wte"] if path is None else path.embedding(params["wte"])
    x = wte[block_ids].to(policy.compute_dtype)
    if cfg.input_emb_norm:
        x = x * math.sqrt(cfg.d_model)
    sin, cos = rope_sin_cos(seq_len, cfg.head_dim, cfg.rope_theta, device=x.device)
    sin, cos = sin[block_start:block_start + blk], cos[block_start:block_start + blk]
    span = slice(block_start, block_start + blk)

    for i, lp in enumerate(layer_params(params)):
        if quantized:
            kc = _dequantize_kv(k_cache[0][i], k_cache[1][i], x.dtype)
            vc = _dequantize_kv(v_cache[0][i], v_cache[1][i], x.dtype)
        else:
            kc, vc = k_cache[i], v_cache[i]
        x = _block(cfg, x, lp, None, sin, cos,
                   cache=(kc, vc, None if cache_is_compact else span), path=path)
    x = _norm(cfg, x, params["ln_f"])
    return _head(params, cfg, x, logit_window, policy, mesh)
