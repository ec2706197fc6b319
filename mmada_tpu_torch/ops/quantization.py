"""Quantized weights for serving, and the W8A8 straight-through forward for
training.

Counterpart of `mmada_tpu/ops/quantization.py`, same schemes, same numerics,
same dispatch (`maybe_matmul` / `multi_matmul`, which `models/llada.py`
calls at every block matmul and in the vocab head):

  * int8 weight-only (`QuantizedTensor`, `qmatmul`): symmetric
    per-output-channel, `scale = absmax / 127`; the matmul multiplies in x's
    dtype, the codes and scales cast to it first;
  * W8A8 (`W8A8Tensor`, `w8a8_matmul`): the same int8 weight, and x
    quantized per token on the fly; an int8 x int8 product with exact int32
    sums (`int8_matmul`), rescaled by token scale x channel scale;
  * int4 (`Int4Tensor`): the grouped nibble layout of `ops/int4_matmul.py`;
    its matmul is kernel B6 when the weight has the kernel's layout (K and N
    multiples of 128, 128-row groups), else x @ the dequantised weight, the
    JAX package's rule by layout (`int4_matmul_dispatch`);
  * training (`W8A8TrainTensor`, `w8a8_ste_matmul`, `tag_w8a8_ste`): a
    trainable weight whose forward runs W8A8 and whose gradients are the
    plain x @ w's (straight-through).

Over a tensor axis a row-parallel W8A8 product (`shards`: each rank holds a
K-shard of x and of the weight; `RowShards` are the two reductions over
those ranks, which the caller brings) takes its scales over the whole row as
JAX's (the absmax reduced with MAX), quantizes its shard, and sums the ranks'
int32 products (exact in any order) before it rescales and rounds once: bit
for bit the unsharded product.

The quantized classes index their leading (layer) axis, so
`llada.layer_params` hands `_block` one layer's weight (`qt[i]`). Stacked
weights are quantized one layer at a time, which gives the same codes as the
whole stack (every scale is per layer) with a layer's temporaries instead
of the stack's.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, NamedTuple, Optional

import torch

from mmada_tpu_torch.ops.int4_matmul import int4_matmul, pack_int4, unpack_int4


class RowShards(NamedTuple):
    """A row-parallel product's reductions over the ranks that hold the
    other K-shards: the elementwise maximum and the sum."""

    max: Callable[[torch.Tensor], torch.Tensor]
    sum: Callable[[torch.Tensor], torch.Tensor]


@dataclasses.dataclass
class QuantizedTensor:
    """int8 values + per-output-channel scales for an (in, out) weight, or
    (layers, in, out) stacked weights with (layers, out) scales."""

    values: torch.Tensor   # int8, the weight's shape
    scales: torch.Tensor   # float32, the weight's shape without dim -2

    @property
    def shape(self):
        return self.values.shape

    def __getitem__(self, i):
        return type(self)(values=self.values[i], scales=self.scales[i])

    def dequantize(self, dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
        return (self.values.float() * self.scales[..., None, :]).to(dtype)


@dataclasses.dataclass
class W8A8Tensor(QuantizedTensor):
    """An int8 weight whose matmuls also quantize the activations per token
    and run the int8 x int8 product with int32 sums."""


@dataclasses.dataclass
class Int4Tensor:
    """Grouped int4 weight (ops/int4_matmul.py layout): packed int8
    (..., K/2, N), fp32 scales (..., K/GROUP, N)."""

    packed: torch.Tensor
    scales: torch.Tensor

    @property
    def shape(self):
        s = self.packed.shape
        return (*s[:-2], s[-2] * 2, s[-1])

    def __getitem__(self, i):
        return Int4Tensor(packed=self.packed[i], scales=self.scales[i])

    def dequantize(self, dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
        return unpack_int4(self.packed, self.scales, dtype)


@dataclasses.dataclass
class W8A8TrainTensor:
    """A trainable weight (the leaf itself, not a copy) tagged so that every
    matmul that consumes it runs the W8A8 forward; its gradient is the plain
    x @ w's."""

    values: torch.Tensor

    @property
    def shape(self):
        return self.values.shape

    def __getitem__(self, i):
        return W8A8TrainTensor(values=self.values[i])


def _per_layer(quant, w: torch.Tensor):
    """`quant(w)` for a 2-D weight; for a stacked (layers, in, out) one, each
    layer quantized alone and the results stacked."""
    if w.dim() <= 2:
        return quant(w)
    parts = [quant(w[i]) for i in range(w.shape[0])]
    fields = [f.name for f in dataclasses.fields(parts[0])]
    return type(parts[0])(**{f: torch.stack([getattr(p, f) for p in parts]) for f in fields})


def _quantize_tensor(w: torch.Tensor, shards: Optional[RowShards] = None) -> QuantizedTensor:
    """`shards`: a row-parallel weight's K-shard (its channels' absmax
    over every shard)."""
    wf = w.float()
    amax = wf.abs().amax(dim=-2)
    scales = torch.clamp((amax if shards is None else shards.max(amax)) / 127.0, min=1e-12)
    q = torch.clamp(torch.round(wf / scales[..., None, :]), -127, 127)
    return QuantizedTensor(values=q.to(torch.int8), scales=scales)


def quantize_tensor(w: torch.Tensor) -> QuantizedTensor:
    """Per-output-channel symmetric int8 over the contracting dim (-2)."""
    return _per_layer(_quantize_tensor, w)


def qmatmul(x: torch.Tensor, qw: QuantizedTensor) -> torch.Tensor:
    """x @ dequant(qw), the codes and the scales cast to x's dtype first."""
    w = qw.values.to(x.dtype) * qw.scales[..., None, :].to(x.dtype)
    return x @ w


def quantize_activations(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-token symmetric int8: (x_q int8, x_scale fp32, keepdims). Split
    out so that q/k/v (and ff/up) quantize their shared input once."""
    xf = x.float()
    return _codes(xf, xf.abs().amax(dim=-1, keepdim=True))


def _row_shard_activations(x: torch.Tensor,
                            shards: RowShards) -> tuple[torch.Tensor, torch.Tensor]:
    """`quantize_activations` of this rank's K-shard of each row, at the
    whole row's scale (the absmax a MAX over the shards)."""
    xf = x.float()
    return _codes(xf, shards.max(xf.abs().amax(dim=-1, keepdim=True)))


def _codes(xf: torch.Tensor, amax: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    x_scale = torch.clamp(amax / 127.0, min=1e-12)
    x_q = torch.clamp(torch.round(xf / x_scale), -127, 127).to(torch.int8)
    return x_q, x_scale


def _pad_to(t: torch.Tensor, rows: int, cols: int) -> torch.Tensor:
    if t.shape == (rows, cols) and t.is_contiguous():
        return t
    out = t.new_zeros((rows, cols))
    out[:t.shape[0], :t.shape[1]] = t
    return out


def int8_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Exact int32 a (M, K) @ b (K, N) of int8 operands (|sum| <= 127^2 K
    < 2^31 for any K the model has), through `torch._int_mm`. On the card
    that call wants M > 16 and K, N multiples of 8 on contiguous operands:
    zero rows and columns pad the operands there, which leaves every sum
    exact, and are sliced off."""
    m, k = a.shape
    n = b.shape[1]
    if a.device.type != "cuda":
        return torch._int_mm(a, b)
    def up8(v):
        return -(-v // 8) * 8
    mp, kp, np_ = max(17, up8(m)), up8(k), up8(n)
    out = torch._int_mm(_pad_to(a, mp, kp), _pad_to(b, kp, np_))
    return out if (mp, np_) == (m, n) else out[:m, :n]


def w8a8_matmul_prequant(x_q: torch.Tensor, x_scale: torch.Tensor, qw: QuantizedTensor,
                         out_dtype: torch.dtype = torch.bfloat16,
                         shards: Optional[RowShards] = None) -> torch.Tensor:
    """int8 x int8 product on pre-quantized activations, rescaled by (token
    scale x channel scale) in fp32; with `shards` the int32 products of the
    K-shards are summed first."""
    acc = int8_matmul(x_q.reshape(-1, x_q.shape[-1]), qw.values)
    if shards is not None:
        acc = shards.sum(acc)
    acc = acc.reshape(*x_q.shape[:-1], acc.shape[-1])
    out = acc.float() * x_scale * qw.scales
    return out.to(out_dtype)


def w8a8_matmul(x: torch.Tensor, qw: QuantizedTensor,
                shards: Optional[RowShards] = None) -> torch.Tensor:
    """Per-token dynamic activation quantization + the int8 product; with
    `shards`, a row-parallel product (the module docstring)."""
    x_q, x_scale = (quantize_activations(x) if shards is None
                    else _row_shard_activations(x, shards))
    return w8a8_matmul_prequant(x_q, x_scale, qw, out_dtype=x.dtype, shards=shards)


def quantize_tensor_int4(w: torch.Tensor) -> Int4Tensor:
    return _per_layer(lambda t: Int4Tensor(*pack_int4(t)), w)


def int4_matmul_dispatch(x: torch.Tensor, qw: Int4Tensor) -> torch.Tensor:
    """B6 (`int4_matmul`: the kernel on the card, its plain version on the
    CPU) when the weight has the kernel's layout, else x @ the dequantised
    weight: the JAX package's routing by layout (K < 128 packs per-channel;
    a head whose N is not a 128 multiple)."""
    k, n = qw.shape[-2], qw.shape[-1]
    kernel_layout = k % 128 == 0 and n % 128 == 0 and qw.scales.shape[-2] * 128 == k
    if kernel_layout:
        return int4_matmul(x, qw.packed, qw.scales)
    return x @ qw.dequantize(x.dtype)


QUANT_TARGETS = (
    "q_proj", "k_proj", "v_proj", "att_proj", "attn_out",
    "ff_proj", "up_proj", "ff_out",
)


def quantize_llada_params(params: Any, quantize_head: bool = True, activations: bool = False,
                          bits: int = 8) -> Any:
    """Quantize the block matmul weights (and the vocab head unless
    `quantize_head=False`). Norms, biases and the embedding stay as they are,
    shared with `params`. `activations=True` gives W8A8 weights; `bits=4`
    grouped int4 (which has no activation-quant path)."""
    if bits == 4:
        if activations:
            raise ValueError("int4 weights have no activation-quant path")
        quant = quantize_tensor_int4
    elif bits == 8:
        quant = _quantize_w8a8 if activations else quantize_tensor
    else:
        raise ValueError(f"unsupported weight bits: {bits}")
    out = dict(params)
    blocks = dict(params["blocks"])
    for name in QUANT_TARGETS:
        if name in blocks:
            blocks[name] = quant(blocks[name])
    out["blocks"] = blocks
    if quantize_head and "ff_out" in params:
        out["ff_out"] = quant(params["ff_out"])
    return out


def _quantize_w8a8(w: torch.Tensor) -> W8A8Tensor:
    q = quantize_tensor(w)
    return W8A8Tensor(values=q.values, scales=q.scales)


def multi_matmul(x: torch.Tensor, weights) -> list:
    """`[x @ w for w in weights]`, the activation quantization shared when
    every weight is a W8A8Tensor (the same numerics as one `w8a8_matmul`
    each)."""
    if all(isinstance(w, W8A8Tensor) for w in weights):
        x_q, x_scale = quantize_activations(x)
        return [w8a8_matmul_prequant(x_q, x_scale, w, out_dtype=x.dtype) for w in weights]
    return [maybe_matmul(x, w) for w in weights]


class _W8A8STE(torch.autograd.Function):
    """Forward: per-channel weight and per-token activation int8, the int8
    product, rescale. Backward: the gradients of the unquantized x @ w. With
    `shards` (a row-parallel K-shard) the forward is the product summed over
    the shards, and the backward this shard's part of the whole product's
    gradients (Megatron's g: the summed output's cotangent is every rank's)."""

    @staticmethod
    def forward(ctx, x, w, shards=None):
        ctx.save_for_backward(x, w)
        qw = _per_layer(lambda t: _quantize_tensor(t, shards), w)
        x_q, x_scale = (quantize_activations(x) if shards is None
                        else _row_shard_activations(x, shards))
        return w8a8_matmul_prequant(x_q, x_scale, W8A8Tensor(values=qw.values, scales=qw.scales),
                                    out_dtype=x.dtype, shards=shards)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        dtype = torch.promote_types(g.dtype, w.dtype)
        dx = (g.to(dtype) @ w.to(dtype).transpose(-1, -2)).to(x.dtype)
        x2 = x.reshape(-1, x.shape[-1]).to(dtype)
        dw = (x2.transpose(0, 1) @ g.reshape(-1, g.shape[-1]).to(dtype)).to(w.dtype)
        return dx, dw, None


def w8a8_ste_matmul(x: torch.Tensor, w: torch.Tensor,
                    shards: Optional[RowShards] = None) -> torch.Tensor:
    """W8A8 forward, straight-through gradients to x and w; `shards` as in
    `w8a8_matmul`."""
    return _W8A8STE.apply(x, w, shards)


def tag_w8a8_ste(params: Any) -> Any:
    """Wrap the block matmul weights (QUANT_TARGETS) in W8A8TrainTensor, in
    the stacked `blocks` or the trainable `layers` form, without copying, so
    that the forward runs them through the STE path and autograd reaches the
    leaves. The vocab head stays as it is."""
    def tag(lp):
        return {name: W8A8TrainTensor(values=t) if name in QUANT_TARGETS
                and isinstance(t, torch.Tensor) else t for name, t in lp.items()}

    out = dict(params)
    if "layers" in params:
        out["layers"] = [tag(lp) for lp in params["layers"]]
    else:
        out["blocks"] = tag(params["blocks"])
    return out


def is_quantized(leaf) -> bool:
    return isinstance(leaf, (QuantizedTensor, Int4Tensor, W8A8TrainTensor))


def maybe_matmul(x: torch.Tensor, w) -> torch.Tensor:
    if isinstance(w, W8A8Tensor):
        return w8a8_matmul(x, w)
    if isinstance(w, W8A8TrainTensor):
        return w8a8_ste_matmul(x, w.values)
    if isinstance(w, QuantizedTensor):
        return qmatmul(x, w)
    if isinstance(w, Int4Tensor):
        return int4_matmul_dispatch(x, w)
    return x @ w


def quantization_error(w: torch.Tensor) -> float:
    """Relative L2 error of the int8 quantize -> dequantize roundtrip."""
    wf = w.float()
    deq = quantize_tensor(w).dequantize(torch.float32)
    return float(torch.linalg.norm(wf - deq) / torch.clamp(torch.linalg.norm(wf), min=1e-12))


def nbytes(params: Any) -> int:
    """Bytes of every tensor of a (possibly quantized) params tree."""
    if isinstance(params, torch.Tensor):
        return params.numel() * params.element_size()
    if isinstance(params, dict):
        return sum(nbytes(v) for v in params.values())
    if isinstance(params, (list, tuple)):
        return sum(nbytes(v) for v in params)
    if dataclasses.is_dataclass(params):
        return sum(nbytes(getattr(params, f.name)) for f in dataclasses.fields(params))
    return 0
