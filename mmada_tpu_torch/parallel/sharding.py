"""Sharding rules for the LLaDA backbone over a (data, fsdp, tensor) mesh.

Counterpart of `mmada_tpu/parallel/sharding.py` (:31-184). The specs are
JAX's, leaf by leaf, as tuples (one entry a dim: None, an axis name, or a
tuple of names joined major first), written against the layer-stacked tree
of `models/llada.py` (leading layer axis, never sharded):

  * FSDP shards every weight's largest non-contracting dim - the ZeRO-3
    analogue: `llada.forward` gathers a layer's shards before its block and
    the backward reduce-scatters their gradients (`parallel/collectives.py`);
  * tensor shards attention heads and MLP hidden: q/k/v, ff_proj, up_proj
    column-parallel (fsdp, tensor), attn_out and ff_out row-parallel
    (tensor, fsdp);
  * `wte` rows over (fsdp, tensor) (Megatron's embedding); norms replicated.

A dim its axes do not divide falls back to replication on that dim
(`_divisibility_fallback`, JAX's rule). One rule is the port's own:
GSPMD computes the global function of any layout, but the port's explicit
tensor-parallel block holds it only where the heads, the kv heads and the
MLP hidden divide the tensor axis, on a llama block without q/k norms whose
weights are plain, int8 or int4 (group-aligned shards); elsewhere
`model_specs` leaves the block's weights replicated over tensor, and the
block runs whole on every tensor rank.

`shard_params` turns a full tree into this rank's shards (quantized leaves:
the values take the weight's spec, the scales replicate); `gather_params` is
the inverse, for checkpoints and tests.
"""

from __future__ import annotations

import functools
from typing import Any, Optional

import torch

from mmada_tpu_torch.core.mesh import FSDP_AXIS, TENSOR_AXIS, axis_group, axis_index, axis_size
from mmada_tpu_torch.ops.quantization import (
    Int4Tensor,
    QuantizedTensor,
    W8A8Tensor,
    W8A8TrainTensor,
    is_quantized,
)
from mmada_tpu_torch.parallel.collectives import all_gather

#: the weights whose rows (heads, MLP hidden) the tensor axis splits
ROW_PARALLEL = ("attn_out", "ff_out")


def llada_param_specs(cfg) -> dict:
    """Specs matching `llada.init_params`' tree (`mmada_tpu`'s, leaf by leaf)."""
    block = {
        "attn_norm": (None, None),
        "ff_norm": (None, None),
        "attn_out": (None, TENSOR_AXIS, FSDP_AXIS),
        "ff_out": (None, TENSOR_AXIS, FSDP_AXIS),
    }
    if cfg.block_type == "llama":
        block.update({name: (None, FSDP_AXIS, TENSOR_AXIS)
                      for name in ("q_proj", "k_proj", "v_proj", "ff_proj", "up_proj")})
        if cfg.include_bias or cfg.include_qkv_bias:
            block.update({name: (None, TENSOR_AXIS) for name in ("q_bias", "k_bias", "v_bias")})
    else:
        block.update(att_proj=(None, FSDP_AXIS, TENSOR_AXIS), ff_proj=(None, FSDP_AXIS, TENSOR_AXIS))
        if cfg.include_bias or cfg.include_qkv_bias:
            block["att_proj_bias"] = (None, TENSOR_AXIS)
    if cfg.attention_layer_norm:
        block["q_norm"] = (None, None)
        block["k_norm"] = (None, None)
    specs = {"wte": ((FSDP_AXIS, TENSOR_AXIS), None), "ln_f": (None,), "blocks": block}
    if not cfg.weight_tying:
        specs["ff_out"] = (FSDP_AXIS, TENSOR_AXIS)
    return specs


def _divisibility_fallback(shape, spec, mesh) -> tuple:
    """`spec` with each axis that does not divide its dim dropped (JAX's)."""
    spec = tuple(spec) + (None,) * (len(shape) - len(spec))
    return tuple(None if axis is not None and dim % axis_size(mesh, axis) else axis
                 for dim, axis in zip(shape, spec))


def _drop_tensor(spec) -> tuple:
    def drop(axis):
        if axis == TENSOR_AXIS:
            return None
        if isinstance(axis, tuple):
            kept = tuple(a for a in axis if a != TENSOR_AXIS)
            return kept[0] if len(kept) == 1 else (kept or None)
        return axis
    return tuple(drop(a) for a in spec)


def _weight(leaf):
    """A leaf's tensor with the weight's layout: a plain weight, or a
    quantized one's values (int4: packed, rows halved)."""
    if isinstance(leaf, Int4Tensor):
        return leaf.packed
    if isinstance(leaf, (QuantizedTensor, W8A8TrainTensor)):
        return leaf.values
    return leaf


def tensor_parallel_ok(cfg, tensor: int, blocks: Optional[dict] = None) -> bool:
    """Whether the tensor-parallel block computes the layer's function at
    this tensor size (the module docstring's rule); `blocks`, when given,
    are the weights' leaves (their quantization matters)."""
    if tensor == 1:
        return True
    if cfg.block_type != "llama" or cfg.attention_layer_norm:
        return False
    if cfg.n_heads % tensor or cfg.effective_n_kv_heads % tensor or cfg.hidden_size % tensor:
        return False
    for name, leaf in (blocks or {}).items():
        if isinstance(leaf, W8A8Tensor):
            return False   # per-token activation scales over a row shard
        if isinstance(leaf, Int4Tensor) and name in ROW_PARALLEL:
            # a row shard must hold whole 128-row groups (one group: per-channel)
            if leaf.scales.shape[-2] % tensor:
                return False
    return True


def model_specs(cfg, mesh, params: Optional[dict] = None) -> dict:
    """`llada_param_specs` with the port's tensor rule applied."""
    specs = llada_param_specs(cfg)
    blocks = None if params is None else params.get("blocks")
    if not tensor_parallel_ok(cfg, axis_size(mesh, TENSOR_AXIS), blocks):
        specs["blocks"] = {k: _drop_tensor(s) for k, s in specs["blocks"].items()}
    return specs


def shard_tensor(t: torch.Tensor, spec, mesh) -> torch.Tensor:
    """This rank's block of `t` under `spec` (already resolved)."""
    out = t
    for dim, axis in enumerate(spec):
        n = axis_size(mesh, axis)
        if axis is None or n == 1:
            continue
        out = out.chunk(n, dim=dim)[axis_index(mesh, axis)]
    return out if out is t else out.contiguous().clone()


def gather_tensor(t: torch.Tensor, spec, mesh) -> torch.Tensor:
    """The whole of a leaf sharded under `spec` (resolved), on every rank."""
    out = t
    for dim, axis in enumerate(spec):
        if axis is not None and axis_size(mesh, axis) > 1:
            out = all_gather(out, dim, axis_group(mesh, axis))
    return out


def _map_leaves(params: Any, specs: Any, fn) -> Any:
    """fn(leaf, spec) over a params tree, its `blocks` (stacked) or `layers`
    (one dict a layer, the block specs without the layer dim)."""
    out = {}
    for name, leaf in params.items():
        if name == "blocks":
            out[name] = {k: fn(v, specs["blocks"][k]) for k, v in leaf.items()}
        elif name == "layers":
            out[name] = [{k: fn(v, specs["blocks"][k][1:]) for k, v in lp.items()}
                         for lp in leaf]
        else:
            out[name] = fn(leaf, specs[name])
    return out


def shard_params(params: Any, specs: Any, mesh) -> Any:
    """This rank's shards of a full tree (stacked `blocks` or split
    `layers`). Dims their axes do not divide stay whole; quantized leaves
    shard their values with the weight's spec, their scales replicate."""

    def place(leaf, spec):
        if is_quantized(leaf):
            values = _weight(leaf)
            local = shard_tensor(values, _divisibility_fallback(values.shape, spec, mesh), mesh)
            if isinstance(leaf, Int4Tensor):
                return Int4Tensor(packed=local, scales=leaf.scales)
            if isinstance(leaf, W8A8TrainTensor):
                return W8A8TrainTensor(values=local)
            return type(leaf)(values=local, scales=leaf.scales)
        return shard_tensor(leaf, _divisibility_fallback(leaf.shape, spec, mesh), mesh)

    return _map_leaves(params, specs, place)


@functools.lru_cache(maxsize=16)
def full_shapes(cfg) -> dict:
    """The full shape of every leaf of `cfg`'s stacked tree."""
    from mmada_tpu_torch.models import llada

    meta = llada.init_params(cfg, device="meta")
    return {name: ({k: tuple(v.shape) for k, v in leaf.items()} if name == "blocks"
                   else tuple(leaf.shape)) for name, leaf in meta.items()}


def resolved_spec(cfg, specs, mesh, name: str, kind: Optional[str] = None,
                  leaf=None) -> tuple:
    """The spec a leaf was sharded with: `name` a top-level leaf, or
    "blocks" with `kind` (one layer's leaf: the layer dim dropped when
    `leaf` has one dim less than the stack); `leaf` a quantized leaf's
    values decide with their own full shape (int4: rows halved)."""
    shapes = full_shapes(cfg)
    if kind is None:
        shape, spec = shapes[name], specs[name]
    else:
        shape, spec = shapes["blocks"][kind], specs["blocks"][kind]
    if isinstance(leaf, Int4Tensor):
        shape = shape[:-2] + (shape[-2] // 2, shape[-1])
    resolved = _divisibility_fallback(shape, spec, mesh)
    if kind is not None and leaf is not None and _weight(leaf).dim() < len(shape):
        resolved = resolved[1:]
    return resolved


def gather_params(params: Any, specs: Any, mesh, cfg) -> Any:
    """The full tree of this rank's shards (every rank of the mesh takes
    part). `specs` are those the tree was sharded with."""

    def whole(name, kind, leaf):
        spec = resolved_spec(cfg, specs, mesh, name, kind, leaf)
        if is_quantized(leaf):
            values = gather_tensor(_weight(leaf), spec, mesh)
            if isinstance(leaf, Int4Tensor):
                return Int4Tensor(packed=values, scales=leaf.scales)
            if isinstance(leaf, W8A8TrainTensor):
                return W8A8TrainTensor(values=values)
            return type(leaf)(values=values, scales=leaf.scales)
        return gather_tensor(leaf, spec, mesh)

    out = {}
    for name, leaf in params.items():
        if name == "blocks":
            out[name] = {k: whole(name, k, v) for k, v in leaf.items()}
        elif name == "layers":
            out[name] = [{k: whole("blocks", k, v) for k, v in lp.items()} for lp in leaf]
        else:
            out[name] = whole(name, None, leaf)
    return out


def leaf_specs(cfg, specs, mesh, names) -> dict:
    """Resolved specs of named leaves (`llada.named_leaves` names: `wte`,
    `layers.{i}.{kind}`, ...)."""
    out = {}
    for name in names:
        if name.startswith("layers."):
            kind = name.split(".", 2)[2]
            out[name] = resolved_spec(cfg, specs, mesh, "blocks", kind)[1:]
        else:
            out[name] = resolved_spec(cfg, specs, mesh, name)
    return out


def spec_axes(spec) -> set:
    """The mesh axes a resolved spec shards over."""
    axes = set()
    for axis in spec:
        if axis is not None:
            axes.update((axis,) if isinstance(axis, str) else axis)
    return axes


class StateLayout:
    """The resolved spec of every leaf of a train state over `mesh`, by
    leaf name (`llada.named_leaves`) or by checkpoint key (`train/params/
    layers/3/q_proj`, `train/opt_state/mu/layers.3.q_proj`, `ema/shadow/wte`):
    the optimizer moments and the EMA shadow are sharded as their weights,
    counters are whole. `whole` / `local` gather a leaf and cut one (the
    checkpoints keep the single-process layout)."""

    def __init__(self, cfg, mesh, names):
        self.mesh = mesh
        self.specs = leaf_specs(cfg, model_specs(cfg, mesh), mesh, names)

    def spec(self, key: str) -> tuple:
        parts = key.split("/")
        if "layers" in parts:
            i = parts.index("layers")
            name = f"layers.{parts[i + 1]}.{parts[i + 2]}"
        else:
            name = parts[-1]
        return self.specs.get(name, ())

    def whole(self, key: str, t: torch.Tensor) -> torch.Tensor:
        return gather_tensor(t, self.spec(key), self.mesh)

    def local(self, key: str, t: torch.Tensor) -> torch.Tensor:
        return shard_tensor(t, _divisibility_fallback(t.shape, self.spec(key), self.mesh),
                            self.mesh)

    def full_shape(self, key: str, t: torch.Tensor) -> tuple:
        spec = tuple(self.spec(key)) + (None,) * t.dim()
        return tuple(d * axis_size(self.mesh, a) for d, a in zip(t.shape, spec))
