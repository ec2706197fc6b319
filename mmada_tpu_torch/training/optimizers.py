"""AdamW and Lion with a no-decay mask, global-norm clipping, and gradient
accumulation.

Counterpart of `mmada_tpu/training/optimizers.py` (:19-98) and of the optax
chains it builds, in optax's order:

    AdamW: clip_by_global_norm -> Adam (bias-corrected, eps outside the sqrt)
           -> add_decayed_weights(mask) -> scale by -lr(count)
    Lion:  clip_by_global_norm -> sign((1 - b1) g + b1 m), m <- (1 - b2) g + b2 m
           -> add_decayed_weights(mask) -> scale by -lr(count)

AdamW's state is one first and one second moment per parameter, in the
parameter's dtype unless `mu_dtype` says otherwise (optax's default with
`mu_dtype=None`), and an update count on the device; Lion's is one moment
per parameter, in the parameter's dtype, and the count.

Each operation rounds as optax's does on the same leaves, so bf16 weights
and moments come out bit for bit as optax's (tests/test_torch_training.py
holds a bf16 and an fp32 case): every op runs in the dtype JAX's promotion
gives it, a Python constant taking the dtype of the tensor it meets (JAX's
weak types), and a bias correction `1 - b**count` computed in fp32 and cast
to the moment's dtype before the division. The clip's global norm is
optax's too: each leaf's sum of squares (squares in the leaf's dtype,
summed in fp32, the sum rounded to the leaf's dtype), the leaves' sums added
in order in their promoted dtype, then the square root; with bf16 leaves
the norm the clip compares with `max_grad_norm` is a bf16 number. (Only the
order of the fp32 summation inside a leaf differs from XLA's; it shows only
where a sum lands within an ulp of a rounding boundary of the leaf's dtype.)

`apply` updates parameters and moments in place, one tensor (and one chunk
of a large tensor) at a time, so its temporaries stay small: torch's
`foreach` AdamW would hold temporaries the size of all the moments at once.
With a `gate` (a 0-d bool tensor on the device) every tensor takes its new
value only where the gate is true and the count advances by the gate: a
non-finite step is skipped on the device, with no host round trip.

`MultiSteps` is optax's `MultiSteps` (gradient accumulation): the running
mean of k micro-batch gradients, an inner update every k-th call.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Mapping, Optional, Union

import torch

NO_DECAY_KEYS = ("norm", "ln_f", "bias", "wte")
CHUNK = 1 << 24   # elements per piece of a large tensor's update

Named = Mapping[str, torch.Tensor]


def _kind(name: str) -> tuple[str, int]:
    """The JAX package's path of a weight and the extra stacked dimension:
    `layers.{i}.{kind}` is one layer of `blocks/{kind}`."""
    if name.startswith("layers."):
        return "blocks/" + name.split(".", 2)[2], 1
    return name, 0


def decay_mask(params: Named, no_decay_keys=NO_DECAY_KEYS) -> dict[str, bool]:
    """True where weight decay applies: weights of two or more dimensions (in
    the layer-stacked layout) whose path names no norm, bias or embedding."""
    out = {}
    for name, t in params.items():
        path, stacked = _kind(name)
        out[name] = not any(nd in path.lower() for nd in no_decay_keys) and (
            t.dim() + stacked >= 2)
    return out


def global_norm(tensors: Named, reduce: Optional[Callable] = None) -> torch.Tensor:
    """`optax.global_norm` with its rounding, on the device, over JAX's
    leaves: the layers of a kind (`layers.{i}.{kind}`) form one leaf
    (`blocks/{kind}`), as in the JAX package's layer-stacked tree. Per leaf,
    squares in the leaf's dtype summed in fp32 and rounded to that dtype;
    the leaves' sums added in JAX's tree order (its paths sorted) promoting
    as JAX does; the square root in the result's dtype (bf16 for bf16
    leaves). Over a mesh `tensors` are this rank's shards and `reduce`
    ({path: fp32 sum} -> the same summed over the shards of each leaf,
    `parallel/grads.py`) makes each leaf's sum whole before its rounding."""
    parts: dict[tuple, torch.Tensor] = {}
    dtypes: dict[tuple, torch.dtype] = {}
    for name, t in tensors.items():
        path = tuple(_kind(name)[0].split("/"))
        part = sum((c * c).sum(dtype=torch.float32) for c in t.reshape(-1).split(CHUNK))
        parts[path] = part if path not in parts else parts[path] + part
        dtypes[path] = t.dtype
    if reduce is not None:
        parts = reduce(parts)
    total = None
    for path in sorted(parts):
        part = parts[path].to(dtypes[path])
        total = part if total is None else total + part
    return torch.sqrt(total)


def _keep(dst: torch.Tensor, new: torch.Tensor, gate: Optional[torch.Tensor]) -> None:
    """dst <- new, or dst <- where(gate, new, dst)."""
    new = new.to(dst.dtype)
    dst.copy_(new if gate is None else torch.where(gate, new, dst))


class _Weak:
    """Python constants as 0-d tensors of the dtype they meet, as JAX's weak
    types round them (a bf16 op rounds 0.1 to bf16 first, where torch would
    keep it in fp32)."""

    def __init__(self, device: torch.device, **values: float):
        self.device, self.values, self.cache = device, values, {}

    def __call__(self, name: str, like: torch.Tensor) -> torch.Tensor:
        key = (name, like.dtype)
        if key not in self.cache:
            self.cache[key] = torch.tensor(self.values[name], dtype=like.dtype,
                                           device=self.device)
        return self.cache[key]


def _learning_rate(learning_rate, count: torch.Tensor) -> torch.Tensor:
    if callable(learning_rate):
        return learning_rate(count)
    return torch.full((), learning_rate, dtype=torch.float32, device=count.device)


def _clip(grads: Named, max_grad_norm: Optional[float], c: "_Weak",
          norm_reduce: Optional[Callable] = None):
    """`clip_by_global_norm`'s per-chunk map (identity without a clip)."""
    if max_grad_norm is None:
        return lambda g: g
    g_norm = global_norm(grads, norm_reduce)
    trigger = g_norm < max_grad_norm
    return lambda g: torch.where(trigger, g, (g / g_norm.to(g.dtype)) * c("max_norm", g))


@dataclasses.dataclass
class AdamW:
    learning_rate: Union[float, Callable]
    beta1: float = 0.9
    beta2: float = 0.999
    eps: float = 1e-8
    weight_decay: float = 0.01
    max_grad_norm: Optional[float] = 1.0
    mu_dtype: Optional[torch.dtype] = None
    no_decay_keys: tuple = NO_DECAY_KEYS
    norm_reduce: Optional[Callable] = None   # over a mesh: the clip's norm whole

    def init(self, params: Named) -> dict:
        device = next(iter(params.values())).device
        return {
            "count": torch.zeros((), dtype=torch.int64, device=device),
            "mu": {n: torch.zeros_like(p, dtype=self.mu_dtype or p.dtype)
                   for n, p in params.items()},
            "nu": {n: torch.zeros_like(p) for n, p in params.items()},
        }

    @torch.no_grad()
    def apply(self, params: Named, grads: Named, state: dict,
              gate: Optional[torch.Tensor] = None) -> None:
        """One update, in place, rounding as optax does (see the module
        docstring)."""
        count = state["count"]
        device = count.device
        count_inc = (count + 1).to(torch.float32)
        f32 = dict(dtype=torch.float32, device=device)
        bc1 = 1.0 - torch.tensor(self.beta1, **f32) ** count_inc  # fp32, as optax
        bc2 = 1.0 - torch.tensor(self.beta2, **f32) ** count_inc
        step_size = -1.0 * _learning_rate(self.learning_rate, count)
        c = _Weak(device, one_minus_b1=1 - self.beta1, b1=self.beta1,
                  one_minus_b2=1 - self.beta2, b2=self.beta2, eps=self.eps,
                  wd=self.weight_decay, max_norm=self.max_grad_norm or 0.0)
        clip = _clip(grads, self.max_grad_norm, c, self.norm_reduce)
        decay = decay_mask(params, self.no_decay_keys)
        for name, p in params.items():
            flat = [t.reshape(-1).split(CHUNK)
                    for t in (p, grads[name], state["mu"][name], state["nu"][name])]
            for pc, g, mc, vc in zip(*flat):
                g = clip(g)
                # scale_by_adam: moments, bias corrections, the update
                mu = c("one_minus_b1", g) * g + c("b1", mc) * mc
                nu = c("one_minus_b2", g) * (g * g) + c("b2", vc) * vc
                mu_hat = mu / bc1.to(mu.dtype)
                nu_hat = nu / bc2.to(nu.dtype)
                u = mu_hat / (torch.sqrt(nu_hat) + c("eps", nu_hat))
                if decay[name]:  # add_decayed_weights (masked)
                    u = u + c("wd", pc) * pc
                u = step_size.to(u.dtype) * u  # scale_by_learning_rate
                _keep(pc, pc + u, gate)        # apply_updates
                _keep(mc, mu, gate)
                _keep(vc, nu, gate)
        count.add_(1 if gate is None else gate.to(count.dtype))


@dataclasses.dataclass
class Lion:
    """`optax.lion` after an optional global-norm clip, with the decay mask
    (`mmada_tpu/training/optimizers.py:67-87`), rounding as optax does: each
    op in the leaf's dtype, Python constants weakly typed."""

    learning_rate: Union[float, Callable]
    beta1: float = 0.9
    beta2: float = 0.99
    weight_decay: float = 0.0
    max_grad_norm: Optional[float] = None
    no_decay_keys: tuple = NO_DECAY_KEYS
    norm_reduce: Optional[Callable] = None   # over a mesh: the clip's norm whole

    def init(self, params: Named) -> dict:
        device = next(iter(params.values())).device
        return {"count": torch.zeros((), dtype=torch.int64, device=device),
                "mu": {n: torch.zeros_like(p) for n, p in params.items()}}

    @torch.no_grad()
    def apply(self, params: Named, grads: Named, state: dict,
              gate: Optional[torch.Tensor] = None) -> None:
        """One update, in place."""
        count = state["count"]
        step_size = -1.0 * _learning_rate(self.learning_rate, count)
        c = _Weak(count.device, one_minus_b1=1 - self.beta1, b1=self.beta1,
                  one_minus_b2=1 - self.beta2, b2=self.beta2, wd=self.weight_decay,
                  max_norm=self.max_grad_norm or 0.0)
        clip = _clip(grads, self.max_grad_norm, c, self.norm_reduce)
        decay = decay_mask(params, self.no_decay_keys)
        for name, p in params.items():
            flat = [t.reshape(-1).split(CHUNK) for t in (p, grads[name], state["mu"][name])]
            for pc, g, mc in zip(*flat):
                g = clip(g)
                # scale_by_lion: the update's sign, then the moment
                u = torch.sign(c("one_minus_b1", g) * g + c("b1", mc) * mc)
                mu = c("one_minus_b2", g) * g + c("b2", mc) * mc
                if decay[name]:  # add_decayed_weights (masked)
                    u = u + c("wd", pc) * pc
                u = step_size.to(u.dtype) * u  # scale_by_learning_rate
                _keep(pc, pc + u, gate)        # apply_updates
                _keep(mc, mu, gate)
        count.add_(1 if gate is None else gate.to(count.dtype))


@dataclasses.dataclass
class MultiSteps:
    """Gradient accumulation over `every_k` calls (optax.MultiSteps)."""

    inner: Union[AdamW, Lion]
    every_k: int

    def init(self, params: Named) -> dict:
        device = next(iter(params.values())).device
        return {
            "mini_step": torch.zeros((), dtype=torch.int64, device=device),
            "acc": {n: torch.zeros_like(p) for n, p in params.items()},
            "inner": self.inner.init(params),
        }

    @torch.no_grad()
    def apply(self, params: Named, grads: Named, state: dict,
              gate: Optional[torch.Tensor] = None) -> None:
        mini = state["mini_step"]
        emit = mini == self.every_k - 1
        acc_new = {n: (a + (grads[n].to(a.dtype) - a) / (mini + 1)).to(a.dtype)
                   for n, a in state["acc"].items()}
        inner_gate = emit if gate is None else emit & gate
        self.inner.apply(params, acc_new, state["inner"], inner_gate)
        for n, a in state["acc"].items():
            _keep(a, torch.where(emit, torch.zeros_like(acc_new[n]), acc_new[n]), gate)
        _keep(mini, (mini + 1) % self.every_k, gate)


def from_config(opt_cfg: Mapping, lr_schedule) -> Union[AdamW, Lion]:
    """Build from the reference config's `optimizer:` block, as a dict:
    `{"name": "adamw" | "lion", "params": {"beta1": ..., "max_grad_norm":
    ...}}`, with JAX's defaults (`mmada_tpu/training/optimizers.py:89-111`:
    Lion's beta2 0.99, both decays 0.01)."""
    name = opt_cfg.get("name", "adamw")
    p = opt_cfg.get("params", {})
    common = dict(beta1=p.get("beta1", 0.9), weight_decay=p.get("weight_decay", 0.01),
                  max_grad_norm=p.get("max_grad_norm", None))
    if name == "adamw":
        mu_dtype = p.get("mu_dtype")
        return AdamW(lr_schedule, beta2=p.get("beta2", 0.999), eps=p.get("epsilon", 1e-8),
                     mu_dtype=getattr(torch, mu_dtype) if mu_dtype else None, **common)
    if name == "lion":
        return Lion(lr_schedule, beta2=p.get("beta2", 0.99), **common)
    raise ValueError(f"unknown optimizer: {name}")
