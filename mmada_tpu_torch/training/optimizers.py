"""AdamW with a no-decay mask, global-norm clipping, and gradient
accumulation.

Counterpart of `mmada_tpu/training/optimizers.py` (:19-64) and of the optax
chain it builds, in optax's order:

    clip_by_global_norm -> Adam (bias-corrected, eps outside the sqrt)
    -> add_decayed_weights(mask) -> scale by -lr(count)

State is one first and one second moment per parameter, in the
parameter's dtype unless `mu_dtype` says otherwise (optax's default with
`mu_dtype=None`), and an update count on the device. Each update's arithmetic
is fp32. `apply` updates parameters and moments in place, one tensor (and one
chunk of a large tensor) at a time, so its temporaries stay small: torch's
`foreach` AdamW would hold temporaries the size of all the moments at once.
With a `gate` (a 0-d bool tensor on the device) every tensor takes its new
value only where the gate is true and the count advances by the gate: a
non-finite step is skipped on the device, with no host round trip.

`MultiSteps` is optax's `MultiSteps` (gradient accumulation): the running
mean of k micro-batch gradients, an inner update every k-th call.
Lion is not ported yet.
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


def global_norm(tensors: Named) -> torch.Tensor:
    """sqrt of the sum of squares of every tensor, in fp32, on the device."""
    sq = [torch.linalg.vector_norm(t, dtype=torch.float32) ** 2 for t in tensors.values()]
    return torch.stack(sq).sum().sqrt()


def _keep(dst: torch.Tensor, new: torch.Tensor, gate: Optional[torch.Tensor]) -> None:
    """dst <- new, or dst <- where(gate, new, dst)."""
    new = new.to(dst.dtype)
    dst.copy_(new if gate is None else torch.where(gate, new, dst))


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

    def _lr(self, count: torch.Tensor) -> torch.Tensor:
        if callable(self.learning_rate):
            return self.learning_rate(count)
        return torch.full((), self.learning_rate, dtype=torch.float32, device=count.device)

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
        """One update, in place (see the module docstring)."""
        count = state["count"]
        count_inc = (count + 1).to(torch.float32)
        bc1 = 1.0 - torch.tensor(self.beta1, dtype=torch.float32, device=count.device) ** count_inc
        bc2 = 1.0 - torch.tensor(self.beta2, dtype=torch.float32, device=count.device) ** count_inc
        step_size = -1.0 * self._lr(count)
        clip = None
        if self.max_grad_norm is not None:
            g_norm = global_norm(grads)
            clip = (g_norm < self.max_grad_norm, g_norm)
        decay = decay_mask(params, self.no_decay_keys)
        b1, b2 = self.beta1, self.beta2
        for name, p in params.items():
            flat = [t.reshape(-1).split(CHUNK)
                    for t in (p, grads[name], state["mu"][name], state["nu"][name])]
            for pc, gc, mc, vc in zip(*flat):
                g = gc.float()
                if clip is not None:
                    trigger, g_norm = clip
                    g = torch.where(trigger, g, (g / g_norm) * self.max_grad_norm)
                mu = (1 - b1) * g + b1 * mc.float()
                nu = (1 - b2) * (g * g) + b2 * vc.float()
                u = (mu / bc1) / (torch.sqrt(nu / bc2) + self.eps)
                pf = pc.float()
                if decay[name]:
                    u = u + self.weight_decay * pf
                _keep(pc, pf + step_size * u, gate)
                _keep(mc, mu, gate)
                _keep(vc, nu, gate)
        count.add_(1 if gate is None else gate.to(count.dtype))


@dataclasses.dataclass
class MultiSteps:
    """Gradient accumulation over `every_k` calls (optax.MultiSteps)."""

    inner: AdamW
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


def from_config(opt_cfg: Mapping, lr_schedule) -> AdamW:
    """Build from the reference config's `optimizer:` block, as a dict:
    `{"name": "adamw", "params": {"beta1": ..., "max_grad_norm": ...}}`."""
    name = opt_cfg.get("name", "adamw")
    if name != "adamw":
        raise NotImplementedError(f"optimizer {name!r} is not ported yet (only adamw)")
    p = opt_cfg.get("params", {})
    mu_dtype = p.get("mu_dtype")
    return AdamW(
        lr_schedule, beta1=p.get("beta1", 0.9), beta2=p.get("beta2", 0.999),
        eps=p.get("epsilon", 1e-8), weight_decay=p.get("weight_decay", 0.01),
        max_grad_norm=p.get("max_grad_norm", None),
        mu_dtype=getattr(torch, mu_dtype) if mu_dtype else None,
    )
