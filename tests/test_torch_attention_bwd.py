"""The port's attention backward against the JAX package, on the CPU.

* `flash_attention_bwd_reference` (the plain version of the dq and dkv
  kernels, which the port's `flash_attention_bwd` runs for CPU tensors)
  against the JAX `flash_attention_bwd` Pallas kernels in interpret mode, on
  the same rotated q/k, v, output and cotangent;
* the port's differentiable attention (`bidirectional_attention` through
  `KernelAttention`, RoPE pulled back in fp32) against `jax.vjp` of the JAX
  `bidirectional_attention(impl="pallas")` with its kernels in interpret mode
  (as tests/test_flash_attention.py runs them).

Tolerances: fp32 atol = rtol = 2e-4, the JAX backward tests' own bar; bf16
rtol 0.1, atol 0.15, the bar of the JAX package's bf16 backward test.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mmada_tpu.ops.attention as jax_attention
from mmada_tpu.models import llada as jax_llada
from mmada_tpu.ops.flash_attention import flash_attention_bwd as jax_flash_attention_bwd
from mmada_tpu_torch.models.llada import rope_sin_cos
from mmada_tpu_torch.ops.attention import bidirectional_attention
from mmada_tpu_torch.ops.flash_attention import (
    flash_attention_bwd,
    flash_attention_bwd_reference,
    flash_attention_reference,
)

TOL = {
    "fp32": (jnp.float32, torch.float32, dict(atol=2e-4, rtol=2e-4)),
    "bf16": (jnp.bfloat16, torch.bfloat16, dict(atol=0.15, rtol=0.1)),
}

# (tag, B, H, KVH, Lq, Lk, rope, dtype)
CASES = [
    ("aligned", 1, 2, 2, 384, 384, False, "fp32"),
    ("unaligned-rope", 1, 2, 2, 388, 388, True, "fp32"),
    ("gqa-4-2", 1, 4, 2, 300, 300, True, "fp32"),
    ("rectangular", 1, 2, 2, 500, 330, False, "fp32"),
    ("bf16", 1, 2, 2, 256, 256, True, "bf16"),
]


def _inputs(b, h, kvh, lq, lk, dtype, seed=0):
    rng = np.random.default_rng(seed)
    d = 128
    q = rng.normal(size=(b, h, lq, d)).astype(np.float32)
    k = rng.normal(size=(b, kvh, lk, d)).astype(np.float32)
    v = rng.normal(size=(b, kvh, lk, d)).astype(np.float32)
    ct = rng.normal(size=(b, h, lq, d)).astype(np.float32)
    jd, td, _ = TOL[dtype]
    return ([jnp.asarray(a, jd) for a in (q, k, v, ct)],
            [torch.from_numpy(a).to(td) for a in (q, k, v, ct)])


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def _close(got, want, dtype):
    for g, w in zip(got, want):
        np.testing.assert_allclose(_np(g), _np(w), **TOL[dtype][2])


@pytest.mark.parametrize("tag,b,h,kvh,lq,lk,rope,dtype", CASES, ids=[c[0] for c in CASES])
def test_backward_reference_matches_jax_kernels(tag, b, h, kvh, lq, lk, rope, dtype):
    (jq, jk, jv, jct), (q, k, v, ct) = _inputs(b, h, kvh, lq, lk, dtype)
    if rope:  # the backward kernels take q/k rotated, in both packages
        jsin, jcos = jax_llada.rope_sin_cos(lq, 128, 500000.0)
        jq, jk = jax_attention.apply_rope(jq, jk, jsin, jcos)
        q, k = (torch.from_numpy(np.array(a, np.float32)).to(q.dtype) for a in (jq, jk))
    out = flash_attention_reference(q, k, v)
    jout = jnp.asarray(_np(out), jq.dtype)
    want = jax_flash_attention_bwd(jq, jk, jv, jout, jct, interpret=True)
    got = flash_attention_bwd_reference(q, k, v, out, ct)
    for g, t in zip(got, (q, k, v)):
        assert g.dtype == t.dtype and g.shape == t.shape
    _close(got, want, dtype)
    # on CPU tensors the kernel wrapper takes the same plain version
    _close(flash_attention_bwd(q, k, v, out, ct), got, dtype)


@pytest.mark.parametrize("tag,b,h,kvh,lq,lk,rope,dtype", CASES, ids=[c[0] for c in CASES])
def test_autograd_matches_jax_grad(monkeypatch, tag, b, h, kvh, lq, lk, rope, dtype):
    monkeypatch.setattr(jax_attention, "_INTERPRET", True)
    (jq, jk, jv, jct), (q, k, v, ct) = _inputs(b, h, kvh, lq, lk, dtype, seed=1)
    rope_kw, jrope_kw = {}, {}
    if rope:
        sin, cos = rope_sin_cos(lq, 128, 500000.0, device="cpu")
        rope_kw = dict(rope_sin=sin, rope_cos=cos)
        jrope_kw = dict(rope_sin=jnp.asarray(sin.numpy()), rope_cos=jnp.asarray(cos.numpy()))

    def jax_fn(q_, k_, v_):
        return jax_attention.bidirectional_attention(q_, k_, v_, impl="pallas", **jrope_kw)

    jout, vjp = jax.vjp(jax_fn, jq, jk, jv)
    want = vjp(jct)

    ins = [t.requires_grad_() for t in (q, k, v)]
    out = bidirectional_attention(*ins, **rope_kw)
    assert out.grad_fn is not None
    got = torch.autograd.grad(out, ins, ct)
    _close([out], [jout], dtype)
    _close(got, want, dtype)


def test_no_gradient_reaches_the_rope_tables():
    (_, _, _, _), (q, k, v, ct) = _inputs(1, 2, 2, 64, 64, "fp32")
    sin, cos = rope_sin_cos(64, 128, 10000.0, device="cpu")
    sin.requires_grad_()
    out = bidirectional_attention(q.requires_grad_(), k, v, rope_sin=sin, rope_cos=cos)
    (dq, dsin) = torch.autograd.grad(out, (q, sin), ct, allow_unused=True)
    assert dq is not None and dsin is None
