"""The port's attention and norms against the JAX package, on the CPU.

`flash_attention_reference` (the plain version of the Hopper kernel, which
the port's `flash_attention` runs for CPU tensors) is held against the JAX
one-pass Pallas kernel in interpret mode, on the same numpy inputs.
Tolerances: fp32 atol 1e-5 (summation order only); bf16 atol = rtol = 3e-2,
the bar of the JAX package's own bf16 kernel test
(tests/test_flash_attention.py::test_flash_bfloat16).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mmada_tpu.models import llada as jax_llada
from mmada_tpu.ops import attention as jax_attention
from mmada_tpu.ops import norms as jax_norms
from mmada_tpu.ops.flash_attention import flash_attention as jax_flash_attention
from mmada_tpu_torch.models.llada import rope_sin_cos
from mmada_tpu_torch.ops import attention, norms
from mmada_tpu_torch.ops.flash_attention import (
    flash_attention,
    flash_attention_reference,
)

DTYPES = {
    "fp32": (jnp.float32, torch.float32, dict(atol=1e-5, rtol=0)),
    "bf16": (jnp.bfloat16, torch.bfloat16, dict(atol=3e-2, rtol=3e-2)),
}


def _pair(a: np.ndarray, dtype: str):
    """The same values as a JAX array and a torch tensor of `dtype`."""
    jd, td, _ = DTYPES[dtype]
    return jnp.asarray(a, jd), torch.from_numpy(a).to(td)


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
@pytest.mark.parametrize(
    "b,h,kvh,lq,lk,rope",
    [
        (2, 2, 2, 128, 128, True),     # aligned, fused rope
        (1, 4, 2, 200, 200, True),     # GQA, unaligned (JAX pads to 256)
        (1, 2, 2, 320, 320, False),    # unaligned (JAX pads to 384), no rope
        (1, 4, 1, 320, 320, True),     # GQA 4:1, unaligned, rope
        (2, 2, 2, 128, 200, False),    # rectangular Lq != Lk (no rope)
    ],
)
def test_reference_matches_jax_kernel(dtype, b, h, kvh, lq, lk, rope):
    rng = np.random.default_rng(7)
    d = 64
    qn = rng.normal(size=(b, h, lq, d)).astype(np.float32) * 2.0
    kn = rng.normal(size=(b, kvh, lk, d)).astype(np.float32)
    vn = rng.normal(size=(b, kvh, lk, d)).astype(np.float32)
    (qj, qt), (kj, kt), (vj, vt) = (_pair(a, dtype) for a in (qn, kn, vn))
    sin_t = cos_t = sin_j = cos_j = None
    if rope:
        sin_j, cos_j = jax_llada.rope_sin_cos(lq, d, 10000.0)
        sin_t, cos_t = torch.from_numpy(np.array(sin_j)), torch.from_numpy(np.array(cos_j))
    want = jax_flash_attention(qj, kj, vj, rope_sin=sin_j, rope_cos=cos_j, interpret=True)
    got = flash_attention_reference(qt, kt, vt, rope_sin=sin_t, rope_cos=cos_t)
    assert got.dtype == DTYPES[dtype][1] and tuple(got.shape) == want.shape
    np.testing.assert_allclose(_np(got), _np(want), **DTYPES[dtype][2])
    # the public wrapper takes the plain version for CPU tensors
    torch.testing.assert_close(
        flash_attention(qt, kt, vt, rope_sin=sin_t, rope_cos=cos_t), got, atol=0, rtol=0)


def test_reference_is_the_xla_function():
    """With rope pre-applied, the plain kernel equals the JAX XLA attention
    (the path JAX takes on the CPU)."""
    rng = np.random.default_rng(1)
    q, k, v = (rng.normal(size=(2, 4, 96, 32)).astype(np.float32) for _ in range(3))
    k, v = k[:, :2], v[:, :2]
    want = jax_attention.xla_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    got = flash_attention_reference(*(torch.from_numpy(np.ascontiguousarray(a)) for a in (q, k, v)))
    np.testing.assert_allclose(_np(got), _np(want), atol=1e-5)


def test_reference_rejects_rectangular_rope():
    q = torch.zeros(1, 2, 8, 16)
    k = torch.zeros(1, 2, 12, 16)
    sin, cos = rope_sin_cos(8, 16, 10000.0, device="cpu")
    with pytest.raises(ValueError, match="square"):
        flash_attention_reference(q, k, k, rope_sin=sin, rope_cos=cos)


def test_wrapper_raises_off_cpu_and_cuda():
    """No silent fallback: a tensor the kernel cannot take raises."""
    q = torch.empty(1, 2, 8, 64, device="meta")
    with pytest.raises(ValueError):
        flash_attention(q, q, q)


@pytest.mark.parametrize("with_bias", [False, True])
def test_dispatch_cpu_matches_jax(with_bias):
    """`bidirectional_attention` on the CPU: unbiased calls take the kernel's
    plain version, biased ones the XLA-style attention - both equal JAX's."""
    rng = np.random.default_rng(3)
    b, h, l, d = 2, 4, 64, 16
    q, k, v = (rng.normal(size=(b, h, l, d)).astype(np.float32) for _ in range(3))
    sin_j, cos_j = jax_llada.rope_sin_cos(l, d, 10000.0)
    bias_np = None
    if with_bias:
        mask = np.ones((b, l), np.float32)
        mask[0, :9] = 0
        bias_np = np.where((mask[:, :, None] * mask[:, None, :]) > 0, 0.0,
                           jax_attention.NEG_INF).astype(np.float32)[:, None]
    want = jax_attention.bidirectional_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        bias=None if bias_np is None else jnp.asarray(bias_np),
        rope_sin=sin_j, rope_cos=cos_j,
    )
    got = attention.bidirectional_attention(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        bias=None if bias_np is None else torch.from_numpy(bias_np),
        rope_sin=torch.from_numpy(np.array(sin_j)),
        rope_cos=torch.from_numpy(np.array(cos_j)),
    )
    np.testing.assert_allclose(_np(got), _np(want), atol=1e-5)


@pytest.mark.parametrize("full_precision", [True, False])
def test_apply_rope_matches_jax(full_precision):
    rng = np.random.default_rng(4)
    q = rng.normal(size=(2, 3, 40, 32)).astype(np.float32)
    k = rng.normal(size=(2, 3, 40, 32)).astype(np.float32)
    sin_j, cos_j = jax_llada.rope_sin_cos(40, 32, 500000.0)
    want = jax_attention.apply_rope(jnp.asarray(q), jnp.asarray(k), sin_j, cos_j,
                                    full_precision=full_precision)
    got = attention.apply_rope(torch.from_numpy(q), torch.from_numpy(k),
                               torch.from_numpy(np.array(sin_j)),
                               torch.from_numpy(np.array(cos_j)),
                               full_precision=full_precision)
    for g, w in zip(got, want):
        np.testing.assert_allclose(_np(g), _np(w), atol=1e-6)


def test_rope_tables_match_jax():
    sin_j, cos_j = jax_llada.rope_sin_cos(1155, 128, 500000.0)
    sin_t, cos_t = rope_sin_cos(1155, 128, 500000.0, device="cpu")
    # fp32 sin/cos of arguments up to ~1.2e3 rad: a few ulps of the argument
    np.testing.assert_allclose(_np(sin_t), _np(sin_j), atol=1e-4)
    np.testing.assert_allclose(_np(cos_t), _np(cos_j), atol=1e-4)


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
@pytest.mark.parametrize("gemma", [False, True])
def test_rms_norm_matches_jax(dtype, gemma):
    rng = np.random.default_rng(5)
    x = rng.normal(size=(3, 7, 48)).astype(np.float32) * 3.0
    w = rng.normal(size=(48,)).astype(np.float32)
    (xj, xt), (wj, wt) = _pair(x, dtype), _pair(w, dtype)
    want = jax_norms.rms_norm(xj, wj, gemma_style=gemma)
    got = norms.rms_norm(xt, wt, gemma_style=gemma)
    assert got.dtype == DTYPES[dtype][1]
    np.testing.assert_allclose(_np(got), _np(want), **DTYPES[dtype][2])


def test_layer_norm_matches_jax():
    rng = np.random.default_rng(6)
    x = rng.normal(size=(4, 33)).astype(np.float32)
    w, b = rng.normal(size=(33,)).astype(np.float32), rng.normal(size=(33,)).astype(np.float32)
    want = jax_norms.layer_norm(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b))
    got = norms.layer_norm(torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(b))
    np.testing.assert_allclose(_np(got), _np(want), atol=1e-5)
