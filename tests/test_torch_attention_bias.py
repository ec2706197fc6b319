"""The port's biased attention against the JAX package, on the CPU.

* `flash_attention_reference` with a bias (the plain version of kernel B2)
  against the JAX one-pass Pallas kernel with a bias in interpret mode, on
  the rows that have an allowed key, and against JAX's `xla_attention` on
  every row;
* the plain dq / dkv with a bias (kernels B3-bias) against the JAX
  `flash_attention_bwd(bias=...)` Pallas kernels in interpret mode;
* `bidirectional_attention` with a bias (through `KernelAttention`) against
  `jax.vjp` of the JAX `bidirectional_attention(impl="pallas")`, kernels in
  interpret mode; no gradient reaches the bias;
* the masked model: `llada.forward` with `attention_bias_enabled=True` and
  padded masks, and the bias built once per forward and shared by every
  layer (with remat too).

Rows in which every key is masked (a padded query): the port's kernels and
plain versions average v over the Lk real keys there, as `xla_attention`
does, while the JAX Pallas tier also averages over its zero-padded tile; so
those rows are compared with `xla_attention` only, and the backward
comparisons give them a zero cotangent, as the model does (no real row
attends to a pad key and no loss reads a pad row).

Tolerances: fp32 atol 1e-5 forward (summation order only), atol = rtol =
2e-4 backward (the JAX backward tests' bar); bf16 atol = rtol = 3e-2 (the JAX
package's bf16 kernel test); logits atol 2e-4 / rtol 1e-3
(tests/test_llada_parity.py).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mmada_tpu.ops.attention as jax_attention
from mmada_tpu.models import llada as jax_llada
from mmada_tpu.ops.flash_attention import flash_attention as jax_flash_attention
from mmada_tpu.ops.flash_attention import flash_attention_bwd as jax_flash_attention_bwd
from mmada_tpu_torch.checkpoints.from_jax import params_from_jax
from mmada_tpu_torch.core.precision import FP32
from mmada_tpu_torch.models import llada
from mmada_tpu_torch.ops import attention
from mmada_tpu_torch.ops.attention import bidirectional_attention
from mmada_tpu_torch.ops.flash_attention import (
    NEG_F32,
    bias_as_float,
    flash_attention,
    flash_attention_bwd,
    flash_attention_bwd_reference,
    flash_attention_reference,
)

DTYPES = {
    "fp32": (jnp.float32, torch.float32, dict(atol=1e-5, rtol=0)),
    "bf16": (jnp.bfloat16, torch.bfloat16, dict(atol=3e-2, rtol=3e-2)),
}
BWD_TOL = dict(atol=2e-4, rtol=2e-4)


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def _bias_np(kind, b, h, lq, lk, rng):
    """A bias of `kind` as numpy, with some query rows that have no allowed
    key:
    - "mask": (B, 1, Lq, Lk) fp32 0 / finite min from per-row keep masks
      (each batch row pads its first 3 + 4 b positions), as
      `prepare_attention_bias` makes it;
    - "bool": (1, 1, Lq, Lk) bool (True = allowed), random, two rows all
      False;
    - "head": (B, H, Lq, Lk) fp32 random, some entries and one row at the
      finite min."""
    if kind == "mask":
        keep_q = np.ones((b, lq), bool)
        keep_k = np.ones((b, lk), bool)
        for row in range(b):
            keep_q[row, :3 + 4 * row] = False
            keep_k[row, :3 + 4 * row] = False
        pair = keep_q[:, :, None] & keep_k[:, None, :]
        return np.where(pair, 0.0, NEG_F32).astype(np.float32)[:, None]
    if kind == "bool":
        allowed = rng.random((1, 1, lq, lk)) < 0.6
        allowed[..., [1, lq // 2], :] = False
        return allowed
    bias = (rng.normal(size=(b, h, lq, lk)) * 2.0).astype(np.float32)
    bias[rng.random(bias.shape) < 0.1] = NEG_F32
    bias[:, :, 2, :] = NEG_F32
    return bias


def _live_rows(bias_np, shape):
    """(B, H, Lq) True where a query row has at least one allowed key."""
    f = _np(bias_as_float(torch.from_numpy(bias_np)))
    return np.broadcast_to((f > NEG_F32).any(-1), shape[:3])


# (tag, B, H, KVH, Lq, Lk, rope, bias kind, dtype)
FWD_CASES = [
    ("mask-rope", 2, 2, 2, 200, 200, True, "mask", "fp32"),     # unaligned (JAX pads 256)
    ("bool-gqa", 2, 4, 2, 130, 130, True, "bool", "fp32"),      # GQA, bool broadcast bias
    ("head-norope", 1, 2, 2, 150, 150, False, "head", "fp32"),  # per-head float bias
    ("rect", 2, 2, 2, 70, 200, False, "mask", "fp32"),          # rectangular, no rope
    ("bf16-gqa", 1, 4, 1, 140, 140, True, "head", "bf16"),      # GQA 4:1 in bf16
]


@pytest.mark.parametrize("tag,b,h,kvh,lq,lk,rope,kind,dtype", FWD_CASES,
                         ids=[c[0] for c in FWD_CASES])
def test_biased_reference_matches_jax(tag, b, h, kvh, lq, lk, rope, kind, dtype):
    rng = np.random.default_rng(8)
    d = 64
    qn = rng.normal(size=(b, h, lq, d)).astype(np.float32) * 2.0
    kn = rng.normal(size=(b, kvh, lk, d)).astype(np.float32)
    vn = rng.normal(size=(b, kvh, lk, d)).astype(np.float32)
    bias_np = _bias_np(kind, b, h, lq, lk, rng)
    jd, td, tol = DTYPES[dtype]
    qj, kj, vj = (jnp.asarray(a, jd) for a in (qn, kn, vn))
    qt, kt, vt = (torch.from_numpy(a).to(td) for a in (qn, kn, vn))
    sin_j = cos_j = sin_t = cos_t = None
    if rope:
        sin_j, cos_j = jax_llada.rope_sin_cos(lq, d, 10000.0)
        sin_t, cos_t = torch.from_numpy(np.array(sin_j)), torch.from_numpy(np.array(cos_j))
    got = flash_attention_reference(qt, kt, vt, rope_sin=sin_t, rope_cos=cos_t,
                                    bias=torch.from_numpy(bias_np))
    assert got.dtype == td and tuple(got.shape) == (b, h, lq, d)
    # the Pallas kernel, on the rows with an allowed key
    want = jax_flash_attention(qj, kj, vj, bias=jnp.asarray(bias_np), rope_sin=sin_j,
                               rope_cos=cos_j, interpret=True)
    live = _live_rows(bias_np, got.shape)
    assert live.any() and not live.all()
    np.testing.assert_allclose(_np(got)[live], _np(want)[live], **tol)
    # the XLA function, on every row
    if rope:
        qj, kj = jax_attention.apply_rope(qj, kj, sin_j, cos_j)
    want_xla = jax_attention.xla_attention(qj, kj, vj, bias=jnp.asarray(bias_np))
    np.testing.assert_allclose(_np(got), _np(want_xla), **tol)
    # the public wrapper takes the plain version for CPU tensors
    torch.testing.assert_close(
        flash_attention(qt, kt, vt, rope_sin=sin_t, rope_cos=cos_t,
                        bias=torch.from_numpy(bias_np)), got, atol=0, rtol=0)


def test_zero_bias_is_the_unbiased_function():
    rng = np.random.default_rng(9)
    q, k, v = (torch.from_numpy(rng.normal(size=(2, 2, 77, 64)).astype(np.float32))
               for _ in range(3))
    zero = torch.zeros(2, 1, 77, 77)
    torch.testing.assert_close(flash_attention_reference(q, k, v, bias=zero),
                               flash_attention_reference(q, k, v), atol=0, rtol=0)


def _bwd_inputs(b, h, kvh, lq, lk, kind, seed):
    rng = np.random.default_rng(seed)
    d = 128
    q = rng.normal(size=(b, h, lq, d)).astype(np.float32)
    k = rng.normal(size=(b, kvh, lk, d)).astype(np.float32)
    v = rng.normal(size=(b, kvh, lk, d)).astype(np.float32)
    ct = rng.normal(size=(b, h, lq, d)).astype(np.float32)
    bias = _bias_np(kind, b, h, lq, lk, rng)
    ct = ct * _live_rows(bias, ct.shape)[..., None]   # zero on rows with no allowed key
    return q, k, v, ct, bias


# (tag, B, H, KVH, Lq, Lk, rope, bias kind)
BWD_CASES = [
    ("mask-rope", 2, 2, 2, 300, 300, True, "mask"),
    ("head-gqa", 1, 4, 2, 260, 260, False, "head"),
    ("bool-rect", 1, 2, 2, 280, 150, False, "bool"),
]


@pytest.mark.parametrize("tag,b,h,kvh,lq,lk,rope,kind", BWD_CASES, ids=[c[0] for c in BWD_CASES])
def test_biased_backward_reference_matches_jax_kernels(tag, b, h, kvh, lq, lk, rope, kind):
    qn, kn, vn, ctn, bias_np = _bwd_inputs(b, h, kvh, lq, lk, kind, seed=2)
    jq, jk, jv, jct = (jnp.asarray(a) for a in (qn, kn, vn, ctn))
    if rope:  # the backward kernels take q/k rotated, in both packages
        jsin, jcos = jax_llada.rope_sin_cos(lq, 128, 500000.0)
        jq, jk = jax_attention.apply_rope(jq, jk, jsin, jcos)
    q, k, v, ct = (torch.from_numpy(np.array(a, np.float32)) for a in (jq, jk, jv, jct))
    bias = torch.from_numpy(bias_np)
    out = flash_attention_reference(q, k, v, bias=bias)
    jbias = jnp.asarray(_np(bias_as_float(bias)))
    want = jax_flash_attention_bwd(jq, jk, jv, jnp.asarray(_np(out)), jct, bias=jbias,
                                   interpret=True)
    got = flash_attention_bwd_reference(q, k, v, out, ct, bias=bias)
    for g, w in zip(got, want):
        np.testing.assert_allclose(_np(g), _np(w), **BWD_TOL)
    # on CPU tensors the kernel wrapper takes the same plain version
    for g, w in zip(flash_attention_bwd(q, k, v, out, ct, bias=bias), got):
        torch.testing.assert_close(g, w, atol=0, rtol=0)


@pytest.mark.parametrize("tag,b,h,kvh,lq,lk,rope,kind", BWD_CASES[:2], ids=[c[0] for c in BWD_CASES[:2]])
def test_biased_autograd_matches_jax_grad(monkeypatch, tag, b, h, kvh, lq, lk, rope, kind):
    monkeypatch.setattr(jax_attention, "_INTERPRET", True)
    qn, kn, vn, ctn, bias_np = _bwd_inputs(b, h, kvh, lq, lk, kind, seed=3)
    rope_kw, jrope_kw = {}, {}
    if rope:
        sin, cos = llada.rope_sin_cos(lq, 128, 500000.0, device="cpu")
        rope_kw = dict(rope_sin=sin, rope_cos=cos)
        jrope_kw = dict(rope_sin=jnp.asarray(sin.numpy()), rope_cos=jnp.asarray(cos.numpy()))
    jbias = jnp.asarray(bias_np)

    def jax_fn(q_, k_, v_):
        return jax_attention.bidirectional_attention(q_, k_, v_, bias=jbias, impl="pallas",
                                                     **jrope_kw)

    jout, vjp = jax.vjp(jax_fn, *(jnp.asarray(a) for a in (qn, kn, vn)))
    want = vjp(jnp.asarray(ctn))

    ins = [torch.from_numpy(a).requires_grad_() for a in (qn, kn, vn)]
    bias = torch.from_numpy(bias_np).requires_grad_()
    out = bidirectional_attention(*ins, bias=bias, **rope_kw)
    assert out.grad_fn is not None
    *got, dbias = torch.autograd.grad(out, ins + [bias], torch.from_numpy(ctn),
                                      allow_unused=True)
    assert dbias is None   # no gradient reaches the bias
    live = _live_rows(bias_np, out.shape)
    np.testing.assert_allclose(_np(out)[live], _np(jout)[live], **BWD_TOL)
    for g, w in zip(got, want):
        np.testing.assert_allclose(_np(g), _np(w), **BWD_TOL)


def test_bool_bias_becomes_float_before_the_function(monkeypatch):
    """A bool bias reaches `KernelAttention` as fp32 0 / finite min, and
    gives what its float form gives."""
    rng = np.random.default_rng(4)
    q, k, v = (torch.from_numpy(rng.normal(size=(1, 2, 40, 64)).astype(np.float32))
               for _ in range(3))
    allowed = torch.from_numpy(rng.random((1, 1, 40, 40)) < 0.5)
    seen = []
    real = attention.KernelAttention.apply

    def spy(*args):
        seen.append(args[3])
        return real(*args)

    monkeypatch.setattr(attention.KernelAttention, "apply", spy)
    got = bidirectional_attention(q, k, v, bias=allowed)
    monkeypatch.undo()
    assert seen[0].dtype == torch.float32
    assert torch.equal(seen[0], torch.where(allowed, 0.0, NEG_F32))
    torch.testing.assert_close(got, bidirectional_attention(q, k, v, bias=seen[0]),
                               atol=0, rtol=0)


def test_backward_is_finite_with_a_cotangent_on_fully_masked_rows():
    """The plain dq / dkv on rows with no allowed key and a nonzero
    cotangent: dkv's p is 1 there (the row's lse is the finite min), and
    every gradient stays finite."""
    qn, kn, vn, _, bias_np = _bwd_inputs(2, 2, 2, 90, 90, "mask", seed=5)
    ct = torch.from_numpy(np.random.default_rng(6).normal(size=qn.shape).astype(np.float32))
    q, k, v = (torch.from_numpy(a) for a in (qn, kn, vn))
    bias = torch.from_numpy(bias_np)
    out = flash_attention_reference(q, k, v, bias=bias)
    for g in flash_attention_bwd_reference(q, k, v, out, ct, bias=bias):
        assert torch.isfinite(g).all()


# ------------------------------------------------------------- the model

def _masked_models(n_kv_heads=2):
    jcfg = dataclasses.replace(jax_llada.tiny_config(n_kv_heads=n_kv_heads),
                               attention_bias_enabled=True)
    jparams = jax_llada.init_params(jax.random.key(12), jcfg)
    cfg = llada.LLaDAConfig(**dataclasses.asdict(jcfg))
    return jcfg, jparams, cfg, params_from_jax(jax.device_get(jparams), cfg, device="cpu")


def test_masked_forward_matches_jax():
    """`attention_bias_enabled=True` with padded masks (two rows padded by
    different amounts, one not at all), GQA: logits on every position within
    the parity bar, the padded positions included (they attend to every key
    in both packages, the XLA function on the JAX side)."""
    jcfg, jparams, cfg, params = _masked_models()
    rng = np.random.default_rng(13)
    ids = rng.integers(0, cfg.vocab_size, (3, 40)).astype(np.int32)
    mask = np.ones(ids.shape, np.int32)
    mask[0, :7] = 0
    mask[1, :19] = 0
    want = jax_llada.forward(jparams, jcfg, jnp.asarray(ids), attention_mask=jnp.asarray(mask))
    got = llada.forward(params, cfg, torch.from_numpy(ids).long(),
                        attention_mask=torch.from_numpy(mask), policy=FP32)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-4, rtol=1e-3)
    unmasked = llada.forward(params, cfg, torch.from_numpy(ids).long(), policy=FP32)
    assert not torch.allclose(got[:2], unmasked[:2], atol=1e-3)   # the mask mattered


@pytest.mark.parametrize("remat", [False, "full"])
def test_bias_is_built_once_and_shared_by_every_layer(monkeypatch, remat):
    """One forward (and its backward, which recomputes each layer under
    remat) builds the bias once and hands the same tensor to every layer."""
    _, _, cfg, params = _masked_models()
    cfg = dataclasses.replace(cfg, n_layers=3)
    params = llada.init_params(cfg, device="cpu", generator=torch.Generator().manual_seed(1))
    built, seen = [], []
    real_prepare, real_attention = llada.prepare_attention_bias, llada.bidirectional_attention

    def prepare(*a, **kw):
        built.append(real_prepare(*a, **kw))
        return built[-1]

    def attend(q, k, v, bias=None, **kw):
        seen.append(bias)
        return real_attention(q, k, v, bias=bias, **kw)

    monkeypatch.setattr(llada, "prepare_attention_bias", prepare)
    monkeypatch.setattr(llada, "bidirectional_attention", attend)
    tree = llada.split_layers(params)
    ids = torch.randint(0, cfg.vocab_size, (2, 24), generator=torch.Generator().manual_seed(2))
    mask = torch.ones(2, 24, dtype=torch.long)
    mask[0, :5] = 0
    out = llada.forward(tree, cfg, ids, attention_mask=mask, remat=remat)
    out.sum().backward()
    assert len(built) == 1
    assert len(seen) == cfg.n_layers * (2 if remat else 1)
    assert all(b is built[0] for b in seen)


@pytest.mark.parametrize("length", [387, 1155])
@pytest.mark.parametrize("with_bias", [False, True])
def test_prepared_bias_is_jax_bias_with_aligned_rows(length, with_bias):
    """At the odd frame lengths the model runs (stage-1 387, t2i CFG 1,155),
    `prepare_attention_bias` gives JAX's bias element for element, as a view
    whose rows start a multiple of 4 floats (16 bytes) apart, the other
    strides contiguous (the biased kernels read it through TMA without a
    copy); the plain versions give the same bits on it as on a contiguous
    copy."""
    rng = np.random.default_rng(length)
    mask = np.ones((2, length), np.int32)
    mask[0, :length // 3] = 0
    extra = (rng.standard_normal((1, 1, length, length)).astype(np.float32)
             if with_bias else None)
    want = jax_llada.prepare_attention_bias(
        jnp.asarray(mask), None if extra is None else jnp.asarray(extra))
    got = llada.prepare_attention_bias(
        torch.from_numpy(mask), None if extra is None else torch.from_numpy(extra))
    assert got.dtype == torch.float32 and tuple(got.shape) == (2, 1, length, length)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert got.stride(-1) == 1 and got.stride(-2) % 4 == 0 and got.stride(-2) >= length
    assert got.stride(1) == length * got.stride(-2) and got.stride(0) == got.stride(1)
    assert not got.is_contiguous()
    dense = got.contiguous()
    g = torch.Generator().manual_seed(length)
    q, k, v = (torch.randn(2, 2, length, 64, generator=g) for _ in range(3))
    out = flash_attention_reference(q, k, v, bias=got)
    torch.testing.assert_close(out, flash_attention_reference(q, k, v, bias=dense),
                               atol=0, rtol=0)
    dout = torch.randn(out.shape, generator=g)
    torch.testing.assert_close(flash_attention_bwd_reference(q, k, v, out, dout, bias=got),
                               flash_attention_bwd_reference(q, k, v, out, dout, bias=dense),
                               atol=0, rtol=0)
