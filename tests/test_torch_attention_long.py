"""The port's long-sequence tier (B4, B5) against the JAX package, on the CPU.

* `flash_attention_long_reference` (B4's plain version, which the port's
  `flash_attention_long` runs for CPU tensors) against the JAX
  `flash_attention_online` and `flash_attention_staged` kernels in interpret
  mode, at small aligned lengths and small blocks, with and without a bias,
  under GQA;
* `flash_attention_bwd_long_reference` (B5-dq and B5-dkv's plain versions)
  against `flash_attention_bwd_staged` in interpret mode: square, GQA,
  rectangular, biased;
* the port's `bidirectional_attention` and its autograd gradients against
  JAX's `bidirectional_attention(impl="pallas")` (kernels in interpret mode,
  as tests/test_flash_attention.py runs them) and `jax.vjp` of it, past 4096
  tokens: at L = 4224 (aligned: the long tier in both packages) and L = 4200
  (unaligned: JAX's XLA attention, the port's one-pass tier), with RoPE,
  with and without a mask bias;
* in bf16, that the long tier computes the online function (p in fp32,
  divided last) and not the one-pass one;
* a 2-layer model on 4,224-token frames against the JAX package with
  `attn_impl="pallas"`: the forward, a text request at T = 0, one train step
  (a t2i row).

Tolerances: fp32 atol = rtol = 2e-4, the bar of the JAX package's own
long-tier tests (tests/test_flash_attention.py:593); the model at the bars of
test_torch_llada.py (logits), test_torch_entry.py (tokens exact) and
test_torch_training.py (train step: 1e-5).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mmada_tpu.ops.attention as jax_attention
from mmada_tpu.core.vocab import tiny_layout as jax_tiny_layout
from mmada_tpu.models import llada as jax_llada
from mmada_tpu.models.mmada import MMadaModel as JaxMMadaModel
from mmada_tpu.ops.flash_attention import (
    flash_attention_bwd_staged,
    flash_attention_online,
    flash_attention_staged,
)
from mmada_tpu.training import optimizers as jax_optimizers
from mmada_tpu.training import train_step as jax_train_step
from mmada_tpu_torch.checkpoints.from_jax import named_from_jax, params_from_jax
from mmada_tpu_torch.core.vocab import tiny_layout
from mmada_tpu_torch.entry import serve_text, text_frames
from mmada_tpu_torch.models import llada
from mmada_tpu_torch.models.mmada import MMadaModel
from mmada_tpu_torch.ops.attention import bidirectional_attention
from mmada_tpu_torch.ops.flash_attention_long import (
    flash_attention_bwd_long,
    flash_attention_bwd_long_reference,
    flash_attention_long,
    flash_attention_long_reference,
)
from mmada_tpu_torch.training import optimizers
from mmada_tpu_torch.training.train_step import StepConfig, TrainState, make_train_step

TOL = dict(atol=2e-4, rtol=2e-4)
NEG = float(np.finfo(np.float32).min)


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def _inputs(b, h, kvh, lq, lk, d, seed=0):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(b, h, lq, d)).astype(np.float32) * 2.0
    k = rng.normal(size=(b, kvh, lk, d)).astype(np.float32)
    v = rng.normal(size=(b, kvh, lk, d)).astype(np.float32)
    ct = rng.normal(size=(b, h, lq, d)).astype(np.float32)
    return q, k, v, ct


def _bias(kind, b, h, lq, lk, seed=3):
    """None, a float bias per head / per batch row, or the mask bias of
    frames whose first positions are padded (those query rows have no
    allowed key)."""
    rng = np.random.default_rng(seed)
    if kind is None:
        return None
    if kind == "head":
        return (rng.normal(size=(b, h, lq, lk)) * 2.0).astype(np.float32)
    if kind == "batch":
        return (rng.normal(size=(b, 1, lq, lk)) * 2.0).astype(np.float32)
    keep = np.ones((b, lq), np.float32)
    for row in range(b):
        keep[row, :7 + 5 * row] = 0
    return np.where(keep[:, :, None] * keep[:, None, :] > 0, 0.0, NEG).astype(np.float32)[:, None]


def _live(bias, shape):
    """1 on query rows with an allowed key, 0 on the others: the model's
    cotangent is 0 there (no loss reads a pad row)."""
    if bias is None:
        return np.ones(shape, np.float32)
    return np.broadcast_to((bias > NEG).any(-1, keepdims=True), shape[:3] + (1,)).astype(
        np.float32)


def _t(a):
    return None if a is None else torch.from_numpy(np.ascontiguousarray(a))


def _j(a):
    return None if a is None else jnp.asarray(a)


# (tag, JAX kernel, B, H, KVH, L, D, bias)
FWD_CASES = [
    ("online", flash_attention_online, 1, 2, 2, 512, 64, None),
    ("online-gqa", flash_attention_online, 1, 4, 2, 384, 64, None),
    ("online-bias", flash_attention_online, 1, 2, 2, 256, 128, "head"),
    ("staged", flash_attention_staged, 1, 2, 2, 1024, 64, None),
    ("staged-gqa-bias", flash_attention_staged, 1, 4, 2, 384, 64, "batch"),
    ("staged-mask", flash_attention_staged, 2, 2, 2, 256, 64, "mask"),
]


@pytest.mark.parametrize("tag,kernel,b,h,kvh,l,d,bias_kind", FWD_CASES,
                         ids=[c[0] for c in FWD_CASES])
def test_long_reference_matches_jax_kernels(tag, kernel, b, h, kvh, l, d, bias_kind):
    q, k, v, _ = _inputs(b, h, kvh, l, l, d)
    bias = _bias(bias_kind, b, h, l, l)
    want = kernel(_j(q), _j(k), _j(v), bias=_j(bias), block_q=128, block_k=128,
                  interpret=True)
    got = flash_attention_long_reference(_t(q), _t(k), _t(v), _t(bias))
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    np.testing.assert_allclose(_np(got), _np(want), **TOL)
    # on CPU tensors the kernel wrapper takes the same plain version
    torch.testing.assert_close(flash_attention_long(_t(q), _t(k), _t(v), _t(bias)), got,
                               atol=0, rtol=0)


# (tag, B, H, KVH, Lq, Lk, D, bias)
BWD_CASES = [
    ("square", 1, 2, 2, 512, 512, 64, None),
    ("gqa", 1, 4, 2, 384, 384, 128, None),
    ("rectangular-gqa", 1, 4, 2, 256, 384, 64, None),
    ("bias", 1, 2, 2, 256, 256, 64, "head"),
    ("mask", 2, 2, 2, 384, 384, 64, "mask"),
]


@pytest.mark.parametrize("tag,b,h,kvh,lq,lk,d,bias_kind", BWD_CASES,
                         ids=[c[0] for c in BWD_CASES])
def test_long_backward_reference_matches_jax_staged(tag, b, h, kvh, lq, lk, d, bias_kind):
    q, k, v, ct = _inputs(b, h, kvh, lq, lk, d, seed=1)
    bias = _bias(bias_kind, b, h, lq, lk)
    ct = ct * _live(bias, ct.shape)
    out = flash_attention_long_reference(_t(q), _t(k), _t(v), _t(bias))
    want = flash_attention_bwd_staged(_j(q), _j(k), _j(v), jnp.asarray(_np(out)), _j(ct),
                                      bias=_j(bias), block_q=128, block_k=128, interpret=True)
    got = flash_attention_bwd_long_reference(_t(q), _t(k), _t(v), out, _t(ct), _t(bias))
    for g, w, ref in zip(got, want, (q, k, v)):
        assert g.dtype == torch.float32 and tuple(g.shape) == ref.shape
        np.testing.assert_allclose(_np(g), _np(w), **TOL)
    for g, w in zip(flash_attention_bwd_long(_t(q), _t(k), _t(v), out, _t(ct), _t(bias)), got):
        torch.testing.assert_close(g, w, atol=0, rtol=0)


# (L, query heads, kv heads, bias, JAX gradient): JAX's gradient through its
# kernels ("pallas": the staged backward at aligned L) or through `jax.vjp` of
# its XLA attention ("xla", the same function). The masked aligned case takes
# the XLA gradient at one head: JAX's biased staged kernels in interpret mode
# copy the (L, L) bias at each of their 33 x 33 grid steps (about 10 ms a
# step here); `test_long_backward_reference_matches_jax_staged` holds B5's
# plain versions against those kernels with a mask bias directly.
DISPATCH_CASES = [(4224, 2, 1, None, "pallas"), (4224, 1, 1, "mask", "xla"),
                  (4200, 2, 1, None, "pallas"), (4200, 2, 1, "mask", "pallas")]


@pytest.mark.parametrize("l,h,kvh,bias_kind,jax_grad", DISPATCH_CASES)
def test_dispatch_past_4096_matches_jax(monkeypatch, l, h, kvh, bias_kind, jax_grad):
    """Forward and gradients past the one-pass range, with RoPE: the aligned
    length through both packages' long tiers, the unaligned one through
    JAX's XLA attention and the port's one-pass tier (one function)."""
    monkeypatch.setattr(jax_attention, "_INTERPRET", True)
    b, d = 1, 128
    q, k, v, ct = _inputs(b, h, kvh, l, l, d, seed=2)
    bias = _bias(bias_kind, b, 1, l, l)
    ct = ct * _live(bias, ct.shape)
    sin, cos = llada.rope_sin_cos(l, d, 500000.0, device="cpu")
    jsin, jcos = jnp.asarray(sin.numpy()), jnp.asarray(cos.numpy())

    def jax_fn(impl):
        return lambda q_, k_, v_: jax_attention.bidirectional_attention(
            q_, k_, v_, bias=_j(bias), impl=impl, rope_sin=jsin, rope_cos=jcos)

    jq, jk, jv = _j(q), _j(k), _j(v)
    if jax_grad == "pallas":
        jout, vjp = jax.vjp(jax_fn("pallas"), jq, jk, jv)
    else:
        jout = jax_fn("pallas")(jq, jk, jv)
        vjp = jax.vjp(jax_fn("xla"), jq, jk, jv)[1]
    want = vjp(_j(ct))
    ins = [_t(a).requires_grad_() for a in (q, k, v)]
    out = bidirectional_attention(*ins, bias=_t(bias), rope_sin=sin, rope_cos=cos)
    got = torch.autograd.grad(out, ins, _t(ct))
    np.testing.assert_allclose(_np(out), _np(jout), **TOL)
    for g, w in zip(got, want):
        np.testing.assert_allclose(_np(g), _np(w), **TOL)


def test_bf16_long_tier_is_the_online_function():
    """In bf16 at L = 4224 the long tier's output is within one bf16 ulp of
    the JAX online kernel's (p in fp32, divided last), and nearer to it than
    JAX's XLA attention (p normalised and rounded to bf16 before p.v) is."""
    b, h, l, d = 1, 2, 4224, 64
    q, k, v, _ = _inputs(b, h, h, l, l, d, seed=4)
    jq, jk, jv = (jnp.asarray(a, jnp.bfloat16) for a in (q, k, v))
    online = _np(flash_attention_online(jq, jk, jv, interpret=True))
    xla = _np(jax_attention.xla_attention(jq, jk, jv))
    got = _np(flash_attention_long(*(torch.from_numpy(a).bfloat16() for a in (q, k, v))))
    mag = np.maximum(np.abs(got), np.abs(online))
    ulp = np.ldexp(np.ones_like(mag), np.frexp(mag)[1] - 8)   # bf16: 8 significant bits
    # plus 2^-20 where cancellation leaves an entry near 1e-5: both sum in fp32,
    # in another order
    assert (np.abs(got - online) <= ulp + 2.0 ** -20).all()
    assert np.abs(got - online).mean() < 0.25 * np.abs(xla - online).mean()


# ---------------------------------------------------------------- the model

FRAME = 4224
JVOCAB = jax_tiny_layout(text_vocab_size=256, image_codebook_size=64)
VOCAB = tiny_layout(text_vocab_size=256, image_codebook_size=64)


@pytest.fixture(scope="module")
def long_models():
    """A 2-layer model with head_dim 128 (the JAX backward kernels' width),
    weights from JAX, in both packages; JAX through its Pallas tiers."""
    jcfg = jax_llada.tiny_config(vocab_size=JVOCAB.total_vocab_size, d_model=256, n_heads=2,
                                 n_kv_heads=1, n_layers=2, mlp_hidden_size=256,
                                 max_sequence_length=FRAME)
    jcfg = dataclasses.replace(jcfg, mask_token_id=JVOCAB.mask_token_id)
    jmodel = JaxMMadaModel(cfg=jcfg, params=jax_llada.init_params(jax.random.key(5), jcfg),
                           vocab=JVOCAB, attn_impl="pallas")
    cfg = llada.LLaDAConfig(**dataclasses.asdict(jcfg))
    params = params_from_jax(jax.device_get(jmodel.params), cfg, device="cpu")
    return jmodel, MMadaModel(cfg=cfg, params=params, vocab=VOCAB)


def test_long_frame_forward_matches_jax(long_models, monkeypatch):
    monkeypatch.setattr(jax_attention, "_INTERPRET", True)
    jmodel, model = long_models
    ids = np.random.default_rng(6).integers(0, 256, (1, FRAME)).astype(np.int32)
    want = jax_llada.forward(jmodel.params, jmodel.cfg, jnp.asarray(ids), attn_impl="pallas",
                             logit_positions=(FRAME - 64, 64))
    got = model.forward(torch.from_numpy(ids).long(), logit_positions=(FRAME - 64, 64))
    np.testing.assert_allclose(_np(got), _np(want), atol=2e-4, rtol=1e-3)


def test_long_frame_text_request_matches_jax(long_models, monkeypatch):
    """One request whose frame is 4,224 tokens, T = 0, 2 steps: the same
    answer token for token."""
    monkeypatch.setattr(jax_attention, "_INTERPRET", True)
    jmodel, model = long_models
    kw = dict(gen_length=16, steps=2, block_length=16, temperature=0.0)
    prompt = ("the quick brown fox jumps over the lazy dog " * 100)[:FRAME - 1 - 16]
    (answer,) = serve_text(model, [prompt], device="cpu", **kw)
    (frame,) = text_frames(model, [prompt])
    assert len(frame) + kw["gen_length"] == FRAME
    want = jmodel.generate(jnp.asarray([frame], jnp.int32), **kw)
    np.testing.assert_array_equal(answer.numpy(), np.asarray(want)[0, len(frame):])


def test_long_frame_train_step_matches_jax(long_models, monkeypatch):
    """One train step on a 4,224-token t2i frame against JAX's
    `make_train_step` on the batch the JAX package corrupted: loss and the
    gradient norm within 1e-5, every weight after the update within 1e-5
    (the bar of test_torch_training.py). One row: JAX's staged backward in
    interpret mode takes seconds per row and layer at this length. The
    learning rate is stage 1's, 1e-4: AdamW's first update is lr g / (|g| +
    1e-8), so where the keys' gradients nearly cancel at this init (entries
    below 1e-9), the fp32 summation order of g, which differs between the
    two packages, moves the update by up to lr times g's relative error.
    At 1e-3 one of 32,768 entries of a key projection moved by 1.1e-5."""
    monkeypatch.setattr(jax_attention, "_INTERPRET", True)
    jmodel, model = long_models
    sizes = dict(batch_size_t2i=1, batch_size_lm=0, batch_size_mmu=0, max_seq_length=8)
    rng = np.random.default_rng(7)
    t2i = rng.integers(3, 250, size=(1, FRAME))
    t2i[:, 9:-1] = rng.integers(0, 64, size=(1, FRAME - 10)) + VOCAB.image_offset
    batch = {"t2i_input_ids": jnp.asarray(t2i),
             "t2i_masks": jnp.ones((1, FRAME), jnp.int32)}
    key = jax.random.key(8)
    jopt = jax_optimizers.adamw(1e-4, params_for_mask=jmodel.params)
    jstate = jax_train_step.TrainState.create(jmodel.params, jopt)
    jsc = jax_train_step.StepConfig(**sizes)
    jstate, jm = jax.jit(jax_train_step.make_train_step(jmodel, jopt, jsc))(jstate, batch, key)
    prepared = {k: torch.from_numpy(np.array(v)) for k, v in
                jax_train_step.corrupt_batch(jmodel, jsc, batch, key).items() if v is not None}
    prepared = {k: v.long() if not v.is_floating_point() else v for k, v in prepared.items()}
    opt = optimizers.AdamW(1e-4)
    step = make_train_step(model, opt, StepConfig(**sizes))
    state, m = step.apply(TrainState.create(model.params, opt), prepared)
    for name in ("loss", "loss_t2i", "grad_norm"):
        np.testing.assert_allclose(float(m[name]), float(jm[name]), rtol=1e-5, atol=1e-6,
                                   err_msg=name)
    assert float(m["skipped_nonfinite"]) == 0.0
    ours = dict(llada.named_leaves(state.params))
    for name, want in named_from_jax(jax.device_get(jstate.params), device="cpu").items():
        torch.testing.assert_close(ours[name], want, rtol=1e-5, atol=1e-5)
