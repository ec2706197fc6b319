"""The port's block-KV cached decode against the JAX package, on the CPU.

Counterpart of tests/test_kv_cache.py without the engine and t2m cases. Both
packages run the same weights (a JAX init carried over by `params_from_jax`)
under the FP32 policy on inputs made from numpy seeds:

* `forward_kv_capture`'s K/V and `forward_kv_step`'s logits within atol /
  rtol 2e-4 of JAX's (llama MHA, GQA, q/k-norm, the sequential block; with
  and without `drop_span` / `cache_is_compact`), and a fresh-cache step
  within the same bar of the port's own full forward sliced to the block;
* `_quantize_kv` equal to JAX's bit for bit; the int8-cache step within 2e-4
  of JAX's on the same cache, and close to the fp32 cache's by JAX's bars
  (argmax agreement >= 0.95, mean error < 5%);
* the cached samplers token-exact against JAX at T = 0 (text with and
  without CFG, int8, refresh 1 and 2; `generate_stepwise`; t2i greedy with
  refresh 0 and 2), and equal to the exact sampler where the cache is always
  fresh (refresh 1, one step a block, one t2i timestep);
* the refusals (`cfg_interval` with the cache, a biased model with the
  cache, segmented runs with the cache), the strict `kv_cache` parser, attention of a few
  queries over more than 4,096 keys (the one-pass tier, equal to JAX's
  `xla_attention` within 2e-4), and `entry.serve_*` with the knobs.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mmada_tpu.core.vocab import tiny_layout as jax_tiny_layout
from mmada_tpu.models import llada as jax_llada
from mmada_tpu.models.mmada import MMadaModel as JaxMMadaModel
from mmada_tpu.ops import attention as jax_attention
from mmada_tpu_torch import entry
from mmada_tpu_torch.checkpoints.from_jax import params_from_jax
from mmada_tpu_torch.core.config import parse_kv_cache
from mmada_tpu_torch.core.vocab import tiny_layout
from mmada_tpu_torch.models import llada
from mmada_tpu_torch.models.mmada import MMadaModel
from mmada_tpu_torch.ops import attention
from mmada_tpu_torch.prompting.universal import SpecialIds

TOL = dict(atol=2e-4, rtol=2e-4)
CONFIGS = {
    "mha": dict(),
    "gqa": dict(n_kv_heads=2),
    "qk_norm": dict(attention_layer_norm=True),
    "sequential": dict(block_type="sequential"),
}
TEXT = dict(gen_length=32, steps=8, block_length=16, temperature=0.0)


def _models(seed=0, **cfg_over):
    """One random tiny MMaDA in both packages, on the same weights."""
    jvocab = jax_tiny_layout()
    jcfg = jax_llada.tiny_config(vocab_size=jvocab.total_vocab_size, **cfg_over)
    jmodel = JaxMMadaModel.init(jax.random.key(seed), jcfg, jvocab)
    cfg = llada.LLaDAConfig(**dataclasses.asdict(jcfg))
    params = params_from_jax(jax.device_get(jmodel.params), cfg, device="cpu")
    return jmodel, MMadaModel(cfg=cfg, params=params, vocab=tiny_layout())


@pytest.fixture(scope="module")
def models():
    return _models()


def _ids(shape, seed):
    return np.random.default_rng(seed).integers(3, 200, shape).astype(np.int32)


def _as_torch(tree):
    if isinstance(tree, tuple):
        return tuple(_as_torch(x) for x in tree)
    return torch.from_numpy(np.array(tree))


@pytest.mark.parametrize("compact", [False, True], ids=["in-place", "compact"])
@pytest.mark.parametrize("name", list(CONFIGS))
def test_capture_and_step_match_jax(name, compact):
    """The same tokens through both packages' capture and one step: K/V and
    logits within 2e-4. Compact: the span [32, 48) left out of the cache and
    forwarded as the step's block, the head over a vocab window."""
    jmodel, model = _models(seed=1, **CONFIGS[name])
    ids = _ids((2, 56), seed=2)
    start, blk = 32, 16
    drop = (start, start + blk) if compact else None
    window = (8, 72) if compact else None
    jkv = jax_llada.forward_kv_capture(jmodel.params, jmodel.cfg, jnp.asarray(ids),
                                       drop_span=drop)
    kv = llada.forward_kv_capture(model.params, model.cfg, torch.from_numpy(ids).long(),
                                  drop_span=drop)
    for got, want in zip(kv, jkv):
        assert got.shape == want.shape
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    block = ids[:, start:start + blk]
    want = jax_llada.forward_kv_step(jmodel.params, jmodel.cfg, jnp.asarray(block), jkv,
                                     jnp.int32(start), logit_window=window,
                                     cache_is_compact=compact)
    got = llada.forward_kv_step(model.params, model.cfg, torch.from_numpy(block).long(), kv,
                                start, logit_window=window, cache_is_compact=compact)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("compact", [False, True], ids=["in-place", "compact"])
@pytest.mark.parametrize("name", list(CONFIGS))
def test_fresh_step_matches_full_forward(name, compact):
    """A step on a cache captured from the same tokens reproduces the full
    forward's logits over the block (JAX test_kv_step_matches_full_forward),
    within 2e-4."""
    _, model = _models(seed=3, **CONFIGS[name])
    ids = torch.from_numpy(_ids((2, 48), seed=4)).long()
    start, blk = 24, 16
    full = llada.forward(model.params, model.cfg, ids)[:, start:start + blk]
    kv = llada.forward_kv_capture(model.params, model.cfg, ids,
                                  drop_span=(start, start + blk) if compact else None)
    got = llada.forward_kv_step(model.params, model.cfg, ids[:, start:start + blk], kv, start,
                                cache_is_compact=compact)
    torch.testing.assert_close(got, full, **TOL)


def test_quantize_kv_matches_jax_bit_for_bit():
    """Codes and scales equal JAX's, on values whose quotients fall on .5
    (round half to even) and on a zero vector (the 1e-8 floor)."""
    rng = np.random.default_rng(5)
    t = rng.normal(size=(2, 3, 17, 16)).astype(np.float32)
    t[0, 0, 0] = np.linspace(-127, 127, 16) / 2 * (1 / 63.5)   # quotients k + 0.5
    t[0, 0, 1] = 0.0
    t[1, 2, 3, 5] = 50.0
    codes, scale = llada._quantize_kv(torch.from_numpy(t))
    jcodes, jscale = jax_llada._quantize_kv(jnp.asarray(t))
    assert codes.dtype == torch.int8 and scale.shape == (2, 3, 17, 1)
    np.testing.assert_array_equal(codes.numpy(), np.asarray(jcodes))
    np.testing.assert_array_equal(scale.numpy(), np.asarray(jscale))
    np.testing.assert_array_equal(
        llada._dequantize_kv(codes, scale, torch.float32).numpy(),
        np.asarray(jax_llada._dequantize_kv(jcodes, jscale, jnp.float32)))


def test_int8_cache_step_matches_jax(models):
    """On JAX's int8 cache the port's step gives JAX's logits within 2e-4;
    the port's own int8 capture holds JAX's codes to within one step of
    rounding (the K/V they quantize agree to float error) and its scales
    within 2e-4."""
    jmodel, model = models
    ids = _ids((2, 48), seed=6)
    start, blk = 32, 16
    jkv = jax_llada.forward_kv_capture(jmodel.params, jmodel.cfg, jnp.asarray(ids),
                                       cache_dtype="int8")
    kv = llada.forward_kv_capture(model.params, model.cfg, torch.from_numpy(ids).long(),
                                  cache_dtype="int8")
    for (codes, scale), (jcodes, jscale) in zip(kv, jkv):
        assert codes.dtype == torch.int8 and codes.shape == jcodes.shape
        assert np.abs(codes.numpy().astype(int) - np.asarray(jcodes).astype(int)).max() <= 1
        np.testing.assert_allclose(scale.numpy(), np.asarray(jscale), **TOL)
    block = ids[:, start:start + blk]
    want = jax_llada.forward_kv_step(jmodel.params, jmodel.cfg, jnp.asarray(block), jkv,
                                     jnp.int32(start))
    got = llada.forward_kv_step(model.params, model.cfg, torch.from_numpy(block).long(),
                                _as_torch(jkv), start)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_int8_cache_close_to_full_cache(models):
    """JAX's bars (test_int8_cache_close_to_fp32_cache): argmax agreement >=
    0.95 and mean error < 5% against the fp32 cache's step; int8 leaves."""
    _, model = models
    ids = torch.from_numpy(_ids((2, 48), seed=7)).long()
    start, blk = 32, 16
    kv = llada.forward_kv_capture(model.params, model.cfg, ids)
    kv8 = llada.forward_kv_capture(model.params, model.cfg, ids, cache_dtype="int8")
    assert kv8[0][0].dtype == torch.int8 and kv8[0][0].numel() == kv[0].numel()
    ref = llada.forward_kv_step(model.params, model.cfg, ids[:, start:start + blk], kv, start)
    got = llada.forward_kv_step(model.params, model.cfg, ids[:, start:start + blk], kv8, start)
    agree = float((ref.argmax(-1) == got.argmax(-1)).float().mean())
    assert agree >= 0.95, agree
    assert float((ref - got).abs().mean() / ref.abs().mean()) < 0.05


TEXT_CASES = {
    "cached": dict(block_kv_cache=True),
    "cached-cfg": dict(block_kv_cache=True, cfg_scale=1.5),
    "int8": dict(block_kv_cache="int8"),
    "refresh-1": dict(block_kv_cache=True, cache_refresh_every=1),
    "refresh-2": dict(block_kv_cache=True, cache_refresh_every=2),
    "refresh-2-cfg": dict(block_kv_cache=True, cache_refresh_every=2, cfg_scale=1.5),
    "int8-refresh-2": dict(block_kv_cache="int8", cache_refresh_every=2),
}


@pytest.mark.parametrize("case", list(TEXT_CASES))
def test_generate_cached_matches_jax(models, case):
    """`generate` with the cache, token-exact against JAX at T = 0."""
    jmodel, model = models
    prompt = _ids((2, 8), seed=8)
    kw = dict(TEXT, **TEXT_CASES[case])
    want = jmodel.generate(jnp.asarray(prompt), **kw)
    got = model.generate(torch.from_numpy(prompt), **kw)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert (got != model.vocab.mask_token_id).all()


def test_generate_stepwise_cached_matches_jax(models):
    """The cached trajectory equals JAX's step for step; its last row is
    `generate`'s."""
    jmodel, model = models
    prompt = _ids((2, 8), seed=9)
    kw = dict(TEXT, block_kv_cache=True)
    want = np.asarray(jmodel.generate_stepwise(jnp.asarray(prompt), **kw))
    got = model.generate_stepwise(torch.from_numpy(prompt), **kw)
    assert got.shape == (TEXT["steps"], 2, 8 + TEXT["gen_length"])
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(got[-1].numpy(),
                                  model.generate(torch.from_numpy(prompt), **kw).numpy())


@pytest.mark.parametrize("cfg_scale", [0.0, 1.5])
def test_refresh_every_step_equals_exact(models, cfg_scale):
    """`cache_refresh_every=1` captures before every step, so the cached
    decode is the exact sampler, token for token (JAX
    test_text_cached_refresh_exact_at_one); so is one step a block."""
    _, model = models
    prompt = torch.from_numpy(_ids((2, 8), seed=10))
    kw = dict(TEXT, cfg_scale=cfg_scale)
    exact = model.generate(prompt, **kw)
    assert torch.equal(model.generate(prompt, **kw, block_kv_cache=True,
                                      cache_refresh_every=1), exact)
    one = dict(kw, steps=2)
    assert torch.equal(model.generate(prompt, **one, block_kv_cache=True),
                       model.generate(prompt, **one))


def _t2i_frame(vocab, b=2, prompt_len=6, n=16, seed=11):
    rng = np.random.default_rng(seed)
    frame = np.concatenate([rng.integers(3, 200, (b, prompt_len)), np.full((b, 1), 250),
                            np.full((b, n), vocab.mask_token_id), np.full((b, 1), 251)],
                           axis=1).astype(np.int32)
    uncond = frame.copy()
    uncond[:, :prompt_len] = vocab.pad_token_id
    return frame, uncond


T2I = dict(timesteps=4, guidance_scale=1.5, temperature=0.0, num_vq_tokens=16, greedy=True)


@pytest.mark.parametrize("knobs", [dict(block_kv_cache=True),
                                   dict(block_kv_cache=True, cache_refresh_every=2),
                                   dict(block_kv_cache="int8")],
                         ids=["cached", "refresh-2", "int8"])
def test_t2i_cached_matches_jax(models, knobs):
    """Cached MaskGIT under CFG, greedy: the codes equal JAX's."""
    jmodel, model = models
    frame, uncond = _t2i_frame(model.vocab)
    want = jmodel.t2i_generate(jnp.asarray(frame), uncond_input_ids=jnp.asarray(uncond),
                               key=jax.random.key(0), **T2I, **knobs)
    got = model.t2i_generate(torch.from_numpy(frame), uncond_input_ids=torch.from_numpy(uncond),
                             **T2I, **knobs)
    assert got.shape == (2, 16)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_t2i_cached_fresh_equals_exact(models):
    """Refresh 1 (and one timestep) keep the cache fresh at every step: the
    cached codes equal the exact sampler's; the stepwise trajectory ends on
    `t2i_generate`'s codes."""
    _, model = models
    frame, uncond = (torch.from_numpy(a) for a in _t2i_frame(model.vocab, seed=12))
    kw = dict(T2I, uncond_input_ids=uncond)
    exact = model.t2i_generate(frame, **kw)
    assert torch.equal(model.t2i_generate(frame, **kw, block_kv_cache=True,
                                          cache_refresh_every=1), exact)
    one = dict(kw, timesteps=1)
    assert torch.equal(model.t2i_generate(frame, **one, block_kv_cache=True),
                       model.t2i_generate(frame, **one))
    traj = model.t2i_generate(frame, **kw, block_kv_cache=True, stepwise=True)
    assert traj.shape == (T2I["timesteps"], 2, 16)
    assert torch.equal(traj[-1], model.t2i_generate(frame, **kw, block_kv_cache=True))


def test_cache_refusals(models):
    """`cfg_interval` with the cache, the cache on a biased model, and the
    segmented runs with the cache raise (JAX's `ValueError`)."""
    _, model = models
    frame, uncond = (torch.from_numpy(a) for a in _t2i_frame(model.vocab))
    with pytest.raises(ValueError, match="cfg_interval"):
        model.t2i_generate(frame, uncond_input_ids=uncond, **T2I, block_kv_cache=True,
                           cfg_interval=(0.25, 0.75))
    biased = dataclasses.replace(model, cfg=dataclasses.replace(model.cfg,
                                                                attention_bias_enabled=True))
    prompt = torch.from_numpy(_ids((1, 8), seed=13))
    with pytest.raises(ValueError, match="no-bias"):
        biased.generate(prompt, **TEXT, block_kv_cache=True)
    with pytest.raises(ValueError, match="no-bias"):
        biased.t2i_generate(frame, **T2I, block_kv_cache="int8")
    with pytest.raises(ValueError, match="exact sampler only"):
        model.generate(prompt, **TEXT, segment_steps=4, block_kv_cache=True)
    with pytest.raises(ValueError, match="exact sampler only"):
        model.t2i_generate(frame, **T2I, segment_timesteps=2, block_kv_cache=True)
    with pytest.raises(NotImplementedError, match="remat"):
        llada.forward_kv_capture(model.params, model.cfg, prompt.long(), remat=True)


@pytest.mark.parametrize("value,want", [("int8", "int8"), (" INT8 ", "int8"), ("false", False),
                                        ("off", False), ("", False), ("true", True),
                                        ("1", True), (True, True), (False, False),
                                        (0, False)])
def test_parse_kv_cache(value, want):
    assert parse_kv_cache(value) == want


@pytest.mark.parametrize("value", ["int4", "maybe", "bf16"])
def test_parse_kv_cache_refuses_junk(value):
    with pytest.raises(ValueError, match="kv_cache"):
        parse_kv_cache(value)


@pytest.mark.parametrize("lk", [4200, 8192])
def test_rectangular_past_4096_is_the_one_pass_function(monkeypatch, lk):
    """64 queries over more than 4,096 keys take the one-pass tier (never the
    long tier, whose function keeps p in fp32) and equal JAX's
    `bidirectional_attention(impl="xla")` within 2e-4, under GQA."""
    monkeypatch.setattr(attention, "flash_attention_long", None)  # any call would fail
    rng = np.random.default_rng(14)
    q = rng.normal(size=(1, 4, 64, 128)).astype(np.float32) * 2
    k = rng.normal(size=(1, 2, lk, 128)).astype(np.float32)
    v = rng.normal(size=(1, 2, lk, 128)).astype(np.float32)
    assert not attention.long_tier(64, lk)
    got = attention.bidirectional_attention(*(torch.from_numpy(a) for a in (q, k, v)))
    want = jax_attention.bidirectional_attention(*(jnp.asarray(a) for a in (q, k, v)),
                                                 impl="xla")
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_serve_text_and_t2i_with_knobs_equal_the_model(models):
    """`serve_text` / `serve_t2i` with the knobs (the cache flag as a string,
    through the strict parser) answer as the model calls do."""
    _, model = models
    prompts = ["abc", "xyz"]
    knobs = dict(parallel_threshold=0.9, parallel_warmup_steps=1, cache_refresh_every=2)
    answers = entry.serve_text(model, prompts, device="cpu", block_kv_cache="int8",
                               **TEXT, **knobs)
    frames = torch.tensor(entry.text_frames(model, prompts))
    want = model.generate(frames, block_kv_cache="int8", **TEXT, **knobs)
    for row, ans in enumerate(answers):
        assert torch.equal(ans, want[row, frames.shape[1]:])
    with pytest.raises(ValueError, match="kv_cache"):
        entry.serve_text(model, prompts, device="cpu", block_kv_cache="yes please", **TEXT)

    t = model.vocab.text_vocab_size
    sp = SpecialIds(soi=t - 20, eoi=t - 19, t2i=t - 18, mmu=t - 17, r2i=t - 16, t2m=t - 15,
                    som=t - 14, eom=t - 13, pad=model.vocab.pad_token_id,
                    bos=model.vocab.bos_token_id, eos=model.vocab.eos_token_id)
    kw = dict(num_vq_tokens=16, max_text_len=8, timesteps=3, guidance_scale=1.5,
              temperature=0.0, greedy=True)
    codes = entry.serve_t2i(model, prompts, special_ids=sp, device="cpu",
                            block_kv_cache="true", cache_refresh_every=2, **kw)
    exact = entry.serve_t2i(model, prompts, special_ids=sp, device="cpu", **kw)
    from mmada_tpu_torch.prompting.universal import ByteTokenizer, UniversalPrompting

    up = UniversalPrompting(ByteTokenizer(), sp, max_text_len=8)
    ids, _ = up.t2i_gen(prompts, np.full((2, 16), model.vocab.mask_token_id))
    uncond, _ = up.t2i_gen_uncond(2, 16, model.vocab.mask_token_id)
    want = model.t2i_generate(torch.as_tensor(ids).long(),
                              uncond_input_ids=torch.as_tensor(uncond).long(),
                              timesteps=3, guidance_scale=1.5, temperature=0.0,
                              num_vq_tokens=16, greedy=True, block_kv_cache=True,
                              cache_refresh_every=2)
    assert torch.equal(codes, want) and codes.shape == exact.shape
