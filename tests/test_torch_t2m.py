"""The port's text-to-motion serving against the JAX package and the golden.

The t2m frame and the synthetic motion data equal JAX's; the MotionGIT
sampler is token-exact against `t2m_generate.npz` and against JAX's
`MMadaModel.t2m_generate` at greedy, temperature 0, on a tiny model with the
motion vocab (`tiny_layout().with_motion(32)`): exact (the frame's mask
through the biased attention and without it), cached at one step and at a
refresh every step (each also equal to the exact sampler, JAX's exactness
cases, tests/test_kv_cache.py:255, :379), segmented against monolithic, the
engine against the direct call, and `serve_t2m` / `decode_motion`.
Stochastic runs are held against the port's own runs with the same seed.
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mmada_tpu.checkpoints.hf_import import (
    params_from_torch_state_dict as jax_params_from_state,
)
from mmada_tpu.core.vocab import tiny_layout as jax_tiny_layout
from mmada_tpu.data import synthetic as jax_synthetic
from mmada_tpu.models import llada as jax_llada
from mmada_tpu.models.mmada import MMadaModel as JaxMMadaModel
from mmada_tpu.prompting import universal as jax_universal
from mmada_tpu.sampling import motion as jax_motion
from mmada_tpu_torch import entry
from mmada_tpu_torch.checkpoints.from_jax import params_from_jax, params_from_torch_state_dict
from mmada_tpu_torch.core.vocab import tiny_layout
from mmada_tpu_torch.data import synthetic
from mmada_tpu_torch.models import llada, motion_vq
from mmada_tpu_torch.models.mmada import MMadaModel
from mmada_tpu_torch.prompting.universal import ByteTokenizer, SpecialIds, UniversalPrompting
from mmada_tpu_torch.sampling import motion as motion_sampling
from mmada_tpu_torch.serve.engine import ServingEngine, T2MSettings
from mmada_tpu_torch.training.t2m import token_range_sanity

GOLDENS = os.path.join(os.path.dirname(__file__), "goldens")
N = 8              # motion tokens a frame
TEXT_LEN = 12      # prompting's max_text_len (the frame's text is one longer)
CAPTIONS = ["walk", "a person jumps"]
GREEDY = dict(timesteps=5, temperature=0.0, num_motion_tokens=N, greedy=True)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _special(vocab):
    t = vocab.text_vocab_size
    return dict(soi=t - 20, eoi=t - 19, t2i=t - 18, mmu=t - 17, r2i=t - 16, t2m=t - 15,
                som=t - 14, eom=t - 13, pad=vocab.pad_token_id, bos=1, eos=2)


@pytest.fixture(scope="module")
def models():
    jvocab = jax_tiny_layout(text_vocab_size=300).with_motion(32)
    jcfg = jax_llada.tiny_config(vocab_size=jvocab.total_vocab_size, d_model=32, n_heads=2,
                                 n_layers=2, mlp_hidden_size=64)
    jcfg = dataclasses.replace(jcfg, mask_token_id=jvocab.mask_token_id)
    jmodel = JaxMMadaModel.init(jax.random.key(0), jcfg, jvocab)
    # weights 8x the init's 0.02: random logits that depend on the positions,
    # so that greedy codes differ along the span
    jmodel = dataclasses.replace(jmodel, params=jax.tree.map(lambda w: w * 8, jmodel.params))
    cfg = llada.LLaDAConfig(**dataclasses.asdict(jcfg))
    params = params_from_jax(jax.device_get(jmodel.params), cfg, device="cpu")
    return jmodel, MMadaModel(cfg=cfg, params=params,
                              vocab=tiny_layout(text_vocab_size=300).with_motion(32))


def _masked(models):
    jmodel, model = models
    return (dataclasses.replace(jmodel, cfg=dataclasses.replace(
                jmodel.cfg, attention_bias_enabled=True)),
            dataclasses.replace(model, cfg=dataclasses.replace(
                model.cfg, attention_bias_enabled=True)))


def _frames(vocab, captions=CAPTIONS):
    """The t2m generation frames (motion span masked) and their masks."""
    prompting = UniversalPrompting(ByteTokenizer(), SpecialIds(**_special(vocab)),
                                   max_text_len=TEXT_LEN)
    motion = np.full((len(captions), N), vocab.mask_token_id, np.int64)
    ids, mask, _ = prompting.t2m(captions, motion, motion, dropout=False)
    return ids, mask


def _jax_codes(jmodel, ids, mask=None, **kw):
    out = jmodel.t2m_generate(jnp.asarray(ids), attention_mask=None if mask is None
                              else jnp.asarray(mask), key=jax.random.key(0),
                              **dict(GREEDY, **kw))
    return np.asarray(out)


def _codes(model, ids, mask=None, **kw):
    return model.t2m_generate(torch.from_numpy(ids), attention_mask=None if mask is None
                              else torch.from_numpy(mask), **dict(GREEDY, **kw)).numpy()


# ------------------------------------------------------------------ data

def test_t2m_frame_matches_jax():
    """`UniversalPrompting.t2m` (and its dispatch) equals JAX's: ids, the mask
    0 over the pads, labels IGNORE outside the motion span, the caption
    dropout drawn alike."""
    vocab = tiny_layout(text_vocab_size=300).with_motion(32)
    jsp = jax_universal.SpecialIds(**_special(vocab))
    caps = ["walk", "a person jumps high in the air and lands"]
    rng = np.random.default_rng(3)
    motion = rng.integers(0, 34, size=(2, N)) + vocab.motion_offset
    want = jax_universal.UniversalPrompting(
        jax_universal.ByteTokenizer(), jsp, max_text_len=TEXT_LEN, cond_dropout_prob=0.5,
        rng=np.random.default_rng(1))((caps, motion, motion), "t2m")
    got = UniversalPrompting(ByteTokenizer(), SpecialIds(**_special(vocab)),
                             max_text_len=TEXT_LEN, cond_dropout_prob=0.5,
                             rng=np.random.default_rng(1))((caps, motion, motion), "t2m")
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    ids, mask, labels = got
    assert ids.shape == (2, TEXT_LEN + 1 + N + 2) and mask[0, 0] == 0 and mask.all(axis=0)[-1]
    assert (labels[:, :TEXT_LEN + 2] == -100).all() and (labels[:, -1] == -100).all()


def test_motion_synthetic_matches_jax():
    for k in (0, 5, 47):
        np.testing.assert_array_equal(synthetic.motion_clip(k, length=40, pose_dim=12),
                                      jax_synthetic.motion_clip(k, length=40, pose_dim=12))
        assert synthetic.motion_caption(k) == jax_synthetic.motion_caption(k)


# --------------------------------------------------------------- sampler

def test_t2m_generate_matches_golden():
    """`t2m_generate.npz` (the reference `t2m_generate`, greedy at T = 0):
    the committed motion span, token for token, through the port's sampler
    on the golden's weights; and JAX's sampler on the same."""
    data = np.load(os.path.join(GOLDENS, "t2m_generate.npz"))
    state = {k[len("w::"):]: data[k] for k in data.files if k.startswith("w::")}
    kw = dict(d_model=64, n_heads=4, n_layers=2, mlp_hidden_size=128, vocab_size=96,
              embedding_size=96, max_sequence_length=128, rope_theta=10000.0, mask_token_id=90)
    cfg = llada.LLaDAConfig(**kw)
    params = params_from_torch_state_dict(state, cfg, device="cpu")
    n, offset = 8, 80

    def window_forward(tokens, attention_mask):
        logits = llada.forward(params, cfg, tokens, attention_mask=attention_mask,
                               logit_window=(offset, offset + 8))
        return logits[:, -(n + 1):-1, :]

    mcfg = motion_sampling.MotionGITConfig(timesteps=5, temperature=0.0, mask_id=90,
                                           num_motion_tokens=n, motion_vocab_size=8,
                                           motion_offset=offset, greedy=True)
    out = motion_sampling.t2m_generate(window_forward, torch.from_numpy(data["input_ids"]),
                                       mcfg)
    np.testing.assert_array_equal(out.numpy(), data["out_committed"])

    jcfg = jax_llada.LLaDAConfig(**kw)
    jparams = jax_params_from_state(state, jcfg)
    jmcfg = jax_motion.MotionGITConfig(timesteps=5, temperature=0.0, mask_id=90,
                                       num_motion_tokens=n, motion_vocab_size=8,
                                       motion_offset=offset, greedy=True)
    want = jax_motion.t2m_generate(
        lambda t, m: jax_llada.forward(jparams, jcfg, t, attention_mask=m,
                                       logit_window=(offset, offset + 8))[:, -(n + 1):-1],
        jnp.asarray(data["input_ids"]), jmcfg, key=jax.random.key(0))
    np.testing.assert_array_equal(out.numpy(), np.asarray(want))


@pytest.mark.parametrize("masked", [False, True], ids=["no-mask", "mask"])
def test_exact_t2m_matches_jax(models, masked):
    """Greedy at T = 0: the port's exact sampler equals JAX's, without the
    mask reaching attention and with it (`attention_bias_enabled`; the frames'
    pads are masked out), where the mask changes the codes."""
    pair = _masked(models) if masked else models
    ids, mask = _frames(pair[1].vocab)
    got = _codes(pair[1], ids, mask)
    np.testing.assert_array_equal(got, _jax_codes(pair[0], ids, mask))
    assert ((got >= 0) & (got < 32)).all()
    if masked:
        assert (got != _codes(models[1], ids, mask)).any()


@pytest.mark.parametrize("knob", [dict(timesteps=1), dict(cache_refresh_every=1)],
                         ids=["one-step", "refresh-1"])
@pytest.mark.parametrize("cache", [True, "int8"], ids=["bf16", "int8"])
def test_cached_t2m_matches_jax_and_exact(models, knob, cache):
    """The cached decode at one step, and with a refresh before every step:
    equal to JAX's cached sampler, and with the unquantized cache to the
    exact sampler (the int8 cache rounds the K/V it holds)."""
    jmodel, model = models
    ids, mask = _frames(model.vocab)
    got = _codes(model, ids, mask, block_kv_cache=cache, **knob)
    if cache is True:
        np.testing.assert_array_equal(got, _codes(model, ids, mask, **knob))
    np.testing.assert_array_equal(got, _jax_codes(jmodel, ids, mask, block_kv_cache=cache,
                                                  **knob))


def test_cached_t2m_ignores_the_mask(models):
    """The cached capture and step take no mask (JAX's `_span_cache_fns`):
    the same codes with and without one, and the refusal of masks in the
    attention."""
    _, model = models
    ids, mask = _frames(model.vocab)
    kw = dict(block_kv_cache=True, cache_refresh_every=2)
    np.testing.assert_array_equal(_codes(model, ids, mask, **kw), _codes(model, ids, None, **kw))
    with pytest.raises(ValueError, match="no-bias"):
        _codes(_masked(models)[1], ids, mask, **kw)


def test_segmented_t2m_matches_monolithic(models):
    """`segment_timesteps` (windows of 2 of 5 steps): the monolithic codes at
    greedy (and JAX's), and with categorical sampling from one generator a
    row the same draws; the run's windows and `.last_window`."""
    jmodel, model = _masked(models)
    ids, mask = _frames(model.vocab)
    seg = _codes(model, ids, mask, segment_timesteps=2)
    np.testing.assert_array_equal(seg, _codes(model, ids, mask))
    np.testing.assert_array_equal(seg, _jax_codes(jmodel, ids, mask))

    def gens():
        return [torch.Generator().manual_seed(s) for s in (4, 5)]

    kw = dict(timesteps=5, temperature=1.0, num_motion_tokens=N, attention_mask=torch.from_numpy(mask))
    mono = model.t2m_generate(torch.from_numpy(ids), generator=gens(), **kw)
    run = model.t2m_segmented_run(torch.from_numpy(ids), generator=gens(), segment_timesteps=2,
                                  **kw)
    widths = []
    while not run.step():
        widths.append(run.last_window.shape[0])
    widths.append(run.last_window.shape[0])
    assert widths == [2, 2, 1]
    np.testing.assert_array_equal(run.codes.numpy(), mono.numpy())
    # a row's codes are its batch-1 run's
    solo = model.t2m_generate(torch.from_numpy(ids[1:]), generator=gens()[1:],
                              **dict(kw, attention_mask=torch.from_numpy(mask[1:])))
    np.testing.assert_array_equal(solo.numpy(), mono[1:].numpy())


def test_t2m_refusals(models):
    _, model = models
    ids, _ = _frames(model.vocab)
    with pytest.raises(ValueError, match="exact sampler only"):
        _codes(model, ids, segment_timesteps=2, block_kv_cache=True)
    with pytest.raises(ValueError, match="requires a torch.Generator"):
        model.t2m_generate(torch.from_numpy(ids), timesteps=2, num_motion_tokens=N)
    plain = dataclasses.replace(model, vocab=tiny_layout(text_vocab_size=300))
    with pytest.raises(ValueError, match="motion window"):
        _codes(plain, ids)


# ---------------------------------------------------------- engine, entry

@pytest.mark.parametrize("settings", [
    T2MSettings(timesteps=5, num_motion_tokens=N),
    T2MSettings(timesteps=5, num_motion_tokens=N, segment_timesteps=2),
    T2MSettings(timesteps=5, num_motion_tokens=N, block_kv_cache=True, cache_refresh_every=2),
], ids=["monolithic", "chunked", "cached"])
def test_engine_t2m_matches_direct_call(models, settings):
    """`submit_t2m` (two requests released together: each runs solo) equals
    the direct call with the request's seed; a chunked request counts its
    windows."""
    _, model = _masked(models) if not settings.block_kv_cache else models
    ids, mask = _frames(model.vocab)
    eng = ServingEngine(model, min_chunk_device_ms=0).start()
    try:
        eng.pause()
        futs = [eng.submit_t2m(ids[i], settings, seed=10 + i, attention_mask=mask[i])
                for i in range(2)]
        eng.resume()
        got = [f.result(120) for f in futs]
        assert eng.stats["batches"] == 2
        assert eng.stats["chunks"] == (6 if settings.segment_timesteps else 0)
    finally:
        eng.stop()
    for i in range(2):
        want = model.t2m_generate(
            torch.from_numpy(ids[i:i + 1]), attention_mask=torch.from_numpy(mask[i:i + 1]),
            timesteps=5, temperature=1.0, num_motion_tokens=N,
            generator=torch.Generator().manual_seed(10 + i),
            block_kv_cache=settings.block_kv_cache,
            cache_refresh_every=settings.cache_refresh_every)
        np.testing.assert_array_equal(got[i], want[0].numpy())


def test_serve_t2m_and_decode_motion(models):
    """`serve_t2m(device="cpu")` at greedy equals JAX's sampler on the same
    frames (the vocab's reserved specials), with each fast knob; its codes
    decode to `(B, 4 n, pose_dim)` features through the motion VQ-VAE; the
    sanity report reads them."""
    jmodel, model = _masked(models)
    kw = dict(device="cpu", num_motion_tokens=N, max_text_len=TEXT_LEN, timesteps=5,
              temperature=0.0, greedy=True)
    codes = entry.serve_t2m(model, CAPTIONS, special_ids=SpecialIds(**_special(model.vocab)),
                            **kw)
    ids, mask = _frames(model.vocab)
    np.testing.assert_array_equal(codes.numpy(), _jax_codes(jmodel, ids, mask))
    seg = entry.serve_t2m(model, CAPTIONS, special_ids=SpecialIds(**_special(model.vocab)),
                          segment_timesteps=3, **kw)
    np.testing.assert_array_equal(seg.numpy(), codes.numpy())
    cached = entry.serve_t2m(models[1], CAPTIONS,
                             special_ids=SpecialIds(**_special(model.vocab)),
                             block_kv_cache="true", **dict(kw, timesteps=1))
    np.testing.assert_array_equal(cached.numpy(), _codes(models[1], ids, mask, timesteps=1))

    vq_cfg = dataclasses.replace(motion_vq.tiny_motion_cfg(), nb_code=32)
    vq = motion_vq.init_motion_vq(vq_cfg, device="cpu", generator=torch.Generator().manual_seed(0))
    feats = entry.decode_motion(vq, vq_cfg, codes, device="cpu")
    assert feats.shape == (2, 4 * N, vq_cfg.pose_dim) and torch.isfinite(feats).all()
    report = token_range_sanity(codes, model.vocab)
    assert report["in_range"] and 1 <= report["unique_tokens"] <= 2 * N
