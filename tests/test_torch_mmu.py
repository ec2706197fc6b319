"""The port's MMU path against the JAX package, on the CPU at tiny sizes.

* The `mmu_gen` and `r2i` frames equal JAX's, token for token.
* `mmu_generate` is token-exact at T = 0 (cfg 0 and 1.5); `mmu_generate_fast`
  too, with an EOT that stops both after the first block, and with one that
  never stops them; both with each fast-sampler knob (the block-KV cache,
  bf16 and int8, its refresh, tau-parallel and its warmup); with
  `segment_steps` too.
* `serve_mmu(device="cpu")` answers as JAX's `get_code` + the
  `inference_mmu.py` frame + `mmu_generate` (or `mmu_generate_fast`) do.
* `Trainer.prepare_batch` on pixel flows with `cache_keys` equals the JAX
  Trainer's on the same pixels and weights, and encodes each image once.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mmada_tpu.core.vocab import tiny_layout as jax_tiny_layout
from mmada_tpu.models import llada as jax_llada
from mmada_tpu.models import magvit2 as jax_magvit2
from mmada_tpu.models.mmada import MMadaModel as JaxMMadaModel
from mmada_tpu.prompting.universal import ByteTokenizer as JaxByteTokenizer
from mmada_tpu.prompting.universal import SpecialIds as JaxSpecialIds
from mmada_tpu.prompting.universal import UniversalPrompting as JaxPrompting
from mmada_tpu.training import train_step as jax_train_step
from mmada_tpu.training.trainer import Trainer as JaxTrainer
from mmada_tpu_torch.checkpoints.from_jax import magvit2_from_jax, params_from_jax
from mmada_tpu_torch.core.vocab import tiny_layout
from mmada_tpu_torch.entry import decode_images, serve_mmu, train
from mmada_tpu_torch.models import llada, magvit2
from mmada_tpu_torch.models.mmada import MMadaModel
from mmada_tpu_torch.prompting.universal import ByteTokenizer, SpecialIds, UniversalPrompting
from mmada_tpu_torch.training.trainer import Trainer

RES = 16                      # tiny_vqgan(16): 8 x 8 = 64 codes over a book of 32
QUESTIONS = ["what is it?", "why?", "who is there?"]
GEN = dict(max_new_tokens=16, steps=8, block_length=8, temperature=0.0)


def _special(vocab, cls):
    t = vocab.text_vocab_size
    return cls(soi=t - 20, eoi=t - 19, t2i=t - 18, mmu=t - 17, r2i=t - 16, t2m=t - 15,
               som=t - 14, eom=t - 13, pad=vocab.pad_token_id, bos=vocab.bos_token_id,
               eos=vocab.eos_token_id)


@pytest.fixture(scope="module")
def models():
    """A tiny MMaDA and a tiny MAGVIT-v2 in both packages, the same weights."""
    jvocab = jax_tiny_layout()
    jcfg = jax_llada.tiny_config(vocab_size=jvocab.total_vocab_size, n_kv_heads=2)
    jmodel = JaxMMadaModel.init(jax.random.key(5), jcfg, jvocab)
    cfg = llada.LLaDAConfig(**dataclasses.asdict(jcfg))
    model = MMadaModel(cfg=cfg, params=params_from_jax(jax.device_get(jmodel.params), cfg,
                                                       device="cpu"), vocab=tiny_layout())
    jvq_cfg = jax_magvit2.tiny_vqgan(RES)
    jvq = jax_magvit2.init_magvit2(jax.random.key(6), jvq_cfg)
    vq_cfg = magvit2.tiny_vqgan(RES)
    vq = magvit2_from_jax(jax.device_get(jvq), vq_cfg, device="cpu")
    return jmodel, model, (jvq, jvq_cfg), (vq, vq_cfg)


def _pixels(n, seed=0):
    return np.random.default_rng(seed).uniform(-1, 1, (n, RES, RES, 3)).astype(np.float32)


def _frame(sp, codes, question):
    """`inference_mmu.py`'s frame: <|mmu|> <|soi|> codes <|eoi|> <bos> question."""
    ids = JaxByteTokenizer()([question])["input_ids"][0]
    return np.concatenate([[sp.mmu, sp.soi], codes, [sp.eoi], [sp.bos], ids]).astype(np.int32)


def test_mmu_gen_and_r2i_frames_match_jax():
    vocab, jvocab = tiny_layout(text_vocab_size=300), jax_tiny_layout(text_vocab_size=300)
    texts = ["hi", "a much longer question that gets cut", "", "x" + chr(290 - 16) + "yz"]
    img = np.arange(4 * 6).reshape(4, 6) + 200
    for end_header in (None, 290):
        sp = dataclasses.replace(_special(vocab, SpecialIds), end_header=end_header)
        jsp = dataclasses.replace(_special(jvocab, JaxSpecialIds), end_header=end_header)
        up = UniversalPrompting(ByteTokenizer(), sp, max_text_len=10)
        jup = JaxPrompting(JaxByteTokenizer(), jsp, max_text_len=10)
        for task in ("mmu_gen", "r2i"):
            got, want = up((img, texts), task), jup((img, texts), task)
            assert len(got) == len(want)
            for g, w in zip(got, want):
                np.testing.assert_array_equal(g, w)


def _prompts(models, n=2):
    jmodel, model, (jvq, jvq_cfg), _ = models
    sp = _special(jmodel.vocab, JaxSpecialIds)
    codes = np.asarray(jax_magvit2.get_code(jvq, jvq_cfg, _pixels(n))) + jmodel.vocab.image_offset
    return np.stack([_frame(sp, c, "what is it?") for c in codes])


@pytest.mark.parametrize("cfg_scale", [0.0, 1.5])
def test_mmu_generate_matches_jax(models, cfg_scale):
    jmodel, model, *_ = models
    prompt = _prompts(models)
    want = jmodel.mmu_generate(jnp.asarray(prompt), cfg_scale=cfg_scale, **GEN)
    got = model.mmu_generate(torch.from_numpy(prompt).long(), cfg_scale=cfg_scale, **GEN)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert (got[:, prompt.shape[1]:] != model.vocab.mask_token_id).all()


@pytest.mark.parametrize("stop", [True, False], ids=["eot-ends-block-1", "never"])
def test_mmu_generate_fast_matches_jax(models, stop):
    """With EOT set to the token JAX's full run leaves at the end of block
    1, both stop after it (block 2 stays [MASK]); with an EOT never
    produced, both run every block and equal `mmu_generate`."""
    jmodel, model, *_ = models
    prompt = _prompts(models, n=1)
    p = prompt.shape[1]
    full = np.asarray(jmodel.mmu_generate(jnp.asarray(prompt), **GEN))
    eot = int(full[0, p + GEN["block_length"] - 1]) if stop else -1
    want = np.asarray(jmodel.mmu_generate_fast(jnp.asarray(prompt), eot_token=eot, **GEN))
    got = model.mmu_generate_fast(torch.from_numpy(prompt).long(), eot_token=eot, **GEN)
    np.testing.assert_array_equal(got.numpy(), want)
    second = got[0, p + GEN["block_length"]:]
    if stop:
        assert (second == model.vocab.mask_token_id).all()
        np.testing.assert_array_equal(got[0, :p + GEN["block_length"]].numpy(),
                                      full[0, :p + GEN["block_length"]])
    else:
        np.testing.assert_array_equal(got.numpy(), full)


MMU_KNOBS = {
    "block_kv_cache": dict(block_kv_cache=True),
    "parallel_threshold": dict(parallel_threshold=0.9),
    "parallel_warmup_steps": dict(parallel_threshold=0.9, parallel_warmup_steps=2),
    "cache_refresh_every": dict(block_kv_cache="int8", cache_refresh_every=2),
}


@pytest.mark.parametrize("knob", list(MMU_KNOBS))
def test_mmu_knobs_match_jax(models, knob):
    """`mmu_generate` with each fast-sampler knob, and `mmu_generate_fast`
    with it and an EOT that stops after block 1, token-exact against JAX."""
    jmodel, model, *_ = models
    prompt = _prompts(models)
    kw = dict(GEN, **MMU_KNOBS[knob])
    want = np.asarray(jmodel.mmu_generate(jnp.asarray(prompt), **kw))
    got = model.mmu_generate(torch.from_numpy(prompt).long(), **kw)
    np.testing.assert_array_equal(got.numpy(), want)
    assert (got[:, prompt.shape[1]:] != model.vocab.mask_token_id).all()
    one = prompt[:1]
    p = one.shape[1]
    eot = int(np.asarray(jmodel.mmu_generate(jnp.asarray(one), **kw))[0, p + GEN["block_length"] - 1])
    want = np.asarray(jmodel.mmu_generate_fast(jnp.asarray(one), eot_token=eot, **kw))
    got = model.mmu_generate_fast(torch.from_numpy(one).long(), eot_token=eot, **kw)
    np.testing.assert_array_equal(got.numpy(), want)


def test_mmu_segment_steps_raises(models):
    """`segment_steps` runs the segmented sampler: JAX's answer at T = 0,
    chunks that divide the block's steps and one that does not."""
    jmodel, model, *_ = models
    prompt = _prompts(models)
    want = np.asarray(jmodel.mmu_generate(jnp.asarray(prompt), **GEN))
    for seg in (3, 4):
        got = model.mmu_generate(torch.from_numpy(prompt).long(), **GEN, segment_steps=seg)
        np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("fast", [False, True])
def test_serve_mmu_matches_jax(models, fast):
    """Three requests, two frame lengths (two batches): each answer equals
    JAX's on the frame `inference_mmu.py` builds from JAX's codes."""
    jmodel, model, (jvq, jvq_cfg), (vq, vq_cfg) = models
    pixels = _pixels(3, seed=7)
    answers = serve_mmu(model, vq, vq_cfg, pixels, QUESTIONS,
                        special_ids=_special(model.vocab, SpecialIds), device="cpu",
                        fast=fast, **GEN)
    sp = _special(jmodel.vocab, JaxSpecialIds)
    codes = np.asarray(jax_magvit2.get_code(jvq, jvq_cfg, pixels)) + jmodel.vocab.image_offset
    for c, question, ans in zip(codes, QUESTIONS, answers):
        frame = jnp.asarray(_frame(sp, c, question))[None]
        if fast:
            want = jmodel.mmu_generate_fast(frame, eot_token=sp.eos, **GEN)
        else:
            want = jmodel.mmu_generate(frame, **GEN)
        np.testing.assert_array_equal(ans.numpy(), np.asarray(want)[0, frame.shape[1]:])


@pytest.mark.parametrize("fast", [False, True])
def test_serve_mmu_with_fast_knobs_matches_jax(models, fast):
    """`serve_mmu` with the int8 cache given as a string (the strict parser),
    its refresh and tau-parallel with warmup: each answer equals JAX's
    `mmu_generate(_fast)` with the same knobs on the same frame."""
    jmodel, model, (jvq, jvq_cfg), (vq, vq_cfg) = models
    pixels = _pixels(2, seed=8)
    knobs = dict(cache_refresh_every=2, parallel_threshold=0.9, parallel_warmup_steps=1)
    answers = serve_mmu(model, vq, vq_cfg, pixels, QUESTIONS[:2],
                        special_ids=_special(model.vocab, SpecialIds), device="cpu",
                        fast=fast, block_kv_cache="INT8", **knobs, **GEN)
    sp = _special(jmodel.vocab, JaxSpecialIds)
    codes = np.asarray(jax_magvit2.get_code(jvq, jvq_cfg, pixels)) + jmodel.vocab.image_offset
    kw = dict(GEN, block_kv_cache="int8", **knobs)
    for c, question, ans in zip(codes, QUESTIONS, answers):
        frame = jnp.asarray(_frame(sp, c, question))[None]
        if fast:
            want = jmodel.mmu_generate_fast(frame, eot_token=sp.eos, **kw)
        else:
            want = jmodel.mmu_generate(frame, **kw)
        np.testing.assert_array_equal(ans.numpy(), np.asarray(want)[0, frame.shape[1]:])


def test_serve_mmu_and_decode_reject_weights_on_another_device(models):
    _, model, _, (vq, vq_cfg) = models
    elsewhere = magvit2.init_magvit2(vq_cfg, device="meta")
    with pytest.raises(ValueError, match="MAGVIT-v2 weights"):
        serve_mmu(model, elsewhere, vq_cfg, _pixels(1), ["?"], device="cpu")
    with pytest.raises(ValueError, match="model weights"):
        serve_mmu(model, vq, vq_cfg, _pixels(1), ["?"], device="meta")
    with pytest.raises(ValueError, match="MAGVIT-v2 weights"):
        decode_images(vq, vq_cfg, np.zeros((1, 64), np.int64), device="meta")


def test_prepare_batch_on_pixels_matches_jax_trainer(models, monkeypatch):
    """t2i and mmu flows of pixels with `cache_keys`: the frames equal the JAX
    Trainer's (its own `encode_images` on the JAX weights); a second call
    encodes nothing, and flows of the same images as codes give the same
    frames."""
    jmodel, model, (jvq, jvq_cfg), (vq, vq_cfg) = models
    pixels = _pixels(3, seed=9)
    raw = {"t2i_flow": {"input_ids": ["a red fox", "", "x" * 30], "images": pixels,
                        "cache_keys": ["a", "b", "c"]},
           "lm_flow": {"input_ids": ["hello world", "a"]},
           "mmu_flow": {"input_ids": ["what is it?", "cat", "a dog"], "images": pixels[::-1],
                        "cache_keys": ["c", "b", "a"]}}
    tr = dict(batch_size_t2i=3, batch_size_lm=2, batch_size_mmu=3)
    trainer = Trainer(model, UniversalPrompting(ByteTokenizer(), _special(model.vocab, SpecialIds),
                                                max_text_len=12),
                      training=tr, vq_params=vq, vq_cfg=vq_cfg)
    got = trainer.prepare_batch(raw)

    stub = type("Stub", (), {})()
    stub.step_cfg = jax_train_step.StepConfig(**tr, max_seq_length=13)
    stub.prompting = JaxPrompting(JaxByteTokenizer(), _special(jmodel.vocab, JaxSpecialIds),
                                  max_text_len=12)
    stub.model, stub.vq_params, stub.vq_cfg = jmodel, jvq, jvq_cfg
    stub._encode_fn = stub._vq_cache = None
    stub.encode_images = lambda images, keys=None: JaxTrainer.encode_images(stub, images, keys)
    want = JaxTrainer.prepare_batch(stub, raw)
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(v), err_msg=k)

    calls = []
    real = magvit2.get_code
    monkeypatch.setattr(magvit2, "get_code", lambda *a: calls.append(a) or real(*a))
    again = trainer.prepare_batch(raw)   # the t2i captions' dropout draws move on
    assert calls == []
    assert torch.equal(again["mmu_input_ids"], got["mmu_input_ids"])
    codes = np.asarray(jax_magvit2.get_code(jvq, jvq_cfg, pixels))
    as_codes = {**raw, "t2i_flow": {"input_ids": raw["t2i_flow"]["input_ids"],
                                    "image_codes": codes},
                "mmu_flow": {"input_ids": raw["mmu_flow"]["input_ids"],
                             "image_codes": codes[::-1]}}
    fresh = Trainer(model, UniversalPrompting(ByteTokenizer(), _special(model.vocab, SpecialIds),
                                              max_text_len=12), training=tr)
    for k, v in fresh.prepare_batch(as_codes).items():
        assert torch.equal(v, got[k]), k


def test_train_entry_on_pixels(models):
    """`train` takes steps on pixel flows, encoding them with the given
    MAGVIT-v2 weights."""
    _, served, _, (vq, vq_cfg) = models
    params = {k: ({n: t.clone() for n, t in v.items()} if k == "blocks" else v.clone())
              for k, v in served.params.items()}
    model = MMadaModel(cfg=served.cfg, params=params, vocab=served.vocab, remat="full")
    flows = {"t2i_flow": {"input_ids": QUESTIONS, "images": _pixels(3, seed=11)},
             "mmu_flow": {"input_ids": QUESTIONS, "images": _pixels(3, seed=12)}}
    trainer = train(model, [flows], steps=2, device="cpu", vq_params=vq, vq_cfg=vq_cfg,
                    special_ids=_special(model.vocab, SpecialIds), max_text_len=12,
                    training=dict(batch_size_t2i=3, batch_size_mmu=3, loss_chunk=16),
                    lr_scheduler={"scheduler": "constant", "params": {"learning_rate": 1e-3}})
    assert int(trainer.state.step) == 2
    for h in trainer.history:
        assert all(np.isfinite(v) for v in h.values()) and h["skipped_nonfinite"] == 0
