"""The port's serving engine on the CPU at tiny sizes.

The cases of `tests/test_serve.py` (but the mesh cases, which run over
ranks in tests/test_torch_distributed.py; the engine's t2m is held in
tests/test_torch_t2m.py).
At T = 0 the engine's answers are held against the JAX model's `generate` on
the same weights; stochastic answers against the port's solo runs with the
request's seed. Batching, joins and the chunk guard are held by the engine's
counters, with requests released together from a held dispatcher
(`pause()` / `resume()`), never by a wall-clock window.
"""

import dataclasses
import sys
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mmada_tpu.core.vocab import tiny_layout as jax_tiny_layout
from mmada_tpu.models import llada as jax_llada
from mmada_tpu.models.mmada import MMadaModel as JaxMMadaModel
from mmada_tpu_torch.checkpoints.from_jax import params_from_jax
from mmada_tpu_torch.core.vocab import tiny_layout
from mmada_tpu_torch.entry import quantize
from mmada_tpu_torch.models import llada
from mmada_tpu_torch.models.mmada import MMadaModel
from mmada_tpu_torch.serve import engine as E
from mmada_tpu_torch.serve.engine import ServingEngine, T2ISettings, T2MSettings, TextSettings

VOCAB = tiny_layout(text_vocab_size=256, image_codebook_size=64)
N_IMG = 16


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """At these tiny shapes torch's intra-op threads cost more than they
    save, most of all beside other test workers; the setting is restored."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def models():
    jvocab = jax_tiny_layout(text_vocab_size=256, image_codebook_size=64)
    jcfg = jax_llada.tiny_config(vocab_size=jvocab.total_vocab_size, d_model=32, n_heads=2,
                                 n_layers=2, mlp_hidden_size=64)
    jcfg = dataclasses.replace(jcfg, mask_token_id=jvocab.mask_token_id)
    jmodel = JaxMMadaModel.init(jax.random.key(0), jcfg, jvocab)
    cfg = llada.LLaDAConfig(**dataclasses.asdict(jcfg))
    params = params_from_jax(jax.device_get(jmodel.params), cfg, device="cpu")
    return jmodel, MMadaModel(cfg=cfg, params=params, vocab=VOCAB)


@pytest.fixture
def engine(models):
    engines = []

    def make(**kw):
        kw.setdefault("min_chunk_device_ms", 0)
        eng = ServingEngine(models[1], **kw).start()
        engines.append(eng)
        return eng

    yield make
    for eng in engines:
        eng.stop()


def jax_text(jmodel, prompts, settings):
    """JAX's answer at T = 0 (a batch of prompts)."""
    return np.asarray(jmodel.generate(
        jnp.asarray(np.stack(prompts)), gen_length=settings.gen_length, steps=settings.steps,
        block_length=settings.block_length, temperature=0.0,
        parallel_threshold=settings.parallel_threshold,
        parallel_warmup_steps=settings.parallel_warmup_steps))


def solo(model, prompt, settings, seed):
    """The port's batch-1 run with the request's seed."""
    return model.generate(
        torch.as_tensor(np.asarray(prompt), dtype=torch.long)[None],
        gen_length=settings.gen_length, steps=settings.steps, block_length=settings.block_length,
        temperature=settings.temperature, remasking=settings.remasking,
        parallel_threshold=settings.parallel_threshold,
        parallel_warmup_steps=settings.parallel_warmup_steps,
        generator=torch.Generator().manual_seed(seed) if settings.stochastic else None,
    )[0].numpy()


def wait_for(eng, key, n, timeout=60):
    deadline = time.time() + timeout
    while eng.stats[key] < n and time.time() < deadline:
        time.sleep(0.001)
    assert eng.stats[key] >= n, eng.stats


def submit_held(eng, items):
    """Submit while the dispatcher is held, then release them together."""
    eng.pause()
    futs = [eng.submit_text(p, s, seed=seed) for p, s, seed in items]
    eng.resume()
    return futs


def t2i_frame():
    frame = np.concatenate([np.full(6, 5), [280], np.full(N_IMG, VOCAB.mask_token_id),
                            [281]]).astype(np.int64)
    uncond = frame.copy()
    uncond[:6] = VOCAB.pad_token_id
    return frame, uncond


def direct_t2i(model, frame, uncond, settings, seed, attn=None, uattn=None):
    def t(a):
        return None if a is None else torch.as_tensor(a, dtype=torch.long)[None]

    return model.t2i_generate(
        t(frame), uncond_input_ids=t(uncond), attention_mask=t(attn),
        uncond_attention_mask=t(uattn), temperature=settings.temperature,
        timesteps=settings.timesteps, guidance_scale=settings.guidance_scale,
        num_vq_tokens=settings.num_vq_tokens, generator=torch.Generator().manual_seed(seed),
        cfg_interval=settings.cfg_interval)[0].numpy()


def test_text_batching_matches_jax(models, engine):
    jmodel, _ = models
    eng = engine(max_wait_ms=5)
    settings = TextSettings(gen_length=8, steps=4, block_length=8)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(3, 200, size=(6,)) for _ in range(4)]
    outs = [f.result(60) for f in submit_held(eng, [(p, settings, 0) for p in prompts])]
    for got, want in zip(outs, jax_text(jmodel, prompts, settings)):
        np.testing.assert_array_equal(got, want)
    assert eng.stats["requests"] == 4
    assert eng.stats["batches"] == 1 and eng.stats["batched_requests"] == 4


def test_t2i_requests_run_solo(engine):
    eng = engine(max_wait_ms=5)
    frame, uncond = t2i_frame()
    settings = T2ISettings(timesteps=3, guidance_scale=1.5, num_vq_tokens=N_IMG)
    eng.pause()
    futs = [eng.submit_t2i(frame, uncond, settings, seed=i) for i in range(3)]
    eng.resume()
    for f in futs:
        out = f.result(60)
        assert out.shape == (N_IMG,)
        assert out.min() >= 0 and out.max() < VOCAB.image_codebook_size
    assert eng.stats["batches"] == 3   # one generator a batch: t2i never shares one


def test_stochastic_seed_reproducibility(models, engine):
    """Per-row generators: each request equals its solo run with its seed,
    and the requests still share one batch."""
    _, model = models
    eng = engine(max_wait_ms=5)
    settings = TextSettings(gen_length=8, steps=4, block_length=8, temperature=1.0)
    prompt = np.arange(3, 9)
    outs = [f.result(60) for f in submit_held(eng, [(prompt, settings, s) for s in (0, 1, 2)])]
    for seed, got in zip((0, 1, 2), outs):
        np.testing.assert_array_equal(got, solo(model, prompt, settings, seed))
    assert eng.stats["batches"] == 1
    f1, f2 = submit_held(eng, [(prompt, settings, 7), (prompt, settings, 7)])
    np.testing.assert_array_equal(f1.result(60), f2.result(60))


def test_random_remasking_draws_per_row(models, engine):
    _, model = models
    eng = engine(max_wait_ms=5)
    settings = TextSettings(gen_length=8, steps=4, block_length=8, temperature=0.0,
                            remasking="random")
    assert settings.stochastic
    prompt = np.arange(3, 9)
    f1, f2 = submit_held(eng, [(prompt, settings, 11), (prompt, settings, 11)])
    r1, r2 = f1.result(60), f2.result(60)
    np.testing.assert_array_equal(r1, r2)
    np.testing.assert_array_equal(r1, solo(model, prompt, settings, 11))
    assert r1.shape == (14,)


def test_stop_drains_queued_futures(models):
    eng = ServingEngine(models[1], min_chunk_device_ms=0)   # never started
    fut = eng.submit_text(np.full(6, 9), TextSettings(gen_length=8, steps=4, block_length=8))
    eng.stop()
    with pytest.raises(RuntimeError, match="engine stopped"):
        fut.result(timeout=5)


def test_queue_full_backpressure(models):
    eng = ServingEngine(models[1], min_chunk_device_ms=0, max_queue=2)
    settings = TextSettings(gen_length=8, steps=4, block_length=8)
    futs = [eng.submit_text(np.full(6, 9), settings) for _ in range(4)]
    overflowed = [f for f in futs if f.done() and f.exception() is not None]
    assert len(overflowed) == 2
    assert "backpressure" in str(overflowed[0].exception())
    eng.stop()


@pytest.mark.parametrize("scheme", ["int8", "int4"])
def test_engine_with_quantized_model(models, scheme):
    _, model = models
    qmodel = quantize(model, scheme)
    eng = ServingEngine(qmodel, min_chunk_device_ms=0, max_wait_ms=5).start()
    try:
        settings = TextSettings(gen_length=8, steps=4, block_length=8)
        out = eng.submit_text(np.arange(3, 9), settings).result(60)
        assert out.shape == (14,) and (out[:6] == np.arange(3, 9)).all()
        np.testing.assert_array_equal(out, solo(qmodel, np.arange(3, 9), settings, 0))
    finally:
        eng.stop()


def test_mixed_kinds_and_lengths(models, engine):
    eng = engine(max_wait_ms=5)
    settings = TextSettings(gen_length=8, steps=4, block_length=8)
    frame, uncond = t2i_frame()
    eng.pause()
    f1 = eng.submit_text(np.full(6, 9), settings)
    f2 = eng.submit_text(np.full(10, 9), settings)
    f3 = eng.submit_mmu(np.full(10, 9), settings)
    f4 = eng.submit_t2i(frame, uncond, T2ISettings(timesteps=2, num_vq_tokens=N_IMG))
    eng.resume()
    assert f1.result(60).shape == (14,) and f2.result(60).shape == (18,)
    np.testing.assert_array_equal(f3.result(60), f2.result(60))
    assert f4.result(60).shape == (N_IMG,)
    assert eng.stats["batches"] == 4


def test_t2i_with_masks_matches_direct(models):
    """Masks reach the sampler (load-bearing on a biased model): the engine's
    codes equal the direct call's with the same seed."""
    _, model = models
    m = dataclasses.replace(model, cfg=dataclasses.replace(model.cfg,
                                                           attention_bias_enabled=True))
    eng = ServingEngine(m, min_chunk_device_ms=0, max_wait_ms=5).start()
    try:
        frame, uncond = t2i_frame()
        attn = np.ones_like(frame)
        attn[:2] = 0
        uattn = np.ones_like(uncond)
        settings = T2ISettings(timesteps=3, guidance_scale=1.5, temperature=0.0,
                               num_vq_tokens=N_IMG)
        got = eng.submit_t2i(frame, uncond, settings, seed=7, attention_mask=attn,
                             uncond_attention_mask=uattn).result(60)
        np.testing.assert_array_equal(got, direct_t2i(m, frame, uncond, settings, 7, attn, uattn))
        unmasked = eng.submit_t2i(frame, uncond, settings, seed=7).result(60)
        assert not np.array_equal(unmasked, got)
    finally:
        eng.stop()


def test_chunked_matches_jax(models, engine):
    """segment_steps > 0: one stream of the three requests, 2 blocks x 2
    chunks; JAX's tokens."""
    jmodel, _ = models
    eng = engine(max_wait_ms=5)
    settings = TextSettings(gen_length=16, steps=8, block_length=8, segment_steps=2)
    rng = np.random.default_rng(3)
    prompts = [rng.integers(3, 200, size=(6,)) for _ in range(3)]
    outs = [f.result(60) for f in submit_held(eng, [(p, settings, 0) for p in prompts])]
    for got, want in zip(outs, jax_text(jmodel, prompts, settings)):
        np.testing.assert_array_equal(got, want)
    assert eng.stats["chunks"] == 4 and eng.stats["batches"] == 0


def test_chunked_stochastic_per_row_seed_exact(models, engine):
    _, model = models
    eng = engine(max_wait_ms=5)
    settings = TextSettings(gen_length=8, steps=4, block_length=8, temperature=1.0,
                            segment_steps=1)
    prompt = np.arange(3, 9)
    futs = submit_held(eng, [(prompt, settings, s) for s in (0, 5)])
    for seed, f in zip((0, 5), futs):
        np.testing.assert_array_equal(f.result(60), solo(model, prompt, settings, seed))
    assert eng.stats["chunks"] == 4


def test_chunked_no_head_of_line_blocking(engine):
    """A short request submitted after a heavy chunked one's first chunk
    finishes first: the dispatcher round-robins chunks."""
    eng = engine(max_wait_ms=1)
    long_settings = TextSettings(gen_length=32, steps=32, block_length=8, segment_steps=1)
    short_settings = TextSettings(gen_length=8, steps=2, block_length=8, segment_steps=1)
    order = []
    f_long = eng.submit_text(np.arange(3, 9), long_settings)
    f_long.add_done_callback(lambda f: order.append("long"))
    wait_for(eng, "chunks", 1)
    f_short = eng.submit_text(np.arange(3, 9), short_settings)
    f_short.add_done_callback(lambda f: order.append("short"))
    f_long.result(120)
    f_short.result(120)
    assert order == ["short", "long"]


def test_chunked_rejects_kv_cache(engine):
    eng = engine(max_wait_ms=1)
    settings = TextSettings(gen_length=8, steps=4, block_length=8, segment_steps=2,
                            block_kv_cache=True)
    with pytest.raises(ValueError, match="exact-sampler only"):
        eng.submit_text(np.arange(3, 9), settings).result(60)


def test_stop_resolves_active_chunked_tasks(models):
    eng = ServingEngine(models[1], min_chunk_device_ms=0, max_wait_ms=1).start()
    settings = TextSettings(gen_length=32, steps=32, block_length=8, segment_steps=1)
    f = eng.submit_text(np.arange(3, 9), settings)
    wait_for(eng, "chunks", 1)
    eng.stop()
    with pytest.raises(RuntimeError, match="engine stopped"):
        f.result(timeout=60)


@pytest.mark.parametrize("temperature", [0.0, 1.0])
def test_stream_join_mid_flight(models, engine, temperature):
    """A request of the stream's key submitted mid-flight joins it at a chunk
    boundary (stream_joins) and both answers equal their solo runs, the
    rows at different blocks of one chunk."""
    jmodel, model = models
    eng = engine(max_wait_ms=1)
    settings = TextSettings(gen_length=32, steps=16, block_length=8, segment_steps=1,
                            temperature=temperature)
    pa, pb = np.arange(3, 9), np.arange(10, 16)
    fa = eng.submit_text(pa, settings, seed=3)
    wait_for(eng, "chunks", 6)   # the first row is in its second block
    (fb,) = submit_held(eng, [(pb, settings, 9)])
    ra, rb = fa.result(120), fb.result(120)
    assert eng.stats["stream_joins"] == 1
    np.testing.assert_array_equal(ra, solo(model, pa, settings, 3))
    np.testing.assert_array_equal(rb, solo(model, pb, settings, 9))
    if temperature == 0.0:
        for got, p in ((ra, pa), (rb, pb)):
            np.testing.assert_array_equal(got, jax_text(jmodel, [p], settings)[0])


def test_stream_padding_chunk_is_noop(models, engine):
    """segment_steps 3 does not divide the block's 4 steps: each block ends
    with two padding steps, which leave the tokens as JAX's."""
    jmodel, _ = models
    eng = engine(max_wait_ms=1)
    settings = TextSettings(gen_length=16, steps=8, block_length=8, segment_steps=3)
    prompt = np.arange(3, 9)
    got = eng.submit_text(prompt, settings).result(60)
    np.testing.assert_array_equal(got, jax_text(jmodel, [prompt], settings)[0])
    assert eng.stats["chunks"] == 4


def test_stream_growth_and_overflow(models, engine):
    """Six requests of one key against max_batch 4: the first stream grows
    from 1 row to 4 as three requests join mid-flight; the fifth and sixth,
    released together, find it full and start a second stream. Every answer
    is JAX's."""
    jmodel, _ = models
    eng = engine(max_batch=4, max_wait_ms=1)
    settings = TextSettings(gen_length=32, steps=32, block_length=8, segment_steps=1)
    prompts = [np.arange(3, 9) + i for i in range(6)]
    futs = [eng.submit_text(prompts[0], settings)]
    wait_for(eng, "chunks", 1)
    futs += submit_held(eng, [(p, settings, 0) for p in prompts[1:4]])
    wait_for(eng, "stream_joins", 3)
    futs += submit_held(eng, [(p, settings, 0) for p in prompts[4:]])
    outs = [f.result(120) for f in futs]
    for got, p in zip(outs, prompts):
        np.testing.assert_array_equal(got, jax_text(jmodel, [p], settings)[0])
    assert eng.stats["stream_joins"] == 3 and eng.stats["batches"] == 0


def test_stream_stochastic_nondividing_segment(models, engine):
    """Stochastic rows with padding steps: a padding step draws nothing, so
    each row's next block starts from its solo run's noise."""
    _, model = models
    eng = engine(max_wait_ms=1)
    settings = TextSettings(gen_length=16, steps=8, block_length=8, temperature=1.0,
                            segment_steps=3)
    prompt = np.arange(3, 9)
    futs = submit_held(eng, [(prompt, settings, s) for s in (2, 8)])
    for seed, f in zip((2, 8), futs):
        np.testing.assert_array_equal(f.result(60), solo(model, prompt, settings, seed))


@pytest.mark.parametrize("temperature", [0.0, 1.0])
def test_chunked_warmup_parallel_matches_monolithic(models, engine, temperature):
    """tau with warmup through the stream: per-row step offsets gate tau; a
    row whose block is done draws nothing while the other goes on."""
    jmodel, model = models
    eng = engine(max_wait_ms=1)
    settings = TextSettings(gen_length=16, steps=8, block_length=8, segment_steps=1,
                            parallel_threshold=0.5, parallel_warmup_steps=2,
                            temperature=temperature)
    rng = np.random.default_rng(5)
    prompts = [rng.integers(3, 200, size=(6,)) for _ in range(2)]
    futs = submit_held(eng, [(p, settings, 4 + i) for i, p in enumerate(prompts)])
    outs = [f.result(60) for f in futs]
    for i, (p, got) in enumerate(zip(prompts, outs)):
        np.testing.assert_array_equal(got, solo(model, p, settings, 4 + i))
    if temperature == 0.0:
        for got, want in zip(outs, jax_text(jmodel, prompts, settings)):
            np.testing.assert_array_equal(got, want)


def test_stream_rejects_invalid_shape(engine):
    eng = engine(max_wait_ms=1)
    bad = TextSettings(gen_length=12, steps=4, block_length=8, segment_steps=2)
    with pytest.raises(ValueError, match="divisible"):
        eng.submit_text(np.arange(3, 9), bad).result(60)


def test_engine_stress_mixed_workload(models, engine):
    """24 requests from 4 threads, monolithic and chunked, deterministic and
    stochastic, several seeds, with a short thread switch interval: every
    future resolves to its solo run."""
    _, model = models
    eng = engine(max_batch=4, max_wait_ms=2)
    variants = [
        TextSettings(gen_length=16, steps=8, block_length=8),
        TextSettings(gen_length=16, steps=8, block_length=8, segment_steps=2),
        TextSettings(gen_length=8, steps=4, block_length=8, temperature=1.0, segment_steps=1),
        TextSettings(gen_length=8, steps=4, block_length=8, temperature=1.0),
    ]
    jobs, lock = [], threading.Lock()

    def submitter(tid):
        r = np.random.default_rng(tid)
        for k in range(6):
            s = variants[(tid + k) % len(variants)]
            prompt = r.integers(3, 200, size=(6,))
            seed = int(r.integers(0, 5))
            f = eng.submit_text(prompt, s, seed=seed)
            with lock:
                jobs.append((prompt, s, seed, f))
            time.sleep(float(r.random()) * 0.01)

    threads = [threading.Thread(target=submitter, args=(t,)) for t in range(4)]
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
            assert not t.is_alive()
    finally:
        sys.setswitchinterval(interval)
    assert len(jobs) == 24
    for prompt, s, seed, f in jobs:
        np.testing.assert_array_equal(f.result(120), solo(model, prompt, s, seed))


def test_t2i_chunked_matches_direct(models, engine):
    """segment_timesteps: the windows give the monolithic codes, and a text
    request submitted behind the chunked t2i finishes first."""
    _, model = models
    eng = engine(max_wait_ms=1)
    frame, uncond = t2i_frame()
    mono = T2ISettings(timesteps=6, guidance_scale=1.5, num_vq_tokens=N_IMG)
    chunked = dataclasses.replace(mono, segment_timesteps=1)
    want = eng.submit_t2i(frame, uncond, mono, seed=3).result(60)
    np.testing.assert_array_equal(want, direct_t2i(model, frame, uncond, mono, 3))
    order = []
    eng.pause()
    f_img = eng.submit_t2i(frame, uncond, chunked, seed=3)
    f_img.add_done_callback(lambda f: order.append("t2i"))
    f_txt = eng.submit_text(np.arange(3, 9), TextSettings(gen_length=8, steps=2, block_length=8))
    f_txt.add_done_callback(lambda f: order.append("text"))
    eng.resume()
    np.testing.assert_array_equal(f_img.result(60), want)
    f_txt.result(60)
    assert order == ["text", "t2i"]
    assert eng.stats["chunks"] == 6


def test_t2i_chunked_rejects_kv_cache(engine):
    eng = engine(max_wait_ms=1)
    frame, _ = t2i_frame()
    settings = T2ISettings(timesteps=3, num_vq_tokens=N_IMG, segment_timesteps=1,
                           block_kv_cache=True)
    with pytest.raises(ValueError, match="exact-sampler only"):
        eng.submit_t2i(frame, frame.copy(), settings).result(60)


def test_cancellation_queued_and_mid_stream(models, engine):
    """A request cancelled while queued never runs; a chunked request
    cancelled mid-flight leaves its stream at the next chunk, and its
    stream-mate still finishes with JAX's tokens."""
    jmodel, _ = models
    eng = engine(max_wait_ms=1)
    settings = TextSettings(gen_length=8, steps=4, block_length=8)
    pa, pb = np.arange(3, 9), np.arange(4, 10)
    eng.pause()
    f1 = eng.submit_text(pa, settings)
    f2 = eng.submit_text(pb, settings)
    assert f2.cancel()
    eng.resume()
    np.testing.assert_array_equal(f1.result(60), jax_text(jmodel, [pa], settings)[0])
    assert f2.cancelled()
    wait_for(eng, "cancelled", 1)
    assert eng.stats["batched_requests"] == 1

    heavy = TextSettings(gen_length=32, steps=32, block_length=8, segment_steps=1)
    f_mate = eng.submit_text(pa, heavy)
    wait_for(eng, "chunks", 2)
    (f_victim,) = submit_held(eng, [(pb, heavy, 0)])
    wait_for(eng, "stream_joins", 1)
    eng.pause()
    assert f_victim.cancel()
    chunks = eng.stats["chunks"]
    eng.resume()
    np.testing.assert_array_equal(f_mate.result(120), jax_text(jmodel, [pa], heavy)[0])
    assert f_victim.cancelled()
    assert eng.stats["cancelled"] == 2
    assert eng.stats["chunks"] == 32   # the victim's row cost no chunk of its own
    assert chunks < 32


def test_t2m_fails_naming_the_motion_port(engine):
    """A t2m request to a model whose vocab has no motion window fails its
    future naming `with_motion` (engine t2m itself: test_torch_t2m.py)."""
    eng = engine()
    frame, _ = t2i_frame()
    f = eng.submit_t2m(frame, T2MSettings(timesteps=4, num_motion_tokens=N_IMG), seed=9)
    with pytest.raises(ValueError, match="with_motion"):
        f.result(5)


def test_drain_finishes_inflight_and_rejects_new(models):
    jmodel, _ = models
    eng = ServingEngine(models[1], min_chunk_device_ms=0, max_wait_ms=1).start()
    settings = TextSettings(gen_length=16, steps=16, block_length=8, segment_steps=1)
    prompt = np.arange(3, 9)
    f = eng.submit_text(prompt, settings)
    wait_for(eng, "chunks", 1)
    eng.stop(drain=True)
    np.testing.assert_array_equal(f.result(timeout=5), jax_text(jmodel, [prompt], settings)[0])
    with pytest.raises(RuntimeError, match="draining"):
        eng.submit_text(prompt, settings).result(timeout=5)
    lat = eng.latency_stats()
    assert lat["text"]["count"] == 1 and lat["text"]["p50_s"] > 0


def test_t2i_cfg_interval_through_engine(models, engine):
    """cfg_interval reaches the sampler, monolithic and chunked (a window
    of 4 cut at the interval's bounds): both the direct call's codes."""
    _, model = models
    eng = engine(max_wait_ms=1)
    frame, uncond = t2i_frame()
    base = T2ISettings(timesteps=6, guidance_scale=1.5, num_vq_tokens=N_IMG,
                       cfg_interval=(1 / 6, 5 / 6))
    want = direct_t2i(model, frame, uncond, base, 3)
    np.testing.assert_array_equal(eng.submit_t2i(frame, uncond, base, seed=3).result(60), want)
    chunked = dataclasses.replace(base, segment_timesteps=4)
    np.testing.assert_array_equal(eng.submit_t2i(frame, uncond, chunked, seed=3).result(60), want)
    assert eng.stats["chunks"] == 4   # [0, 1) [1, 4) [4, 5) [5, 6)


def test_chunk_guard_demotes_small_ops(models, engine):
    """With the default floor (25 ms at the card's rate), a tiny model's
    chunked request runs as one call: the same tokens, no chunk."""
    jmodel, _ = models
    eng = engine(max_wait_ms=1, min_chunk_device_ms=25.0)
    settings = TextSettings(gen_length=16, steps=8, block_length=8, segment_steps=2)
    prompt = np.random.default_rng(5).integers(3, 200, size=(6,))
    out = eng.submit_text(prompt, settings).result(60)
    np.testing.assert_array_equal(out, jax_text(jmodel, [prompt], settings)[0])
    assert eng.stats["chunks"] == 0
    assert eng.stats["chunk_guard_skips"] == 1 and eng.stats["batches"] == 1


def test_chunk_guard_estimate_scales_to_heavy_ops():
    """The estimate uses JAX's FLOP count at the card's rate: the 8B's heavy
    operating point chunks, the tiny model does not, a model without a
    config disables the guard."""
    from mmada_tpu.utils.flops import forward_matmul_flops_per_token as jax_flops
    from mmada_tpu_torch.utils.flops import forward_matmul_flops_per_token

    eng = ServingEngine.__new__(ServingEngine)
    eng.min_chunk_device_s = 0.025
    eng.model = type("M", (), {"cfg": None})()
    small = TextSettings(gen_length=64, steps=32, block_length=32, segment_steps=8)
    assert eng._est_chunk_device_s(small, 64) == 0.0
    tiny = llada.tiny_config(vocab_size=VOCAB.total_vocab_size, d_model=32, n_heads=2,
                             n_layers=2, mlp_hidden_size=64)
    eng.model = type("M", (), {"cfg": tiny})()
    assert eng._est_chunk_device_s(small, 64) < eng.min_chunk_device_s
    big = llada.llada_8b()
    eng.model = type("M", (), {"cfg": big})()
    heavy = TextSettings(gen_length=512, steps=256, block_length=64, segment_steps=16)
    assert eng._est_chunk_device_s(heavy, 64) > eng.min_chunk_device_s
    jbig = jax_llada.LLaDAConfig(**dataclasses.asdict(big))
    for args in ((576, 64, big.vocab_size), (1194, 128, 8192)):
        assert forward_matmul_flops_per_token(big, *args) == jax_flops(jbig, *args)
    # one chunk of the heavy point: 16 steps of 576 tokens at the card's rate
    want = 16 * 576 * jax_flops(jbig, 576, 64, big.embedding_size) / E.CARD_FLOPS_PER_S
    assert eng._est_chunk_device_s(heavy, 64) == pytest.approx(want)


@pytest.mark.parametrize("n,chunked", [(4, True), (1, False)])
def test_chunk_guard_prices_whole_group(models, engine, monkeypatch, n, chunked):
    """A row just under the floor: four rows of one group clear it together
    and stay chunked; one alone is demoted."""
    jmodel, _ = models
    monkeypatch.setattr(E.ServingEngine, "_est_chunk_device_s",
                        lambda self, settings, plen: 0.0008)
    eng = engine(min_chunk_device_ms=1.0, max_batch=4, max_wait_ms=1)
    settings = TextSettings(gen_length=16, steps=8, block_length=8, segment_steps=2)
    prompt = np.random.default_rng(6).integers(3, 200, size=(6,))
    outs = [f.result(60) for f in submit_held(eng, [(prompt, settings, 0)] * n)]
    want = jax_text(jmodel, [prompt], settings)[0]
    for out in outs:
        np.testing.assert_array_equal(out, want)
    assert (eng.stats["chunks"] > 0) == chunked
    assert eng.stats["chunk_guard_skips"] == (0 if chunked else 1)


def test_pause_holds_the_dispatcher(models, engine):
    """Nothing runs while the dispatcher is held; what queued meanwhile runs
    as one batch after `resume()`."""
    eng = engine(max_wait_ms=1)
    settings = TextSettings(gen_length=8, steps=4, block_length=8)
    eng.pause()
    futs = [eng.submit_text(np.arange(3, 9) + i, settings) for i in range(3)]
    time.sleep(0.05)
    assert not any(f.done() for f in futs) and eng.stats["batches"] == 0
    eng.resume()
    [f.result(60) for f in futs]
    assert eng.stats["batches"] == 1 and eng.stats["batched_requests"] == 3


@pytest.mark.parametrize("serving", [
    {"kv_cache": False, "parallel_threshold": 0.9,
     "text": {"cache_refresh_every": 2, "parallel_warmup_steps": 2},
     "mmu": {"kv_cache": "int8"}, "t2i": {"kv_cache": True}},
    {"fast_stack": True},
    {"fast_stack": True, "cache_refresh_every": 2, "text": {"kv_cache": False}},
    {"mmu": {"fast_stack": True}},
    {"fast_stack": "false"},
], ids=["family-overrides", "fast-stack", "fast-stack-overridden", "family-fast-stack",
        "false-string"])
def test_task_serving_defaults_match_jax(serving):
    """The engine's deployment defaults (the port's loader) resolve as JAX's."""
    from mmada_tpu.core.config import Config as JaxConfig
    from mmada_tpu.serve.loader import task_serving_defaults as jax_defaults
    from mmada_tpu_torch.core.config import Config
    from mmada_tpu_torch.serve.loader import task_serving_defaults

    for task in ("text", "mmu", "t2i", "t2m"):
        got = task_serving_defaults(Config({"serving": serving}), task)
        want = jax_defaults(JaxConfig({"serving": serving}), task)
        assert got == want, task
