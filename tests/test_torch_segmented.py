"""The port's segmented runs against the JAX package, on the CPU at tiny sizes.

* Text and MMU: `generate(segment_steps=...)` / `mmu_generate` token-exact
  against JAX's `generate` and `generate_segmented` at T = 0 (cfg 0 and
  1.5; chunks of 1, 3 and the block's steps); tau with warmup, segmented,
  against JAX's monolithic run.
* The port's own contracts (its draws are a stream, not JAX's key
  schedule): a stochastic segmented run equals the monolithic run with the
  same generator bit for bit; rows with their own generators equal their
  solo runs, also with a chunk that does not divide the block's steps and
  under tau-parallel; the stepwise chunks concatenate to `generate_stepwise`.
* t2i: `t2i_generate(segment_timesteps=...)` against JAX's `t2i_generate`
  (greedy; guidance 0 and 2; with a `cfg_interval` that cuts windows); the
  windows against the stepwise trajectory; stochastic windows against the
  monolithic run with the same generator.
* The refusals: the block-KV cache with segments, `segment_steps < 1`, row
  generators with deterministic settings, stepwise with windows.
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
from mmada_tpu_torch.checkpoints.from_jax import params_from_jax
from mmada_tpu_torch.core.vocab import tiny_layout
from mmada_tpu_torch.models import llada
from mmada_tpu_torch.models.mmada import MMadaModel
from mmada_tpu_torch.sampling import t2i as t2i_sampling
from mmada_tpu_torch.sampling import text as text_sampling

TEXT = dict(gen_length=16, steps=8, block_length=8)     # 2 blocks of 4 steps
T2I = dict(timesteps=6, num_vq_tokens=16)


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
    """One random tiny MMaDA in both packages, on the same weights."""
    jvocab = jax_tiny_layout()
    jcfg = jax_llada.tiny_config(vocab_size=jvocab.total_vocab_size, n_kv_heads=2)
    jmodel = JaxMMadaModel.init(jax.random.key(3), jcfg, jvocab)
    cfg = llada.LLaDAConfig(**dataclasses.asdict(jcfg))
    params = params_from_jax(jax.device_get(jmodel.params), cfg, device="cpu")
    return jmodel, MMadaModel(cfg=cfg, params=params, vocab=tiny_layout())


def _ids(shape, seed, lo=3, hi=200):
    return np.random.default_rng(seed).integers(lo, hi, shape).astype(np.int32)


def _gen(seed):
    return torch.Generator().manual_seed(seed)


@pytest.mark.parametrize("segment_steps", [1, 3, 4])
@pytest.mark.parametrize("cfg_scale", [0.0, 1.5])
def test_segmented_text_matches_jax(models, cfg_scale, segment_steps):
    jmodel, model = models
    prompt = _ids((2, 10), seed=1)
    kw = dict(TEXT, cfg_scale=cfg_scale, temperature=0.0)
    want = np.asarray(jmodel.generate(jnp.asarray(prompt), **kw))
    got = model.generate(torch.from_numpy(prompt), **kw, segment_steps=segment_steps).numpy()
    np.testing.assert_array_equal(got, want)
    if segment_steps == 3:   # JAX's own segmented run, a chunk that does not divide 4
        jseg = jmodel.generate(jnp.asarray(prompt), **kw, segment_steps=segment_steps)
        np.testing.assert_array_equal(got, np.asarray(jseg))


@pytest.mark.parametrize("segment_steps", [3, 4])
@pytest.mark.parametrize("cfg_scale", [0.0, 1.5])
def test_segmented_mmu_matches_jax(models, cfg_scale, segment_steps):
    """An MMU frame (<|mmu|> <|soi|> image codes <|eoi|> <bos> question)."""
    jmodel, model = models
    v = model.vocab
    codes = _ids((2, 16), seed=2, lo=v.image_offset, hi=v.image_offset + v.image_codebook_size)
    frame = np.concatenate([np.full((2, 1), v.text_vocab_size - 17),
                            np.full((2, 1), v.text_vocab_size - 20), codes,
                            np.full((2, 1), v.text_vocab_size - 19), np.full((2, 1), v.bos_token_id),
                            _ids((2, 5), seed=3)], axis=1).astype(np.int32)
    kw = dict(max_new_tokens=16, steps=8, block_length=8, cfg_scale=cfg_scale)
    want = np.asarray(jmodel.mmu_generate(jnp.asarray(frame), **kw))
    got = model.mmu_generate(torch.from_numpy(frame), **kw, segment_steps=segment_steps)
    np.testing.assert_array_equal(got.numpy(), want)


def test_segmented_warmup_parallel_matches_jax(models):
    """tau with its warmup under segmentation: the chunk's in-block step
    offset gates tau as in the monolithic run (JAX's
    `test_model_segmented_warmup_parallel_matches_monolithic`)."""
    jmodel, model = models
    prompt = _ids((2, 12), seed=7)
    kw = dict(TEXT, temperature=0.0, parallel_threshold=0.05, parallel_warmup_steps=2)
    want = np.asarray(jmodel.generate(jnp.asarray(prompt), **kw))
    mono = model.generate(torch.from_numpy(prompt), **kw).numpy()
    np.testing.assert_array_equal(mono, want)
    for seg in (1, 2, 3, 4):
        got = model.generate(torch.from_numpy(prompt), **kw, segment_steps=seg).numpy()
        np.testing.assert_array_equal(got, want, err_msg=f"seg={seg}")


@pytest.mark.parametrize("knobs", [dict(temperature=0.8), dict(remasking="random"),
                                   dict(temperature=0.8, cfg_scale=1.5),
                                   dict(temperature=0.8, parallel_threshold=0.05)],
                         ids=["gumbel", "random-remasking", "cfg", "tau"])
def test_stochastic_segmented_equals_monolithic(models, knobs):
    """The same generator seed gives the same tokens bit for bit: each chunk
    makes the monolithic run's draws in its order."""
    _, model = models
    prompt = torch.from_numpy(_ids((2, 10), seed=4))
    want = model.generate(prompt, **TEXT, generator=_gen(9), **knobs)
    for seg in (1, 3, 4):
        got = model.generate(prompt, **TEXT, generator=_gen(9), segment_steps=seg, **knobs)
        assert torch.equal(got, want), seg


@pytest.mark.parametrize("segment_steps", [0, 1, 3])
@pytest.mark.parametrize("knobs", [dict(temperature=0.8), dict(remasking="random"),
                                   dict(temperature=0.8, parallel_threshold=0.05)],
                         ids=["gumbel", "random-remasking", "tau"])
def test_row_generators_equal_solo_runs(models, knobs, segment_steps):
    """Each row with its own generator equals its batch-1 run with that
    generator, monolithic (0) and segmented (3 does not divide the block's 4
    steps); under tau a row whose block is done draws nothing while the
    other row goes on."""
    _, model = models
    prompt = torch.from_numpy(_ids((3, 10), seed=5))
    seeds = (11, 12, 13)
    got = model.generate(prompt, **TEXT, generator=[_gen(s) for s in seeds],
                         segment_steps=segment_steps, **knobs)
    for i, s in enumerate(seeds):
        solo = model.generate(prompt[i:i + 1], **TEXT, generator=_gen(s), **knobs)
        assert torch.equal(got[i], solo[0]), (i, s)


def test_segmented_run_and_chunk_counts(models):
    """`segmented_run` hands the chunks to the caller: ceil(4 / 3) = 2 chunks
    a block, 4 in all; rows with their own generators through it too."""
    _, model = models
    prompt = torch.from_numpy(_ids((2, 10), seed=6))
    run = model.segmented_run(prompt, **TEXT, temperature=0.8,
                              generator=[_gen(1), _gen(2)], segment_steps=3)
    n = 0
    while not run.step():
        n += 1
    assert run.total_chunks == 4 and n + 1 == 4 and run.step()
    for i, s in enumerate((1, 2)):
        solo = model.generate(prompt[i:i + 1], **TEXT, temperature=0.8, generator=_gen(s))
        assert torch.equal(run.x[i], solo[0])


def test_stepwise_chunks_equal_trajectory(models):
    """The chunks' states concatenate to `generate_stepwise`'s trajectory,
    which at T = 0 equals JAX's."""
    jmodel, model = models
    prompt = _ids((1, 12), seed=8)
    want = np.asarray(jmodel.generate_stepwise(jnp.asarray(prompt), **TEXT))
    traj = model.generate_stepwise(torch.from_numpy(prompt), **TEXT)
    np.testing.assert_array_equal(traj.numpy(), want)
    for temperature in (0.0, 0.7):
        ref = model.generate_stepwise(torch.from_numpy(prompt), **TEXT, temperature=temperature,
                                      generator=_gen(4))
        run = model.segmented_stepwise_run(torch.from_numpy(prompt), **TEXT,
                                           temperature=temperature, generator=_gen(4),
                                           segment_steps=3)
        chunks = []
        while not run.step():
            chunks.append(run.last_states)
        chunks.append(run.last_states)
        assert torch.equal(torch.cat(chunks), ref)


def _t2i_frame(vocab, b=2, prompt_len=6, n=16, seed=11):
    rng = np.random.default_rng(seed)
    frame = np.concatenate([rng.integers(3, 200, (b, prompt_len)), np.full((b, 1), 250),
                            np.full((b, n), vocab.mask_token_id), np.full((b, 1), 251)],
                           axis=1).astype(np.int32)
    uncond = frame.copy()
    uncond[:, :prompt_len] = vocab.pad_token_id
    return frame, uncond


@pytest.mark.parametrize("segment_timesteps", [1, 4, 6])
@pytest.mark.parametrize("guidance", [(0.0, (0.0, 1.0)), (2.0, (0.0, 1.0)),
                                      (2.0, (1 / 6, 5 / 6))],
                         ids=["gs0", "gs2", "gs2-interval"])
def test_segmented_t2i_matches_jax(models, guidance, segment_timesteps):
    """Greedy windows (4 and 6 cut by the interval's bounds at steps 1 and
    5) give JAX's monolithic codes."""
    jmodel, model = models
    gs, interval = guidance
    frame, uncond = _t2i_frame(model.vocab)
    kw = dict(T2I, guidance_scale=gs, temperature=0.0, greedy=True, cfg_interval=interval)
    want = np.asarray(jmodel.t2i_generate(jnp.asarray(frame), uncond_input_ids=jnp.asarray(uncond),
                                          key=jax.random.key(0), **kw))
    got = model.t2i_generate(torch.from_numpy(frame), uncond_input_ids=torch.from_numpy(uncond),
                             segment_timesteps=segment_timesteps, **kw)
    np.testing.assert_array_equal(got.numpy(), want)


def test_t2i_windows_match_the_stepwise_trajectory(models):
    """The windows concatenate to the stepwise trajectory (greedy: JAX's;
    sampled: the port's with the same generator), and a stochastic segmented
    run's codes equal the monolithic run's; with an interval the window list
    is cut at its bounds."""
    jmodel, model = models
    frame, uncond = _t2i_frame(model.vocab, seed=12)
    f, u = torch.from_numpy(frame), torch.from_numpy(uncond)
    greedy = dict(T2I, guidance_scale=2.0, temperature=0.0, greedy=True)
    want = np.asarray(jmodel.t2i_generate(jnp.asarray(frame), uncond_input_ids=jnp.asarray(uncond),
                                          key=jax.random.key(0), stepwise=True, **greedy))
    sampled = dict(T2I, guidance_scale=2.0, temperature=1.0, cfg_interval=(1 / 6, 5 / 6))
    for kw, ref in ((greedy, torch.from_numpy(want)),
                    (sampled, model.t2i_generate(f, uncond_input_ids=u, stepwise=True,
                                                 generator=_gen(5), **sampled))):
        run = model.t2i_segmented_run(f, uncond_input_ids=u, segment_timesteps=4,
                                      generator=_gen(5), **kw)
        windows = []
        while not run.step():
            windows.append(run.last_window)
        windows.append(run.last_window)
        assert torch.equal(torch.cat(windows), ref.long())
        assert torch.equal(run.codes, ref[-1].long())
    assert run.total_chunks == 4   # [0, 1) [1, 4) [4, 5) [5, 6)
    mono = model.t2i_generate(f, uncond_input_ids=u, generator=_gen(8), **sampled)
    seg = model.t2i_generate(f, uncond_input_ids=u, generator=_gen(8), segment_timesteps=4,
                             **sampled)
    assert torch.equal(seg, mono)
    # a guidance interval without uncond rows is moot: the windows run
    no_uncond = t2i_sampling.t2i_generate_segmented(
        model._window_forward_fn(16, model.vocab.image_window), f,
        model._maskgit_config(1.0, 6, 2.0, t2i_sampling.cosine_schedule, 16, False, (0.2, 0.8)),
        generator=_gen(3), segment_timesteps=4)
    assert no_uncond.shape == (2, 16)


def test_segmented_refusals(models):
    _, model = models
    prompt = torch.from_numpy(_ids((1, 8), seed=13))
    frame, uncond = (torch.from_numpy(a) for a in _t2i_frame(model.vocab))
    with pytest.raises(ValueError, match="exact sampler only"):
        model.generate(prompt, **TEXT, segment_steps=2, block_kv_cache=True)
    with pytest.raises(ValueError, match="exact sampler only"):
        model.mmu_generate(prompt, max_new_tokens=8, steps=4, block_length=8, segment_steps=2,
                           block_kv_cache="int8")
    with pytest.raises(ValueError, match="exact sampler only"):
        model.t2i_generate(frame, **T2I, greedy=True, segment_timesteps=2, block_kv_cache=True)
    with pytest.raises(ValueError, match="stepwise"):
        model.t2i_generate(frame, **T2I, greedy=True, segment_timesteps=2, stepwise=True)
    with pytest.raises(ValueError, match="segment_steps"):
        text_sampling.SegmentedRun(prompt, model._semiar_config(16, 8, 8, 0.0, 0.0),
                                   segment_steps=0,
                                   window_forward_fn=model._text_window_forward_fn(8))
    with pytest.raises(ValueError, match="segment_timesteps"):
        model.t2i_segmented_run(frame, **T2I, greedy=True, segment_timesteps=0)
    with pytest.raises(ValueError, match="row generators require stochastic"):
        model.segmented_run(prompt, **TEXT, generator=[_gen(0)], segment_steps=2)
    with pytest.raises(ValueError, match="row generators require stochastic"):
        model.generate(prompt, **TEXT, generator=[_gen(0)])
    with pytest.raises(ValueError, match="torch.Generator"):
        model.generate(prompt, **TEXT, temperature=0.5, segment_steps=2)
    with pytest.raises(ValueError, match="torch.Generator"):
        model.t2i_segmented_run(frame, **T2I, segment_timesteps=2)
    with pytest.raises(ValueError, match="2 row generators for 1 rows"):
        model.generate(prompt, **TEXT, temperature=0.5, generator=[_gen(0), _gen(1)])


def test_per_row_head_span_matches_int_span(models):
    """`forward(logit_positions=(starts, n))` with a `(B,)` tensor gives each
    row the logits of its own span, as the int form gives them."""
    _, model = models
    ids = torch.from_numpy(_ids((3, 20), seed=14)).long()
    starts = torch.tensor([0, 5, 12])
    got = model.forward(ids, logit_positions=(starts, 8))
    assert got.shape == (3, 8, model.cfg.vocab_size)
    for i, s in enumerate(starts.tolist()):
        want = model.forward(ids, logit_positions=(s, 8))
        torch.testing.assert_close(got[i], want[i], rtol=0, atol=1e-6)
