"""The port's tau-parallel text decoding against the JAX package, on the CPU.

Counterpart of tests/test_parallel_decode.py. Both packages run the same
weights (a JAX init carried over by `params_from_jax`) under the FP32
policy:

* tau 0.9 with warmup 0 and 2, alone, with the block-KV cache and with CFG:
  token-exact against JAX at T = 0;
* tau > 1 never fires: equal to the exact sampler (and to tau off), also
  under CFG and in `mmu_generate_fast`; a warmup at or past the steps per
  block equals tau off; a tau that always fires commits a whole block in its
  first step (equal to one step a block) and leaves each block after that
  step, and a warmup of 1 delays it;
* the refusals: tau with `remasking="random"`, tau in `generate_stepwise`.
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
from mmada_tpu_torch.sampling import text as text_sampling

TEXT = dict(gen_length=32, steps=8, block_length=16, temperature=0.0)


@pytest.fixture(scope="module")
def models():
    """One random tiny MMaDA in both packages, on the same weights."""
    jvocab = jax_tiny_layout()
    jcfg = jax_llada.tiny_config(vocab_size=jvocab.total_vocab_size)
    jmodel = JaxMMadaModel.init(jax.random.key(0), jcfg, jvocab)
    cfg = llada.LLaDAConfig(**dataclasses.asdict(jcfg))
    params = params_from_jax(jax.device_get(jmodel.params), cfg, device="cpu")
    return jmodel, MMadaModel(cfg=cfg, params=params, vocab=tiny_layout())


def _prompt(seed, b=2):
    return np.random.default_rng(seed).integers(3, 200, (b, 8)).astype(np.int32)


CASES = {
    "tau": dict(parallel_threshold=0.9),
    "tau-warmup-2": dict(parallel_threshold=0.9, parallel_warmup_steps=2),
    "tau-cached": dict(parallel_threshold=0.9, block_kv_cache=True),
    "tau-warmup-2-cached": dict(parallel_threshold=0.9, parallel_warmup_steps=2,
                                block_kv_cache=True),
    "tau-cfg": dict(parallel_threshold=0.9, cfg_scale=1.5),
    "tau-low-refresh": dict(parallel_threshold=0.3, parallel_warmup_steps=1,
                            block_kv_cache=True, cache_refresh_every=2),
}


@pytest.mark.parametrize("case", list(CASES))
def test_parallel_matches_jax(models, case):
    jmodel, model = models
    prompt = _prompt(1)
    kw = dict(TEXT, **CASES[case])
    want = jmodel.generate(jnp.asarray(prompt), **kw)
    got = model.generate(torch.from_numpy(prompt), **kw)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert (got != model.vocab.mask_token_id).all()


@pytest.mark.parametrize("cfg_scale", [0.0, 1.5])
@pytest.mark.parametrize("tau", [1.5, 2.0])
def test_threshold_above_one_equals_exact(models, tau, cfg_scale):
    _, model = models
    prompt = torch.from_numpy(_prompt(2))
    kw = dict(TEXT, cfg_scale=cfg_scale)
    assert torch.equal(model.generate(prompt, **kw, parallel_threshold=tau),
                       model.generate(prompt, **kw))


@pytest.mark.parametrize("warmup", [4, 5])
def test_warmup_at_or_past_steps_per_block_equals_tau_off(models, warmup):
    """Steps per block is 4: tau never gets to fire."""
    _, model = models
    prompt = torch.from_numpy(_prompt(3))
    assert torch.equal(
        model.generate(prompt, **TEXT, parallel_threshold=1e-9, parallel_warmup_steps=warmup),
        model.generate(prompt, **TEXT))


def test_tau_that_always_fires_commits_a_block_in_one_step(models):
    """tau ~ 0 commits every candidate on a block's first step and leaves
    the block (one forward a block); equal to one step a block. Warmup 1
    delays the fire by one step: two forwards a block, no [MASK] left."""
    _, model = models
    prompt = torch.from_numpy(_prompt(4))
    calls = []
    window = model._text_window_forward_fn(TEXT["block_length"])

    def counted(tokens, start):
        calls.append(start)
        return window(tokens, start)

    scfg = text_sampling.SemiARConfig(**TEXT, mask_id=model.vocab.mask_token_id,
                                      parallel_threshold=1e-9)
    fired = text_sampling.generate(None, prompt, scfg, window_forward_fn=counted)
    assert calls == [8, 24]
    one_step = model.generate(prompt, **dict(TEXT, steps=2))
    assert torch.equal(fired, one_step)
    calls.clear()
    warm = text_sampling.generate(None, prompt, dataclasses.replace(scfg, parallel_warmup_steps=1),
                                  window_forward_fn=counted)
    assert calls == [8, 8, 24, 24]
    assert (warm != model.vocab.mask_token_id).all()


def test_mmu_fast_with_tau_above_one_equals_exact(models):
    _, model = models
    prompt = torch.from_numpy(_prompt(5))
    kw = dict(eot_token=5, max_new_tokens=32, steps=8, block_length=16)
    assert torch.equal(model.mmu_generate_fast(prompt, **kw, parallel_threshold=2.0),
                       model.mmu_generate_fast(prompt, **kw))


def test_stochastic_tau_is_reproducible(models):
    _, model = models
    prompt = torch.from_numpy(_prompt(6))
    kw = dict(TEXT, temperature=1.0, parallel_threshold=0.3)
    a = model.generate(prompt, **kw, generator=torch.Generator().manual_seed(9))
    b = model.generate(prompt, **kw, generator=torch.Generator().manual_seed(9))
    assert torch.equal(a, b) and (a != model.vocab.mask_token_id).all()


def test_tau_refusals(models):
    _, model = models
    with pytest.raises(ValueError, match="coin-flip"):
        text_sampling.SemiARConfig(**TEXT, remasking="random", parallel_threshold=0.5)
    with pytest.raises(ValueError, match="coin-flip"):
        model.generate(torch.from_numpy(_prompt(7)), **TEXT, remasking="random",
                       parallel_threshold=0.5, generator=torch.Generator())
    scfg = text_sampling.SemiARConfig(**TEXT, mask_id=model.vocab.mask_token_id,
                                      parallel_threshold=0.5)
    with pytest.raises(ValueError, match="parallel_threshold"):
        text_sampling.generate_stepwise(
            None, torch.from_numpy(_prompt(7, b=1)), scfg,
            window_forward_fn=model._text_window_forward_fn(TEXT["block_length"]))
