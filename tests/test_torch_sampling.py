"""The port's exact samplers against the JAX package and the goldens.

Token-exact at the deterministic settings of tests/test_sampler_parity.py:
text `generate` at temperature 0 with cfg 0 and 1.5, t2i `t2i_generate`
greedy at temperature 0 with guidance 0 and 2. Both packages run the same
weights (the goldens' state dicts through each package's loader, or a JAX
init carried over with `params_from_jax`).
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
from mmada_tpu.models import llada as jax_llada
from mmada_tpu.models.mmada import MMadaModel as JaxMMadaModel
from mmada_tpu.sampling import gumbel as jax_gumbel
from mmada_tpu.sampling import schedules as jax_schedules
from mmada_tpu.sampling import t2i as jax_t2i
from mmada_tpu.sampling import text as jax_text
from mmada_tpu_torch.checkpoints.from_jax import (
    params_from_jax,
    params_from_torch_state_dict,
)
from mmada_tpu_torch.core.vocab import tiny_layout
from mmada_tpu_torch.models import llada
from mmada_tpu_torch.models.mmada import MMadaModel
from mmada_tpu_torch.sampling import gumbel, schedules
from mmada_tpu_torch.sampling import t2i as t2i_sampling
from mmada_tpu_torch.sampling import text as text_sampling

GOLDENS = os.path.join(os.path.dirname(__file__), "goldens")
MASK_ID = 90
TEXT_LEN = 64
CODEBOOK = 16


def _golden(name):
    data = np.load(os.path.join(GOLDENS, f"{name}.npz"))
    state = {k[len("w::"):]: data[k] for k in data.files if k.startswith("w::")}
    rest = {k: data[k] for k in data.files if not k.startswith("w::")}
    return state, rest


def _golden_cfgs():
    kw = dict(d_model=64, n_heads=4, n_layers=2, mlp_hidden_size=128, vocab_size=96,
              embedding_size=96, max_sequence_length=128, rope_theta=10000.0,
              mask_token_id=MASK_ID)
    return jax_llada.LLaDAConfig(**kw), llada.LLaDAConfig(**kw)


@pytest.mark.parametrize("cfg_scale", [0.0, 1.5])
def test_text_generate_matches_golden_and_jax(cfg_scale):
    state, rest = _golden("text_generate")
    jcfg, cfg = _golden_cfgs()
    params = params_from_torch_state_dict(state, cfg, device="cpu")
    scfg = text_sampling.SemiARConfig(gen_length=16, steps=8, block_length=8,
                                      temperature=0.0, cfg_scale=cfg_scale,
                                      mask_id=MASK_ID)
    out = text_sampling.generate(lambda t: llada.forward(params, cfg, t),
                                 torch.from_numpy(rest["prompt"]), scfg)
    np.testing.assert_array_equal(out.numpy(), rest[f"out_cfg{cfg_scale}"])

    jparams = jax_params_from_state(state, jcfg)
    jscfg = jax_text.SemiARConfig(gen_length=16, steps=8, block_length=8,
                                  temperature=0.0, cfg_scale=cfg_scale, mask_id=MASK_ID)
    want = jax_text.generate(lambda t: jax_llada.forward(jparams, jcfg, t),
                             jnp.asarray(rest["prompt"]), jscfg)
    np.testing.assert_array_equal(out.numpy(), np.asarray(want))


@pytest.mark.parametrize("gs", [0.0, 2.0])
def test_t2i_generate_matches_golden_and_jax(gs):
    state, rest = _golden("t2i_generate")
    jcfg, cfg = _golden_cfgs()
    params = params_from_torch_state_dict(state, cfg, device="cpu")
    n_img = 16

    def window_forward(tokens, attention_mask):
        logits = llada.forward(params, cfg, tokens, attention_mask=attention_mask,
                               logit_window=(TEXT_LEN, TEXT_LEN + CODEBOOK))
        return logits[:, -(n_img + 1):-1, :]

    mcfg = t2i_sampling.MaskGITConfig(timesteps=6, temperature=0.0, guidance_scale=gs,
                                      mask_id=MASK_ID, num_vq_tokens=n_img,
                                      codebook_size=CODEBOOK, text_vocab_size=TEXT_LEN,
                                      greedy=True)

    def t(name):
        return torch.from_numpy(rest[name])

    out = t2i_sampling.t2i_generate(
        window_forward, t("input_ids"), mcfg,
        uncond_input_ids=t("uncond_ids") if gs > 0 else None,
        attention_mask=t("attn"),
        uncond_attention_mask=t("uncond_attn") if gs > 0 else None,
    )
    np.testing.assert_array_equal(out.numpy(), rest[f"out_gs{gs}"])

    jparams = jax_params_from_state(state, jcfg)

    def jax_window_forward(tokens, attention_mask):
        logits = jax_llada.forward(jparams, jcfg, tokens, attention_mask=attention_mask,
                                   logit_window=(TEXT_LEN, TEXT_LEN + CODEBOOK))
        return logits[:, -(n_img + 1):-1, :]

    jmcfg = jax_t2i.MaskGITConfig(timesteps=6, temperature=0.0, guidance_scale=gs,
                                  mask_id=MASK_ID, num_vq_tokens=n_img,
                                  codebook_size=CODEBOOK, text_vocab_size=TEXT_LEN,
                                  greedy=True)
    want = jax_t2i.t2i_generate(
        jax_window_forward, jnp.asarray(rest["input_ids"]), jmcfg, key=jax.random.key(0),
        uncond_input_ids=jnp.asarray(rest["uncond_ids"]) if gs > 0 else None,
        attention_mask=jnp.asarray(rest["attn"]),
        uncond_attention_mask=jnp.asarray(rest["uncond_attn"]) if gs > 0 else None,
    )
    np.testing.assert_array_equal(out.numpy(), np.asarray(want))


def _models(seed=0, **cfg_over):
    """One random tiny MMaDA in both packages, on the same weights."""
    jvocab = jax_tiny_layout()
    jcfg = jax_llada.tiny_config(vocab_size=jvocab.total_vocab_size, **cfg_over)
    jmodel = JaxMMadaModel.init(jax.random.key(seed), jcfg, jvocab)
    cfg = llada.LLaDAConfig(**dataclasses.asdict(jcfg))
    params = params_from_jax(jax.device_get(jmodel.params), cfg, device="cpu")
    return jmodel, MMadaModel(cfg=cfg, params=params, vocab=tiny_layout())


@pytest.mark.parametrize("cfg_scale,n_kv_heads", [(0.0, None), (1.5, 2)])
def test_model_generate_matches_jax(cfg_scale, n_kv_heads):
    """`MMadaModel.generate` (block-windowed head) token-exact vs JAX."""
    jmodel, model = _models(seed=1, n_kv_heads=n_kv_heads)
    prompt = np.random.default_rng(2).integers(3, 200, (2, 7)).astype(np.int32)
    kw = dict(gen_length=16, steps=8, block_length=8, temperature=0.0, cfg_scale=cfg_scale)
    want = jmodel.generate(jnp.asarray(prompt), **kw)
    got = model.generate(torch.from_numpy(prompt), **kw)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("gs,cfg_interval", [(0.0, (0.0, 1.0)), (2.0, (0.0, 1.0)),
                                             (2.0, (0.25, 0.75))])
def test_model_t2i_generate_matches_jax(gs, cfg_interval):
    """`MMadaModel.t2i_generate` (vocab + position windows) greedy, token-exact
    vs JAX, with and without a guidance interval."""
    jmodel, model = _models(seed=3)
    vocab = model.vocab
    n, prompt_len = 16, 9
    rng = np.random.default_rng(4)
    frame = np.concatenate([rng.integers(3, 200, (2, prompt_len)),
                            np.full((2, 1), 250), np.full((2, n), vocab.mask_token_id),
                            np.full((2, 1), 251)], axis=1).astype(np.int32)
    uncond = frame.copy()
    uncond[:, :prompt_len] = vocab.pad_token_id
    kw = dict(temperature=0.0, timesteps=6, guidance_scale=gs, num_vq_tokens=n,
              greedy=True, cfg_interval=cfg_interval)
    want = jmodel.t2i_generate(jnp.asarray(frame), uncond_input_ids=jnp.asarray(uncond),
                               key=jax.random.key(0), **kw)
    got = model.t2i_generate(torch.from_numpy(frame), uncond_input_ids=torch.from_numpy(uncond),
                             **kw)
    assert got.shape == (2, n)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_stochastic_text_generation_valid():
    """T > 0 (and random remasking): no masks left, prompt kept, ids in
    vocab, and the generator's seed decides the sample."""
    state, rest = _golden("text_generate")
    _, cfg = _golden_cfgs()
    params = params_from_torch_state_dict(state, cfg, device="cpu")
    prompt = torch.from_numpy(rest["prompt"])

    def run(seed, remasking="low_confidence"):
        scfg = text_sampling.SemiARConfig(gen_length=16, steps=8, block_length=8,
                                          temperature=1.0, mask_id=MASK_ID,
                                          remasking=remasking)
        return text_sampling.generate(lambda t: llada.forward(params, cfg, t), prompt,
                                      scfg, generator=torch.Generator().manual_seed(seed))

    out = run(1)
    assert (out[:, :prompt.shape[1]] == prompt).all()
    assert (out != MASK_ID).all() and (out >= 0).all() and (out < cfg.vocab_size).all()
    assert torch.equal(out, run(1))
    assert not torch.equal(out, run(2))
    assert (run(3, "random") != MASK_ID).all()
    with pytest.raises(ValueError, match="Generator"):
        text_sampling.generate(lambda t: llada.forward(params, cfg, t), prompt,
                               text_sampling.SemiARConfig(gen_length=16, steps=8,
                                                          block_length=8, temperature=1.0,
                                                          mask_id=MASK_ID))


def test_stochastic_t2i_generation_valid():
    _, model = _models(seed=5)
    vocab = model.vocab
    n = 16
    frame = torch.cat([torch.full((2, 5), 7), torch.full((2, 1), 250),
                       torch.full((2, n), vocab.mask_token_id), torch.full((2, 1), 251)], 1)

    def run(seed):
        return model.t2i_generate(frame, uncond_input_ids=frame, temperature=1.0,
                                  timesteps=5, guidance_scale=1.0, num_vq_tokens=n,
                                  generator=torch.Generator().manual_seed(seed))

    codes = run(0)
    assert codes.shape == (2, n)
    assert ((codes >= 0) & (codes < vocab.image_codebook_size)).all()
    assert torch.equal(codes, run(0)) and not torch.equal(codes, run(1))


def test_num_transfer_schedule_matches_jax():
    counts = np.asarray([10, 7, 8, 0, 33])
    want = jax_text.num_transfer_schedule(jnp.asarray(counts), 4)
    got = text_sampling.num_transfer_schedule(torch.from_numpy(counts), 4)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert (got.sum(1).numpy() == counts).all()


def test_semiar_config_validates():
    with pytest.raises(ValueError):
        text_sampling.SemiARConfig(gen_length=10, block_length=4)
    with pytest.raises(ValueError):
        text_sampling.SemiARConfig(gen_length=8, steps=3, block_length=4)
    with pytest.raises(ValueError):
        text_sampling.SemiARConfig(remasking="top_p")


@pytest.mark.parametrize("name", ["cosine", "linear", "pow2", "sigmoid"])
def test_schedules_match_jax(name):
    t = np.linspace(0.0, 1.0, 19, dtype=np.float32)
    want = jax_schedules.get_mask_schedule(name)(jnp.asarray(t))
    got = schedules.get_mask_schedule(name)(torch.from_numpy(t))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)


def test_cfg_interval_steps_match_jax():
    for interval in [(0.0, 1.0), (0.2, 0.8), (0.5, 0.5), (0.0, 0.34)]:
        want = jax_t2i.cfg_interval_steps(jax_t2i.MaskGITConfig(timesteps=12,
                                                                cfg_interval=interval))
        got = t2i_sampling.cfg_interval_steps(t2i_sampling.MaskGITConfig(timesteps=12,
                                                                         cfg_interval=interval))
        assert got == want


def test_gumbel_primitives_match_jax():
    rng = np.random.default_rng(9)
    logits = rng.normal(size=(3, 5, 40)).astype(np.float32) * 4
    ids = rng.integers(0, 40, (3, 5))
    np.testing.assert_allclose(
        gumbel.confidence_of(torch.from_numpy(logits), torch.from_numpy(ids)).numpy(),
        np.asarray(jax_gumbel.confidence_of(jnp.asarray(logits), jnp.asarray(ids))),
        rtol=1e-5, atol=1e-7)
    vals = np.round(rng.normal(size=(4, 12)), 1).astype(np.float32)  # with ties
    np.testing.assert_array_equal(
        gumbel.ranks_desc(torch.from_numpy(vals)).numpy(),
        np.asarray(jax_gumbel.ranks_desc(jnp.asarray(vals))))
    k = np.asarray([0, 3, 12, 5])
    np.testing.assert_array_equal(
        gumbel.select_top_k_dynamic(torch.from_numpy(vals), torch.from_numpy(k)).numpy(),
        np.asarray(jax_gumbel.select_top_k_dynamic(jnp.asarray(vals), jnp.asarray(k))))
    probs = rng.uniform(size=(4, 12)).astype(np.float32)
    mask_len = np.asarray([[1], [4], [11], [6]])
    np.testing.assert_array_equal(
        gumbel.mask_by_random_topk(torch.from_numpy(mask_len), torch.from_numpy(probs),
                                   torch.tensor(1.0), None).numpy(),
        np.asarray(jax_gumbel.mask_by_random_topk(jnp.asarray(mask_len), jnp.asarray(probs),
                                                  jnp.float32(1.0), None)))


def test_gumbel_noise_is_gumbel():
    """The port's own noise stream: Gumbel(0, 1) moments (mean = Euler's
    gamma, variance = pi^2 / 6) within 4 standard errors at 2e5 draws."""
    g = gumbel.gumbel_noise((200_000,), torch.Generator().manual_seed(0), "cpu").double()
    se_mean = (np.pi ** 2 / 6 / 2e5) ** 0.5
    assert abs(float(g.mean()) - 0.5772156649) < 4 * se_mean
    assert abs(float(g.var()) - np.pi ** 2 / 6) < 0.03
