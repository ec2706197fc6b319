"""The slice as a whole on the CPU: a model with 256-wide heads under FP32 and
BF16, and `configs/tiny_test.yaml` (fp32, 16-wide heads) through the
command line, against the JAX package on the same weights.

* A head_dim-256 model (2 layers, d_model 512, 2 heads; JAX init carried
  over by `params_from_jax`): logits within atol 2e-4 / rtol 1e-3 of JAX's
  under FP32 (test_torch_llada.py's bar), within bf16's bar (atol = rtol =
  2e-2, test_torch_llada.py::test_forward_bf16_policy_tracks_jax) under
  BF16, and the T = 0 text sampler token-exact under FP32. These are the
  functions the card computes with B7 / B8 (`kernel_for`: fp32, and bf16 at
  head_dim 256, take the generic kernels).
* `generate_torch.run` on `configs/tiny_test.yaml` (the tiny model under the
  fp32 policy, head_dim 16) prints what JAX's `generate.main` prints on the
  same config, its random weights carried over.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import generate
import generate_torch
import mmada_tpu.serve.loader as jax_loader
from mmada_tpu.core.precision import BF16 as JAX_BF16
from mmada_tpu.core.vocab import tiny_layout as jax_tiny_layout
from mmada_tpu.models import llada as jax_llada
from mmada_tpu.models.mmada import MMadaModel as JaxMMadaModel
from mmada_tpu.prompting.universal import ByteTokenizer as JaxByteTokenizer
from mmada_tpu_torch.checkpoints.from_jax import params_from_jax
from mmada_tpu_torch.core.precision import BF16, FP32
from mmada_tpu_torch.core.vocab import tiny_layout
from mmada_tpu_torch.entry import serve_text, text_frames
from mmada_tpu_torch.models import llada
from mmada_tpu_torch.models.mmada import MMadaModel
from mmada_tpu_torch.ops.flash_attention import kernel_for
from mmada_tpu_torch.prompting.universal import ByteTokenizer

TOL = dict(atol=2e-4, rtol=1e-3)


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def models():
    jvocab = jax_tiny_layout()
    jcfg = jax_llada.tiny_config(vocab_size=jvocab.total_vocab_size, d_model=512, n_heads=2,
                                 n_layers=2, mlp_hidden_size=256)
    jcfg = dataclasses.replace(jcfg, mask_token_id=jvocab.mask_token_id)
    params = jax.jit(lambda k: jax_llada.init_params(k, jcfg))(jax.random.key(5))  # one compile
    jmodel = JaxMMadaModel(cfg=jcfg, params=params, vocab=jvocab)
    cfg = llada.LLaDAConfig(**dataclasses.asdict(jcfg))
    assert cfg.head_dim == 256
    params = params_from_jax(jax.device_get(jmodel.params), cfg, device="cpu")
    return jmodel, MMadaModel(cfg=cfg, params=params, vocab=tiny_layout(), policy=FP32)


def _ids(cfg, b=2, l=40, seed=1):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, (b, l)).astype(np.int32)


def test_head_dim_256_takes_the_generic_kernels_on_the_card(models):
    _, model = models
    assert kernel_for(torch.float32, model.cfg.head_dim) == "generic"
    assert kernel_for(torch.bfloat16, model.cfg.head_dim) == "generic"


def test_fp32_logits_at_head_dim_256_match_jax(models):
    jmodel, model = models
    ids = _ids(model.cfg)
    want = jax_llada.forward(jmodel.params, jmodel.cfg, jnp.asarray(ids))
    got = llada.forward(model.params, model.cfg, torch.from_numpy(ids).long(), policy=FP32)
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_bf16_logits_at_head_dim_256_track_jax(models):
    jmodel, model = models
    jparams16 = jax.tree_util.tree_map(lambda a: a.astype(jnp.bfloat16), jmodel.params)
    params16 = params_from_jax(jax.device_get(jparams16), model.cfg, device="cpu",
                               dtype=torch.bfloat16)
    ids = _ids(model.cfg, seed=2)
    want = jax_llada.forward(jparams16, jmodel.cfg, jnp.asarray(ids), policy=JAX_BF16)
    got = llada.forward(params16, model.cfg, torch.from_numpy(ids).long(), policy=BF16)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-2, rtol=2e-2)


def test_fp32_text_sampler_at_head_dim_256_is_token_exact(models):
    jmodel, model = models
    prompts = ["hello", "a longer prompt"]
    kw = dict(gen_length=16, steps=8, block_length=8, temperature=0.0)
    answers = serve_text(model, prompts, device="cpu", **kw)
    for frame, ans in zip(text_frames(model, prompts), answers):
        want = jmodel.generate(jnp.asarray([frame], jnp.int32), **kw)
        np.testing.assert_array_equal(ans.numpy(), np.asarray(want)[0, len(frame):])


def test_tiny_test_yaml_generate_prints_what_jax_prints(monkeypatch, capsys):
    """`generate_torch` on configs/tiny_test.yaml (the fp32 policy, head_dim
    16: B7 on the card) against JAX's `generate.main` on the same config,
    the tiny model's random weights carried over; answers printed as ids
    (a random model's answers are mostly outside the printable bytes)."""
    for cls in (JaxByteTokenizer, ByteTokenizer):
        monkeypatch.setattr(cls, "decode", lambda self, ids: repr([int(i) for i in ids]))
    built = {}
    build_model = jax_loader.build_model

    def keep(*args, **kw):
        built["model"] = build_model(*args, **kw)
        return built["model"]

    monkeypatch.setattr(jax_loader, "build_model", keep)
    argv = ["config=configs/tiny_test.yaml", "prompt=Name three colors", "gen_length=16",
            "steps=8", "block_length=8"]
    assert generate.main(argv + ["parallel.serving=none"]) == 0
    want = capsys.readouterr().out
    cfg = generate_torch.read_config(argv + ["device=cpu"])
    loaded = generate_torch.load(cfg)
    assert loaded.model.policy == FP32 and loaded.model.cfg.head_dim == 16
    assert kernel_for(torch.float32, loaded.model.cfg.head_dim) == "generic"
    params = params_from_jax(jax.device_get(built["model"].params), loaded.model.cfg,
                             device="cpu")
    loaded = loaded._replace(model=dataclasses.replace(loaded.model, params=params))
    got = "".join(generate_torch.answer_text(loaded, ids) + "\n"
                  for ids in generate_torch.run(cfg, loaded))
    assert got == want and len(eval(want)) > 0
