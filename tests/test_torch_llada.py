"""The port's LLaDA forward against the JAX package and the reference goldens.

Both packages run the same weights (JAX init, carried over by
`params_from_jax`) on the same tokens under the FP32 policy; logits must agree
within atol 2e-4 / rtol 1e-3, the bar of tests/test_llada_parity.py. The
goldens' torch state dicts load through the port's own loader.
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mmada_tpu.models import llada as jax_llada
from mmada_tpu_torch.checkpoints.from_jax import (
    params_from_jax,
    params_from_torch_state_dict,
)
from mmada_tpu_torch.core.precision import BF16, FP32
from mmada_tpu_torch.models import llada

GOLDENS = os.path.join(os.path.dirname(__file__), "goldens")
TOL = dict(atol=2e-4, rtol=1e-3)


def _configs():
    return {
        "mha": jax_llada.tiny_config(),
        "gqa": jax_llada.tiny_config(n_kv_heads=2),
        "seq_tied": jax_llada.tiny_config(block_type="sequential",
                                          activation_type="swiglu",
                                          weight_tying=True),
        "qk_norm": jax_llada.tiny_config(attention_layer_norm=True),
    }


def _port_cfg(jcfg) -> llada.LLaDAConfig:
    return llada.LLaDAConfig(**dataclasses.asdict(jcfg))


def _both(name, seed=0):
    jcfg = _configs()[name]
    jparams = jax_llada.init_params(jax.random.key(seed), jcfg)
    cfg = _port_cfg(jcfg)
    return jcfg, jparams, cfg, params_from_jax(jax.device_get(jparams), cfg, device="cpu")


def _ids(cfg, b=2, l=24, seed=1):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, (b, l)).astype(np.int32)


@pytest.mark.parametrize("name", ["mha", "gqa", "seq_tied", "qk_norm"])
def test_forward_matches_jax(name):
    jcfg, jparams, cfg, params = _both(name)
    ids = _ids(cfg)
    want = jax_llada.forward(jparams, jcfg, jnp.asarray(ids))
    got = llada.forward(params, cfg, torch.from_numpy(ids).long(), policy=FP32)
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("window,positions", [
    ((40, 104), None),
    (None, (5, 8)),
    ((256, 320), (15, 8)),
])
def test_forward_windows_match_jax(window, positions):
    jcfg, jparams, cfg, params = _both("gqa", seed=3)
    ids = _ids(cfg, seed=4)
    want = jax_llada.forward(jparams, jcfg, jnp.asarray(ids),
                             logit_window=window, logit_positions=positions)
    got = llada.forward(params, cfg, torch.from_numpy(ids).long(),
                        logit_window=window, logit_positions=positions)
    assert tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("variant", ["scale_logits", "input_emb_norm", "rope_half",
                                     "bias_enabled"])
def test_forward_config_variants_match_jax(variant):
    jcfg0, jparams, _, _ = _both("mha", seed=5)
    over = {"scale_logits": dict(scale_logits=True),
            "input_emb_norm": dict(input_emb_norm=True),
            "rope_half": dict(rope_full_precision=False),
            "bias_enabled": dict(attention_bias_enabled=True)}[variant]
    jcfg = dataclasses.replace(jcfg0, **over)
    cfg = _port_cfg(jcfg)
    params = params_from_jax(jax.device_get(jparams), cfg, device="cpu")
    ids = _ids(cfg, seed=6)
    mask = np.ones(ids.shape, np.int32)
    mask[0, :5] = 0
    want = jax_llada.forward(jparams, jcfg, jnp.asarray(ids), attention_mask=jnp.asarray(mask))
    got = llada.forward(params, cfg, torch.from_numpy(ids).long(),
                        attention_mask=torch.from_numpy(mask))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_forward_bf16_policy_tracks_jax():
    """BF16 weights and compute on both sides: bf16 rounds every matmul
    output to 8 mantissa bits, and the two CPU backends accumulate in other
    orders, so logits agree to bf16 precision (atol 2e-2 at |logit| < 1),
    not bit for bit."""
    jcfg, jparams, cfg, _ = _both("gqa", seed=7)
    jparams16 = jax.tree_util.tree_map(lambda a: a.astype(jnp.bfloat16), jparams)
    params16 = params_from_jax(jax.device_get(jparams16), cfg, device="cpu",
                               dtype=torch.bfloat16)
    ids = _ids(cfg, seed=8)
    from mmada_tpu.core.precision import BF16 as JAX_BF16

    want = jax_llada.forward(jparams16, jcfg, jnp.asarray(ids), policy=JAX_BF16)
    got = llada.forward(params16, cfg, torch.from_numpy(ids).long(), policy=BF16)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-2, rtol=2e-2)


@pytest.mark.parametrize("name", ["mha", "gqa", "seq_tied", "qk_norm"])
def test_init_params_layout_matches_jax(name):
    """The port's on-device init makes the JAX layout: same names, shapes."""
    jcfg = _configs()[name]
    jparams = jax_llada.init_params(jax.random.key(0), jcfg)
    params = llada.init_params(_port_cfg(jcfg), device="cpu",
                               generator=torch.Generator().manual_seed(0))
    want = jax.tree_util.tree_map(lambda a: tuple(a.shape), jparams)
    got = {k: ({n: tuple(t.shape) for n, t in v.items()} if isinstance(v, dict)
               else tuple(v.shape)) for k, v in params.items()}
    assert got == want
    assert abs(float(params["wte"].std()) - 0.02) < 2e-3
    assert llada.param_count(params) == jax_llada.param_count(jparams)


def test_init_params_is_seeded():
    cfg = _port_cfg(_configs()["mha"])
    a = llada.init_params(cfg, device="cpu", generator=torch.Generator().manual_seed(3))
    b = llada.init_params(cfg, device="cpu", generator=torch.Generator().manual_seed(3))
    torch.testing.assert_close(a["blocks"]["q_proj"], b["blocks"]["q_proj"], atol=0, rtol=0)


def _golden(name):
    data = np.load(os.path.join(GOLDENS, f"{name}.npz"))
    state = {k[len("w::"):]: data[k] for k in data.files if k.startswith("w::")}
    rest = {k: data[k] for k in data.files if not k.startswith("w::")}
    return state, rest


def _golden_cfg(**over):
    base = dict(d_model=64, n_heads=4, n_layers=2, mlp_hidden_size=128,
                vocab_size=96, max_sequence_length=128, rope_theta=10000.0)
    base.update(over)
    return llada.LLaDAConfig(embedding_size=base["vocab_size"], mask_token_id=90, **base)


@pytest.mark.parametrize("tag,over", [
    ("mha", {}),
    ("gqa", {"n_kv_heads": 2}),
    ("seq", {"block_type": "sequential", "weight_tying": True}),
])
def test_forward_matches_goldens(tag, over):
    state, rest = _golden(f"forward_{tag}")
    cfg = _golden_cfg(**over)
    params = params_from_torch_state_dict(state, cfg, device="cpu")
    ids = torch.from_numpy(rest["input_ids"]).long()
    np.testing.assert_allclose(llada.forward(params, cfg, ids).numpy(), rest["logits"], **TOL)
    if tag == "mha":  # the reference ignores masks in attention
        masked = llada.forward(params, cfg, ids,
                               attention_mask=torch.from_numpy(rest["attention_mask"]))
        np.testing.assert_allclose(masked.numpy(), rest["logits_masked"], **TOL)
    assert llada.param_count(params) == sum(v.size for v in state.values())
