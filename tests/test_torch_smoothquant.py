"""The port's SmoothQuant (`llada.calibration_stats`, `ops/smoothquant.py`)
and the quantize entry point (`entry.quantize`) against the JAX package, on
the CPU: calibration stats
(rel 1e-5) and scales (2 fp32 ulps), an exact migration for both block
types, GQA, biases, q/k norms and the Gemma norm, JAX-migrated weights
quantized alike (codes bit for bit, logits within 2e-4), the calibration ids
of the JAX loader, and every scheme name of `entry.quantize`.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mmada_tpu.core.vocab import tiny_layout as jax_tiny_layout
from mmada_tpu.models import llada as jax_llada
from mmada_tpu.ops import quantization as JQ
from mmada_tpu.ops import smoothquant as JSQ
from mmada_tpu.serve import loader as jax_loader
from mmada_tpu_torch import entry
from mmada_tpu_torch.checkpoints.from_jax import params_from_jax
from mmada_tpu_torch.core.vocab import tiny_layout
from mmada_tpu_torch.models import llada
from mmada_tpu_torch.models.mmada import MMadaModel
from mmada_tpu_torch.ops import quantization as Q
from mmada_tpu_torch.ops import smoothquant as SQ


def _np(x) -> np.ndarray:
    return x.detach().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _calib(vocab_size, n=2):
    return [np.random.default_rng(7 + i).integers(3, vocab_size - 4, (2, 32)) for i in range(n)]


def _sq_pair(block_type="llama", kv=2, qknorm=False, bias=False, norm="rms", n_layers=3):
    jcfg = jax_llada.tiny_config(n_layers=n_layers, block_type=block_type, n_kv_heads=kv,
                                 attention_layer_norm=qknorm)
    jcfg = dataclasses.replace(jcfg, include_qkv_bias=bias, layer_norm_type=norm)
    jparams = jax_llada.init_params(jax.random.key(0), jcfg)
    for i, name in enumerate(("q_bias", "k_bias", "v_bias", "att_proj_bias")):
        if name in jparams["blocks"]:   # init biases are zeros: randomize them
            jparams["blocks"][name] = 0.1 * jax.random.normal(
                jax.random.key(50 + i), jparams["blocks"][name].shape)
    cfg = llada.LLaDAConfig(**dataclasses.asdict(jcfg))
    return jcfg, jparams, cfg, params_from_jax(jax.device_get(jparams), cfg, device="cpu")


def test_collect_stats_and_smooth_scales_match_jax():
    """Stats within rel 1e-5 of JAX's; the scales within 2 fp32 ulps (torch's
    and XLA's pow differ by one ulp on about 1-3% of entries)."""
    jcfg, jparams, cfg, params = _sq_pair()
    calib = _calib(cfg.vocab_size)
    jstats = JSQ.collect_stats(jparams, jcfg, calib)
    stats = llada.calibration_stats(params, cfg, calib)
    assert set(stats) == set(jstats)
    for k in jstats:
        assert tuple(stats[k].shape) == tuple(np.shape(jstats[k])), k
        np.testing.assert_allclose(_np(stats[k]), np.asarray(jstats[k]), rtol=1e-5, atol=0)
    w_amax = _np(SQ._row_amax(params["blocks"]["ff_out"]))
    for alpha in (0.5, 0.8):
        want = np.asarray(JSQ._smooth_scales(jstats["mlp_mid"], w_amax, alpha))
        got = _np(SQ._smooth_scales(torch.tensor(np.asarray(jstats["mlp_mid"])),
                                    torch.from_numpy(w_amax), alpha))
        ulp = np.spacing(np.maximum(np.abs(got), np.abs(want)))
        assert np.all(np.abs(got - want) <= 2 * ulp), alpha


@pytest.mark.parametrize("block_type,kv,qknorm,bias,norm", [
    ("llama", 2, False, False, "rms"),       # GQA
    ("llama", None, True, True, "rms"),      # MHA + q/k norm + qkv biases
    ("sequential", 2, False, True, "rms"),   # fused att_proj + bias
    ("llama", None, False, False, "gemma_rms"),
])
def test_migration_is_exact(block_type, kv, qknorm, bias, norm):
    """The fp32 forward of the migrated params is the original's within
    1e-4, and the migration moved something."""
    _, _, cfg, params = _sq_pair(block_type, kv, qknorm, bias, norm)
    ids = torch.from_numpy(np.random.default_rng(1).integers(3, 300, (2, 24)))
    ref = llada.forward(params, cfg, ids)
    migrated = SQ.migrate_params(params, cfg, llada.calibration_stats(params, cfg, _calib(300)))
    np.testing.assert_allclose(_np(llada.forward(migrated, cfg, ids)), _np(ref), atol=1e-4,
                               rtol=2e-4)
    assert not torch.equal(migrated["blocks"]["attn_norm"], params["blocks"]["attn_norm"])
    assert migrated["wte"] is params["wte"]


def test_jax_migrated_weights_quantize_alike():
    """JAX's migrated weights, carried across, W8A8-quantized by each
    package: identical codes and scales, logits within 2e-4."""
    jcfg, jparams, cfg, _ = _sq_pair(n_layers=2)
    migrated = JSQ.migrate_params(jparams, jcfg, JSQ.collect_stats(jparams, jcfg,
                                                                    _calib(cfg.vocab_size, 1)))
    jq = JQ.quantize_llada_params(migrated, activations=True)
    q = Q.quantize_llada_params(params_from_jax(jax.device_get(migrated), cfg, device="cpu"),
                                activations=True)
    for name in ("q_proj", "attn_out", "ff_out"):
        np.testing.assert_array_equal(q["blocks"][name].values.numpy(),
                                      np.asarray(jq["blocks"][name].values))
        np.testing.assert_array_equal(q["blocks"][name].scales.numpy(),
                                      np.asarray(jq["blocks"][name].scales))
    ids = np.random.default_rng(2).integers(3, 300, (2, 24))
    with jax.disable_jit():   # W8A8: see test_quantized_forward_matches_jax
        want = jax_llada.forward(jq, jcfg, jnp.asarray(ids))
    np.testing.assert_allclose(_np(llada.forward(q, cfg, torch.from_numpy(ids))),
                               np.asarray(want), atol=2e-4, rtol=0)


def test_calibration_batches_equal_the_loaders(tmp_path):
    """The synthetic batches and the batches of a user's id file equal
    `loader._calibration_batches`'."""
    vocab = tiny_layout()
    cfg = llada.tiny_config(vocab_size=vocab.total_vocab_size)
    jcfg = jax_llada.tiny_config(vocab_size=vocab.total_vocab_size)
    path = str(tmp_path / "calib.npy")
    np.save(path, np.arange(18 * 10).reshape(18, 10) % 200)
    for calib in (None, path):
        m = {} if calib is None else {"smoothquant_calib": calib}
        want = jax_loader._calibration_batches(m, jcfg, jax_tiny_layout())
        got = entry.calibration_batches(cfg, vocab, calib)
        assert len(got) == len(want) == (2 if calib is None else 4)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
    with pytest.raises(ValueError, match="N, L"):
        entry.calibration_batches(cfg, vocab, np.zeros(5))


def test_entry_quantize_every_scheme():
    """Every scheme name gives a model whose block weights are of its class
    and whose embedding is the input model's (shared, not copied); the
    forward is finite; an unknown name raises."""
    vocab = tiny_layout()
    cfg = dataclasses.replace(llada.tiny_config(vocab_size=vocab.total_vocab_size),
                              mask_token_id=vocab.mask_token_id)
    model = MMadaModel.init(cfg, vocab, device="cpu", generator=torch.Generator().manual_seed(0))
    ids = torch.randint(3, 200, (1, 12), generator=torch.Generator().manual_seed(1))
    want = {"int8": Q.QuantizedTensor, "w8": Q.QuantizedTensor, "w8a8": Q.W8A8Tensor,
            "w8a8_smooth": Q.W8A8Tensor, "int4": Q.Int4Tensor}
    assert set(want) == set(entry.QUANT_SCHEMES)
    for scheme, cls in want.items():
        qm = entry.quantize(model, scheme)
        assert type(qm.params["blocks"]["q_proj"]) is cls and type(qm.params["ff_out"]) is cls
        assert qm.params["wte"] is model.params["wte"]
        if scheme != "w8a8_smooth":
            assert qm.params["blocks"]["attn_norm"] is model.params["blocks"]["attn_norm"]
        assert torch.isfinite(qm.forward(ids)).all()
        assert Q.nbytes(qm.params) < Q.nbytes(model.params)
    with pytest.raises(ValueError, match="scheme"):
        entry.quantize(model, "int3")
