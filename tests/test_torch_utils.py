"""The port's utilities and training leftovers against the JAX package.

`training/diagnostics.mask_ratio_bucket_stats`, the r2i losses
(`soft_target_cross_entropy`, `get_loss_weight`, `weighted_t2i_loss`,
`forward_process_with_r2i`) and `utils/flops.train_step_flops` take the same
numpy inputs as JAX's functions (`tests/test_r2i_and_eval_driver.py:42`'s
shapes) and must agree: the losses within fp32 rounding, the FLOP counts
exactly. `masking.eval_image_corruption` draws from a `torch.Generator`,
whose bits differ from JAX's threefry, so it is held by its laws: the same
seed gives the same corruption, the ratio override fixes each row's masked
count, and without one the schedule decides it. `utils/profiling.trace`
writes a Chrome trace that holds an annotated span.
"""

import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mmada_tpu.core.vocab import tiny_layout as jax_tiny_layout
from mmada_tpu.models import llada as jax_llada
from mmada_tpu.models.mmada import MMadaModel as JaxMMadaModel
from mmada_tpu.training import diagnostics as jax_diag
from mmada_tpu.training import losses as jax_losses
from mmada_tpu.utils import flops as jax_flops
from mmada_tpu_torch.checkpoints.from_jax import params_from_jax
from mmada_tpu_torch.core.vocab import tiny_layout
from mmada_tpu_torch.models import llada
from mmada_tpu_torch.models.mmada import MMadaModel
from mmada_tpu_torch.sampling.schedules import cosine_schedule
from mmada_tpu_torch.training import diagnostics, losses, masking
from mmada_tpu_torch.utils import flops, profiling

VOCAB = dict(text_vocab_size=256, image_codebook_size=32, motion_codebook_size=16,
             motion_special=2)
TOL = dict(rtol=1e-5, atol=1e-6)


@pytest.fixture(scope="module")
def models():
    jvocab = jax_tiny_layout(**VOCAB)
    jcfg = jax_llada.tiny_config(vocab_size=jvocab.total_vocab_size, d_model=32, n_heads=2,
                                 n_layers=2, mlp_hidden_size=64)
    jcfg = dataclasses.replace(jcfg, mask_token_id=jvocab.mask_token_id)
    jparams = jax_llada.init_params(jax.random.key(0), jcfg)
    cfg = llada.LLaDAConfig(**dataclasses.asdict(jcfg))
    model = MMadaModel(cfg=cfg, params=params_from_jax(jax.device_get(jparams), cfg, device="cpu"),
                       vocab=tiny_layout(**VOCAB))
    return JaxMMadaModel(cfg=jcfg, params=jparams, vocab=jvocab), model


def _close(got, want, **tol):
    np.testing.assert_allclose(np.asarray(got.detach() if hasattr(got, "detach") else got),
                               np.asarray(want), **(tol or TOL))


@pytest.mark.parametrize("num_buckets", [4, 10])
def test_mask_ratio_bucket_stats_matches_jax(num_buckets):
    rng = np.random.default_rng(1)
    b, l, v = 6, 12, 40
    logits = rng.standard_normal((b, l, v)).astype(np.float32) * 3
    labels = rng.integers(0, v, (b, l))
    labels[rng.random((b, l)) < 0.2] = -100
    # rows from nearly clean to nearly all masked: several buckets, one empty
    masked = rng.random((b, l)) < np.linspace(0.05, 0.95, b)[:, None]
    want = jax_diag.mask_ratio_bucket_stats(jnp.asarray(logits), jnp.asarray(labels),
                                            jnp.asarray(masked), num_buckets)
    got = diagnostics.mask_ratio_bucket_stats(torch.from_numpy(logits), torch.from_numpy(labels),
                                              torch.from_numpy(masked), num_buckets)
    assert set(got) == set(want)
    assert (np.asarray(want["bucket_tokens"]) == 0).any()
    for k in want:
        assert got[k].shape == (num_buckets,)
        _close(got[k], want[k])


def test_soft_target_cross_entropy_matches_jax():
    rng = np.random.default_rng(2)
    b, l, v, c = 3, 9, 30, 12
    logits = rng.standard_normal((b, l, v)).astype(np.float32)
    targets = rng.integers(0, c, (b, l))
    targets[0, 5:] = -100
    soft = rng.random((b, l - 1, c)).astype(np.float32)
    soft /= soft.sum(-1, keepdims=True)
    want = jax_losses.soft_target_cross_entropy(jnp.asarray(logits), jnp.asarray(targets),
                                                jnp.asarray(soft))
    got = losses.soft_target_cross_entropy(torch.from_numpy(logits), torch.from_numpy(targets),
                                           torch.from_numpy(soft))
    _close(got, want)


def test_weighted_t2i_loss_and_weights_match_jax():
    rng = np.random.default_rng(3)
    b, l, v, seq = 4, 16, 50, 5
    t = rng.random(b).astype(np.float32)
    mask = (rng.random((b, l - seq - 1)) < 0.5).astype(np.float32)
    w_jax = jax_losses.get_loss_weight(jnp.asarray(t), jnp.asarray(mask), min_val=0.3)
    w = losses.get_loss_weight(torch.from_numpy(t), torch.from_numpy(mask), min_val=0.3)
    _close(w, w_jax)
    logits = rng.standard_normal((b, l, v)).astype(np.float32)
    labels = rng.integers(0, v, (b, l))
    labels[1, -3:] = -100
    want = jax_losses.weighted_t2i_loss(jnp.asarray(logits), jnp.asarray(labels), seq, w_jax)
    got = losses.weighted_t2i_loss(torch.from_numpy(logits), torch.from_numpy(labels), seq, w)
    _close(got, want)


@pytest.mark.parametrize("mode", ["llada", "reference_stage3"])
def test_forward_process_with_r2i_matches_jax(models, mode):
    """The five outputs of the stage-4 loss on tests/test_r2i_and_eval_driver.py's
    batch (1 t2i, 1 lm, 1 mmu, 2 r2i rows), with lm answer lengths in both
    lm modes."""
    jmodel, model = models
    mask_id = model.vocab.mask_token_id
    rng = np.random.default_rng(0)
    bt, bl, bm, br, length = 1, 1, 1, 2, 20
    ids = rng.integers(3, 200, size=(bt + bl + bm + br, length))
    ids = np.where(rng.random(ids.shape) < 0.4, mask_id, ids)
    labels = rng.integers(3, 200, size=ids.shape)
    labels[0, :5] = -100
    p = np.full((1, length), 0.5, np.float32)
    ans = np.full((1, length), 4.0, np.float32)
    p2 = np.full((br, length), 0.5, np.float32)
    ans2 = np.full((br, length), 4.0, np.float32)
    kw = dict(batch_size_t2i=bt, batch_size_lm=bl, batch_size_mmu=bm, batch_size_r2i=br,
              max_seq_length=4, lm_loss_mode=mode)
    arrays = dict(p_mask_lm=p, p_mask_mmu=p, p_mask_r2i=p2, answer_lengths=ans,
                  answer_lengths_lm=ans, answer_lengths_r2i=ans2)
    want = jax_losses.forward_process_with_r2i(
        jmodel, jnp.asarray(ids), jnp.asarray(labels),
        **{k: jnp.asarray(v) for k, v in arrays.items()}, **kw)
    got = losses.forward_process_with_r2i(
        model, torch.from_numpy(ids), torch.from_numpy(labels),
        **{k: torch.from_numpy(v) for k, v in arrays.items()}, **kw)
    assert len(got) == len(want) == 5
    _close(got[0], want[0], rtol=1e-4, atol=1e-5)
    for g, w in zip(got[1:], want[1:]):
        assert float(w) > 0
        _close(g, w)


def _proxy(module):
    """The proxy config's architecture (configs/proxy_160m.yaml's `arch`)."""
    return dataclasses.replace(module.llada_8b(), d_model=512, n_heads=4, n_kv_heads=4,
                               n_layers=8, mlp_hidden_size=1536, weight_tying=False,
                               max_sequence_length=2048)


@pytest.mark.parametrize("arch,batch,seq_len", [("8b", 15, 387), ("8b", 2, 8192),
                                                ("proxy", 12, 1091), ("proxy", 15, 387)])
@pytest.mark.parametrize("remat", [False, None, True, "full", "dots"])
def test_train_step_flops_equals_jax(arch, batch, seq_len, remat):
    """The 8B at the stage-1 batch (15 rows of 387) and at 8,192 tokens, the
    proxy at its training frame and at stage 1's: JAX's counts exactly."""
    jcfg, cfg = ((m.llada_8b() if arch == "8b" else _proxy(m)) for m in (jax_llada, llada))
    want = jax_flops.train_step_flops(jcfg, batch, seq_len, remat=remat)
    got = flops.train_step_flops(cfg, batch, seq_len, remat=remat)
    assert got == want
    assert got[1] >= got[0] > 0


def test_h100_peak_is_the_smokes_bound():
    import chip_smoke

    assert flops.H100_BF16_PEAK == chip_smoke.PEAK_BF16_FLOPS == 989e12


def test_eval_image_corruption_is_deterministic_and_follows_its_ratios():
    rng = np.random.default_rng(5)
    tokens = torch.from_numpy(rng.integers(0, 64, (8, 64)))
    mask_id = 99
    a = masking.eval_image_corruption(7, tokens, mask_id)
    b = masking.eval_image_corruption(7, tokens, mask_id)
    other = masking.eval_image_corruption(8, tokens, mask_id)
    for x, y in zip(a, b):
        assert torch.equal(x, y)
    assert not torch.equal(a[0], other[0])
    ids, labels, ratio = a
    masked = ids == mask_id
    # the labels hold the tokens exactly where the frame is masked
    assert torch.equal(labels[masked], tokens[masked])
    assert (labels[~masked] == masking.IGNORE_ID).all()
    # without an override, each row masks round(n * schedule(t)) tokens, t
    # the generator's first draw
    t = torch.rand((8,), generator=torch.Generator().manual_seed(7))
    want = torch.clamp(torch.round(64 * cosine_schedule(t)), min=1)
    assert torch.equal(masked.sum(1), want.long())
    assert torch.equal(ratio, cosine_schedule(t))

    ratios = [0.25, 0.5, 1.0]
    ids, labels, ratio = masking.eval_image_corruption(3, tokens, mask_id, ratios)
    assert set(ratio.tolist()) <= set(ratios) and len(set(ratio.tolist())) > 1
    assert torch.equal((ids == mask_id).sum(1), torch.round(64 * ratio).long())
    again = masking.eval_image_corruption(3, tokens, mask_id, ratios)
    assert torch.equal(ids, again[0])


def test_profiling_trace_holds_the_annotated_span(tmp_path):
    """`trace` on the CPU writes a Chrome trace whose span of `annotate`
    holds the ops run inside it; `step_timer` and `device_memory_stats`
    answer without a card."""
    x = torch.randn(64, 64)
    with profiling.trace(str(tmp_path), cuda=False) as prof:
        with profiling.annotate("my_step"):
            y = x @ x
        with profiling.step_timer(sync_on={"y": y}) as timed:
            (y @ x).sum()
    assert timed["seconds"] > 0
    events = json.load(open(os.path.join(tmp_path, "trace.json")))["traceEvents"]
    span = [e for e in events if e.get("name") == "my_step"]
    assert len(span) == 1
    lo, hi = span[0]["ts"], span[0]["ts"] + span[0]["dur"]
    inside = [e["name"] for e in events if e.get("ph") == "X" and lo <= e.get("ts", -1) < hi
              and e.get("name") != "my_step"]
    assert any("mm" in n for n in inside), inside
    assert "my_step" in {e.key for e in prof.key_averages()}
    assert profiling.device_memory_stats() == {}
    profiling.enable_nan_debugging(True)
    assert torch.is_anomaly_enabled()
    profiling.enable_nan_debugging(False)
    assert not torch.is_anomaly_enabled()
