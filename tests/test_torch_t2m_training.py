"""The port's text-to-motion training against the JAX package.

One t2m train step (full fine-tuning) and one LoRA step on a batch the JAX
package corrupted, against JAX's `make_t2m_train_step` /
`make_t2m_lora_train_step` on the same weights: loss, `mask_prob` and the
gradient norm within 1e-5, every trained weight after the update within
1e-5, without and with the frames' masks in the attention. LoRA's `merge` /
`apply_trainable` and the optimizer's decay mask on the trainable tree equal
JAX's; the three motion datasets read the same samples from the same files;
`train_torch.py training.task=t2m` saves and resumes into the uninterrupted
run, and `train_motion_vq_torch.py` trains, saves and loads back.
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
from mmada_tpu.data import motion as jax_motion_data
from mmada_tpu.models import llada as jax_llada
from mmada_tpu.models import lora as jax_lora
from mmada_tpu.models.mmada import MMadaModel as JaxMMadaModel
from mmada_tpu.sampling.schedules import cosine_schedule as jax_cosine
from mmada_tpu.training import losses as jax_losses
from mmada_tpu.training import masking as jax_masking
from mmada_tpu.training import optimizers as jax_optimizers
from mmada_tpu.training import t2m as jax_t2m
from mmada_tpu.training.train_step import TrainState as JaxTrainState
from mmada_tpu_torch.checkpoints.from_jax import named_from_jax, params_from_jax
from mmada_tpu_torch.checkpoints.manager import flatten, load_params_only
from mmada_tpu_torch.core.config import load_config
from mmada_tpu_torch.core.vocab import tiny_layout
from mmada_tpu_torch.data import motion as motion_data
from mmada_tpu_torch.models import llada
from mmada_tpu_torch.models import lora as lora_mod
from mmada_tpu_torch.models.mmada import MMadaModel
from mmada_tpu_torch.prompting.universal import ByteTokenizer, SpecialIds, UniversalPrompting
from mmada_tpu_torch.training import losses, optimizers, t2m
from mmada_tpu_torch.training.train_step import TrainState

LR = 1e-3
N_MOTION = 8
TEXT_LEN = 8
TINY = "configs/tiny_test.yaml"
SP = dict(soi=230, eoi=231, t2i=232, mmu=233, r2i=234, t2m=235, som=236, eom=237, bos=1, eos=2)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _vocabs():
    kw = dict(text_vocab_size=256, image_codebook_size=32, motion_codebook_size=16,
              motion_special=2)
    return jax_tiny_layout(**kw), tiny_layout(**kw)


@pytest.fixture(scope="module")
def models():
    jvocab, vocab = _vocabs()
    jcfg = jax_llada.tiny_config(vocab_size=jvocab.total_vocab_size, d_model=32, n_heads=2,
                                 n_layers=2, mlp_hidden_size=64)
    jcfg = dataclasses.replace(jcfg, mask_token_id=jvocab.mask_token_id)
    jmodel = JaxMMadaModel(cfg=jcfg, params=jax_llada.init_params(jax.random.key(0), jcfg),
                           vocab=jvocab)
    return jmodel, llada.LLaDAConfig(**dataclasses.asdict(jcfg)), vocab


def _pair(models, masked):
    """(JAX model, port model) on the same weights; `masked` turns the
    frames' masks on in both."""
    jmodel, cfg, vocab = models
    if masked:
        jmodel = dataclasses.replace(jmodel, cfg=dataclasses.replace(
            jmodel.cfg, attention_bias_enabled=True))
        cfg = dataclasses.replace(cfg, attention_bias_enabled=True)
    params = params_from_jax(jax.device_get(jmodel.params), cfg, device="cpu")
    return jmodel, MMadaModel(cfg=cfg, params=params, vocab=vocab)


def _batch(vocab, seed=0):
    """Clean t2m frames (numpy) as JAX's training tests build them: short
    captions, so the frames carry pads."""
    prompting = UniversalPrompting(ByteTokenizer(), SpecialIds(pad=vocab.pad_token_id, **SP),
                                   max_text_len=TEXT_LEN, cond_dropout_prob=0.0)
    rng = np.random.default_rng(seed)
    codes = rng.integers(0, 18, size=(3, N_MOTION))
    fused = t2m.map_motion_tokens(codes, vocab)
    ids, masks, labels = prompting((["walk", "run", "hop"], fused, fused), "t2m", dropout=False)
    return {"input_ids": ids, "labels": labels, "attention_mask": masks}, prompting.max_text_len


def _jax_corrupted(jvocab, batch, text_len, key):
    """JAX's step corruption of `batch` under `key` (its loss_fn's), as torch."""
    ids = jnp.asarray(batch["input_ids"])
    span = slice(text_len + 1, ids.shape[1] - 1)
    noisy_span, _, mask_prob = jax_masking.mask_image_tokens(
        key, ids[:, span], jvocab.mask_token_id, mask_schedule=jax_cosine)
    noisy = np.asarray(ids.at[:, span].set(noisy_span)).astype(np.int64)
    return {"input_ids": torch.from_numpy(noisy),
            "labels": torch.from_numpy(batch["labels"].astype(np.int64)),
            "attention_mask": torch.from_numpy(batch["attention_mask"].astype(np.int64)),
            "mask_prob": torch.from_numpy(np.array(mask_prob))}


def _check_metrics(m, jm):
    for k in ("loss", "loss_t2m", "mask_prob", "grad_norm"):
        np.testing.assert_allclose(float(m[k]), float(jm[k]), rtol=1e-5, atol=1e-6, err_msg=k)
    assert float(m["skipped_nonfinite"]) == float(jm["skipped_nonfinite"]) == 0.0


@pytest.mark.parametrize("masked", [False, True], ids=["no-mask", "mask"])
def test_t2m_train_step_matches_jax(models, masked):
    """Full fine-tuning, one step (JAX's `adamw(lr, params_for_mask=...)`,
    clip 1.0, decay 0.01): metrics and every weight after the update."""
    jmodel, model = _pair(models, masked)
    batch, text_len = _batch(model.vocab)
    sc = dict(batch_size=3, max_text_len=text_len, num_motion_tokens=N_MOTION)
    jopt = jax_optimizers.adamw(LR, params_for_mask=jmodel.params)
    jstate = JaxTrainState.create(jmodel.params, jopt)
    jstep = jax.jit(jax_t2m.make_t2m_train_step(jmodel, jopt, jax_t2m.T2MStepConfig(**sc)))
    key = jax.random.key(11)
    jstate, jm = jstep(jstate, {k: jnp.asarray(v) for k, v in batch.items()}, key)

    opt = optimizers.AdamW(LR)
    state = TrainState.create(model.params, opt)
    step = t2m.make_t2m_train_step(model, opt, t2m.T2MStepConfig(**sc))
    state, m = step.apply(state, _jax_corrupted(jmodel.vocab, batch, text_len, key))
    _check_metrics(m, jm)
    assert int(state.step) == int(jstate.step) == 1
    want = named_from_jax(jax.device_get(jstate.params), device="cpu")
    for name, t in llada.named_leaves(state.params):
        torch.testing.assert_close(t, want[name], rtol=1e-5, atol=1e-5, msg=name)


def _lora_pair(jmodel, lcfg):
    """JAX adapters with a random B (a zero B leaves A's gradient 0), and the
    port's copy of them."""
    adapters = jax_lora.init_lora(jax.random.key(1), jmodel.params, lcfg)
    for i, name in enumerate(sorted(adapters["blocks"])):
        b = adapters["blocks"][name]["b"]
        adapters["blocks"][name]["b"] = 0.05 * jax.random.normal(jax.random.key(100 + i), b.shape)
    port = {"blocks": {name: {k: torch.from_numpy(np.array(v)) for k, v in ab.items()}
                       for name, ab in adapters["blocks"].items()}}
    return adapters, port


@pytest.mark.parametrize("masked", [False, True], ids=["no-mask", "mask"])
def test_lora_train_step_matches_jax(models, masked):
    """LoRA (rank 4, alpha 8, the embedding and head trained), one step with
    JAX's `adamw(lr)` on the trainable tree: metrics and every trainable leaf
    after the update; the base weights untouched."""
    jmodel, model = _pair(models, masked)
    lcfg_kw = dict(rank=4, alpha=8.0, train_embeddings=True)
    jl = jax_lora.LoRAConfig(**lcfg_kw)
    adapters, port_adapters = _lora_pair(jmodel, jl)
    batch, text_len = _batch(model.vocab, seed=1)
    sc = dict(batch_size=3, max_text_len=text_len, num_motion_tokens=N_MOTION)
    jopt = jax_optimizers.adamw(LR)
    jstate = JaxTrainState.create(jax_lora.trainable_params(jmodel.params, adapters, jl), jopt)
    jstep = jax.jit(jax_t2m.make_t2m_lora_train_step(jmodel, jopt, jax_t2m.T2MStepConfig(**sc),
                                                     jl))
    key = jax.random.key(5)
    jstate, jm = jstep(jstate, {k: jnp.asarray(v) for k, v in batch.items()}, key,
                       jmodel.params)

    lcfg = lora_mod.LoRAConfig(**lcfg_kw)
    base_q = model.params["blocks"]["q_proj"].clone()
    opt = optimizers.AdamW(LR)
    wte, head = model.params["wte"].clone(), model.params["ff_out"].clone()
    wte0 = wte.clone()
    base = dict(model.params, wte=wte, ff_out=head)
    model = dataclasses.replace(model, params=base)
    state = t2m.lora_state(model.params, port_adapters, lcfg, opt)
    step = t2m.make_t2m_lora_train_step(model, opt, t2m.T2MStepConfig(**sc), lcfg)
    state, m = step.apply(state, _jax_corrupted(jmodel.vocab, batch, text_len, key))
    _check_metrics(m, jm)
    want = jax.device_get(jstate.params)
    got = flatten(state.params)
    assert sorted(got) == ["head", *sorted(f"lora/blocks/{n}/{k}" for n in want["lora"]["blocks"]
                                           for k in ("a", "b")), "wte"]
    for name, t in got.items():
        node = want
        for part in name.split("/"):
            node = node[part]
        torch.testing.assert_close(t, torch.from_numpy(np.array(node)), rtol=1e-5, atol=1e-5,
                                   msg=name)
    # the embedding and head are trained in place; the block weights are frozen
    assert got["wte"].data_ptr() == wte.data_ptr() and not torch.equal(wte, wte0)
    torch.testing.assert_close(model.params["blocks"]["q_proj"], base_q, rtol=0, atol=0)


def test_merge_and_apply_trainable_match_jax(models):
    jmodel, model = _pair(models, False)
    jl = jax_lora.LoRAConfig(rank=4, alpha=8.0, targets=("q_proj", "ff_out", "nope"))
    adapters, port_adapters = _lora_pair(jmodel, jl)
    lcfg = lora_mod.LoRAConfig(rank=4, alpha=8.0, targets=("q_proj", "ff_out", "nope"))
    assert sorted(port_adapters["blocks"]) == ["ff_out", "q_proj"]
    merged = lora_mod.merge(model.params, port_adapters, lcfg)
    want = jax.device_get(jax_lora.merge(jmodel.params, adapters, jl))
    for name in ("q_proj", "ff_out", "k_proj"):
        torch.testing.assert_close(merged["blocks"][name],
                                   torch.from_numpy(np.array(want["blocks"][name])),
                                   rtol=1e-6, atol=1e-7)
    trainable = lora_mod.trainable_params(model.params, port_adapters, lcfg)
    eff = lora_mod.apply_trainable(model.params, trainable, lcfg)
    jeff = jax.device_get(jax_lora.apply_trainable(
        jmodel.params, jax_lora.trainable_params(jmodel.params, adapters, jl), jl))
    for name, t in llada.named_leaves(eff):
        ref = named_from_jax(jeff, device="cpu")[name]
        torch.testing.assert_close(t, ref, rtol=1e-6, atol=1e-7, msg=name)
    assert eff["wte"] is model.params["wte"]
    assert lora_mod.param_count(port_adapters) == jax_lora.param_count(adapters)
    # A ~ N(0, 0.02) drawn in fp32, B = 0: the merged weights start equal
    fresh = lora_mod.init_lora(model.params, lora_mod.LoRAConfig(rank=4),
                               generator=torch.Generator().manual_seed(0))
    assert all(float(ab["b"].abs().max()) == 0 for ab in fresh["blocks"].values())
    assert 0.015 < float(fresh["blocks"]["q_proj"]["a"].std()) < 0.025
    torch.testing.assert_close(lora_mod.merge(model.params, fresh, lcfg)["blocks"]["q_proj"],
                               model.params["blocks"]["q_proj"], rtol=0, atol=0)


def test_decay_mask_matches_jax_on_trainable_tree(models):
    """The no-decay mask on the LoRA trainable tree (`lora/blocks/*/a|b`,
    `wte`, `head`) and on the full model equals JAX's `decay_mask`."""
    jmodel, model = _pair(models, False)
    jl = jax_lora.LoRAConfig(rank=4)
    adapters, port_adapters = _lora_pair(jmodel, jl)
    jtree = jax_lora.trainable_params(jmodel.params, adapters, jl)
    jmask = jax.tree_util.tree_leaves_with_path(jax_optimizers.decay_mask(jtree))
    want = {"/".join(str(getattr(k, "key", k)) for k in path): bool(v) for path, v in jmask}
    tree = lora_mod.trainable_params(model.params, port_adapters, lora_mod.LoRAConfig(rank=4))
    assert optimizers.decay_mask(flatten(tree)) == want
    assert want["head"] and not want["wte"] and want["lora/blocks/q_proj/a"]
    full = jax.tree_util.tree_leaves_with_path(jax_optimizers.decay_mask(jmodel.params))
    full = {"/".join(str(getattr(k, "key", k)) for k in path): bool(v) for path, v in full}
    for name, decays in optimizers.decay_mask(dict(llada.named_leaves(model.params))).items():
        assert decays == full[optimizers._kind(name)[0]], name


def test_t2m_losses_match_jax():
    rng = np.random.default_rng(0)
    logits = rng.normal(size=(3, 10, 18)).astype(np.float32)
    labels = rng.integers(0, 18, size=(3, 10))
    labels[rng.random((3, 10)) < 0.3] = -100
    masked = rng.random((3, 10)) < 0.5
    p_mask = np.repeat(rng.uniform(0.1, 1.0, size=(3, 1)), 10, axis=1).astype(np.float32)
    ans = np.full((3, 10), 4.0, np.float32)
    got = t2m.t2m_loss(torch.from_numpy(logits), torch.from_numpy(labels),
                       torch.from_numpy(masked))
    want = jax_t2m.t2m_loss(jnp.asarray(logits), jnp.asarray(labels), jnp.asarray(masked))
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)
    got = losses.t2m_loss(*(torch.from_numpy(a) for a in (logits, labels, masked, p_mask, ans)))
    want = jax_losses.t2m_loss(*(jnp.asarray(a) for a in (logits, labels, masked, p_mask, ans)))
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)
    codes = np.array([[0, 5, 15, 16, 17]])
    jvocab, vocab = _vocabs()
    np.testing.assert_array_equal(t2m.map_motion_tokens(codes, vocab),
                                  np.asarray(jax_t2m.map_motion_tokens(jnp.asarray(codes), jvocab)))
    gen = rng.integers(0, 16, size=(2, 8))
    assert t2m.token_range_sanity(torch.from_numpy(gen), vocab) == \
        jax_t2m.token_range_sanity(jnp.asarray(gen), jvocab)


# ----------------------------------------------------------------- data

def _motion_root(tmp_path):
    root = tmp_path / "humanml"
    for sub in ("toks", "texts", "new_joint_vecs"):
        (root / sub).mkdir(parents=True)
    rng = np.random.default_rng(0)
    names = []
    for i in range(4):
        name = f"m{i:03d}"
        names.append(name)
        np.save(root / "toks" / f"{name}.npy", rng.integers(0, 16, size=(2, 5 + i)))
        np.save(root / "new_joint_vecs" / f"{name}.npy",
                rng.normal(size=(50 + 10 * i, 7)).astype(np.float32))
        (root / "texts" / f"{name}.txt").write_text(
            f"a person walks {i}#a/DET person/NOUN walks/VERB#0.0#0.0\n"
            f"someone turns#someone/PRON turns/VERB#1.5#3.0\n")
    np.save(root / "Mean.npy", rng.normal(size=7).astype(np.float32))
    np.save(root / "Std.npy", rng.uniform(0.5, 2, size=7).astype(np.float32))
    (root / "train.txt").write_text("\n".join(names + ["missing"]))
    return str(root), str(root / "train.txt")


class _Vectorizer:
    def __getitem__(self, token):
        word, pos = token.split("/")
        h = sum(map(ord, word))
        return np.full(4, h % 13, np.float32), np.eye(15, dtype=np.float32)[len(pos) % 15]


def test_motion_datasets_match_jax(tmp_path):
    """`MotionTokenDataset`, `MotionVQDataset`, `MotionEvalDataset` and the
    caption reader: the same samples as JAX's from the same files."""
    root, split = _motion_root(tmp_path)
    assert motion_data.read_split(split) == jax_motion_data.read_split(split)
    cap = f"{root}/texts/m001.txt"
    assert motion_data.read_caption_file(cap) == jax_motion_data.read_caption_file(cap)
    tok = motion_data.MotionTokenDataset(root, split, "toks", nb_code=16, max_motion_length=10)
    jtok = jax_motion_data.MotionTokenDataset(root, split, "toks", nb_code=16,
                                              max_motion_length=10)
    got, want = iter(tok), iter(jtok)
    for _ in range(12):
        (c, t, n), (jc, jt, jn) = next(got), next(want)
        assert (c, n) == (jc, jn)
        np.testing.assert_array_equal(t, jt)
    vq = motion_data.MotionVQDataset(root, split, window_size=16, min_motion_len=40)
    jvq = jax_motion_data.MotionVQDataset(root, split, window_size=16, min_motion_len=40)
    assert len(vq) == len(jvq) == 4
    got, want = iter(vq), iter(jvq)
    for _ in range(6):
        np.testing.assert_array_equal(next(got), next(want))
    np.testing.assert_array_equal(vq.denormalize(vq[0] * 0), jvq.denormalize(jvq[0] * 0))
    ev = motion_data.MotionEvalDataset(root, split, _Vectorizer(), max_text_len=3,
                                       min_motion_len=40, max_motion_length=96)
    jev = jax_motion_data.MotionEvalDataset(root, split, _Vectorizer(), max_text_len=3,
                                            min_motion_len=40, max_motion_length=96)
    assert len(ev) == len(jev) == 8
    for i in range(len(ev)):
        a, b = ev[i], jev[i]
        assert sorted(a) == sorted(b)
        for k in a:
            np.testing.assert_array_equal(np.asarray(a[k]), np.asarray(b[k]), err_msg=k)


# ------------------------------------------------------------ the CLIs

def _t2m_cfg(tmp_path, *overrides):
    import train_torch

    return load_config(TINY, reader=train_torch._yaml, overrides=[
        "device=cpu", "training.task=t2m", "dataset.synthetic=true",
        "model.mmada.motion_vocab_size=32", f"dataset.max_motion_length={N_MOTION}",
        "training.batch_size_t2m=2", "experiment.log_every=1",
        f"experiment.output_dir={tmp_path / 'out'}", "model.mmada.attention_bias_enabled=true",
        *overrides])


@pytest.mark.parametrize("lora", [False, True], ids=["full", "lora"])
def test_train_t2m_saves_and_resumes_into_the_uninterrupted_run(tmp_path, lora):
    """`train_torch.run` with `training.task=t2m` (synthetic codes, masks in
    the attention): 2 steps saving each, then a resume to 3 equals 3 steps
    in one go, weights and optimizer state; the metrics lines count 1-3."""
    import train_torch

    extra = ["training.lora.rank=4", "training.lora.alpha=8"] if lora else []
    straight = train_torch.run(_t2m_cfg(tmp_path / "a", "training.max_train_steps=3",
                                        "experiment.save_every=0", *extra))
    assert not list((tmp_path / "a" / "out").glob("checkpoint-*"))
    first = train_torch.run(_t2m_cfg(tmp_path / "b", "training.max_train_steps=2",
                                     "experiment.save_every=1", *extra))
    assert first.model.cfg.attention_bias_enabled and first.model.vocab.motion_codebook_size == 32
    resumed = train_torch.run(_t2m_cfg(tmp_path / "b", "training.max_train_steps=3",
                                       "experiment.save_every=1",
                                       "experiment.resume_from_checkpoint=latest", *extra))
    assert [h["step"] for h in resumed.history] == [3]
    out = tmp_path / "b" / "out"
    steps = [json.loads(ln)["step"] for ln in (out / "metrics.jsonl").read_text().splitlines()]
    assert steps == [1, 2, 3] and (out / "checkpoint-3" / "metadata.json").exists()
    fa, fb = flatten(straight._payload()), flatten(resumed._payload())
    assert sorted(fa) == sorted(fb)
    for k in fa:
        torch.testing.assert_close(fa[k], fb[k], rtol=0, atol=0, msg=k)
    np.testing.assert_allclose(straight.history[-1]["loss"], resumed.history[-1]["loss"],
                               rtol=0)
    if lora:
        assert "lora/blocks/q_proj/a" in flatten(resumed.state.params)


def test_train_motion_vq_cli(tmp_path):
    """`train_motion_vq_torch.train` (synthetic windows at the tiny config):
    finite losses and perplexity a logged step, the weights saved by
    `save_params_only` and read back by `load_params_only` and the loader's
    `build_motion_vq`; the evaluator stays refused (A.13)."""
    import train_motion_vq_torch
    import train_torch
    from mmada_tpu_torch.models import motion_vq
    from mmada_tpu_torch.serve.loader import build_motion_vq

    out = tmp_path / "vq"
    cfg = load_config(TINY, reader=train_torch._yaml, overrides=[
        "device=cpu", "dataset.synthetic=true", "training.max_train_steps=3",
        "training.batch_size=4", "training.log_every=1", "dataset.window_size=16",
        f"experiment.output_dir={out}"])
    vq, mcfg, history = train_motion_vq_torch.train(cfg)
    assert [h["step"] for h in history] == [0, 1, 2]
    assert all(np.isfinite([h["loss"], h["perplexity"], h["recon"], h["vel"], h["commit"]]).all()
               for h in history)
    assert mcfg == motion_vq.tiny_motion_cfg()
    assert (out / "checkpoint-3" / "metadata.json").exists()
    fresh = motion_vq.init_motion_vq(mcfg, device="cpu", generator=torch.Generator().manual_seed(5))
    load_params_only(str(out / "motion_vq"), fresh)
    for (k, a), (_, b) in zip(vq.state_dict().items(), fresh.state_dict().items()):
        torch.testing.assert_close(a, b, rtol=0, atol=0, msg=k)
    assert float(vq.codebook.detach().abs().sum()) > 0  # seeded from the first batch
    tiny = [f"model.motion_vq_model.{k}={v}" for k, v in dataclasses.asdict(mcfg).items()
            if k in ("pose_dim", "code_dim", "nb_code", "width", "down_t", "depth",
                     "dilation_growth_rate")]
    loaded, _ = build_motion_vq(load_config(TINY, reader=train_torch._yaml, overrides=[
        *tiny, f"model.motion_vq_model.pretrained_path={out / 'motion_vq'}"]), device="cpu")
    torch.testing.assert_close(loaded.codebook, vq.codebook, rtol=0, atol=0)
    with pytest.raises(NotImplementedError, match="A.13"):
        train_motion_vq_torch.train(load_config(TINY, reader=train_torch._yaml, overrides=[
            "device=cpu", "dataset.synthetic=true", "eval.run_vq_eval=true"]))


def test_motion_port_imports_without_jax_or_the_jax_package():
    """No file of the port, no `*_torch.py` script and not `chip_smoke.py`
    imports jax or the JAX package (a scan of their import lines); in a fresh
    interpreter where neither can be imported, the motion modules import and
    run at tiny size: the VQ-VAE's encode and decode, the t2m frame and
    sampler, a LoRA merge, the two training command lines' modules."""
    import pathlib
    import re
    import subprocess
    import sys

    root = pathlib.Path(__file__).resolve().parents[1]
    files = [*root.glob("mmada_tpu_torch/**/*.py"), *root.glob("*_torch.py"),
             root / "chip_smoke.py"]
    pattern = re.compile(r"^\s*(import|from)\s+(jax|jaxlib|mmada_tpu)(\.|\s|$)", re.M)
    offenders = [str(f.relative_to(root)) for f in files if pattern.search(f.read_text())]
    assert "train_motion_vq_torch.py" in {f.name for f in files} and not offenders
    code = (
        "import sys\n"
        "for m in ('jax', 'jaxlib', 'mmada_tpu'):\n"
        "    sys.modules[m] = None\n"
        "import numpy as np, torch\n"
        "import train_torch, train_motion_vq_torch, chip_smoke\n"
        "from mmada_tpu_torch.models import motion_vq, lora, llada\n"
        "from mmada_tpu_torch.data import motion, synthetic\n"
        "from mmada_tpu_torch.training import t2m\n"
        "from mmada_tpu_torch.checkpoints import motion_import\n"
        "from mmada_tpu_torch.core.vocab import tiny_layout\n"
        "from mmada_tpu_torch.models.mmada import MMadaModel\n"
        "from mmada_tpu_torch import entry\n"
        "cfg = motion_vq.tiny_motion_cfg()\n"
        "vq = motion_vq.init_motion_vq(cfg, device='cpu', generator=torch.Generator().manual_seed(0))\n"
        "x = torch.from_numpy(synthetic.motion_clip(1, length=32, pose_dim=cfg.pose_dim))[None]\n"
        "codes = motion_vq.encode(vq, cfg, x)\n"
        "assert motion_vq.decode(vq, cfg, codes).shape == x.shape\n"
        "vocab = tiny_layout(text_vocab_size=300).with_motion(32)\n"
        "m = MMadaModel.init(llada.tiny_config(vocab_size=vocab.total_vocab_size), vocab,\n"
        "                    device='cpu', generator=torch.Generator().manual_seed(0))\n"
        "from mmada_tpu_torch.prompting.universal import SpecialIds\n"
        f"sp = SpecialIds(pad=vocab.pad_token_id, **{SP!r})\n"
        "out = entry.serve_t2m(m, ['walk'], device='cpu', num_motion_tokens=4, max_text_len=8,\n"
        "                      timesteps=2, temperature=0.0, greedy=True, special_ids=sp)\n"
        "assert out.shape == (1, 4)\n"
        "ad = lora.init_lora(m.params, lora.LoRAConfig(rank=2), generator=torch.Generator())\n"
        "assert lora.merge(m.params, ad, lora.LoRAConfig(rank=2))['blocks']['q_proj'].shape\n"
    )
    env = dict(os.environ, PYTHONPATH=str(root))
    proc = subprocess.run([sys.executable, "-c", code], cwd=root, env=env, capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
