"""The port's training slice against the JAX package, on the CPU.

* each loss on the same logits / labels as the JAX loss, and the chunked
  head equal to the unchunked one;
* the corruption laws (the two packages draw different random bits, so the
  port is held to the laws: counts, labels, prompt positions kept);
* AdamW + global-norm clip + cosine schedule against optax, step by step;
* the train step against JAX's `make_train_step` on the same weights and on
  a batch the JAX package corrupted: loss, gradient norm and the updated
  weights and moments; remat on = off; accumulation against optax
  `MultiSteps`; a non-finite batch skipped on the device;
* `Trainer.prepare_batch` frames against the JAX Trainer's on the same codes.

Everything runs in fp32 (the FP32 policy), where the two packages differ only
by summation order: losses and weights within 1e-5, optimizer arithmetic
within 1e-6.
"""

import dataclasses
import os
import types

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from mmada_tpu.core.config import load_config
from mmada_tpu.core.vocab import tiny_layout as jax_tiny_layout
from mmada_tpu.models import llada as jax_llada
from mmada_tpu.models.mmada import MMadaModel as JaxMMadaModel
from mmada_tpu.prompting.universal import ByteTokenizer as JaxByteTokenizer
from mmada_tpu.prompting.universal import SpecialIds as JaxSpecialIds
from mmada_tpu.prompting.universal import UniversalPrompting as JaxPrompting
from mmada_tpu.training import losses as JL
from mmada_tpu.training import optimizers as jax_optimizers
from mmada_tpu.training import train_step as jax_train_step
from mmada_tpu.training.lr_schedules import get_scheduler as jax_get_scheduler
from mmada_tpu.training.trainer import Trainer as JaxTrainer
from mmada_tpu_torch.checkpoints.from_jax import named_from_jax, params_from_jax
from mmada_tpu_torch.core.vocab import tiny_layout
from mmada_tpu_torch.models import llada
from mmada_tpu_torch.models.mmada import MMadaModel
from mmada_tpu_torch.prompting.universal import ByteTokenizer, SpecialIds, UniversalPrompting
from mmada_tpu_torch.training import losses as L
from mmada_tpu_torch.training import masking, optimizers
from mmada_tpu_torch.training.lr_schedules import get_scheduler
from mmada_tpu_torch.training.train_step import (
    StepConfig,
    TrainState,
    make_train_step,
    per_kind_grad_norms,
    with_grad_accumulation,
)
from mmada_tpu_torch.training.trainer import Trainer

VOCAB = tiny_layout(text_vocab_size=256, image_codebook_size=64)
JVOCAB = jax_tiny_layout(text_vocab_size=256, image_codebook_size=64)
SIZES = dict(batch_size_t2i=2, batch_size_lm=2, batch_size_mmu=2, max_seq_length=8)
LR = 1e-3


def _t(a) -> torch.Tensor:
    """A JAX / numpy array as a torch tensor (ints as int64)."""
    a = np.array(a)
    return torch.from_numpy(a.astype(np.int64) if a.dtype.kind in "iu" else a)


def _np(x) -> np.ndarray:
    return x.detach().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


@pytest.fixture(scope="module")
def models():
    jcfg = jax_llada.tiny_config(vocab_size=JVOCAB.total_vocab_size, d_model=32, n_heads=2,
                                 n_layers=2, mlp_hidden_size=64)
    jcfg = dataclasses.replace(jcfg, mask_token_id=JVOCAB.mask_token_id)
    jmodel = JaxMMadaModel(cfg=jcfg, params=jax_llada.init_params(jax.random.key(0), jcfg),
                           vocab=JVOCAB)
    cfg = llada.LLaDAConfig(**dataclasses.asdict(jcfg))
    return jmodel, cfg


def _port_model(models, remat=False) -> MMadaModel:
    jmodel, cfg = models
    params = params_from_jax(jax.device_get(jmodel.params), cfg, device="cpu")
    return MMadaModel(cfg=cfg, params=params, vocab=VOCAB, remat=remat)


def _masked(models):
    """The same weights with `attention_bias_enabled=True` in both packages."""
    jmodel, cfg = models
    return (dataclasses.replace(jmodel, cfg=dataclasses.replace(jmodel.cfg,
                                                                attention_bias_enabled=True)),
            dataclasses.replace(cfg, attention_bias_enabled=True))


def _toy_batch(seed=0, seq_lm=24, n_img=16):
    """Clean frames as the JAX training tests build them (numpy)."""
    rng = np.random.default_rng(seed)
    bt, bl, bm, text_len = (SIZES[k] for k in ("batch_size_t2i", "batch_size_lm",
                                               "batch_size_mmu", "max_seq_length"))
    l_t2i = text_len + 1 + n_img + 1
    t2i = rng.integers(3, 250, size=(bt, l_t2i))
    t2i[:, text_len + 1:-1] = rng.integers(0, 64, size=(bt, n_img)) + VOCAB.image_offset
    lm = rng.integers(3, 250, size=(bl, seq_lm))
    mmu = rng.integers(3, 250, size=(bm, seq_lm))
    prompt = np.zeros((bm, seq_lm), np.int64)
    prompt[:, :8] = 1

    def pad(x):
        return np.pad(x, ((0, 0), (0, l_t2i - x.shape[1])), constant_values=2)

    return {
        "t2i_input_ids": t2i, "t2i_masks": np.ones((bt, l_t2i), np.int64),
        "lm_input_ids": pad(lm), "lm_labels": pad(lm),
        "mmu_input_ids": pad(mmu), "mmu_prompt_masks": pad(prompt),
        "mmu_labels": np.where(pad(prompt) == 1, -100, pad(mmu)),
    }


def _jax_corrupted(jmodel, batch, key):
    """The JAX train step's own corruption of `batch` under `key`, as torch."""
    prepared = jax_train_step.corrupt_batch(
        jmodel, jax_train_step.StepConfig(**SIZES), {k: jnp.asarray(v) for k, v in batch.items()},
        key)
    return {k: _t(v) for k, v in prepared.items() if v is not None}


# ------------------------------------------------------------------ losses

def _loss_inputs(seed=0, b=3, l=12, v=40):
    rng = np.random.default_rng(seed)
    logits = rng.normal(size=(b, l, v)).astype(np.float32) * 2
    labels = rng.integers(0, v, size=(b, l))
    labels[rng.random((b, l)) < 0.3] = -100
    masked = rng.random((b, l)) < 0.5
    p_mask = np.repeat(rng.uniform(0.1, 1.0, size=(b, 1)), l, axis=1).astype(np.float32)
    ans = np.full((b, l), 5.0, np.float32)
    return logits, labels, masked, p_mask, ans


@pytest.mark.parametrize("kind", ["ce", "t2i", "lm", "lm_answer", "lm_stage3", "answer"])
def test_losses_match_jax(kind):
    arrays = _loss_inputs()
    jx = [jnp.asarray(a) for a in arrays]
    pt = [torch.from_numpy(a) for a in arrays]
    fns = {
        "ce": lambda m, lo, la, ma, p, a: m.masked_cross_entropy(lo, la)[0],
        "t2i": lambda m, lo, la, ma, p, a: m.t2i_loss(lo, la, 4),
        "lm": lambda m, lo, la, ma, p, a: m.lm_loss(lo, la, ma, p),
        "lm_answer": lambda m, lo, la, ma, p, a: m.lm_loss(lo, la, ma, p, a),
        "lm_stage3": lambda m, lo, la, ma, p, a: m.lm_loss(lo, la, ma, p, a,
                                                           mode="reference_stage3"),
        "answer": lambda m, lo, la, ma, p, a: m.answer_loss(lo, la, ma, p, a),
    }
    got, want = fns[kind](L, *pt), fns[kind](JL, *jx)
    np.testing.assert_allclose(_np(got), np.asarray(want), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("chunk,mode,chat_lm", [
    (0, "llada", False), (8, "llada", False), (8, "llada", True), (5, "reference_stage3", True),
])
def test_forward_process_matches_jax(models, chunk, mode, chat_lm):
    """The three task losses of one forward, chunked (L = 21 is not a
    multiple of the chunk) and unchunked, against JAX's unchunked ones; the
    chunked gradients equal the unchunked ones."""
    jmodel, _ = models
    model = _port_model(models)
    rng = np.random.default_rng(7)
    bt, bl, bm, l, msl = 2, 2, 2, 21, 6
    ids = rng.integers(3, 200, size=(6, l))
    ids[rng.random((6, l)) < 0.4] = VOCAB.mask_token_id
    labels = np.full((6, l), -100)
    labels[:bt, msl + 1:l - 1] = rng.integers(0, 64, size=(bt, l - msl - 2)) + VOCAB.image_offset
    labels[bt:] = rng.integers(3, 200, size=(bl + bm, l))
    kw = dict(batch_size_t2i=bt, batch_size_lm=bl, batch_size_mmu=bm, max_seq_length=msl,
              lm_loss_mode=mode)
    extra = dict(p_mask_lm=np.full((bl, l), 0.5, np.float32),
                 p_mask_mmu=np.full((bm, l), 0.4, np.float32),
                 answer_lengths=np.full((bm, l), 5.0, np.float32))
    if chat_lm:
        extra["answer_lengths_lm"] = np.full((bl, l), 3.0, np.float32)
    _, *want = JL.forward_process(jmodel, jnp.asarray(ids), jnp.asarray(labels), **kw,
                                  **{k: jnp.asarray(v) for k, v in extra.items()})
    params = llada.split_layers(model.params)
    model = dataclasses.replace(model, params=params)
    textra = {k: torch.from_numpy(v) for k, v in extra.items()}

    def losses(loss_chunk):
        logits, *parts = L.forward_process(model, _t(ids), _t(labels), **kw, **textra,
                                           loss_chunk=loss_chunk)
        assert (logits is None) == bool(loss_chunk)
        return parts

    got = losses(chunk)
    for g, w in zip(got, want):
        np.testing.assert_allclose(_np(g), np.asarray(w), rtol=1e-5, atol=1e-6)
    if chunk:
        leaves = [t for _, t in llada.named_leaves(params)]
        g1 = torch.autograd.grad(sum(got), leaves)
        g0 = torch.autograd.grad(sum(losses(0)), leaves)
        for a, b in zip(g1, g0):
            torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-6)


# ----------------------------------------------------------------- masking

def test_mask_image_tokens_law():
    g = torch.Generator().manual_seed(0)
    tokens = torch.arange(4 * 16).reshape(4, 16) % 64
    ids, labels, mask_prob = masking.mask_image_tokens(g, tokens, mask_id=999,
                                                       mask_schedule=lambda t: t)
    masked = ids == 999
    want = torch.clamp(torch.round(16 * mask_prob), min=1).long()
    assert torch.equal(masked.sum(1), want)
    assert (labels[~masked] == L.IGNORE_ID).all()
    assert torch.equal(labels[masked], tokens[masked])
    fixed = torch.tensor([0.25, 0.5, 0.75, 1.0])
    ids, _, _ = masking.mask_image_tokens(g, tokens, 999, lambda t: t, mask_prob_override=fixed)
    assert (ids == 999).sum(1).tolist() == [4, 8, 12, 16]
    ids, labels, _ = masking.mask_image_tokens(g, tokens, 999, lambda t: t,
                                               noise_type="random_replace", codebook_size=64)
    assert torch.equal(labels, tokens) and ((ids >= 0) & (ids < 64)).all()


def test_mask_contiguous_region_is_a_rectangle():
    g = torch.Generator().manual_seed(1)
    ids, _, _ = masking.mask_image_tokens(
        g, torch.zeros((3, 64), dtype=torch.long), mask_id=9,
        mask_schedule=lambda t: torch.full_like(t, 0.5), mask_contiguous_region_prob=1.0)
    m = (ids == 9).reshape(3, 8, 8).numpy()
    for b in range(3):
        ys, xs = np.nonzero(m[b])
        assert len(ys) == (ys.max() - ys.min() + 1) * (xs.max() - xs.min() + 1)


def test_mask_text_and_answer_tokens_laws():
    g = torch.Generator().manual_seed(2)
    noisy, p_mask = masking.mask_text_tokens(g, torch.full((512, 128), 5), mask_id=7)
    rate = (noisy == 7).float().mean(1)
    np.testing.assert_allclose(rate.numpy(), p_mask[:, 0].numpy(), atol=0.2)
    assert abs(float(rate.mean() - p_mask[:, 0].mean())) < 0.02
    assert ((p_mask >= 1e-3) & (p_mask <= 1.0)).all()
    ids = torch.arange(20).reshape(2, 10) % 50 + 10
    prompt = torch.zeros((2, 10), dtype=torch.long)
    prompt[:, :4] = 1
    noisy, _, ans = masking.mask_answer_tokens(g, ids, prompt, mask_id=7)
    assert torch.equal(noisy[:, :4], ids[:, :4])
    assert (ans == 6).all()


# --------------------------------------------------------------- optimizer

def test_decay_mask_and_schedules_match_jax(models):
    jmodel, _ = models
    jmask = jax_optimizers.decay_mask(jmodel.params)
    model = _port_model(models)
    mask = optimizers.decay_mask(dict(llada.named_leaves(llada.split_layers(model.params))))
    for name, decay in mask.items():
        if name.startswith("layers."):
            assert decay == jmask["blocks"][name.split(".", 2)[2]], name
        else:
            assert decay == jmask[name], name
    for name in ("constant", "linear", "cosine", "cosine_with_restarts", "polynomial"):
        fn = get_scheduler(name, 1e-4, warmup_steps=10, total_steps=100, min_lr_scale=0.1)
        jfn = jax_get_scheduler(name, 1e-4, warmup_steps=10, total_steps=100, min_lr_scale=0.1)
        for step in (0, 3, 10, 55, 100, 130):
            np.testing.assert_allclose(float(fn(torch.tensor(step))), float(jfn(step)),
                                       rtol=1e-6, atol=1e-12)


def test_adamw_matches_optax():
    """Clip (triggered on some steps) -> Adam -> masked decay -> cosine lr,
    three steps, fp32."""
    rng = np.random.default_rng(3)
    jparams = {
        "wte": rng.normal(size=(6, 4)).astype(np.float32),
        "ln_f": rng.normal(size=(4,)).astype(np.float32),
        "blocks": {"q_proj": rng.normal(size=(2, 4, 4)).astype(np.float32),
                   "attn_norm": rng.normal(size=(2, 4)).astype(np.float32)},
    }
    sched = dict(warmup_steps=1, total_steps=5)
    jopt = jax_optimizers.adamw(jax_get_scheduler("cosine", 0.1, **sched), max_grad_norm=1.0,
                                params_for_mask=jparams)
    opt = optimizers.AdamW(get_scheduler("cosine", 0.1, **sched), max_grad_norm=1.0)
    jp = jax.tree.map(jnp.asarray, jparams)
    jstate = jopt.init(jp)
    params = named_from_jax(jparams, device="cpu")
    state = opt.init(params)
    for step, scale in enumerate((3.0, 0.05, 1.0)):
        jg = jax.tree.map(lambda a: jnp.asarray(rng.normal(size=a.shape) * scale, jnp.float32),
                          jparams)
        updates, jstate = jopt.update(jg, jstate, jp)
        jp = optax.apply_updates(jp, updates)
        opt.apply(params, named_from_jax(jax.device_get(jg), device="cpu"), state)
        for name, want in named_from_jax(jax.device_get(jp), device="cpu").items():
            torch.testing.assert_close(params[name], want, rtol=1e-6, atol=1e-6)
    adam = jstate[1][0]
    for ours, theirs in ((state["mu"], adam.mu), (state["nu"], adam.nu)):
        for name, want in named_from_jax(jax.device_get(theirs), device="cpu").items():
            torch.testing.assert_close(ours[name], want, rtol=1e-6, atol=1e-9)
    assert int(state["count"]) == 3


def test_adamw_bf16_matches_optax_bit_for_bit():
    """bf16 weights, gradients and moments (how the card trains the 8B): the
    JAX package's own chain (clip 1.0 -> optax AdamW, lr 1e-4, wd 0.01) and
    the port's AdamW, 5 steps on a 256 x 256 weight and a no-decay vector,
    the clip triggered on some steps and not on others. optax computes every
    op in the leaf's dtype; the port rounds the same way, so weights, mu and
    nu agree bit for bit."""
    rng = np.random.default_rng(11)
    bf16 = dict(device="cpu", dtype=torch.bfloat16)
    jparams = {"blocks": {"q_proj": rng.normal(size=(1, 256, 256)).astype(np.float32)},
               "ln_f": rng.normal(size=(256,)).astype(np.float32)}
    jp = jax.tree.map(lambda a: jnp.asarray(a, jnp.bfloat16), jparams)
    jopt = jax_optimizers.adamw(1e-4, max_grad_norm=1.0, weight_decay=0.01,
                                params_for_mask=jp)
    jstate = jopt.init(jp)
    params = named_from_jax(jax.device_get(jp), **bf16)
    assert all(t.dtype == torch.bfloat16 for t in params.values())
    opt = optimizers.AdamW(1e-4, max_grad_norm=1.0, weight_decay=0.01)
    state = opt.init(params)
    for scale in (1.0, 0.3, 2.0, 1e-3, 1.0):   # global norm 1e-3 x 256: no clip
        jg = jax.tree.map(
            lambda a: jnp.asarray(rng.normal(size=a.shape) * scale, jnp.bfloat16), jparams)
        updates, jstate = jopt.update(jg, jstate, jp)
        jp = optax.apply_updates(jp, updates)
        opt.apply(params, named_from_jax(jax.device_get(jg), **bf16), state)
        for name, want in named_from_jax(jax.device_get(jp), **bf16).items():
            assert torch.equal(params[name], want), name
    adam = jstate[1][0]
    for ours, theirs in ((state["mu"], adam.mu), (state["nu"], adam.nu)):
        for name, want in named_from_jax(jax.device_get(theirs), **bf16).items():
            assert ours[name].dtype == torch.bfloat16 and torch.equal(ours[name], want), name


def test_training_block_max_grad_norm_clips(models):
    """The port's Trainer builds the JAX Trainer's optimizer: from the
    `optimizer` block alone (`mmada_tpu.training.optimizers.from_config`).
    The stage-1 blocks put `max_grad_norm` under `training:`
    (configs/mmada_pretraining_stage1.yaml:63), which neither package reads,
    so both train them without a clip: the port's optimizer has no
    `max_grad_norm`, and two steps on a gradient of norm 10 move the weights
    and moments as optax's chain from the same blocks does. A clip under
    `optimizer.params` is taken: with it a gradient of norm 10 moves them as
    one of norm 1, and as the JAX chain with that clip does."""
    stage1 = load_config(os.path.join(os.path.dirname(__file__), os.pardir, "configs",
                                      "mmada_pretraining_stage1.yaml"))
    optimizer = stage1.get_path("optimizer").to_dict()
    training = stage1.get_path("training").to_dict()
    assert training["max_grad_norm"] == 1 and "max_grad_norm" not in optimizer["params"]
    training.update(batch_size_t2i=0, batch_size_lm=1, batch_size_mmu=0,
                    gradient_accumulation_steps=1)
    lr = {"scheduler": "constant", "params": {"learning_rate": 1e-4}}
    prompting = UniversalPrompting(ByteTokenizer(), _special(VOCAB, SpecialIds), max_text_len=8)

    def built(opt_cfg):
        return Trainer(_port_model(models), prompting, training=training, optimizer=opt_cfg,
                       lr_scheduler=lr).optimizer

    rng = np.random.default_rng(2)
    w = rng.normal(size=(8, 8)).astype(np.float32)
    g = rng.normal(size=(8, 8)).astype(np.float32)
    g = g * (10.0 / np.linalg.norm(g))

    def moved(opt, grad):
        params = {"layers.0.q_proj": torch.from_numpy(w.copy())}
        st = opt.init(params)
        for _ in range(2):
            opt.apply(params, {"layers.0.q_proj": torch.from_numpy(grad)}, st)
        return params["layers.0.q_proj"], st["nu"]["layers.0.q_proj"]

    def jax_moved(opt_cfg, grad):
        jopt = jax_optimizers.from_config(opt_cfg, 1e-4)
        jp = {"blocks": {"q_proj": jnp.asarray(w[None])}}
        jstate = jopt.init(jp)
        for _ in range(2):
            updates, jstate = jopt.update({"blocks": {"q_proj": jnp.asarray(grad[None])}},
                                          jstate, jp)
            jp = optax.apply_updates(jp, updates)
        adam = jstate[-1][0]   # the chain's last link: optax.adamw's Adam state
        return (torch.from_numpy(np.array(jp["blocks"]["q_proj"][0])),
                torch.from_numpy(np.array(adam.nu["blocks"]["q_proj"][0])))

    unclipped = built(optimizer)
    assert unclipped.max_grad_norm is None
    torch.testing.assert_close(moved(unclipped, g), jax_moved(optimizer, g),
                               rtol=1e-6, atol=1e-9)
    explicit = {"name": "adamw", "params": dict(optimizer["params"], max_grad_norm=1.0)}
    clipped = built(explicit)
    assert clipped.max_grad_norm == 1.0
    torch.testing.assert_close(moved(clipped, g), moved(unclipped, g / 10.0),
                               rtol=1e-6, atol=1e-9)
    torch.testing.assert_close(moved(clipped, g), jax_moved(explicit, g), rtol=1e-6, atol=1e-9)
    assert not torch.allclose(moved(clipped, g)[1], moved(unclipped, g)[1])


# -------------------------------------------------------------- train step

def _step_pair(models, key_seed=1, every_k=1, log_norms=False, forward_quantize="none"):
    """(JAX step fn + state, port TrainStep + state) on the same weights."""
    jmodel, _ = models
    jsc = jax_train_step.StepConfig(**SIZES, log_param_grad_norms=log_norms,
                                    forward_quantize=forward_quantize)
    jopt = jax_train_step.with_grad_accumulation(
        jax_optimizers.adamw(LR, params_for_mask=jmodel.params), every_k)
    jstate = jax_train_step.TrainState.create(jmodel.params, jopt)
    jstep = jax.jit(jax_train_step.make_train_step(jmodel, jopt, jsc))
    model = _port_model(models)
    opt = with_grad_accumulation(optimizers.AdamW(LR), every_k)
    state = TrainState.create(model.params, opt)
    step = make_train_step(model, opt, StepConfig(**SIZES, log_param_grad_norms=log_norms,
                                                  forward_quantize=forward_quantize))
    return (jstep, jstate), (step, state)


def _assert_params_close(state, jstate):
    for name, want in named_from_jax(jax.device_get(jstate.params), device="cpu").items():
        torch.testing.assert_close(dict(llada.named_leaves(state.params))[name], want,
                                   rtol=1e-5, atol=1e-5)


def test_train_step_matches_jax(models):
    """One step on a batch the JAX package corrupted: loss, its parts and the
    gradient norm within 1e-5, every weight after the update within 1e-5."""
    (jstep, jstate), (step, state) = _step_pair(models, log_norms=True)
    batch = _toy_batch()
    key = jax.random.key(42)
    jstate, jm = jstep(jstate, {k: jnp.asarray(v) for k, v in batch.items()}, key)
    state, m = step.apply(state, _jax_corrupted(models[0], batch, key))
    for k in ("loss", "loss_t2i", "loss_lm", "loss_mmu", "grad_norm", "mask_prob"):
        np.testing.assert_allclose(float(m[k]), float(jm[k]), rtol=1e-5, atol=1e-6, err_msg=k)
    kinds = [k for k in jm if k.startswith("grad_norm/")]
    assert sorted(kinds) == sorted(k for k in m if k.startswith("grad_norm/"))
    for k in kinds:
        np.testing.assert_allclose(float(m[k]), float(jm[k]), rtol=1e-5, err_msg=k)
    assert float(m["skipped_nonfinite"]) == 0.0 and int(state.step) == int(jstate.step) == 1
    _assert_params_close(state, jstate)


def test_masked_train_step_matches_jax(models):
    """`attention_bias_enabled=True` with t2i_masks that pad the captions of
    the t2i rows (3 and 5 positions): one step against JAX's
    `make_train_step` on the same corrupted batch, loss, parts and gradient
    norm within 1e-5 and every weight after the update within 1e-5. The pad
    rows get a zero cotangent in both (no loss reads them)."""
    (jstep, jstate), (step, state) = _step_pair(_masked(models))
    batch = _toy_batch(2)
    batch["t2i_masks"][0, :3] = 0
    batch["t2i_masks"][1, :5] = 0
    key = jax.random.key(7)
    jstate, jm = jstep(jstate, {k: jnp.asarray(v) for k, v in batch.items()}, key)
    prepared = _jax_corrupted(models[0], batch, key)
    assert (prepared["t2i_masks"] == 0).sum() == 8
    state, m = step.apply(state, prepared)
    for k in ("loss", "loss_t2i", "loss_lm", "loss_mmu", "grad_norm"):
        np.testing.assert_allclose(float(m[k]), float(jm[k]), rtol=1e-5, atol=1e-6, err_msg=k)
    _assert_params_close(state, jstate)
    # the masks reach attention: the unmasked step computes another loss
    (_, _), (step0, state0) = _step_pair(models)
    _, m0 = step0.apply(state0, prepared)
    assert abs(float(m0["loss_t2i"]) - float(m["loss_t2i"])) > 1e-4


def test_w8a8_train_step_matches_jax(models):
    """`forward_quantize="w8a8"`: the block matmuls run the W8A8 forward with
    straight-through gradients. One step on a batch the JAX package
    corrupted: loss, parts and gradient norm within 1e-5 of JAX's
    `make_train_step`, every weight after the update within 1e-5; the tags
    wrap the trainable leaves (no copy) and leave the head alone; the
    quantized forward computes another loss than the plain one."""
    from mmada_tpu_torch.ops.quantization import tag_w8a8_ste

    (jstep, jstate), (step, state) = _step_pair(models, forward_quantize="w8a8")
    tagged = tag_w8a8_ste(state.params)
    assert tagged["layers"][0]["q_proj"].values is state.params["layers"][0]["q_proj"]
    assert tagged["ff_out"] is state.params["ff_out"]
    batch, key = _toy_batch(4), jax.random.key(9)
    prepared = _jax_corrupted(models[0], batch, key)
    (_, _), (plain, _) = _step_pair(models)
    loss_plain, _ = plain.loss(state.params, prepared)
    jstate, jm = jstep(jstate, {k: jnp.asarray(v) for k, v in batch.items()}, key)
    state, m = step.apply(state, prepared)
    for k in ("loss", "loss_t2i", "loss_lm", "loss_mmu", "grad_norm"):
        np.testing.assert_allclose(float(m[k]), float(jm[k]), rtol=1e-5, atol=1e-6, err_msg=k)
    _assert_params_close(state, jstate)
    assert float(loss_plain.detach()) != float(m["loss"])


def test_train_step_remat_equals_no_remat(models):
    prepared = _jax_corrupted(models[0], _toy_batch(1), jax.random.key(3))
    out = []
    for remat in (False, "full"):
        model = _port_model(models, remat=remat)
        opt = optimizers.AdamW(LR)
        state = TrainState.create(model.params, opt)
        state, m = make_train_step(model, opt, StepConfig(**SIZES)).apply(state, prepared)
        out.append((float(m["loss"]), dict(llada.named_leaves(state.params))))
    assert out[0][0] == pytest.approx(out[1][0], rel=1e-6)
    for name, t in out[0][1].items():
        torch.testing.assert_close(out[1][1][name], t, rtol=1e-6, atol=1e-7)


def test_grad_accumulation_matches_optax_multisteps(models):
    """k = 2 over two micro-batches: no update after the first, then the
    update of the mean gradient; weights and AdamW moments as optax's."""
    (jstep, jstate), (step, state) = _step_pair(models, every_k=2)
    before = {n: t.clone() for n, t in llada.named_leaves(state.params)}
    for i in range(2):
        batch, key = _toy_batch(10 + i), jax.random.key(20 + i)
        jstate, _ = jstep(jstate, {k: jnp.asarray(v) for k, v in batch.items()}, key)
        state, _ = step.apply(state, _jax_corrupted(models[0], batch, key))
        if i == 0:
            for name, t in llada.named_leaves(state.params):
                assert torch.equal(t, before[name]), name
        _assert_params_close(state, jstate)
    inner = jstate.opt_state.inner_opt_state[1][0]
    for ours, theirs in ((state.opt_state["inner"]["mu"], inner.mu),
                         (state.opt_state["inner"]["nu"], inner.nu)):
        for name, want in named_from_jax(jax.device_get(theirs), device="cpu").items():
            torch.testing.assert_close(ours[name], want, rtol=1e-5, atol=1e-8)
    assert int(state.opt_state["mini_step"]) == 0 and int(state.step) == 2


def test_nonfinite_batch_leaves_the_state_unchanged(models):
    model = _port_model(models)
    opt = optimizers.AdamW(1e-2)
    step = make_train_step(model, opt, StepConfig(**SIZES))
    state = TrainState.create(model.params, opt)
    prepared = _jax_corrupted(models[0], _toy_batch(), jax.random.key(1))
    state, m1 = step.apply(state, prepared)
    assert float(m1["skipped_nonfinite"]) == 0.0
    with torch.no_grad():
        # poison the [MASK] row, which every corrupted batch reads -> NaN loss
        state.params["wte"][VOCAB.mask_token_id, 0] = float("nan")
    snapshot = {n: t.clone() for n, t in llada.named_leaves(state.params)}
    moments = {k: {n: t.clone() for n, t in state.opt_state[k].items()} for k in ("mu", "nu")}
    count = int(state.opt_state["count"])
    state, m2 = step.apply(state, prepared)
    assert float(m2["skipped_nonfinite"]) == 1.0
    assert int(state.step) == 1 and int(state.opt_state["count"]) == count
    for name, t in llada.named_leaves(state.params):
        assert torch.equal(t.nan_to_num(), snapshot[name].nan_to_num()), name
    for k in ("mu", "nu"):
        for n, t in state.opt_state[k].items():
            assert torch.equal(t, moments[k][n]), (k, n)
    # without the guard the NaN spreads into unrelated weights
    unguarded = make_train_step(model, opt, StepConfig(**SIZES, skip_nonfinite_updates=False))
    state, _ = unguarded.apply(state, prepared)
    assert torch.isnan(state.params["layers"][0]["q_proj"]).any()


def test_trained_weights_are_the_serving_storage(models):
    """The trainable leaves are views of the stacked weights serving reads:
    one step changes what `forward` computes, with no copy back."""
    model = _port_model(models)
    stacked = model.params["blocks"]["q_proj"]
    opt = optimizers.AdamW(LR)
    state = TrainState.create(model.params, opt)
    assert state.params["layers"][1]["q_proj"].data_ptr() == stacked[1].data_ptr()
    before = stacked.clone()
    make_train_step(model, opt, StepConfig(**SIZES)).apply(
        state, _jax_corrupted(models[0], _toy_batch(), jax.random.key(5)))
    assert not torch.equal(stacked, before)
    assert torch.equal(stacked[1], state.params["layers"][1]["q_proj"])


def test_per_kind_grad_norms_sum_layers():
    grads = {"wte": torch.ones(2, 2), "layers.0.q_proj": torch.ones(3),
             "layers.1.q_proj": torch.full((3,), 2.0)}
    norms = per_kind_grad_norms(grads)
    assert set(norms) == {"grad_norm/wte", "grad_norm/blocks/q_proj"}
    assert float(norms["grad_norm/blocks/q_proj"]) == pytest.approx(15 ** 0.5)


def test_unported_modes_raise(models):
    """An unknown `forward_quantize` raises; the remat policies "dots" and
    "auto" (unresolved: "full") now run, with the gradients of remat=False."""
    model = _port_model(models)
    with pytest.raises(ValueError, match="forward_quantize"):
        make_train_step(model, optimizers.AdamW(LR), StepConfig(**SIZES, forward_quantize="w4"))
    ids = torch.arange(8, dtype=torch.long).reshape(2, 4)
    grads = {}
    for mode in (False, "dots", "auto"):
        tree = llada.split_layers(model.params)
        names, leaves = zip(*llada.named_leaves(tree))
        loss = llada.forward(tree, model.cfg, ids, remat=mode).float().square().mean()
        grads[mode] = torch.autograd.grad(loss, leaves)
    for mode in ("dots", "auto"):
        assert all(torch.equal(a, b) for a, b in zip(grads[mode], grads[False])), mode


# ----------------------------------------------------------------- trainer

def _special(vocab, cls):
    t = vocab.text_vocab_size
    return cls(soi=t - 20, eoi=t - 19, t2i=t - 18, mmu=t - 17, r2i=t - 16, t2m=t - 15,
               som=t - 14, eom=t - 13, pad=vocab.pad_token_id, bos=vocab.bos_token_id,
               eos=vocab.eos_token_id)


@pytest.mark.parametrize("chat_lm,pad_loss", [(False, True), (False, False), (True, True)])
def test_prepare_batch_matches_jax_trainer(models, chat_lm, pad_loss):
    """Frames from VQ codes: t2i (with its caption dropout draws), lm and mmu,
    padded to one length, equal to the JAX Trainer's."""
    rng = np.random.default_rng(4)
    codes = rng.integers(0, 64, size=(3, 9))
    raw = {"t2i_flow": {"input_ids": ["a red fox", "", "x" * 30], "image_codes": codes},
           "lm_flow": {"input_ids": ["hello world", "a"]},
           "mmu_flow": {"input_ids": ["what is it?", "cat", "a dog"],
                        "image_codes": codes[::-1]}}
    tr = dict(batch_size_t2i=3, batch_size_lm=2, batch_size_mmu=3, use_chat_lm=chat_lm,
              lm_pad_loss=pad_loss)
    sp = dataclasses.replace(_special(VOCAB, SpecialIds), end_header=40)
    jsp = dataclasses.replace(_special(JVOCAB, JaxSpecialIds), end_header=40)
    model = _port_model(models)
    got = Trainer(model, UniversalPrompting(ByteTokenizer(), sp, max_text_len=12),
                  training=tr).prepare_batch(raw)
    jraw = {k: dict(v) for k, v in raw.items()}
    for k in ("t2i_flow", "mmu_flow"):
        jraw[k]["images"] = jraw[k].pop("image_codes")
    stub = types.SimpleNamespace(
        step_cfg=jax_train_step.StepConfig(
            batch_size_t2i=3, batch_size_lm=2, batch_size_mmu=3, max_seq_length=13,
            use_chat_lm=chat_lm, lm_pad_loss=pad_loss),
        prompting=JaxPrompting(JaxByteTokenizer(), jsp, max_text_len=12),
        model=models[0],
        encode_images=lambda images, keys=None: np.asarray(images) + JVOCAB.image_offset,
    )
    want = JaxTrainer.prepare_batch(stub, jraw)
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(v), err_msg=k)


def test_prepare_batch_refuses_pixels(models):
    """Without MAGVIT-v2 weights a Trainer cannot encode pixel flows."""
    trainer = Trainer(_port_model(models),
                      UniversalPrompting(ByteTokenizer(), _special(VOCAB, SpecialIds),
                                         max_text_len=8),
                      training=dict(batch_size_t2i=1))
    with pytest.raises(ValueError, match="MAGVIT"):
        trainer.prepare_batch({"t2i_flow": {"input_ids": ["a"],
                                            "images": np.zeros((1, 8, 8, 3))}})
