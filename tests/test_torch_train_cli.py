"""The port's training command line and what it stands on, against the JAX
package where it has a counterpart:

* `checkpoints/manager.py`: the state round trip bit for bit in fp32 and
  bf16, rotation by `checkpoints_total_limit`, `latest`, an async save
  invisible to `latest` until `finalize`, and restores that refuse a
  missing key, a shape or a dtype before touching the template.
* `training/ema.py` against JAX's jitted `ema_update` and `training/
  optimizers.Lion` against the JAX package's optax chain, bit for bit in
  fp32 and bf16 (see each test for what differs from XLA and where).
* `remat="dots"`: the train step's loss, gradients and updated weights equal
  to `remat=False`'s; `gradient_checkpointing: auto` resolved by
  `remat_auto.pick_remat` to dots or full by the budget
  (`tests/test_remat_policy.py:131`).
* `Trainer.from_config` against the JAX Trainer built from the same config:
  step config, optimizer hyperparameters, cadences, EMA.
* `resume()` restoring the train state, the EMA and the step; a SIGTERM
  during step 2 saving checkpoint-2 and stopping; the previous handler back.
* `python train_torch.py config=configs/tiny_test.yaml device=cpu
  dataset.synthetic=true ...` in a subprocess, twice: the second run
  resumes at step 2.
"""

import dataclasses
import json
import os
import signal
import subprocess
import sys
import threading

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from mmada_tpu.core.config import load_config as jax_load_config
from mmada_tpu.serve import loader as jax_loader
from mmada_tpu.training import ema as jax_ema
from mmada_tpu.training import optimizers as jax_optimizers
from mmada_tpu.training.lr_schedules import from_config as jax_lr_from_config
from mmada_tpu.training.trainer import Trainer as JaxTrainer
from mmada_tpu_torch.checkpoints import manager
from mmada_tpu_torch.checkpoints.from_jax import named_from_jax
from mmada_tpu_torch.core.config import load_config
from mmada_tpu_torch.core.vocab import tiny_layout
from mmada_tpu_torch.models import llada
from mmada_tpu_torch.models.mmada import MMadaModel
from mmada_tpu_torch.prompting.universal import ByteTokenizer, SpecialIds, UniversalPrompting
from mmada_tpu_torch.serve import loader
from mmada_tpu_torch.training import ema, optimizers
from mmada_tpu_torch.training.lr_schedules import from_config as lr_from_config
from mmada_tpu_torch.training.train_step import StepConfig, TrainState, make_train_step
from mmada_tpu_torch.training.trainer import Trainer

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = os.path.join(REPO, "configs", "tiny_test.yaml")
DTYPES = [(jnp.float32, torch.float32), (jnp.bfloat16, torch.bfloat16)]


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """At these tiny shapes torch's intra-op threads cost more than they
    save, most of all beside other test workers; the setting is restored."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _tree(dtype, seed=0):
    g = torch.Generator().manual_seed(seed)
    return {"params": {"wte": torch.randn(7, 5, generator=g).to(dtype),
                       "layers": [{"q_proj": torch.randn(5, 5, generator=g).to(dtype)}
                                  for _ in range(2)]},
            "opt_state": {"count": torch.tensor(3), "mu": [torch.randn(4, generator=g)]},
            "step": torch.tensor(5, dtype=torch.int32)}


def _zeros_like(tree):
    if isinstance(tree, dict):
        return {k: _zeros_like(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_zeros_like(v) for v in tree]
    return torch.zeros_like(tree)


def _assert_trees_equal(a, b):
    fa, fb = manager.flatten(a), manager.flatten(b)
    assert sorted(fa) == sorted(fb)
    for k in fa:
        assert fa[k].dtype == fb[k].dtype and torch.equal(fa[k], fb[k]), k


# ------------------------------------------------------------- manager

@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("wait", [True, False])
def test_checkpoint_round_trip_bit_for_bit(tmp_path, dtype, wait):
    ckpt = manager.CheckpointManager(str(tmp_path))
    state = _tree(dtype)
    path = ckpt.save(4, state, wait=wait)
    ckpt.finalize()
    assert os.path.exists(os.path.join(path, "metadata.json"))
    template = _zeros_like(state)
    restored, step = ckpt.restore(template)
    assert step == 4 and restored is template
    _assert_trees_equal(template, state)
    assert ckpt.last_save["bytes"] == sum(
        t.numel() * t.element_size() for t in manager.flatten(state).values())


def test_rotation_latest_and_async_visibility(tmp_path):
    out = str(tmp_path)
    ckpt = manager.CheckpointManager(out, total_limit=2)
    state = _tree(torch.bfloat16)
    assert manager.latest_checkpoint(out) is None and ckpt.restore(state) == (None, 0)
    for step in (1, 2, 3):
        ckpt.save(step, state)
    assert [s for s, _ in manager.list_checkpoints(out)] == [2, 3]
    assert not os.path.exists(os.path.join(out, "checkpoint-1"))
    # an async save stays invisible (no metadata.json) until finalize
    before = {k: t.clone() for k, t in manager.flatten(state).items()}
    ckpt.save(4, state, wait=False)
    for t in manager.flatten(state).values():   # the step changes tensors in place
        t.add_(1)
    assert manager.latest_checkpoint(out).endswith("checkpoint-3")
    assert [s for s, _ in manager.list_checkpoints(out)] == [2, 3]
    ckpt.finalize()
    assert manager.latest_checkpoint(out).endswith("checkpoint-4")
    assert [s for s, _ in manager.list_checkpoints(out)] == [3, 4]
    template = _zeros_like(state)
    ckpt.restore(template)
    for k, t in manager.flatten(template).items():   # the snapshot, not the later values
        assert torch.equal(t, before[k]), k
    # a directory without metadata.json (torn) is never resumable
    os.makedirs(os.path.join(out, "checkpoint-9", "state"))
    assert manager.latest_checkpoint(out).endswith("checkpoint-4")


@pytest.mark.parametrize("change", ["missing", "extra", "shape", "dtype"])
def test_restore_refuses_a_mismatch_untouched(tmp_path, change):
    ckpt = manager.CheckpointManager(str(tmp_path))
    ckpt.save(1, _tree(torch.float32))
    template = _zeros_like(_tree(torch.float32))
    if change == "missing":
        template["params"]["extra"] = torch.zeros(2)
    elif change == "extra":
        del template["params"]["wte"]
    elif change == "shape":
        template["params"]["wte"] = torch.zeros(7, 6)
    else:
        template["params"]["wte"] = template["params"]["wte"].to(torch.bfloat16)
    with pytest.raises(ValueError):
        ckpt.restore(template)
    assert all(not t.any() for t in manager.flatten(template).values())


# ------------------------------------------------------------------ EMA

def _ema_pair(dtype, tdtype, steps, **kw):
    rng = np.random.default_rng(0)
    shadow = rng.standard_normal((64, 33)).astype(np.float32)
    bias = rng.standard_normal(33).astype(np.float32)
    jstate = jax_ema.EMAState.create({"w": jnp.asarray(shadow, dtype),
                                      "b": [jnp.asarray(bias, dtype)]})
    update = jax.jit(lambda s, p: jax_ema.ema_update(s, p, **kw))
    state = ema.EMAState.create({"w": torch.tensor(shadow).to(tdtype),
                                 "b": [torch.tensor(bias).to(tdtype)]})
    for _ in range(steps):
        p = rng.standard_normal((64, 33)).astype(np.float32)
        jstate = update(jstate, {"w": jnp.asarray(p, dtype), "b": [jnp.asarray(p[0], dtype)]})
        ema.ema_update(state, {"w": torch.tensor(p).to(tdtype),
                               "b": [torch.tensor(p[0]).to(tdtype)]}, **kw)
        for got, want in ((state.shadow["w"], jstate.shadow["w"]),
                          (state.shadow["b"][0], jstate.shadow["b"][0])):
            assert got.dtype == tdtype
            np.testing.assert_array_equal(got.float().numpy(),
                                          np.asarray(want.astype(jnp.float32)))
    assert int(state.step) == int(jstate.step) == steps and state.step.dtype == torch.int32


@pytest.mark.parametrize("dtype,tdtype", DTYPES)
def test_ema_update_matches_jax_bit_for_bit(dtype, tdtype):
    """The warmup decay over the steps where torch's and XLA's fp32 `pow`
    agree (the first 13; bf16 rounds the decay away, so 40 there), and a
    fixed decay (min_decay = max_decay) over 40 steps."""
    _ema_pair(dtype, tdtype, 40 if tdtype == torch.bfloat16 else 13, max_decay=0.999)
    _ema_pair(dtype, tdtype, 40, max_decay=0.75, min_decay=0.75)


def test_ema_decay_within_one_ulp_of_jax():
    decay = jax.jit(lambda s: jax_ema.ema_decay(s))
    steps = np.arange(1, 400)
    want = np.array([np.float32(decay(jnp.int32(s))) for s in steps])
    got = ema.ema_decay(torch.tensor(steps, dtype=torch.int32)).numpy()
    ulps = np.abs(got.view(np.int32) - want.view(np.int32))
    assert ulps.max() <= 1 and got.dtype == np.float32


# ----------------------------------------------------------------- Lion

def _lion_run(dtype, tdtype, clip, steps=8):
    rng = np.random.default_rng(1)
    jparams = {"wte": rng.standard_normal((40, 8)).astype(np.float32),
               "ln_f": rng.standard_normal(8).astype(np.float32),
               "blocks": {"q_proj": rng.standard_normal((2, 8, 8)).astype(np.float32),
                          "attn_norm": rng.standard_normal((2, 8)).astype(np.float32)}}
    block = {"name": "lion", "params": {"max_grad_norm": clip, "weight_decay": 0.1}}
    sched = {"scheduler": "cosine", "params": {"learning_rate": 1e-3, "warmup_steps": 3}}
    jp = jax.tree.map(lambda a: jnp.asarray(a, dtype), jparams)
    jopt = jax_optimizers.from_config(block, jax_lr_from_config(sched, total_steps=20), params=jp)
    jstate = jopt.init(jp)
    kw = dict(device="cpu", dtype=tdtype)
    params = named_from_jax(jax.device_get(jp), **kw)
    opt = optimizers.from_config(block, lr_from_config(sched, total_steps=20))
    assert isinstance(opt, optimizers.Lion) and opt.beta2 == 0.99
    state = opt.init(params)
    for step in range(steps):
        scale = 1.0 if step % 3 == 0 else 0.01   # the clip triggered on some steps
        jg = jax.tree.map(lambda a: jnp.asarray(rng.standard_normal(a.shape) * scale, dtype),
                          jparams)
        updates, jstate = jopt.update(jg, jstate, jp)
        jp = optax.apply_updates(jp, updates)
        opt.apply(params, named_from_jax(jax.device_get(jg), **kw), state)
    lion = jstate[-1][0]
    return (params, named_from_jax(jax.device_get(jp), **kw), state["mu"],
            named_from_jax(jax.device_get(lion.mu), **kw), int(state["count"]), steps)


@pytest.mark.parametrize("dtype,tdtype", DTYPES)
@pytest.mark.parametrize("clip", [None, 0.5])
def test_lion_matches_optax(dtype, tdtype, clip):
    """Clip -> sign((1 - b1) g + b1 m), m <- (1 - b2) g + b2 m -> masked decay
    -> cosine lr, against the JAX package's optax chain op by op: weights
    and moments bit for bit. With an fp32 clip the moments agree to 1e-6
    (the clip's global norm sums each leaf in fp32 in another order than
    XLA, so it may differ in its last bit) and the weights, which move by
    the update's sign, bit for bit."""
    params, jparams, mu, jmu, count, steps = _lion_run(dtype, tdtype, clip)
    assert count == steps
    for name, want in jparams.items():
        assert params[name].dtype == tdtype and torch.equal(params[name], want), name
    for name, want in jmu.items():
        if clip is not None and tdtype == torch.float32:
            torch.testing.assert_close(mu[name], want, rtol=1e-6, atol=1e-9)
        else:
            assert torch.equal(mu[name], want), name


def test_optimizer_from_config_names():
    assert isinstance(optimizers.from_config({}, 1e-3), optimizers.AdamW)
    with pytest.raises(ValueError, match="unknown optimizer"):
        optimizers.from_config({"name": "sgd"}, 1e-3)


# ---------------------------------------------------------------- remat

VOCAB = tiny_layout()


def _tiny_model(remat=False, seed=0):
    cfg = llada.tiny_config(vocab_size=VOCAB.total_vocab_size)
    cfg = dataclasses.replace(cfg, mask_token_id=VOCAB.mask_token_id)
    return MMadaModel.init(cfg, VOCAB, device="cpu", remat=remat,
                           generator=torch.Generator().manual_seed(seed))


def _lm_batch(seed=0):
    ids = torch.randint(3, 250, (2, 16), generator=torch.Generator().manual_seed(seed))
    return {"lm_input_ids": ids, "lm_labels": ids}


def test_dots_train_step_equals_no_remat():
    sc = StepConfig(batch_size_t2i=0, batch_size_lm=2, batch_size_mmu=0, max_seq_length=4,
                    loss_chunk=8)
    results = {}
    for remat in (False, "dots"):
        model = _tiny_model(remat)
        opt = optimizers.AdamW(1e-3, max_grad_norm=1.0)
        state = TrainState.create(model.params, opt)
        state, metrics = make_train_step(model, opt, sc)(state, _lm_batch(),
                                                         torch.Generator().manual_seed(2))
        results[remat] = (metrics, dict(llada.named_leaves(state.params)))
    (m0, p0), (m1, p1) = results[False], results["dots"]
    assert torch.equal(m0["loss"], m1["loss"]) and torch.equal(m0["grad_norm"], m1["grad_norm"])
    for name, t in p0.items():
        assert torch.equal(t, p1[name]), name


def _prompting(max_text_len=8):
    t = VOCAB.text_vocab_size
    sp = SpecialIds(soi=t - 20, eoi=t - 19, t2i=t - 18, mmu=t - 17, r2i=t - 16, t2m=t - 15,
                    som=t - 14, eom=t - 13, pad=VOCAB.pad_token_id, bos=1, eos=2)
    return UniversalPrompting(ByteTokenizer(), sp, max_text_len=max_text_len,
                              cond_dropout_prob=0.0)


def _lm_flows(n, seed=0):
    rng = np.random.default_rng(seed)
    words = ["red", "fox", "snow", "oil", "lamp", "dusk"]
    return [{"lm_flow": {"input_ids": [" ".join(rng.choice(words, 6)) for _ in range(2)]}}
            for _ in range(n)]


@pytest.mark.parametrize("budget_gb,expect", [(1000, "dots"), (0.0001, "full")])
def test_auto_remat_resolution(monkeypatch, budget_gb, expect):
    """`auto` resolves at the first step by the measured fit, the step runs
    either way, and the resolved step replaces the trampoline."""
    monkeypatch.setenv("MMADA_REMAT_AUTO_BUDGET_GB", str(budget_gb))
    trainer = Trainer(_tiny_model("auto"), _prompting(),
                      training={"batch_size_lm": 2, "max_train_steps": 2},
                      lm_max_seq_length=24, log_every=1)
    assert trainer.train_step == trainer._resolve_auto_remat
    trainer.fit(_lm_flows(2))
    mode, info = trainer.remat_resolved
    assert mode == expect, info
    assert trainer.train_step.model.remat == expect and int(trainer.state.step) == 2
    assert (info["rows"], info["length"]) == (2, 24)
    cfg = trainer.model.cfg
    per_token = 4 * cfg.d_model + 2 * cfg.hidden_size + cfg.d_model + cfg.d_model
    assert info["dots_layer_bytes"] == 2 * 24 * per_token * 4   # fp32 outputs + the input
    assert info["total_bytes"] == (info["allocated_bytes"] + info["grads_bytes"]
                                   + cfg.n_layers * info["dots_layer_bytes"])
    assert all(np.isfinite(h["loss"]) for h in trainer.history)


# -------------------------------------------------------------- trainer

def test_config_trainer_matches_jax_trainer(tmp_path):
    overrides = [
        "dataset.synthetic=true", f"experiment.output_dir={tmp_path / 'out'}",
        "experiment.save_every=7", "experiment.generate_every=5", "experiment.log_every=3",
        "experiment.checkpoints_total_limit=2", "training.max_train_steps=40",
        "training.gradient_accumulation_steps=2", "training.loss_chunk=16",
        "training.lm_coeff=0.3", "training.ema.enabled=true", "training.ema.max_decay=0.99",
        "training.async_checkpointing=true", "mask_schedule.schedule=linear",
        "optimizer.params.max_grad_norm=0.5", "optimizer.params.beta2=0.95",
    ]
    jcfg = jax_load_config(TINY, overrides=overrides)
    jvocab = jax_loader.build_vocab(jcfg)
    jtrainer = JaxTrainer(jcfg, jax_loader.build_model(jcfg, jvocab), jax_loader.build_prompting(
        jcfg, jax_loader.build_text_tokenizer(jcfg), jvocab))
    cfg = load_config(TINY, reader=__import__("train_torch")._yaml,
                      overrides=overrides + ["device=cpu"])
    vocab = loader.build_vocab(cfg)
    trainer = Trainer.from_config(cfg, loader.build_model(cfg, vocab, "cpu"),
                                  loader.build_prompting(cfg, loader.build_text_tokenizer(cfg),
                                                         vocab))
    for f in dataclasses.fields(StepConfig):
        got, want = getattr(trainer.step_cfg, f.name), getattr(jtrainer.step_cfg, f.name)
        if f.name == "mask_schedule":
            assert got.__name__ == want.__name__ == "linear_schedule"
        else:
            assert got == want, f.name
    inner = trainer.optimizer.inner
    jchain = jtrainer.optimizer   # MultiSteps over clip -> adamw
    assert trainer.optimizer.every_k == 2 and isinstance(jchain, optax.MultiSteps)
    assert (inner.beta1, inner.beta2, inner.eps, inner.weight_decay, inner.max_grad_norm) == (
        0.9, 0.95, 1e-8, 0.01, 0.5)
    jlr = jax_lr_from_config(jcfg.lr_scheduler, total_steps=40)
    for count in (0, 3, 10):
        assert float(inner.learning_rate(torch.tensor(count))) == pytest.approx(
            float(jlr(count)), rel=1e-6)
    for name in ("save_every", "generate_every", "log_every", "max_train_steps",
                 "global_step"):
        assert getattr(trainer, name) == getattr(jtrainer, name), name
    assert trainer.ckpt.total_limit == jtrainer.ckpt.total_limit == 2
    assert trainer.ckpt.output_dir == jtrainer.ckpt.output_dir
    assert trainer.async_checkpointing and trainer.ema_state is not None
    assert jtrainer.ema_state is not None and trainer.ema_cfg["max_decay"] == 0.99
    assert trainer.lm_max_seq_length == 32


def _trainer(tmp_path, seed=0, **experiment):
    return Trainer(_tiny_model(seed=seed), _prompting(),
                   training={"batch_size_lm": 2, "max_train_steps": 5,
                             "ema": {"enabled": True, "max_decay": 0.9}},
                   optimizer={"name": "lion", "params": {"max_grad_norm": 1.0}},
                   lm_max_seq_length=24, log_every=1,
                   experiment=dict({"output_dir": str(tmp_path), "save_every": 2}, **experiment))


def test_resume_restores_state_ema_and_step(tmp_path):
    first = _trainer(tmp_path)
    first.max_train_steps = 2
    first.fit(_lm_flows(2))
    assert [s["step"] for s in first.saves] == [2]
    second = _trainer(tmp_path, seed=5)
    assert second.resume() == 2
    _assert_trees_equal(second._payload(), first._payload())
    assert int(second.ema_state.step) == 2 and int(second.state.opt_state["count"]) == 2
    second.fit(_lm_flows(3, seed=1))
    assert second.global_step == 5 and [h["step"] for h in second.history] == [3, 4, 5]
    assert os.path.exists(tmp_path / "checkpoint-4" / "metadata.json")
    lines = (tmp_path / "metrics.jsonl").read_text().splitlines()
    assert [json.loads(ln)["step"] for ln in lines] == [1, 2, 3, 4, 5]
    for key in ("samples_per_sec", "data_time", "batch_time"):
        assert json.loads(lines[-1])[key] > 0


def test_sigterm_saves_and_stops(tmp_path):
    if threading.current_thread() is not threading.main_thread():
        pytest.skip("signal handlers can only be installed on the main thread")
    trainer = _trainer(tmp_path, save_every=0)
    prepare, calls = trainer.prepare_batch, []
    before = signal.getsignal(signal.SIGTERM)

    def prepare_and_signal(raw):
        calls.append(1)
        if len(calls) == 2:   # during step 2
            assert signal.getsignal(signal.SIGTERM) is not before
            os.kill(os.getpid(), signal.SIGTERM)
        return prepare(raw)

    trainer.prepare_batch = prepare_and_signal
    trainer.fit(_lm_flows(5))
    assert trainer.global_step == 2 and len(calls) == 2
    assert [s for s, _ in manager.list_checkpoints(str(tmp_path))] == [2]
    assert trainer.saves[-1]["wait"] is True
    assert signal.getsignal(signal.SIGTERM) is before
    again = _trainer(tmp_path, seed=3)
    assert again.resume() == 2
    _assert_trees_equal(again._payload(), trainer._payload())


# ------------------------------------------------------------------ CLI

def _cli(tmp_path, *extra):
    out = tmp_path / "out"
    argv = [sys.executable, "-B", os.path.join(REPO, "train_torch.py"), f"config={TINY}",
            "device=cpu", "dataset.synthetic=true", "experiment.save_every=1",
            "experiment.log_every=1", f"experiment.output_dir={out}", *extra]
    res = subprocess.run(argv, cwd=REPO, capture_output=True, text=True, timeout=240,
                         env=dict(os.environ, OMP_NUM_THREADS="1"))
    assert res.returncode == 0, res.stderr[-4000:]
    return out, res.stderr


def test_train_torch_cli_saves_and_resumes(tmp_path):
    out, _ = _cli(tmp_path, "training.max_train_steps=2")
    for step in (1, 2):
        meta = json.loads((out / f"checkpoint-{step}" / "metadata.json").read_text())
        assert meta == {"global_step": step}
    assert (out / "config.yaml").exists()
    out, log = _cli(tmp_path, "training.max_train_steps=3",
                    "experiment.resume_from_checkpoint=latest")
    assert "resumed from step 2" in log
    steps = [json.loads(ln)["step"] for ln in (out / "metrics.jsonl").read_text().splitlines()]
    assert steps == [1, 2, 3]
    assert json.loads((out / "checkpoint-3" / "metadata.json").read_text())["global_step"] == 3


@pytest.mark.parametrize("override,item", [("training.task=t2m", "A.12c"),
                                           ("parallel.serving=pipeline", "A.12c")])
def test_unported_training_modes_name_their_item(override, item, monkeypatch):
    """Over more than one rank (a launcher's WORLD_SIZE) t2m training and a
    pipelined model are refused, naming their item; one rank trains them
    (t2m) or serves whole, and `parallel.*` with `distributed.initialize`
    is no longer refused."""
    import train_torch

    cfg = load_config(TINY, reader=train_torch._yaml, overrides=[override])
    train_torch.check_supported(cfg)
    wide = load_config(TINY, reader=train_torch._yaml, overrides=[
        "parallel.tensor=2", "distributed.initialize=true"])
    monkeypatch.setenv("WORLD_SIZE", "2")
    train_torch.check_supported(wide)
    with pytest.raises(NotImplementedError, match=item):
        train_torch.check_supported(cfg)


def test_profile_at_step_writes_a_three_step_trace(tmp_path):
    trainer = _trainer(tmp_path, save_every=0, profile_at_step=1)
    trainer.max_train_steps = 5
    trainer.fit(_lm_flows(5))
    trace = tmp_path / "profile" / "trace_step1.json"
    events = json.loads(trace.read_text())["traceEvents"]
    assert trainer.global_step == 5 and any("aten::" in e.get("name", "") for e in events)
