"""The port over ranks: worlds of 2 and 4 spawned on the CPU and joined over
gloo (`torch_dist_worker.py`), held against the JAX package's sharded
functions on the same mesh shapes over 2 or 4 of its 8 CPU devices
(`conftest.py`), with JAX's own bars, and against the port's world of one:

  * the serving forward's logits on (1,4,1), (1,2,2), (1,1,4), (2,2,1), masked
    too, and with int8 weights; `tp_attention` with a broadcast bias, a
    per-head bias and GQA; `ring_attention` and the model's ring; the
    pipeline's logits with 2 and 4 stages and a vocab window (fp32, atol
    2e-5); bf16 over tensor 4 (ROADMAP C.8): equal to the whole bf16
    forward, no farther from fp32 than JAX's sharded bf16 forward; two bf16
    train steps over (1,2,2) no farther from fp32 than JAX's sharded ones;
  * greedy text and t2i samplers (T = 0) token-exact, the same on every rank
    (sharded, pipelined and cached);
  * two train steps on (1,2,1), (1,2,2) and (2,2,1), unmasked and with
    `t2i_masks`, on batches whose masked counts differ by rank: loss, grad
    norm and every weight after the steps against the port's world of one
    and JAX's sharded step (atol 5e-5, rtol 1e-3, `tests/test_training.py`'s);
    the Trainer's fit (each rank its rows, the caption dropout and the
    corruption drawn for the global batch) against its world of one;
  * `train_torch` at world 2 with `parallel.fsdp=2`: checkpoint-2 resumed at
    world 1 and at world 2 lands on the uninterrupted run; the three serving
    command lines under two ranks, sharded and pipelined, answer as one;
  * the refusals: pipeline stages of quantized weights or of layers they do
    not divide; the serving engine is served over four ranks;
  * W8A8 over tensor 2 and 4: the logits equal the unsharded W8A8 forward
    bit for bit (the row-parallel products sum exact int32 partials); two
    W8A8 steps over (1,2,2) against JAX's sharded W8A8 step;
  * the serving engine at world 2 over fsdp and over tensor (rank 0
    dispatches, rank 1 follows over the control channel): text, a stream
    joined mid-block, MMU, t2i with CFG, t2m, the stepwise demos, equal to
    the engine at world 1 and, at T = 0 and greedy, to JAX's engine on its
    CPU mesh; a cancel and a drain leave no rank waiting; `app_torch` at
    world 2 answers as at world 1, four concurrent /generate calls one
    batch; a follower's injected failure fails rank 0's request within the
    channel's timeout and ends every rank with an error, and so does a
    failure of rank 0 alone after its first collective.
"""

import dataclasses
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_dist_worker as W
from mmada_tpu.core import precision as jax_precision
from mmada_tpu.core.mesh import make_mesh as jax_make_mesh
from mmada_tpu.core.vocab import tiny_layout as jax_tiny_layout
from mmada_tpu.models import llada as jax_llada
from mmada_tpu.models.mmada import MMadaModel as JaxMMadaModel
from mmada_tpu.ops import quantization as jax_quant
from mmada_tpu.parallel import pipeline as jax_pipeline
from mmada_tpu.parallel import sharding as jax_sharding
from mmada_tpu.parallel.ring_attention import ring_attention as jax_ring
from mmada_tpu.parallel.tp_attention import tp_attention as jax_tp
from mmada_tpu.serve import engine as jax_engine
from mmada_tpu.training import optimizers as jax_optimizers
from mmada_tpu.training import train_step as jax_train_step
from mmada_tpu_torch.checkpoints.from_jax import named_from_jax, params_from_jax
from mmada_tpu_torch.core.precision import BF16, FP32
from mmada_tpu_torch.core.vocab import tiny_layout
from mmada_tpu_torch.models import llada
from mmada_tpu_torch.models.mmada import MMadaModel
from mmada_tpu_torch.training import optimizers
from mmada_tpu_torch.training.train_step import StepConfig, TrainState, make_train_step

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = os.path.join(REPO, "configs", "tiny_test.yaml")
FWD_TOL = dict(atol=2e-5, rtol=0)
STEP_TOL = dict(atol=5e-5, rtol=1e-3)
WORLD4_SHAPES = [(1, 4, 1), (1, 2, 2), (1, 1, 4), (2, 2, 1)]
BF16_SHAPE = (1, 1, 4)   # tensor 4: every block's attn_out and ff_out sums four partials
# fsdp 2 x tensor 2: the bf16 gradients' reduce-scatter and the row-parallel sums
BF16_STEP_SHAPE = (1, 2, 2)
W8A8_STEP_SHAPE = (1, 2, 2)
TRAIN_SHAPES = {2: [(1, 2, 1)], 4: [(1, 2, 2), (2, 2, 1)]}
SIZES = dict(batch_size_t2i=4, batch_size_lm=4, batch_size_mmu=4, max_seq_length=8)
TRAIN_VOCAB = dict(text_vocab_size=256, image_codebook_size=64)
ENGINE_VOCAB = dict(text_vocab_size=256, image_codebook_size=64, motion_codebook_size=32,
                    motion_special=2)
ENGINE_SHAPES = [(1, 2, 1), (1, 1, 2)]
ENGINE_JAX_SHAPE = (1, 1, 2)
FAULT_TIMEOUT_S = 3.0
INT4_HEAD_VOCAB = dict(text_vocab_size=320, image_codebook_size=64)   # 384 columns
# JAX's sharded step compiles for each mesh (about 7 s each here): the
# data x fsdp mesh unmasked and the fsdp x tensor mesh masked; every run is
# also held to the port's one-device step, which test_torch_training.py
# holds to JAX's unmasked and masked steps
JAX_STEPS = [((2, 2, 1), False), ((1, 2, 2), True)]
LR = 1e-3


def _jmesh(shape):
    return jax_make_mesh(*shape, devices=jax.devices()[:int(np.prod(shape))])


def _np_tree(params):
    return jax.device_get(params)


def _cfg_dict(jcfg):
    return dataclasses.asdict(jcfg)


# ---------------------------------------------------------------- fixtures

@pytest.fixture(scope="module")
def serving():
    """A 4-layer GQA model (8 heads, 4 kv heads: every tensor size of the
    meshes splits both) in JAX, its inputs, and JAX's answers."""
    jvocab = jax_tiny_layout()
    jcfg = jax_llada.tiny_config(vocab_size=jvocab.total_vocab_size, d_model=64, n_heads=8,
                                 n_kv_heads=4, n_layers=4, mlp_hidden_size=128)
    jcfg = dataclasses.replace(jcfg, mask_token_id=jvocab.mask_token_id)
    jparams = jax_llada.init_params(jax.random.key(0), jcfg)
    rng = np.random.default_rng(0)
    ids = rng.integers(3, 250, (4, 32)).astype(np.int32)
    mask = np.ones((4, 32), np.int32)
    mask[1, :5] = 0
    mask[3, :9] = 0
    return dict(jcfg=jcfg, jparams=jparams, jvocab=jvocab, ids=ids, mask=mask,
                np_params=_np_tree(jparams))


@pytest.fixture(scope="module")
def training():
    """The training test's tiny model (`test_torch_training.py`'s) and two
    batches the JAX step corrupts, masked rows padded unevenly."""
    jvocab = jax_tiny_layout(**TRAIN_VOCAB)
    jcfg = jax_llada.tiny_config(vocab_size=jvocab.total_vocab_size, d_model=32, n_heads=2,
                                 n_layers=2, mlp_hidden_size=64)
    jcfg = dataclasses.replace(jcfg, mask_token_id=jvocab.mask_token_id)
    jparams = jax_llada.init_params(jax.random.key(0), jcfg)
    return dict(jcfg=jcfg, jparams=jparams, jvocab=jvocab, np_params=_np_tree(jparams),
                batches=[_toy_batch(s, jvocab) for s in range(2)],
                keys=[jax.random.key(40 + s) for s in range(2)], prepared={})


def _toy_batch(seed, vocab, text_len=8, seq_lm=24, n_img=16):
    rng = np.random.default_rng(seed)
    bt, bl, bm = SIZES["batch_size_t2i"], SIZES["batch_size_lm"], SIZES["batch_size_mmu"]
    l_t2i = text_len + 1 + n_img + 1
    t2i = rng.integers(3, 250, size=(bt, l_t2i))
    t2i[:, text_len + 1:-1] = rng.integers(0, 64, size=(bt, n_img)) + vocab.image_offset
    masks = np.ones((bt, l_t2i), np.int64)
    masks[0, :2], masks[3, :6] = 0, 0   # pads on the first and the last rank's rows
    lm = rng.integers(3, 250, size=(bl, seq_lm))
    mmu = rng.integers(3, 250, size=(bm, seq_lm))
    prompt = np.zeros((bm, seq_lm), np.int64)
    prompt[:, :8] = 1

    def pad(x):
        return np.pad(x, ((0, 0), (0, l_t2i - x.shape[1])), constant_values=2)

    return {"t2i_input_ids": t2i, "t2i_masks": masks, "lm_input_ids": pad(lm),
            "lm_labels": pad(lm), "mmu_input_ids": pad(mmu), "mmu_prompt_masks": pad(prompt),
            "mmu_labels": np.where(pad(prompt) == 1, -100, pad(mmu))}


def _jax_prepared(jmodel, batch, key):
    prepared = jax_train_step.corrupt_batch(
        jmodel, jax_train_step.StepConfig(**SIZES),
        {k: jnp.asarray(v) for k, v in batch.items()}, key)
    return {k: np.asarray(v) for k, v in prepared.items() if v is not None}


def _jax_steps(training, masked, shape, bf16=False, forward_quantize="none"):
    """JAX's `make_train_step` over the mesh of `shape` (or one device):
    each step's metrics and the weights after both (fp32), by the port's
    names; `bf16`: the bf16 weights, computed in bf16."""
    jcfg = dataclasses.replace(training["jcfg"], attention_bias_enabled=masked)
    jmodel = JaxMMadaModel(cfg=jcfg, params=training["jparams"], vocab=training["jvocab"])
    if bf16:
        jmodel = dataclasses.replace(jmodel, params=_bf16_params(jmodel.params),
                                     policy=jax_precision.BF16)
    opt = jax_optimizers.adamw(LR, params_for_mask=jmodel.params)
    params = jmodel.params
    if shape is not None:
        params = jax_sharding.shard_params(params, jax_sharding.llada_param_specs(jcfg),
                                           _jmesh(shape))
    state = jax_train_step.TrainState.create(params, opt)
    step = jax.jit(jax_train_step.make_train_step(
        jmodel, opt, jax_train_step.StepConfig(**SIZES, forward_quantize=forward_quantize)))
    metrics = []
    for batch, key in zip(training["batches"], training["keys"]):
        if not masked:
            batch = {k: v for k, v in batch.items() if k != "t2i_masks"}
        state, m = step(state, {k: jnp.asarray(v) for k, v in batch.items()}, key)
        metrics.append({k: float(m[k]) for k in ("loss", "grad_norm")})
    named = named_from_jax(jax.device_get(jax.tree.map(lambda w: w.astype(jnp.float32),
                                                       state.params)), device="cpu")
    return metrics, {n: t.numpy() for n, t in named.items()}


def _port_world1_steps(training, masked, prepared, bf16=False):
    """The port's step on one device; `bf16`: the bf16 weights computed in
    bf16, or with `bf16="weights"` the bf16 weights computed in fp32."""
    model = _port_model(_bf16_np(training["jparams"]) if bf16 else training["np_params"],
                        dataclasses.replace(training["jcfg"], attention_bias_enabled=masked),
                        policy=BF16 if bf16 is True else FP32, **TRAIN_VOCAB)
    opt = optimizers.AdamW(LR, max_grad_norm=1.0)
    state = TrainState.create(model.params, opt)
    step = make_train_step(model, opt, StepConfig(**SIZES))
    metrics = []
    for batch in prepared:
        state, m = step.apply(state, {k: torch.tensor(v) for k, v in batch.items()})
        metrics.append({k: float(m[k]) for k in ("loss", "grad_norm")})
    return metrics, {n: t.detach().float().numpy() for n, t in llada.named_leaves(state.params)}


# ---------------------------------------------------------------- the runs

@pytest.fixture(scope="module")
def runs(serving, training, engine_setup, tmp_path_factory):
    """The worlds one after the other (at most four ranks at once beside
    this process, so that the suite's other workers keep their cores), the
    references computed while each runs (JAX's sharded functions and
    engine; the port on one device)."""
    out = tmp_path_factory.mktemp("train_cli")
    w4 = W.start(4, _world4_cases(serving, training), tmp_path_factory.mktemp("world4"))
    refs = _serving_references(serving)
    refs.update(_training_references(training, out))
    w4 = w4.join()
    # the follower's injected failure comes last: it ends both ranks with an
    # error, after their results are written
    fault = ("fault", "engine_fault", _engine_case(engine_setup, (1, 1, 2), dict(
        timeout_s=FAULT_TIMEOUT_S)))
    w2 = W.start(2, _world2_cases(serving, training, out, engine_setup) + [fault],
                 tmp_path_factory.mktemp("world2"), exit_codes=[1, 1])
    # rank 0's own failure ends its two ranks too: a spawn of its own, beside
    # the world-2 one
    lead = W.start(2, [("leader_fault", "engine_leader_fault", _engine_case(
        engine_setup, (1, 1, 2), dict(timeout_s=FAULT_TIMEOUT_S)))],
        tmp_path_factory.mktemp("world2_leader_fault"), exit_codes=[1, 1])
    refs.update(_engine_references(serving, engine_setup))
    return dict(w4=w4, w2=w2.join(), lead=lead.join(), out=out, refs=refs)


@pytest.fixture(scope="module")
def world4(runs):
    return runs["w4"]


@pytest.fixture(scope="module")
def world2(runs):
    return runs["w2"], runs["out"]


@pytest.fixture(scope="module")
def refs(runs):
    return runs["refs"]


def _world4_cases(serving, training):
    """Every world-4 case, one spawn."""
    s, cases = serving, []
    cfg = _cfg_dict(s["jcfg"])
    common = dict(cfg=cfg, params=s["np_params"], vocab={})
    for shape in WORLD4_SHAPES:
        cases.append((f"fwd{shape}", "forward", dict(common, shape=shape, ids=s["ids"])))
    masked = dict(common, cfg=dict(cfg, attention_bias_enabled=True))
    cases.append(("fwd_masked", "forward", dict(masked, shape=(1, 2, 2), ids=s["ids"],
                                                mask=s["mask"])))
    cases.append(("fwd_int8", "forward", dict(common, shape=(1, 2, 2), ids=s["ids"],
                                              quantize="int8")))
    cases.append(("fwd_ring", "forward", dict(common, shape=(1, 4, 1), ids=s["ids"],
                                              attn_impl="ring")))
    bf16 = dict(common, params=_bf16_np(s["jparams"]), ids=s["ids"], policy="bf16")
    cases.append(("fwd_bf16", "forward", dict(bf16, shape=BF16_SHAPE)))
    cases.append(("fwd_bf16_whole", "forward", dict(bf16, shape=None)))
    cases.append(("bf16_sums", "bf16_sums", dict(shape=(8, 33), seed=11)))
    cases.append(("row_parallel_bf16", "row_parallel_bf16", _row_parallel_inputs()))
    cases.append(("pipe4", "forward", dict(common, shape=(1, 4, 1), ids=s["ids"], pipeline=True,
                                           logit_window=(100, 260))))
    for name, kw in _attention_cases().items():
        cases.append((name, "tp_attention" if name.startswith("tp") else "ring", kw))
    cases.append(("samplers", "samplers", dict(common, shape=(1, 2, 2), **_sampler_inputs())))
    for shape in TRAIN_SHAPES[4]:
        for m in (False, True):
            cases.append(_train_case(training, shape, m))
    _, kind, kw = _train_case(training, BF16_STEP_SHAPE, False)
    cases.append(("train_bf16", kind, dict(kw, params=_bf16_np(training["jparams"]),
                                           policy="bf16")))
    cases.append(("refusals", "refusals", dict(common, shape=(1, 2, 2))))
    for scheme in (None, "int4"):
        cases.append((f"round_trip_{scheme}", "round_trip",
                      dict(common, shape=(1, 2, 2), quantize=scheme)))
    cases.append(("fwd_w8a8_t4", "forward", dict(common, shape=(1, 1, 4), ids=s["ids"],
                                                 quantize="w8a8")))
    name, kind, kw = _train_case(training, W8A8_STEP_SHAPE, False)
    cases.append(("train_w8a8", kind, dict(kw, sizes=dict(SIZES, forward_quantize="w8a8"))))
    return cases


def _world2_cases(serving, training, out, engine_setup):
    """Two ranks: the pipeline of 2 stages, the pipelined and cached samplers,
    the (1,2,1) steps, the Trainer's fit, the serving command lines, the
    training command line's save at step 2 beside its uninterrupted run, the
    W8A8 forward over tensor 2, the engine over fsdp and tensor, the app."""
    s, cases = serving, []
    common = dict(cfg=_cfg_dict(s["jcfg"]), params=s["np_params"], vocab={})
    cases.append(("fwd_w8a8_t2", "forward", dict(common, shape=(1, 1, 2), ids=s["ids"],
                                                 quantize="w8a8")))
    wide = _wide_int4()
    cases.append(("fwd_int4_t2", "forward", dict(cfg=_cfg_dict(wide["jcfg"]),
                                                 params=wide["np_params"], vocab={},
                                                 shape=(1, 1, 2), ids=s["ids"], quantize="int4")))
    head = _wide_int4(INT4_HEAD_VOCAB)
    for shape in ((1, 2, 1), (1, 1, 2)):
        cases.append((f"int4_operands{shape}", "int4_operands",
                      dict(cfg=_cfg_dict(head["jcfg"]), params=head["np_params"],
                           vocab=INT4_HEAD_VOCAB, shape=shape)))
    for shape in ENGINE_SHAPES:
        cases.append((f"engine{shape}", "engine_script", _engine_case(engine_setup, shape)))
    cases.append(("app", "app_http", _app_case(["parallel.fsdp=1", "parallel.tensor=2"])))
    common = dict(cfg=_cfg_dict(s["jcfg"]), params=s["np_params"], vocab={})
    cases.append(("pipe2", "forward", dict(common, shape=(1, 2, 1), ids=s["ids"], pipeline=True,
                                           logit_window=(100, 260))))
    cases.append(("samplers_pipe", "samplers", dict(common, shape=(1, 2, 1), pipeline=True,
                                                    **_sampler_inputs())))
    cases.append(("samplers_cached", "samplers", dict(common, shape=(1, 1, 2), cached=True,
                                                      **_sampler_inputs())))
    for m in (False, True):
        cases.append(_train_case(training, TRAIN_SHAPES[2][0], m))
    cases.append(("fit", "trainer_fit", dict(_fit_inputs(training), shape=(1, 2, 1))))
    for name, argv, inputs in _serve_cli_cases(out):
        cases.append((name, "serve_cli", dict(script=name.split(":")[0], argv=argv,
                                              inputs=inputs)))
    cases.append(("cli_save", "train_cli", dict(argv=_cli_argv(out / "run", 2) + [
        "experiment.save_every=2", "parallel.fsdp=2"])))
    cases.append(("cli_straight", "train_cli", dict(argv=_cli_argv(out / "straight", 3) + [
        "parallel.fsdp=2"])))
    return cases


def _serving_references(serving):
    """What the ranks' forwards and samplers are held to, computed here."""
    refs = {f"fwd{shape}": _jax_forward(serving, shape) for shape in WORLD4_SHAPES}
    from mmada_tpu_torch.entry import quantize

    w8a8 = quantize(_port_model(serving["np_params"], serving["jcfg"]), "w8a8")
    refs["fwd_w8a8"] = w8a8.forward(torch.from_numpy(serving["ids"]).long()).numpy()
    refs["fwd_masked"] = _jax_forward(serving, (1, 2, 2), mask=serving["mask"])
    refs["fwd_int8"] = _jax_forward(serving, (1, 2, 2), quantize="int8")
    refs["fwd_ring"] = _jax_forward(serving, (1, 4, 1), attn_impl="ring")
    refs.update(_jax_attention())
    for stages in (2, 4):
        mesh = _jmesh((1, stages, 1))
        params = jax_pipeline.shard_stage_params(serving["jparams"], mesh)
        refs[f"pipe{stages}"] = np.asarray(jax.jit(lambda p, ids, mesh=mesh: (
            jax_pipeline.pipeline_forward(p, serving["jcfg"], ids, mesh,
                                          logit_window=(100, 260))))(
            params, jnp.asarray(serving["ids"])))
    refs["full"] = np.asarray(jax.jit(lambda p, ids: jax_llada.forward(p, serving["jcfg"], ids))(
        serving["jparams"], jnp.asarray(serving["ids"])))
    refs.update(_jax_bf16_forwards(serving))
    refs["tokens"] = _jax_tokens(serving)
    refs["cached"] = _port_cached_tokens(serving)
    return refs


def _training_references(training, out):
    """What the ranks' steps, fit and command lines are held to."""
    refs = {}
    for shape, masked in JAX_STEPS:
        refs[("jax", shape, masked)] = _jax_steps(training, masked, shape)
    for masked in (False, True):
        refs[("one", masked)] = _port_world1_steps(training, masked, _prepared(training, masked))
    for shape in (BF16_STEP_SHAPE, None):
        refs[("jax_bf16", shape)] = _jax_steps(training, False, shape, bf16=True)
    refs["jax_w8a8"] = _jax_steps(training, False, W8A8_STEP_SHAPE, forward_quantize="w8a8")
    refs["one_bf16"] = _port_world1_steps(training, False, _prepared(training, False), bf16=True)
    refs["one_fp32_on_bf16"] = _port_world1_steps(training, False, _prepared(training, False),
                                                  bf16="weights")
    refs["fit"] = _port_world1_fit(training)
    refs["serve_cli"] = _port_world1_cli(out)
    return refs


def _attention_cases():
    rng = np.random.default_rng(5)
    b, h, kvh, length, d = 2, 8, 4, 32, 16
    q = rng.standard_normal((b, h, length, d)).astype(np.float32)
    k, v = (rng.standard_normal((b, kvh, length, d)).astype(np.float32) for _ in range(2))
    k_full = rng.standard_normal((b, h, length, d)).astype(np.float32)
    v_full = rng.standard_normal((b, h, length, d)).astype(np.float32)
    bcast = np.where(rng.random((b, 1, length, length)) < 0.2, -1e9, 0.0).astype(np.float32)
    per_head = rng.standard_normal((b, h, length, length)).astype(np.float32)
    sin, cos = (np.asarray(t) for t in jax_llada.rope_sin_cos(length, d, 10000.0))
    return {
        "tp_gqa_rope": dict(shape=(1, 1, 4), q=q, k=k, v=v, rope=(sin, cos)),
        "tp_bcast_bias": dict(shape=(2, 1, 2), q=q, k=k, v=v, bias=bcast, batch_axes=("data",)),
        "tp_head_bias": dict(shape=(1, 2, 2), q=q, k=k_full, v=v_full, bias=per_head,
                             batch_axes=("fsdp",)),
        "ring4": dict(shape=(1, 4, 1), q=q, k=k_full, v=v_full),
    }


def _sampler_inputs():
    vocab = tiny_layout()
    n, prompt_len = 16, 9
    rng = np.random.default_rng(4)
    frame = np.concatenate([rng.integers(3, 200, (2, prompt_len)), np.full((2, 1), 250),
                            np.full((2, n), vocab.mask_token_id), np.full((2, 1), 251)],
                           axis=1).astype(np.int32)
    uncond = frame.copy()
    uncond[:, :prompt_len] = vocab.pad_token_id
    return dict(prompt=np.random.default_rng(2).integers(3, 200, (2, 7)).astype(np.int32),
                frame=frame, uncond=uncond,
                text_kw=dict(gen_length=16, steps=8, block_length=8, temperature=0.0),
                t2i_kw=dict(temperature=0.0, timesteps=6, guidance_scale=2.0, num_vq_tokens=n,
                            greedy=True))


def _prepared(training, masked):
    """The two batches as JAX's step corrupts them (once a variant)."""
    if masked not in training["prepared"]:
        jcfg = dataclasses.replace(training["jcfg"], attention_bias_enabled=masked)
        jmodel = JaxMMadaModel(cfg=jcfg, params=training["jparams"], vocab=training["jvocab"])
        training["prepared"][masked] = [
            _jax_prepared(jmodel, b if masked else {k: v for k, v in b.items()
                                                    if k != "t2i_masks"}, key)
            for b, key in zip(training["batches"], training["keys"])]
    return training["prepared"][masked]


def _train_case(training, shape, masked):
    jcfg = dataclasses.replace(training["jcfg"], attention_bias_enabled=masked)
    prepared = _prepared(training, masked)
    return (f"train{shape}{'masked' if masked else ''}", "train_steps",
            dict(cfg=_cfg_dict(jcfg), params=training["np_params"], vocab=TRAIN_VOCAB,
                 shape=shape, sizes=SIZES, prepared=prepared, lr=LR))


def _fit_inputs(training):
    rng = np.random.default_rng(9)
    words = ["red", "fox", "snow", "oil", "lamp", "dusk"]

    def flows():
        return {"t2i_flow": {"input_ids": [" ".join(rng.choice(words, 3)) for _ in range(4)],
                             "image_codes": rng.integers(0, 64, (4, 16))},
                "lm_flow": {"input_ids": [" ".join(rng.choice(words, 6)) for _ in range(4)]}}

    return dict(cfg=_cfg_dict(training["jcfg"]), params=training["np_params"],
                vocab=TRAIN_VOCAB, flows=[flows(), flows()], ema=True,
                training=dict(batch_size_t2i=4, batch_size_lm=4, max_train_steps=2,
                              loss_chunk=8))


def _cli_argv(out, steps):
    """`train_torch` on the tiny config, `auto` remat (one decision for every
    rank) and the EMA on."""
    return [f"config={TINY}", "device=cpu", "dataset.synthetic=true", "experiment.log_every=1",
            "model.mmada.num_vq_tokens=16", "dataset.preprocessing.resolution=16",
            "training.gradient_checkpointing=auto", "training.ema.enabled=true",
            f"training.max_train_steps={steps}", f"experiment.output_dir={out}"]


def _serve_cli_cases(tmp):
    pixels = np.random.default_rng(3).uniform(-1, 1, (1, 16, 16, 3)).astype(np.float32)
    text = [f"config={TINY}", "device=cpu", "gen_length=16", "steps=8", "block_length=8"]
    t2i = [f"config={TINY}", "device=cpu", "generation_timesteps=4", "guidance_scale=1.5",
           "model.mmada.num_vq_tokens=16", "dataset.preprocessing.resolution=16"]
    mmu = [f"config={TINY}", "device=cpu", "max_new_tokens=8", "steps=4",
           "question=What is in it?"]
    out = []
    for mode in ("auto", "pipeline"):
        p = [f"parallel.serving={mode}"]
        out.append((f"generate_torch:{mode}", text + p, None))
        out.append((f"inference_t2i_torch:{mode}", t2i + p, ["a red fox", "a cat"]))
        out.append((f"inference_mmu_torch:{mode}", mmu + p, pixels))
    return out


# -------------------------------------------------------------- references

def _jax_forward(serving, shape, mask=None, attn_impl="auto", quantize=None):
    jcfg = dataclasses.replace(serving["jcfg"], attention_bias_enabled=mask is not None)
    params = serving["jparams"]
    if quantize:
        params = jax_quant.quantize_llada_params(params)
    mesh = _jmesh(shape)
    params = jax_sharding.shard_params(params, jax_sharding.llada_param_specs(jcfg), mesh)
    mask = None if mask is None else jnp.asarray(mask)
    fwd = jax.jit(lambda p, ids, mask: jax_llada.forward(p, jcfg, ids, attention_mask=mask,
                                                         mesh=mesh, attn_impl=attn_impl))
    return np.asarray(fwd(params, jnp.asarray(serving["ids"]), mask))


def _bf16_params(jparams):
    return jax.tree.map(lambda w: w.astype(jnp.bfloat16), jparams)


def _bf16_np(jparams):
    """The bf16 weights as fp32 numpy (the port casts them back exactly)."""
    return jax.tree.map(lambda w: np.asarray(w.astype(jnp.float32)), _bf16_params(jparams))


def _jax_bf16_forwards(serving):
    """JAX's bf16 forward on bf16 weights: sharded over BF16_SHAPE, whole,
    and the same weights' fp32 forward."""
    jcfg, params, ids = serving["jcfg"], _bf16_params(serving["jparams"]), serving["ids"]
    mesh = _jmesh(BF16_SHAPE)
    sharded = jax_sharding.shard_params(params, jax_sharding.llada_param_specs(jcfg), mesh)
    fwd = jax.jit(lambda p, ids, mesh: jax_llada.forward(p, jcfg, ids, policy=jax_precision.BF16,
                                                          mesh=mesh), static_argnums=2)
    fp32 = jax.tree.map(lambda w: w.astype(jnp.float32), params)
    return {"jax_bf16": np.asarray(fwd(sharded, jnp.asarray(ids), mesh)),
            "jax_bf16_whole": np.asarray(fwd(params, jnp.asarray(ids), None)),
            "bf16_weights_fp32": np.asarray(jax.jit(lambda p, ids: jax_llada.forward(
                p, jcfg, ids))(fp32, jnp.asarray(ids)))}


def _row_parallel_inputs():
    """bf16-valued x (2, 5, 64), w (64, 24) and a cotangent (fp32 numpy)."""
    import torch

    g = torch.Generator().manual_seed(12)
    x, w, cot = (torch.randn(shape, generator=g) for shape in ((2, 5, 64), (64, 24), (2, 5, 24)))
    x, w = (t.to(torch.bfloat16).float() for t in (x, w))
    return dict(x=x.numpy(), w=w.numpy(), cot=cot.numpy())


def _jax_attention():
    out = {}
    for name, kw in _attention_cases().items():
        mesh = _jmesh(kw["shape"])
        q, k, v = (jnp.asarray(kw[x]) for x in "qkv")
        if name == "ring4":
            out[name] = np.asarray(jax.jit(lambda q, k, v, mesh=mesh: jax_ring(q, k, v, mesh))(
                q, k, v))
            continue
        rope, bias = kw.get("rope"), kw.get("bias")
        rope = (None, None) if rope is None else tuple(jnp.asarray(r) for r in rope)
        bias = None if bias is None else jnp.asarray(bias)
        tp = jax.jit(lambda q, k, v, bias, sin, cos, mesh=mesh, axes=kw.get("batch_axes", ()): (
            jax_tp(q, k, v, mesh, bias=bias, batch_axes=axes, rope_sin=sin, rope_cos=cos)))
        out[name] = np.asarray(tp(q, k, v, bias, *rope))
    return out


def _jax_tokens(serving):
    """JAX's greedy text and t2i tokens over the (1,2,2) mesh."""
    kw = _sampler_inputs()
    mesh = _jmesh((1, 2, 2))
    params = jax_sharding.shard_params(serving["jparams"],
                                       jax_sharding.llada_param_specs(serving["jcfg"]), mesh)
    jmodel = JaxMMadaModel(cfg=serving["jcfg"], params=params, vocab=serving["jvocab"],
                           mesh=mesh)
    text = jmodel.generate(jnp.asarray(kw["prompt"]), **kw["text_kw"])
    codes = jmodel.t2i_generate(jnp.asarray(kw["frame"]), uncond_input_ids=jnp.asarray(
        kw["uncond"]), key=jax.random.key(0), **kw["t2i_kw"])
    return np.asarray(text), np.asarray(codes)


def _port_model(np_params, jcfg, policy=FP32, **vocab):
    cfg = llada.LLaDAConfig(**_cfg_dict(jcfg))
    return MMadaModel(cfg=cfg, params=params_from_jax(np_params, cfg, device="cpu",
                                                      dtype=policy.param_dtype),
                      vocab=tiny_layout(**vocab), policy=policy)


def _port_cached_tokens(serving):
    """The port's cached decode on one device."""
    kw = _sampler_inputs()
    model = _port_model(serving["np_params"], serving["jcfg"])
    text = model.generate(torch.from_numpy(kw["prompt"]).long(), block_kv_cache=True,
                          **kw["text_kw"])
    codes = model.t2i_generate(torch.from_numpy(kw["frame"]).long(), block_kv_cache=True,
                               uncond_input_ids=torch.from_numpy(kw["uncond"]).long(),
                               **kw["t2i_kw"])
    return text.numpy(), codes.numpy()


def _port_world1_fit(training):
    from mmada_tpu_torch.training.trainer import Trainer

    kw = _fit_inputs(training)
    model = _port_model(kw["params"], training["jcfg"], **TRAIN_VOCAB)
    trainer = Trainer(model, W.prompting(model.vocab),
                      training=dict(kw["training"], ema={"enabled": True}),
                      optimizer={"params": {"max_grad_norm": 1.0}}, log_every=1)
    trainer.fit(kw["flows"])
    return trainer.history, {n: t.detach().numpy()
                             for n, t in llada.named_leaves(trainer.state.params)}


def _port_world1_cli(out):
    """Each serving command line's answers in one process."""
    import importlib

    answers = {}
    for name, argv, inputs in _serve_cli_cases(out):
        script = name.split(":")[0]
        mod = importlib.import_module(script)
        cfg = mod.read_config(argv)
        loaded = mod.load(cfg)
        assert loaded.model.mesh is None
        if script == "inference_t2i_torch":
            answers[name] = [mod.run(cfg, loaded, inputs)[0]]
        elif script == "inference_mmu_torch":
            answers[name] = mod.run(cfg, loaded, inputs)
        else:
            answers[name] = mod.run(cfg, loaded)
    return answers


# ------------------------------------------------------------------ forward

@pytest.mark.parametrize("case", [f"fwd{shape}" for shape in WORLD4_SHAPES]
                         + ["fwd_masked", "fwd_int8", "fwd_ring"])
def test_forward_matches_jax_on_every_rank(world4, refs, case):
    """The serving forward over (1,4,1), (1,2,2), (1,1,4) and (2,2,1); masked
    (B2 on the local heads), int8, and with the ring over fsdp."""
    for rank in world4:
        np.testing.assert_allclose(rank[case]["logits"], refs[case], **FWD_TOL)


def test_bf16_tensor_parallel_sums_like_jax(world4, refs):
    """bf16 weights and compute over tensor 4 (ROADMAP C.8): each rank's
    row-parallel partial (attn_out, ff_out) stays fp32 and the sum is
    rounded once, so the sharded logits equal the port's whole bf16
    forward, and lie no farther from the same weights' fp32 forward than
    JAX's sharded bf16 logits (which XLA sums in fp32) do. Before the
    partials were rounded to bf16 and summed in bf16 (on this model: rel L2
    5.86e-3 from fp32 against JAX's 5.66e-3, 4.88e-3 from the whole bf16
    forward against JAX's 4.39e-3)."""
    fp32 = refs["bf16_weights_fp32"]

    def rel(a):
        return float(np.linalg.norm(a - fp32) / np.linalg.norm(fp32))

    jax_gap = float(np.abs(refs["jax_bf16"] - refs["jax_bf16_whole"]).max())
    assert rel(refs["jax_bf16"]) > 0 and jax_gap > 0
    for rank in world4:
        got, whole = rank["fwd_bf16"]["logits"], rank["fwd_bf16_whole"]["logits"]
        assert got.dtype == np.float32
        np.testing.assert_array_equal(got, whole)
        assert rel(got) <= rel(refs["jax_bf16"]), (rel(got), rel(refs["jax_bf16"]))
        assert rel(whole) <= rel(refs["jax_bf16_whole"]) * 1.05


def test_bf16_sharded_step_sums_like_jax(world4, refs):
    """Two bf16 train steps over fsdp 2 x tensor 2 (ROADMAP C.8: the
    gradients' reduce-scatter and the row-parallel sums) on the bf16
    weights, against JAX's sharded bf16 step on the same mesh and batches:
    the losses within 1e-4, the grad norms within a bf16 ulp, and the
    weights after both steps (the L2 norm over every leaf) no farther from the
    fp32 step of the same weights than JAX's, and no farther from the
    port's unsharded bf16 step than JAX's sharded step lies from JAX's
    unsharded one. Before the sums ran in fp32 (the partials and the
    gradients summed in bf16): 2.617e-2 from fp32 against JAX's 2.599e-2,
    and 1.37e-2 from the unsharded step against JAX's 1.85e-2; after:
    2.589e-2 and 0.85e-2."""
    jax_m, jax_w = refs[("jax_bf16", BF16_STEP_SHAPE)]
    jax_whole = refs[("jax_bf16", None)][1]
    whole, fp32 = refs["one_bf16"][1], refs["one_fp32_on_bf16"][1]

    def dist(a, b):
        return float(np.sqrt(sum(((a[n] - b[n]) ** 2).sum() for n in b)))

    assert dist(jax_w, fp32) > 0 and dist(jax_w, jax_whole) > 0
    for rank in world4:
        got = rank["train_bf16"]
        for i in range(2):
            np.testing.assert_allclose(got["metrics"][i]["loss"], jax_m[i]["loss"], rtol=1e-4)
            np.testing.assert_allclose(got["metrics"][i]["grad_norm"], jax_m[i]["grad_norm"],
                                       rtol=2 ** -8)
        w = got["params"]
        assert dist(w, fp32) <= dist(jax_w, fp32), (dist(w, fp32), dist(jax_w, fp32))
        assert dist(w, whole) <= dist(jax_w, jax_whole), (dist(w, whole),
                                                          dist(jax_w, jax_whole))


def test_bf16_collectives_sum_in_fp32_and_round_once(world4):
    """The collectives' sums of bf16 tensors over four ranks (the fsdp
    gradients' reduce-scatter, the tensor axis' all-reduces, the batch
    axes' in-place all-reduce): the fp32 sum of the ranks' values rounded
    to bf16 once, bit for bit, as XLA sums a sharded bf16 gradient; a sum
    in bf16 would round after each rank's addition."""
    import torch

    parts = [torch.randn((8, 33), generator=torch.Generator().manual_seed(11 + r)).to(
        torch.bfloat16) for r in range(4)]
    want = sum(p.float() for p in parts).to(torch.bfloat16).float().numpy()
    in_bf16 = parts[0]
    for p in parts[1:]:
        in_bf16 = in_bf16 + p
    assert not np.array_equal(in_bf16.float().numpy(), want)   # the cases tell them apart
    for rank, got in enumerate(world4):
        got = got["bf16_sums"]
        assert got["dtypes"] == {"torch.bfloat16"}
        np.testing.assert_array_equal(got["all_reduce"], want)
        np.testing.assert_array_equal(got["all_reduce_"], want)
        np.testing.assert_array_equal(got["reduce_scatter"], want[2 * rank:2 * rank + 2])


def test_bf16_row_parallel_product_and_its_gradients(world4):
    """`llada._row_parallel` over tensor 4 in bf16, with autograd (the
    tensor-parallel train step's path): the output is the fp32 product
    rounded once, and each rank's gradients are its slices of the whole
    bf16 product's (the cotangent in bf16, as the unsharded block takes it)."""
    import torch

    kw = _row_parallel_inputs()
    x, w = (torch.from_numpy(kw[k]).to(torch.bfloat16) for k in ("x", "w"))
    g = torch.from_numpy(kw["cot"]).to(torch.bfloat16)
    y = (x.float() @ w.float()).to(torch.bfloat16).float().numpy()
    gx, gw = (g @ w.T).float().numpy(), (x.reshape(-1, 64).T @ g.reshape(-1, 24)).float().numpy()
    for rank, got in enumerate(world4):
        got = got["row_parallel_bf16"]
        sl = slice(16 * rank, 16 * (rank + 1))
        assert got["dtype"] == "torch.bfloat16"
        np.testing.assert_allclose(got["y"], y, rtol=2 ** -8, atol=0)
        np.testing.assert_allclose(got["gx"], gx[..., sl], rtol=2 ** -8, atol=1e-6)
        np.testing.assert_allclose(got["gw"], gw[sl], rtol=2 ** -8, atol=1e-6)


def test_collectives_by_kind(world4, world2, serving):
    """The counterpart of the JAX tests' HLO collective audit: the
    collectives a serving forward launches, by kind. FSDP (1,4,1): one
    all-gather a sharded weight of each layer (q, k, v, attn_out, ff_proj,
    up_proj, ff_out), the embedding, the head and the logits' rows; tensor
    (1,1,4): two sums a layer (attention and MLP outputs) and the embedding
    and head gathered; the ring sends K/V three times a layer; the pipeline
    sends and broadcasts, with no weight gathered."""
    layers = serving["jcfg"].n_layers
    assert world4[0]["fwd(1, 4, 1)"]["collectives"] == {"all_gather": 7 * layers + 3}
    assert world4[0]["fwd(1, 1, 4)"]["collectives"] == {"all_gather": 2,
                                                        "all_reduce": 2 * layers}
    ring = world4[0]["fwd_ring"]["collectives"]
    assert ring["send_recv"] == 3 * layers and "all_reduce" not in ring
    pipe = world2[0][0]["pipe2"]["collectives"]
    assert set(pipe) == {"send_recv", "broadcast"} and pipe["broadcast"] == 1


@pytest.mark.parametrize("name", ["tp_gqa_rope", "tp_bcast_bias", "tp_head_bias", "ring4"])
def test_tp_and_ring_attention_match_jax(world4, refs, name):
    for rank in world4:
        np.testing.assert_allclose(rank[name]["out"], refs[name], **FWD_TOL)


@pytest.mark.parametrize("stages", [2, 4])
def test_pipeline_matches_jax(world4, world2, refs, stages):
    """GPipe over 2 and 4 stages with a vocab window: JAX's pipeline, and
    the one-device forward."""
    ranks = world4 if stages == 4 else world2[0]
    for rank in ranks:
        got = rank[f"pipe{stages}"]["logits"]
        np.testing.assert_allclose(got, refs[f"pipe{stages}"], **FWD_TOL)
        np.testing.assert_allclose(got, refs["full"][..., 100:260], **FWD_TOL)


# ----------------------------------------------------------------- samplers

def test_samplers_token_exact_on_every_rank(world4, world2, refs):
    """Sharded (1,2,2) and pipelined (2 stages) samplers give JAX's tokens
    over (1,2,2) on every rank."""
    text, codes = refs["tokens"]
    ranks = [r["samplers"] for r in world4] + [r["samplers_pipe"] for r in world2[0]]
    for got in ranks:
        np.testing.assert_array_equal(got["text"], text)
        np.testing.assert_array_equal(got["t2i"], codes)


def test_cached_samplers_over_ranks_equal_world_one(world2, refs):
    """The block-KV cached decode over a tensor-parallel mesh (the cache
    holds each rank's kv heads): every rank the tokens of the port's cached
    decode on one device."""
    text, codes = refs["cached"]
    for rank in world2[0]:
        np.testing.assert_array_equal(rank["samplers_cached"]["text"], text)
        np.testing.assert_array_equal(rank["samplers_cached"]["t2i"], codes)


# ------------------------------------------------------------------ training

@pytest.mark.parametrize("shape", TRAIN_SHAPES[2] + TRAIN_SHAPES[4])
@pytest.mark.parametrize("masked", [False, True])
def test_train_steps_match_jax_sharded_and_world_one(world4, world2, training, refs, shape,
                                                     masked):
    """Two steps over the mesh: loss and grad norm of each, every weight
    after both, against the port on one device and JAX's sharded step on the
    same mesh (JAX_STEPS); the masked counts of the ranks' rows differ, so
    per-rank denominators would miss."""
    name = f"train{shape}{'masked' if masked else ''}"
    ranks = world2[0] if np.prod(shape) == 2 else world4
    ids = _prepared(training, masked)[0]["input_ids"]
    n_batch = shape[0] * shape[1]
    per_rank = (ids.reshape(3, n_batch, -1, ids.shape[1]) == training["jvocab"].mask_token_id
                ).sum(axis=(0, 2, 3))
    assert len(set(per_rank.tolist())) > 1, per_rank
    wants = [refs[("one", masked)]]
    if (shape, masked) in JAX_STEPS:
        wants.append(refs[("jax", shape, masked)])
    for rank in ranks:
        got = rank[name]
        for metrics, params in wants:
            for i in range(2):
                for k in ("loss", "grad_norm"):
                    np.testing.assert_allclose(got["metrics"][i][k], metrics[i][k], err_msg=k,
                                               **STEP_TOL)
            for n, want in params.items():
                np.testing.assert_allclose(got["params"][n], want, err_msg=n, **STEP_TOL)


def test_trainer_fit_over_ranks_equals_world_one(world2, refs):
    """`Trainer.fit` at (1,2,1), each rank fed its rows, half the captions
    dropped, the EMA on: the losses and every weight equal the one-device
    fit's."""
    history, want = refs["fit"]
    for rank in world2[0]:
        got = rank["fit"]
        assert [h["step"] for h in got["history"]] == [1, 2]
        for h, w in zip(got["history"], history):
            for k in ("loss", "loss_t2i", "loss_lm", "grad_norm"):
                np.testing.assert_allclose(h[k], w[k], err_msg=k, **STEP_TOL)
        for n, w in want.items():
            np.testing.assert_allclose(got["params"][n], w, err_msg=n, **STEP_TOL)


def test_train_cli_resumes_at_world_one_and_two(world2, tmp_path_factory):
    """checkpoint-2 of a world-2 run (parallel.fsdp=2) resumed to step 3 at
    world 2 and at world 1 lands on the uninterrupted world-2 run: every
    weight and the EMA's shadow; `auto` remat took one decision on both
    ranks."""
    import train_torch

    results, out = world2
    assert results[0]["cli_save"]["steps"] == [1, 2]
    straight = results[0]["cli_straight"]
    assert straight["steps"] == [1, 2, 3]
    np.testing.assert_allclose(results[0]["cli_save"]["loss"], straight["loss"][:2], rtol=1e-6)
    shutil.copytree(out / "run", out / "run1")
    resume = ["experiment.save_every=0", "experiment.resume_from_checkpoint=latest"]
    two = W.start(2, [("r", "train_cli", dict(argv=_cli_argv(out / "run", 3) + resume +
                                               ["parallel.fsdp=-1"]))],
                  tmp_path_factory.mktemp("resume2"))
    one = train_torch.run(train_torch.read_config(_cli_argv(out / "run1", 3) + resume))
    got_one = {"params": dict(llada.named_leaves(one.state.params)),
               "ema": dict(llada.named_leaves(one.ema_state.shadow))}
    assert [h["step"] for h in one.history] == [3]
    assert {r["cli_straight"]["remat"] for r in results} == {"dots"}
    for rank in two.join():
        assert rank["r"]["steps"] == [3]
        for tree in ("params", "ema"):
            for n, want in straight[tree].items():
                np.testing.assert_allclose(rank["r"][tree][n], want, err_msg=n, **STEP_TOL)
                np.testing.assert_allclose(got_one[tree][n].detach().numpy(), want, err_msg=n,
                                           **STEP_TOL)


# ---------------------------------------------------------- serving, refusals

def test_serving_clis_answer_over_ranks_as_one(world2, refs):
    """generate / t2i / MMU command lines under two ranks, sharded (auto) and
    pipelined: every rank answers what the one-process run answers."""
    results, out = world2
    for name, _, _ in _serve_cli_cases(out):
        want = refs["serve_cli"][name]
        for rank in results:
            got = rank[name]
            assert got["mesh"] == (1, 2, 1)
            assert got["pipeline"] == ("fsdp" if name.endswith("pipeline") else None)
            assert len(got["out"]) == len(want)
            for g, w in zip(got["out"], want):
                np.testing.assert_array_equal(g, np.asarray(w), err_msg=name)


def test_refusals_over_ranks(world4, serving):
    """The pipeline's refusals stay; the serving engine over four ranks is
    served: rank 0's greedy answer is the unsharded model's, the followers
    end on rank 0's stop."""
    got = world4[0]["refusals"]
    assert "unquantized" in got["pipeline_quantized"]
    assert "3 layers do not divide" in got["pipeline_layers"]
    model = _port_model(serving["np_params"], serving["jcfg"])
    want = model.generate(torch.from_numpy(W.REFUSAL_PROMPT)[None], **W.REFUSAL_TEXT)[0]
    np.testing.assert_array_equal(got["engine"], want.numpy())
    assert [r["refusals"]["engine"] for r in world4[1:]] == [0, 0, 0]


@pytest.mark.parametrize("scheme", [None, "int4"])
def test_gather_params_round_trip(world4, serving, scheme):
    """`shard_params` then `gather_params` over (1,2,2) gives every leaf back
    bit for bit (int4: packed values and scales); each rank holds a quarter
    of q_proj, or half in int4, whose 64-row weights pack per channel (one
    group: the block stays whole over tensor)."""
    from mmada_tpu_torch.entry import quantize

    model = _port_model(serving["np_params"], serving["jcfg"])
    if scheme:
        model = quantize(model, scheme)
    want = W._fields(model.params)
    key = "blocks/q_proj" + (".packed" if scheme else "")
    for rank in world4:
        got = rank[f"round_trip_{scheme}"]
        assert got["params"].keys() == want.keys()
        for path, w in want.items():
            np.testing.assert_array_equal(got["params"][path], w, err_msg=path)
        assert got["local"][key].size * (2 if scheme else 4) == want[key].size



# ------------------------------------------------------------------ W8A8

@pytest.mark.parametrize("case", ["fwd_w8a8_t2", "fwd_w8a8_t4"])
def test_w8a8_tensor_parallel_logits_equal_unsharded(world4, world2, refs, case):
    """W8A8 weights over tensor 2 and 4: each row-parallel product takes its
    per-token scale over the whole row (a MAX over the tensor ranks) and
    sums the ranks' exact int32 products before it rescales, so the logits
    are the unsharded W8A8 forward's bit for bit."""
    ranks = world2[0] if case.endswith("t2") else world4
    for rank in ranks:
        np.testing.assert_array_equal(rank[case]["logits"], refs["fwd_w8a8"])
    assert ranks[0][case]["collectives"]["all_reduce_max"] > 0


def test_int4_tensor_parallel_logits_match_unsharded(world2, refs):
    """int4 weights whose row-parallel shards hold whole 128-row groups run
    the tensor-parallel block (two sums a layer) and give the unsharded int4
    forward's logits within the sharded forwards' fp32 bar."""
    for rank in world2[0]:
        got = rank["fwd_int4_t2"]
        np.testing.assert_allclose(got["logits"], refs["fwd_int4"], **FWD_TOL)
        assert got["collectives"]["all_reduce"] == 2 * 2


@pytest.mark.parametrize("shape", [(1, 2, 1), (1, 1, 2)])
def test_int4_operands_over_ranks_take_b6(world2, shape):
    """ROADMAP C.9: every int4 operand the mesh path hands B6 (the first
    layer's block weights after their fsdp gather, the vocab head gathered
    whole) passes B6's operand check, which needs each row's bytes
    contiguous. A gather along a weight's second dim (the row-parallel
    weights' fsdp shards, the head's tensor shards) gave a strided view,
    which the card refused ("x, packed and scales need a contiguous last
    dim") and the CPU's plain version never checked."""
    for rank in world2[0]:
        checks = rank[f"int4_operands{shape}"]["checks"]
        assert "head" in checks and "attn_out" in checks and "ff_out" in checks
        assert checks == {name: None for name in checks}, checks


def test_w8a8_sharded_steps_match_jax(world4, refs):
    """Two W8A8 (straight-through) steps over (1,2,2) against JAX's sharded
    W8A8 step on the same mesh and batches: the losses within 1e-4 and the
    grad norms within a bf16 ulp (the bf16 C.8 test's bars), every weight
    within the sharded steps' tolerance."""
    metrics, params = refs["jax_w8a8"]
    for rank in world4:
        got = rank["train_w8a8"]
        for i in range(2):
            np.testing.assert_allclose(got["metrics"][i]["loss"], metrics[i]["loss"], rtol=1e-4)
            np.testing.assert_allclose(got["metrics"][i]["grad_norm"], metrics[i]["grad_norm"],
                                       rtol=2 ** -8)
        for n, want in params.items():
            np.testing.assert_allclose(got["params"][n], want, err_msg=n, **STEP_TOL)
    # the quantized forward computes another loss than the plain step
    assert metrics[0]["loss"] != refs[("one", False)][0][0]["loss"]


# ------------------------------------------------------------------ engine

@pytest.fixture(scope="module")
def engine_setup():
    """A 2-layer GQA model (4 heads over 2 kv heads: tensor 2 splits both)
    with the image and motion codes, weights 8x the init's (greedy tokens
    that vary along a span), and the engine's requests."""
    jvocab = jax_tiny_layout(**ENGINE_VOCAB)
    jcfg = jax_llada.tiny_config(vocab_size=jvocab.total_vocab_size, d_model=32, n_heads=4,
                                 n_kv_heads=2, n_layers=2, mlp_hidden_size=64)
    jcfg = dataclasses.replace(jcfg, mask_token_id=jvocab.mask_token_id)
    jparams = jax.tree.map(lambda w: w * 8, jax_llada.init_params(jax.random.key(3), jcfg))
    vocab = tiny_layout(**ENGINE_VOCAB)
    rng = np.random.default_rng(7)
    n_img, n_motion = 16, 8
    frame = np.concatenate([rng.integers(3, 200, 6), [250], np.full(n_img, vocab.mask_token_id),
                            [251]]).astype(np.int64)
    uncond = frame.copy()
    uncond[:6] = vocab.pad_token_id
    t2m = np.concatenate([rng.integers(3, 200, 5), [240],
                          np.full(n_motion, vocab.mask_token_id), [241]]).astype(np.int64)
    inputs = dict(
        prompts=[rng.integers(3, 200, 7).astype(np.int64) for _ in range(4)],
        mmu=rng.integers(3, 200, 20).astype(np.int64),
        text=dict(gen_length=16, steps=8, block_length=8, temperature=0.0), segment=1,
        frame=frame, uncond=uncond,
        t2i=dict(timesteps=4, guidance_scale=1.5, temperature=0.0, num_vq_tokens=n_img),
        t2m_frame=t2m, t2m=dict(timesteps=4, temperature=0.0, num_motion_tokens=n_motion))
    return dict(jcfg=jcfg, jparams=jparams, jvocab=jvocab, np_params=_np_tree(jparams),
                inputs=inputs)


def _engine_case(setup, shape, extra=None):
    return dict(cfg=_cfg_dict(setup["jcfg"]), params=setup["np_params"], vocab=ENGINE_VOCAB,
                shape=shape, inputs=setup["inputs"], **(extra or {}))


def _app_case(parallel):
    import app_torch

    pixels = np.random.default_rng(8).uniform(0, 255, (16, 16, 3)).astype(np.uint8)
    return dict(argv=[f"config={TINY}", "device=cpu", "model.mmada.num_vq_tokens=16",
                      "dataset.preprocessing.resolution=16"] + parallel,
                png=app_torch.png_b64(pixels), prompt="a red fox")


def _wide_int4(vocab=None):
    """A 2-layer model whose int4 block weights hold two or more 128-row
    groups (d_model 256, MLP 512): tensor 2 shards the row-parallel weights
    in whole groups, so the int4 blocks run tensor-parallel (B6's dispatch on
    each shard). `vocab`: `tiny_layout`'s keywords (INT4_HEAD_VOCAB: a head
    of 384 columns, B6's layout)."""
    jvocab = jax_tiny_layout(**(vocab or {}))
    jcfg = jax_llada.tiny_config(vocab_size=jvocab.total_vocab_size, d_model=256, n_heads=4,
                                 n_layers=2, mlp_hidden_size=512)
    jcfg = dataclasses.replace(jcfg, mask_token_id=jvocab.mask_token_id)
    jparams = jax_llada.init_params(jax.random.key(6), jcfg)
    return dict(jcfg=jcfg, np_params=_np_tree(jparams))


def _engine_references(serving, setup):
    """The engine script at world 1 (the port without a mesh), JAX's engine
    on its CPU mesh at T = 0 (t2i and t2m greedy, as the ranks'), and the
    app at world 1; computed while world 2 runs."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        refs = {"engine_one": W.engine_script(**_engine_case(setup, None)),
                "app_one": W.app_http(**_app_case([]))}
        from mmada_tpu_torch.entry import quantize

        wide = _wide_int4()
        refs["fwd_int4"] = quantize(_port_model(wide["np_params"], wide["jcfg"]), "int4").forward(
            torch.from_numpy(serving["ids"]).long()).numpy()
    finally:
        torch.set_num_threads(n)
    refs["engine_jax"] = _jax_engine(setup)
    return refs


def _jax_engine(setup):
    """JAX's ServingEngine over its (1,1,2) mesh on the same weights: the
    text batch, both stream rows, MMU, t2i (CFG) and t2m, at T = 0; its t2i
    and t2m samplers called at greedy."""
    import functools
    from unittest import mock

    inputs, jcfg = setup["inputs"], setup["jcfg"]
    mesh = _jmesh(ENGINE_JAX_SHAPE)
    params = jax_sharding.shard_params(setup["jparams"], jax_sharding.llada_param_specs(jcfg),
                                       mesh)
    jmodel = JaxMMadaModel(cfg=jcfg, params=params, vocab=setup["jvocab"], mesh=mesh)

    @functools.partial(jax.jit, static_argnames=("settings",))
    def t2i(model, frames, unconds, attns, uncond_attns, settings, key):
        return model.t2i_generate(
            frames, uncond_input_ids=unconds, attention_mask=attns,
            uncond_attention_mask=uncond_attns, temperature=settings.temperature,
            timesteps=settings.timesteps, guidance_scale=settings.guidance_scale,
            num_vq_tokens=settings.num_vq_tokens, key=key, greedy=True)

    @functools.partial(jax.jit, static_argnames=("settings",))
    def t2m(model, frames, attns, settings, key):
        return model.t2m_generate(frames, attention_mask=attns, temperature=settings.temperature,
                                  timesteps=settings.timesteps,
                                  num_motion_tokens=settings.num_motion_tokens, key=key,
                                  greedy=True)

    with mock.patch.object(jax_engine, "_jit_t2i", t2i), \
            mock.patch.object(jax_engine, "_jit_t2m", t2m):
        engine = jax_engine.ServingEngine(jmodel, min_chunk_device_ms=0, max_wait_ms=50).start()
        try:
            text = jax_engine.TextSettings(**inputs["text"])
            chunked = dataclasses.replace(text, segment_steps=inputs["segment"])
            futs = {"text": [engine.submit_text(p, text) for p in inputs["prompts"]],
                    "stream": [engine.submit_text(p, chunked) for p in inputs["prompts"][:2]],
                    "mmu": engine.submit_mmu(inputs["mmu"], text),
                    "t2i": engine.submit_t2i(inputs["frame"], inputs["uncond"],
                                             jax_engine.T2ISettings(**inputs["t2i"])),
                    "t2m": engine.submit_t2m(inputs["t2m_frame"],
                                             jax_engine.T2MSettings(**inputs["t2m"]))}
            return {k: ([np.asarray(f.result(timeout=300)) for f in v] if isinstance(v, list)
                        else np.asarray(v.result(timeout=300))) for k, v in futs.items()}
        finally:
            engine.stop()


def _assert_same(got, want, key):
    if isinstance(want, (list, tuple)):
        assert len(got) == len(want), key
        for g, w in zip(got, want):
            _assert_same(g, w, key)
    else:
        np.testing.assert_array_equal(np.asarray(got), np.asarray(want), err_msg=key)


ENGINE_ANSWERS = ["text", "stochastic", "stream", "mmu", "t2i", "t2i_windows", "t2m",
                  "text_steps", "text_steps_streamed", "t2i_steps", "t2i_steps_streamed",
                  "after_cancel"]


@pytest.mark.parametrize("shape", ENGINE_SHAPES)
def test_engine_over_two_ranks_equals_world_one(world2, refs, shape):
    """Rank 0 dispatches, rank 1 follows: every answer (greedy and seeded
    stochastic rows, the joined stream, MMU, t2i whole and in windows, t2m,
    the demos whole and streamed, the request after a cancel) equals the
    engine's at world 1, the counters too; the follower ends on the drain's
    stop, having taken every event."""
    lead, follower = (rank[f"engine{shape}"] for rank in world2[0])
    one = refs["engine_one"]
    for key in ENGINE_ANSWERS:
        _assert_same(lead[key], one[key], key)
    counters = ("requests", "batches", "batched_requests", "stream_joins", "cancelled")
    assert {k: lead["stats"][k] for k in counters} == {k: one["stats"][k] for k in counters}
    assert lead["stream_joins"] == 1 and lead["stats"]["cancelled"] == 1
    assert follower == {"follow": 0, "events": lead["events"]} and lead["events"] > 20
    assert not np.array_equal(lead["stochastic"][0], lead["stochastic"][1])
    # the streamed demos are the whole trajectories, chunk after chunk
    np.testing.assert_array_equal(lead["text_steps_streamed"], lead["text_steps"])
    np.testing.assert_array_equal(lead["t2i_steps_streamed"], lead["t2i_steps"])


def test_engine_over_two_ranks_equals_jax_engine(world2, refs):
    """At T = 0 (t2i and t2m greedy) the port's engine over fsdp 2 and
    tensor 2 gives JAX's engine's tokens over its (1,1,2) CPU mesh: the text
    batch, the stream rows, MMU, t2i with CFG (whole and in windows) and
    t2m."""
    jax_out = refs["engine_jax"]
    for shape in ENGINE_SHAPES:
        got = world2[0][0][f"engine{shape}"]
        for i, want in enumerate(jax_out["text"]):
            np.testing.assert_array_equal(got["text"][i], want)
        for i, want in enumerate(jax_out["stream"]):
            np.testing.assert_array_equal(got["stream"][i], want)
        for key, want in (("mmu", jax_out["mmu"]), ("t2i", jax_out["t2i"]),
                          ("t2i_windows", jax_out["t2i"]), ("t2m", jax_out["t2m"])):
            np.testing.assert_array_equal(got[key], want, err_msg=key)
        assert len(set(got["t2i"].tolist())) > 1 and len(set(got["t2m"].tolist())) > 1


def test_app_over_two_ranks_answers_as_world_one(world2, refs):
    """`app_torch` with its loader's model over tensor 2 (rank 0 serves HTTP,
    rank 1 follows): /generate, /generate_stepwise (whole and streamed),
    /t2i and /mmu answer as the app at world 1; four concurrent /generate
    calls run as one batch."""
    lead, follower = (rank["app"] for rank in world2[0])
    one = refs["app_one"]
    assert lead["mesh"] == {"data": 1, "fsdp": 1, "tensor": 2} and one["mesh"] is None
    assert lead["health"] == {"status": "ok"}
    for key in ("generate", "stepwise", "stepwise_stream", "t2i", "mmu", "concurrent"):
        assert lead[key] == one[key], key
    assert lead["stepwise_stream"] == lead["stepwise"]
    assert lead["concurrent"] == [lead["generate"]] * 4
    assert lead["deltas"]["batches"] == 1 and lead["deltas"]["batched_requests"] == 4
    assert follower == {"follow": 0}


def test_follower_failure_fails_rank_zero_within_the_timeout(world2):
    """A follower whose t2i call raises: rank 0's t2i request fails with the
    follower's traceback within the channel's timeout (plus its polling),
    the engine stops (later requests fail at once), and both ranks exit
    with an error; the text request before it was served."""
    lead, follower = (rank["fault"] for rank in world2[0])
    assert lead["text"].shape == (7 + 16,)
    assert lead["error"] is not None and "injected follower failure" in lead["error"]
    assert "rank 1 failed event" in lead["error"]
    assert FAULT_TIMEOUT_S <= lead["seconds"] < FAULT_TIMEOUT_S + 5, lead["seconds"]
    assert lead["late"] == "RuntimeError" and lead["running"] is False
    assert follower["follow"] == 1


def test_rank_zero_failure_stops_every_rank(runs):
    """Rank 0's t2i call fails after its first collective, the follower
    left in the next one: no follower reports the failure, so rank 0 stops
    the engine within the channel's timeout instead of serving on with the
    ranks out of step (its later requests fail at once), and the follower
    ends with an error once rank 0's process is gone; both ranks exit with
    an error."""
    lead, follower = (rank["leader_fault"] for rank in runs["lead"])
    assert lead["text"].shape == (7 + 16,)
    assert lead["sums"] == 2
    assert lead["error"] is not None and "RankFault" in lead["error"]
    assert "rank 0 failed event" in lead["error"] and "injected rank-0 failure" in lead["error"]
    assert FAULT_TIMEOUT_S <= lead["seconds"] < FAULT_TIMEOUT_S + 5, lead["seconds"]
    assert lead["late"] == "RuntimeError" and lead["running"] is False
    assert follower["follow"] is None and follower["error"] is not None
