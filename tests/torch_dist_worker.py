"""Ranks of the port's distributed tests: worlds of 2 and 4 spawned on the
CPU, joined over gloo.

`start(world, cases, tmp_dir)` starts `world` processes (the "spawn" start
method: fresh interpreters, one torch thread each), which meet through a
file under `tmp_dir` (`core.mesh.initialize_distributed` with a `file://`
address: no TCP port to race for), run every case of `cases` in order, each
returning a dict of arrays, and write their results; `join()` gives one dict
a rank (`spawn` does both). A case may end its rank's process: its result's
"_exit" is the exit code, after the results are written (the ranks' expected
codes are `start`'s `exit_codes`). The caller computes its references while the
ranks run. Each process, and the group's every collective, has a deadline, so a
hung rank fails the test instead of the suite. This module imports torch and
the port only (never JAX): the tests hold its results against the JAX
package in their own process.
"""

from __future__ import annotations

import dataclasses
import os
import time
import traceback

import numpy as np
import torch

TIMEOUT_S = 240


class Ranks:
    """Ranks started by `start`; `join` waits for them (within the deadline
    counted from their start) and returns their results."""

    def __init__(self, world: int, cases: list, tmp_dir, timeout: float, exit_codes=None):
        import multiprocessing as mp

        self.world, self.tmp_dir = world, str(tmp_dir)
        self.exit_codes = list(exit_codes or [0] * world)
        torch.save(cases, os.path.join(self.tmp_dir, "cases.pt"))
        ctx = mp.get_context("spawn")
        self.procs = [ctx.Process(target=_rank_main, args=(rank, world, self.tmp_dir),
                                  daemon=True) for rank in range(world)]
        for p in self.procs:
            p.start()
        self.deadline = time.monotonic() + timeout

    def join(self) -> list[dict]:
        """[{name: result}] by rank; raises with each failed rank's traceback
        (or the hung ranks, killed)."""
        for p in self.procs:
            p.join(max(0.0, self.deadline - time.monotonic()))
        hung = [r for r, p in enumerate(self.procs) if p.is_alive()]
        for p in self.procs:
            if p.is_alive():
                p.kill()
                p.join(10)
        errors = []
        for rank in range(self.world):
            err = os.path.join(self.tmp_dir, f"err_{rank}.txt")
            if os.path.exists(err):
                with open(err) as f:
                    errors.append(f"rank {rank}:\n{f.read()}")
        if hung or errors or [p.exitcode for p in self.procs] != self.exit_codes:
            raise AssertionError(f"ranks hung {hung}, exit codes "
                                 f"{[p.exitcode for p in self.procs]}\n" + "\n".join(errors))
        return [torch.load(os.path.join(self.tmp_dir, f"out_{rank}.pt"), weights_only=False)
                for rank in range(self.world)]


def start(world: int, cases: list, tmp_dir, timeout: float = TIMEOUT_S,
          exit_codes=None) -> Ranks:
    """Start `world` ranks running `cases` ([(name, kind, kwargs)]) in order."""
    return Ranks(world, cases, tmp_dir, timeout, exit_codes)


def spawn(world: int, cases: list, tmp_dir, timeout: float = TIMEOUT_S) -> list[dict]:
    """`start(...).join()`."""
    return start(world, cases, tmp_dir, timeout).join()


def _rank_main(rank: int, world: int, tmp_dir: str) -> None:
    torch.set_num_threads(1)
    try:
        import torch.distributed as dist

        from mmada_tpu_torch.core.mesh import initialize_distributed

        initialize_distributed(f"file://{tmp_dir}/rendezvous", world, rank, device="cpu",
                               timeout_s=120)
        out = {}
        for name, kind, kwargs in torch.load(os.path.join(tmp_dir, "cases.pt"),
                                             weights_only=False):
            out[name] = CASES[kind](**kwargs)
            if "_exit" in out[name]:
                torch.save(out, os.path.join(tmp_dir, f"out_{rank}.pt"))
                os._exit(out[name]["_exit"])
        torch.save(out, os.path.join(tmp_dir, f"out_{rank}.pt"))
        if dist.is_initialized():
            dist.barrier()
            dist.destroy_process_group()
    except BaseException:
        with open(os.path.join(tmp_dir, f"err_{rank}.txt"), "w") as f:
            f.write(traceback.format_exc())
        raise


# ----------------------------------------------------------------- helpers

def _mesh(shape):
    from mmada_tpu_torch.core.mesh import make_mesh

    return make_mesh(*shape, device="cpu")


def _model(cfg: dict, params, vocab: dict, shape=None, attn_impl="auto", pipeline=False,
           quantize=None, policy="fp32"):
    """The port's model on the CPU from JAX's numpy params; over the mesh of
    `shape`: sharded (or, `pipeline`, split into stages over fsdp). With
    `policy="bf16"` the weights are bf16 and the model computes in bf16."""
    from mmada_tpu_torch.checkpoints.from_jax import params_from_jax
    from mmada_tpu_torch.core.precision import policy_from_name
    from mmada_tpu_torch.core.vocab import tiny_layout
    from mmada_tpu_torch.entry import quantize as quantize_model
    from mmada_tpu_torch.models import llada
    from mmada_tpu_torch.models.mmada import MMadaModel
    from mmada_tpu_torch.parallel import pipeline as pp
    from mmada_tpu_torch.parallel import sharding

    lcfg = llada.LLaDAConfig(**cfg)
    pol = policy_from_name(policy)
    model = MMadaModel(cfg=lcfg, params=params_from_jax(params, lcfg, device="cpu",
                                                        dtype=pol.param_dtype),
                       vocab=tiny_layout(**vocab), attn_impl=attn_impl, policy=pol)
    if quantize:
        model = quantize_model(model, quantize)
    if shape is None:
        return model
    mesh = _mesh(shape)
    if pipeline:
        return dataclasses.replace(model, params=pp.shard_stage_params(model.params, mesh),
                                   mesh=mesh, pipeline_axis="fsdp")
    specs = sharding.model_specs(lcfg, mesh, model.params)
    return dataclasses.replace(model, params=sharding.shard_params(model.params, specs, mesh),
                               mesh=mesh)


def _t(a):
    return None if a is None else torch.from_numpy(np.asarray(a))


def prompting(vocab):
    """Prompting for a tiny vocab (specials below its text ids), half the
    captions dropped, so that the dropout draws matter."""
    from mmada_tpu_torch.prompting.universal import ByteTokenizer, SpecialIds, UniversalPrompting

    t = vocab.text_vocab_size
    sp = SpecialIds(soi=t - 20, eoi=t - 19, t2i=t - 18, mmu=t - 17, r2i=t - 16, t2m=t - 15,
                    som=t - 14, eom=t - 13, pad=vocab.pad_token_id, bos=vocab.bos_token_id,
                    eos=vocab.eos_token_id)
    return UniversalPrompting(ByteTokenizer(), sp, max_text_len=8, cond_dropout_prob=0.5)


# ------------------------------------------------------------------- cases

def forward(cfg, params, vocab, shape, ids, mask=None, attn_impl="auto", pipeline=False,
            logit_window=None, logit_positions=None, quantize=None, policy="fp32"):
    """The serving forward's logits (every rank all of them) and the
    collectives it launched, by kind."""
    from mmada_tpu_torch.parallel import collectives

    model = _model(cfg, params, vocab, shape, attn_impl, pipeline, quantize, policy)
    before = collectives.counts.copy()
    logits = model.forward(_t(ids).long(), attention_mask=_t(mask),
                           logit_window=logit_window, logit_positions=logit_positions)
    return {"logits": logits.numpy(), "collectives": dict(collectives.counts - before)}


def tp_attention(shape, q, k, v, bias=None, batch_axes=(), rope=None):
    from mmada_tpu_torch.parallel.tp_attention import tp_attention as tp

    mesh = _mesh(shape)
    sin, cos = (None, None) if rope is None else (_t(rope[0]), _t(rope[1]))
    out = tp(_t(q), _t(k), _t(v), mesh, bias=_t(bias), batch_axes=batch_axes,
             rope_sin=sin, rope_cos=cos, gather=True)
    return {"out": out.numpy()}


def ring(shape, q, k, v):
    from mmada_tpu_torch.parallel.ring_attention import ring_attention

    out = ring_attention(_t(q), _t(k), _t(v), _mesh(shape), gather=True)
    return {"out": out.numpy()}


def samplers(cfg, params, vocab, shape, prompt, frame, uncond, text_kw, t2i_kw, pipeline=False,
             cached=False):
    """Greedy text and t2i tokens at T = 0 (every rank its own)."""
    model = _model(cfg, params, vocab, shape, pipeline=pipeline)
    text = model.generate(_t(prompt).long(), block_kv_cache=cached, **text_kw)
    codes = model.t2i_generate(_t(frame).long(), uncond_input_ids=_t(uncond).long(),
                               block_kv_cache=cached, **t2i_kw)
    return {"text": text.numpy(), "t2i": codes.numpy()}


def train_steps(cfg, params, vocab, shape, sizes, prepared, lr, remat=False, clip=1.0,
                policy="fp32"):
    """`TrainStep.apply` on each global corrupted batch in `prepared`, over the
    mesh: each step's metrics and every weight after the last, whole (fp32
    numpy; with `policy="bf16"` the weights and the compute are bf16)."""
    from mmada_tpu_torch.models import llada
    from mmada_tpu_torch.parallel import sharding
    from mmada_tpu_torch.training import optimizers
    from mmada_tpu_torch.training.train_step import StepConfig, TrainState, make_train_step

    model = dataclasses.replace(_model(cfg, params, vocab, shape, policy=policy), remat=remat)
    opt = optimizers.AdamW(lr, max_grad_norm=clip)
    state = TrainState.create(model.params, opt)
    step = make_train_step(model, opt, StepConfig(**sizes))
    metrics = []
    for batch in prepared:
        state, m = step.apply(state, {k: _t(v) for k, v in batch.items()})
        metrics.append({k: float(v) for k, v in m.items()})
    specs = sharding.model_specs(model.cfg, model.mesh)
    whole = sharding.gather_params(state.params, specs, model.mesh, model.cfg)
    return {"metrics": metrics,
            "params": {n: t.detach().float().numpy() for n, t in llada.named_leaves(whole)}}


def trainer_fit(cfg, params, vocab, shape, training, flows, seed=0, ema=False):
    """`Trainer.fit` over the mesh on flows of this rank's rows (each flow's
    rows sliced by `process_local_batch_slice`): its history and every
    weight after it, whole."""
    from mmada_tpu_torch.core.mesh import process_local_batch_slice
    from mmada_tpu_torch.models import llada
    from mmada_tpu_torch.parallel import sharding
    from mmada_tpu_torch.training.trainer import Trainer

    model = _model(cfg, params, vocab, None)
    mesh = _mesh(shape)
    tr = dict(training)
    if ema:
        tr["ema"] = {"enabled": True}
    trainer = Trainer(model, prompting(model.vocab), training=tr, optimizer={"params": {"max_grad_norm": 1.0}},
                      log_every=1, mesh=mesh)

    def local(flow):
        n = len(flow["input_ids"])
        rows = process_local_batch_slice(n, mesh)
        return {k: v[rows] for k, v in flow.items()}

    trainer.fit([{k: local(f) for k, f in raw.items()} for raw in flows], rng_seed=seed)
    specs = sharding.model_specs(trainer.model.cfg, mesh)
    whole = sharding.gather_params(trainer.state.params, specs, mesh, trainer.model.cfg)
    return {"history": trainer.history,
            "params": {n: t.detach().numpy() for n, t in llada.named_leaves(whole)}}


def train_cli(argv):
    """`train_torch.run` on this rank (its config's parallel.* over the group
    the spawn made): every weight after it, and the steps it logged."""
    import train_torch

    from mmada_tpu_torch.models import llada
    from mmada_tpu_torch.parallel import sharding

    trainer = train_torch.run(train_torch.read_config(argv))
    mesh = trainer.model.mesh
    params = trainer.state.params
    ema = trainer.ema_state.shadow
    if mesh is not None:
        specs = sharding.model_specs(trainer.model.cfg, mesh)
        params, ema = (sharding.gather_params(t, specs, mesh, trainer.model.cfg)
                       for t in (params, ema))
    return {"steps": [h["step"] for h in trainer.history],
            "loss": [h["loss"] for h in trainer.history],
            "remat": trainer.remat_resolved and trainer.remat_resolved[0],
            "params": {n: t.detach().numpy() for n, t in llada.named_leaves(params)},
            "ema": {n: t.detach().numpy() for n, t in llada.named_leaves(ema)}}


def serve_cli(script, argv, inputs=None):
    """A serving command line's `load` and `run` on this rank (t2i: the
    codes of `inputs`, its prompts; MMU: the answers about `inputs`, its
    pixels), and the mesh its loader served over."""
    import importlib

    mod = importlib.import_module(script)
    cfg = mod.read_config(argv)
    loaded = mod.load(cfg)
    if script == "inference_t2i_torch":
        out = [mod.run(cfg, loaded, inputs)[0]]
    elif script == "inference_mmu_torch":
        out = mod.run(cfg, loaded, inputs)
    else:
        out = mod.run(cfg, loaded)
    mesh = loaded.model.mesh
    return {"out": [np.asarray(o) for o in out], "pipeline": loaded.model.pipeline_axis,
            "mesh": None if mesh is None else tuple(mesh.shape)}


def refusals(cfg, params, vocab, shape):
    """The refusals over ranks, each as its error's message."""
    from mmada_tpu_torch.core.config import Config
    from mmada_tpu_torch.serve.engine import ServingEngine, TextSettings
    from mmada_tpu_torch.serve.loader import shard_for_serving

    out = {}
    model = _model(cfg, params, vocab, None)

    def message(fn):
        try:
            fn()
        except (ValueError, NotImplementedError) as e:
            return f"{type(e).__name__}: {e}"
        return None

    pipe = Config({"parallel": {"serving": "pipeline", "fsdp": -1}})
    out["pipeline_quantized"] = message(lambda: shard_for_serving(
        pipe, _model(cfg, params, vocab, None, quantize="int8")))
    odd = dataclasses.replace(model, cfg=dataclasses.replace(model.cfg, n_layers=3), params=dict(
        model.params, blocks={k: v[:3] for k, v in model.params["blocks"].items()}))
    out["pipeline_layers"] = message(lambda: shard_for_serving(pipe, odd))
    # the engine over the mesh: rank 0's answer, the followers' codes
    engine = ServingEngine(_model(cfg, params, vocab, shape), min_chunk_device_ms=0)
    if not engine.leader:
        out["engine"] = engine.follow()
        return out
    engine.start()
    try:
        out["engine"] = engine.submit_text(REFUSAL_PROMPT, TextSettings(**REFUSAL_TEXT)).result(
            timeout=120)
    finally:
        engine.stop()
    return out


def round_trip(cfg, params, vocab, shape, quantize=None):
    """`shard_params` then `gather_params` over the mesh: the whole tree
    again, quantized leaves' fields apart."""
    from mmada_tpu_torch.parallel import sharding

    model = _model(cfg, params, vocab, shape, quantize=quantize)
    specs = sharding.model_specs(model.cfg, model.mesh, model.params)
    whole = sharding.gather_params(model.params, specs, model.mesh, model.cfg)
    return {"params": _fields(whole), "local": _fields(model.params)}


def bf16_sums(shape, seed):
    """Each rank's bf16 tensor (drawn from `seed` + rank) summed over the
    group: `all_reduce`, `all_reduce_` and `reduce_scatter` along dim 0."""
    import torch.distributed as dist

    from mmada_tpu_torch.parallel import collectives as C

    rank = dist.get_rank()
    x = torch.randn(shape, generator=torch.Generator().manual_seed(seed + rank)).to(
        torch.bfloat16)
    inplace = x.clone()
    C.all_reduce_(inplace, dist.group.WORLD)
    return {"all_reduce": C.all_reduce(x, dist.group.WORLD).float().numpy(),
            "all_reduce_": inplace.float().numpy(),
            "reduce_scatter": C.reduce_scatter(x, 0, dist.group.WORLD).float().numpy(),
            "dtypes": {str(t.dtype) for t in (inplace,)}}


def row_parallel_bf16(x, w, cot):
    """`llada._row_parallel` over the world as the tensor group, bf16: this
    rank's slice of x's last axis and of w's rows; the sum (bf16) and the
    gradients of sum(y * cot) for this rank's slices."""
    import torch.distributed as dist

    from mmada_tpu_torch.models import llada

    rank, world = dist.get_rank(), dist.get_world_size()
    k = x.shape[-1] // world
    xs = _t(x[..., rank * k:(rank + 1) * k]).to(torch.bfloat16).requires_grad_(True)
    ws = _t(w[rank * k:(rank + 1) * k]).to(torch.bfloat16).requires_grad_(True)
    y = llada._row_parallel(xs, ws, dist.group.WORLD)
    gx, gw = torch.autograd.grad((y.float() * _t(cot)).sum(), [xs, ws])
    return {"y": y.float().detach().numpy(), "dtype": str(y.dtype),
            "gx": gx.float().numpy(), "gw": gw.float().numpy()}


def _greedy(model):
    """The model with its t2i and t2m samplers at greedy (argmax): the
    engines sample categorically, and torch's draws are not threefry's, so
    the ranks are held to JAX's engine at greedy (JAX's patched alike)."""
    from mmada_tpu_torch.models.mmada import MMadaModel

    @dataclasses.dataclass
    class Greedy(MMadaModel):
        def t2i_generate(self, *a, **kw):
            return super().t2i_generate(*a, greedy=True, **kw)

        def t2i_segmented_run(self, *a, **kw):
            return super().t2i_segmented_run(*a, greedy=True, **kw)

        def t2m_generate(self, *a, **kw):
            return super().t2m_generate(*a, greedy=True, **kw)

    return Greedy(**{f.name: getattr(model, f.name) for f in dataclasses.fields(model)})


def _until(cond, timeout=60.0):
    deadline = time.monotonic() + timeout
    while not cond():
        if time.monotonic() > deadline:
            raise TimeoutError("the engine did not get there")
        time.sleep(0.002)


def engine_script(cfg, params, vocab, shape, inputs, timeout_s=30.0):
    """The serving engine over the mesh of `shape` (None: no mesh, the world
    of one): rank 0 starts it and sends `inputs`' requests, every other rank
    follows. Rank 0 returns the answers and the engine's counters; a
    follower its `follow()` code. The requests: a held text batch at T = 0
    and two seeded stochastic rows, a chunked stream joined mid-block by a
    second request after its first chunk, MMU, t2i with CFG (whole and in
    windows), t2m, the stepwise demos (whole and streamed), a chunked
    request cancelled after its first chunk; then a drain."""
    from mmada_tpu_torch.serve import engine as E

    model = _greedy(_model(cfg, params, vocab, shape))
    engine = E.ServingEngine(model, min_chunk_device_ms=0, max_wait_ms=1,
                             control_timeout_s=timeout_s)
    if not engine.leader:
        return {"follow": engine.follow(), "events": engine.channel.seq}
    engine.start()
    text = E.TextSettings(**inputs["text"])
    stoch = dataclasses.replace(text, temperature=1.0)
    chunked = dataclasses.replace(text, segment_steps=inputs["segment"])
    out = {}

    def batch(submits):
        engine.pause()
        futs = [f() for f in submits]
        engine.resume()
        return [f.result(timeout=120) for f in futs]

    out["text"] = batch([lambda p=p: engine.submit_text(p, text) for p in inputs["prompts"]])
    out["stochastic"] = batch([lambda s=s: engine.submit_text(inputs["prompts"][0], stoch, seed=s)
                               for s in (3, 4)])
    def after_a_chunk(submit):
        """`submit()`'s request once a chunk of the stream has run, with the
        dispatcher held meanwhile (it then joins, or is cancelled, at the
        next chunk boundary)."""
        chunks = engine.stats["chunks"]
        _until(lambda: engine.stats["chunks"] > chunks)
        engine.pause()
        try:
            return submit()
        finally:
            engine.resume()

    joins = engine.stats["stream_joins"]
    first = engine.submit_text(inputs["prompts"][0], chunked)
    second = after_a_chunk(lambda: engine.submit_text(inputs["prompts"][1], chunked))
    out["stream"] = [first.result(timeout=120), second.result(timeout=120)]
    out["stream_joins"] = engine.stats["stream_joins"] - joins
    out["mmu"] = engine.submit_mmu(inputs["mmu"], text).result(timeout=120)
    t2i = E.T2ISettings(**inputs["t2i"])
    frame, uncond = inputs["frame"], inputs["uncond"]
    out["t2i"] = engine.submit_t2i(frame, uncond, t2i).result(timeout=120)
    out["t2i_windows"] = engine.submit_t2i(
        frame, uncond, dataclasses.replace(t2i, segment_timesteps=2)).result(timeout=120)
    out["t2m"] = engine.submit_t2m(inputs["t2m_frame"], E.T2MSettings(**inputs["t2m"])).result(
        timeout=120)
    steps = dict(inputs["text"], temperature=1.0)
    out["text_steps"] = engine.submit_text_steps(inputs["prompts"][0], seed=5, **steps).result(
        timeout=120)
    fut = engine.submit_text_steps(inputs["prompts"][0], seed=5, segment_steps=3, **steps)
    out["text_steps_streamed"] = np.concatenate(list(E.partials(fut)))
    t2i_steps = dict(temperature=0.0, timesteps=t2i.timesteps,
                     guidance_scale=t2i.guidance_scale, num_vq_tokens=t2i.num_vq_tokens)
    out["t2i_steps"] = engine.submit_t2i_steps(frame, uncond, **t2i_steps).result(timeout=120)
    fut = engine.submit_t2i_steps(frame, uncond, segment_timesteps=2, **t2i_steps)
    out["t2i_steps_streamed"] = np.concatenate(list(E.partials(fut)))
    doomed = engine.submit_text(inputs["prompts"][2], chunked)
    assert after_a_chunk(doomed.cancel)
    last = engine.submit_text(inputs["prompts"][3], chunked)
    out["after_cancel"] = last.result(timeout=120)
    engine.stop(drain=True)
    out["stats"] = dict(engine.stats)
    out["events"] = engine.channel.seq if engine.channel is not None else 0
    return out


#: the engine's request in `refusals`
REFUSAL_PROMPT = np.arange(3, 9)
REFUSAL_TEXT = dict(gen_length=8, steps=4, block_length=8)


def engine_fault(cfg, params, vocab, shape, inputs, timeout_s):
    """A follower that fails every t2i call (an error injected into its
    `_call`): rank 0's t2i request must fail with the follower's traceback
    within the control channel's timeout, and every rank end with an error
    code. Rank 0 returns the error and the seconds it took."""
    from mmada_tpu_torch.serve import engine as E

    model = _model(cfg, params, vocab, shape)
    engine = E.ServingEngine(model, min_chunk_device_ms=0, control_timeout_s=timeout_s)
    if not engine.leader:
        call = E._call

        def failing(model, kind, *a):
            if kind == "t2i":
                raise RuntimeError("injected follower failure")
            return call(model, kind, *a)

        E._call = failing
        return {"follow": engine.follow(), "_exit": 1}
    engine.start()
    text = E.TextSettings(**inputs["text"])
    answer = engine.submit_text(inputs["prompts"][0], text).result(timeout=120)
    t = time.monotonic()
    fut = engine.submit_t2i(inputs["frame"], inputs["uncond"], E.T2ISettings(**inputs["t2i"]))
    try:
        fut.result(timeout=4 * timeout_s)
        error = None
    except Exception as e:
        error = f"{type(e).__name__}: {e}"
    seconds = time.monotonic() - t
    late = engine.submit_text(inputs["prompts"][0], text)
    # rank 0's process serves the channel's store: stay until the follower
    # has taken the fault's stop
    _until(lambda: engine.channel.store.add("seen/1", 0) >= engine.channel.seq, timeout_s)
    return {"text": answer, "error": error, "seconds": seconds,
            "late": type(late.exception(timeout=10)).__name__, "running": engine.running,
            "_exit": 1}


def engine_leader_fault(cfg, params, vocab, shape, inputs, timeout_s):
    """Rank 0's t2i call fails after its first collective (an error injected
    into its row-parallel sums), which leaves the follower waiting in the
    next one: rank 0 must stop the engine and fail the request within the
    control channel's timeout (no follower reports the failure), and the
    follower end with an error once rank 0's process is gone. Rank 0
    returns the error and the seconds it took; the follower the error that
    ended its `follow()`."""
    from mmada_tpu_torch.parallel import collectives
    from mmada_tpu_torch.serve import engine as E

    model = _model(cfg, params, vocab, shape)
    engine = E.ServingEngine(model, min_chunk_device_ms=0, control_timeout_s=timeout_s)
    if not engine.leader:
        try:
            return {"follow": engine.follow(), "error": None, "_exit": 1}
        except Exception as e:
            return {"follow": None, "error": f"{type(e).__name__}: {e}", "_exit": 1}
    engine.start()
    text = E.TextSettings(**inputs["text"])
    answer = engine.submit_text(inputs["prompts"][0], text).result(timeout=120)
    reduce, sums = collectives.all_reduce, []

    def failing(x, group):
        sums.append(1)
        if len(sums) == 2:
            raise RuntimeError("injected rank-0 failure")
        return reduce(x, group)

    collectives.all_reduce = failing
    t = time.monotonic()
    fut = engine.submit_t2i(inputs["frame"], inputs["uncond"], E.T2ISettings(**inputs["t2i"]))
    try:
        fut.result(timeout=4 * timeout_s)
        error = None
    except Exception as e:
        error = f"{type(e).__name__}: {e}"
    seconds = time.monotonic() - t
    collectives.all_reduce = reduce
    late = engine.submit_text(inputs["prompts"][0], text)
    return {"text": answer, "error": error, "seconds": seconds, "sums": len(sums),
            "late": type(late.exception(timeout=10)).__name__, "running": engine.running,
            "_exit": 1}


def app_http(argv, png, prompt):
    """`app_torch` on this rank from the command line's `argv` (its loader
    shards over the spawn's ranks): rank 0 serves HTTP on a free port and
    calls /generate, /generate_stepwise (whole and streamed), /t2i and /mmu,
    then four concurrent /generate calls released together; the others
    follow. Rank 0 returns the answers, /stats' deltas and its mesh."""
    import json as _json
    import threading
    import urllib.request

    import app_torch
    import generate_torch

    state = app_torch.AppState(generate_torch.read_config(argv))
    if not state.leader:
        return {"follow": state.follow()}
    httpd = app_torch.make_server(state, 0, "127.0.0.1")
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    url = f"http://127.0.0.1:{httpd.server_address[1]}"

    def call(path, payload=None):
        data = None if payload is None else _json.dumps(payload).encode()
        req = urllib.request.Request(url + path, data, {"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=120) as resp:
            if resp.headers.get("Content-Type") == "application/x-ndjson":
                return [_json.loads(line) for line in resp if line.strip()]
            return _json.loads(resp.read())

    text = dict(prompt=prompt, gen_length=16, steps=8, block_length=8, temperature=0.0)
    out = {"health": call("/health"), "mesh": call("/stats")["mesh"]}
    try:
        out["generate"] = call("/generate", text)["text"]
        out["stepwise"] = call("/generate_stepwise", dict(text, temperature=1.0, seed=2))["steps"]
        out["stepwise_stream"] = [s["step"] for s in call(
            "/generate_stepwise", dict(text, temperature=1.0, seed=2, stream=True,
                                       segment_steps=3))]
        out["t2i"] = call("/t2i", dict(prompt=prompt, timesteps=3, guidance_scale=1.5,
                                       seed=1))["image_png_b64"]
        out["mmu"] = call("/mmu", dict(image_png_b64=png, question="what?", max_new_tokens=8,
                                       steps=4, block_length=8))["text"]
        before = call("/stats")["engine"]
        state.engine.pause()
        answers = [None] * 4

        def worker(i):
            answers[i] = call("/generate", text)["text"]

        threads = [threading.Thread(target=worker, args=(i,)) for i in range(4)]
        for th in threads:
            th.start()
        _until(lambda: call("/stats")["engine"]["requests"] >= before["requests"] + 4)
        state.engine.resume()
        for th in threads:
            th.join()
        out["concurrent"] = answers
        after = call("/stats")["engine"]
        out["deltas"] = {k: after[k] - before[k] for k in before}
    finally:
        httpd.shutdown()
        httpd.server_close()
        state.stop_engine()
        thread.join(timeout=30)
    return out


def int4_operands(cfg, params, vocab, shape):
    """The int4 operands the mesh path hands B6 over the mesh of `shape`:
    each block weight of the first layer after `_MeshPath.layer` and the
    vocab head after `head_params`, each run through B6's operand check
    (`int4_matmul._check`, which the card's wrapper applies): None where it
    passes, else its error."""
    from mmada_tpu_torch.models import llada
    from mmada_tpu_torch.ops.int4_matmul import _check
    from mmada_tpu_torch.ops.quantization import Int4Tensor

    model = _model(cfg, params, vocab, shape, quantize="int4")
    path = llada._MeshPath(model.cfg, model.mesh, model.params)
    leaves = dict(path.layer(next(iter(llada.layer_params(model.params)))))
    head = "wte" if model.cfg.weight_tying else "ff_out"
    leaves["head"] = path.head_params(model.params)[head]
    out = {}
    for name, leaf in leaves.items():
        if isinstance(leaf, Int4Tensor):
            x = torch.zeros((1, leaf.shape[-2]), dtype=torch.bfloat16)
            try:
                _check(x, leaf.packed, leaf.scales)
                out[name] = None
            except ValueError as e:
                out[name] = str(e)
    return {"checks": out}


def _fields(tree):
    out = {}
    for name, leaf in tree.items():
        for kind, t in (leaf.items() if name == "blocks" else [(None, leaf)]):
            path = name if kind is None else f"{name}/{kind}"
            if dataclasses.is_dataclass(t):
                for f in dataclasses.fields(t):
                    out[f"{path}.{f.name}"] = getattr(t, f.name).numpy()
            else:
                out[path] = t.numpy()
    return out


CASES = {f.__name__: f for f in (forward, tp_attention, ring, samplers, train_steps,
                                 trainer_fit, train_cli, serve_cli, refusals, round_trip,
                                 bf16_sums, row_parallel_bf16, engine_script, engine_fault,
                                 engine_leader_fault, app_http, int4_operands)}
